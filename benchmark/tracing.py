"""Reading a torch.profiler trace of the traced batches: the device's busy
time (the union of every kernel, copy and fill on the card), the device time
by operation, and the idle gaps by what the host was doing meanwhile.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

# names of the program's own CUDA kernels (csrc/): the node-block hop ring
# and the rescore's row gathers
HOP_KERNEL = "hop_dist_ring"
PORT_KERNELS = (HOP_KERNEL, "gather_dist_")
_NAME_CHARS = 120


_NOISE = ("void ", "at::native::", "(anonymous namespace)::", "at::cuda::detail::",
          "at::cuda::", "std::")


def _short(name: str) -> str:
    """A kernel's name without its namespaces, cut to _NAME_CHARS, so that
    the functor of a templated kernel stays in view."""
    for word in _NOISE:
        name = name.replace(word, "")
    return name if len(name) <= _NAME_CHARS else name[: _NAME_CHARS - 3] + "..."


def _merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(prof, top: int = 10) -> dict | None:
    """From a finished profiler: busy seconds, device seconds by operation,
    the hop kernel's launches and seconds, and the idle gaps (device idle
    while the host ran an operation) by the innermost host operation. None
    when the trace holds no device operation."""
    dev, host = [], []
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((e.name, s, t))
        elif e.device_type == torch.autograd.DeviceType.CPU:
            host.append((s, t, e.name))
    if not dev:
        return None
    by_op = defaultdict(float)
    for name, s, t in dev:
        by_op[name] += (t - s) * 1e-6
    busy = _merge((s, t) for _, s, t in dev)
    lo = min([busy[0][0]] + [s for s, _, _ in host])
    hi = max([busy[-1][1]] + [t for _, t, _ in host])
    # gaps: before the first device operation, between, and after the last
    edges = [lo] + [v for iv in busy for v in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host.sort()
    starts = [s for s, _, _ in host]
    idle = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        j = bisect.bisect_right(starts, mid) - 1
        name = "(host between operations)"
        # the innermost host operation holding the gap's middle: the latest
        # started one that has not ended
        for i in range(j, max(j - 64, -1), -1):
            if host[i][1] >= mid:
                name = host[i][2]
                break
        idle[name] += (b - a) * 1e-6
    hop = [(s, t) for name, s, t in dev if HOP_KERNEL in name]
    ranked = sorted(by_op.items(), key=lambda kv: -kv[1])
    return {
        "busy_s": sum(t - s for s, t in busy) * 1e-6,
        "span_s": (hi - lo) * 1e-6,
        "device_s_by_op": dict(by_op),
        "hop_launches": len(hop),
        "hop_s": sum(t - s for s, t in hop) * 1e-6,
        "breakdown": {
            "device_ops": [[_short(n), v] for n, v in ranked[:top]],
            "idle_gaps": [[_short(n), v] for n, v in
                          sorted(idle.items(), key=lambda kv: -kv[1])[:top]],
        },
    }
