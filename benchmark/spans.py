"""Reading a torch.profiler trace by the program's own spans: the `hnsw.`
host ranges that hnsw_tpu_torch opens while a profiler runs
(hnsw_tpu_torch/utils/trace.py), on the profiler's clock.

Three things are given to spans, each to the innermost `hnsw.` span that
holds it and to every span around that one:
- a device operation (kernel, copy, fill): to the span that held the CUDA
  runtime call that launched it, found by the profiler's correlation id. The
  card runs the work after the host has left the span, so overlap in time
  would give it to a later span;
- a device idle gap (no kernel, copy or fill running): to the span the host
  was in at the gap's middle;
- a CUDA runtime launch, copy, fill or graph-launch call: to the span it was
  made in.

What no span holds goes to OUTSIDE: the harness's own time between batches.
A profile with no `hnsw.` span (a program without them) or no device
operation (a run on the CPU) reads as None.
"""

from __future__ import annotations

import bisect
from collections import Counter, defaultdict

import torch

PREFIX = "hnsw."
OUTSIDE = "(outside)"
# the CUDA runtime calls, and their `cu*` counterparts, that put work on the card
_RUNTIME = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset",
            "cudaGraphLaunch", "cuGraphLaunch")


def _is_runtime_call(name: str) -> bool:
    return name.startswith(_RUNTIME)


class _Nesting:
    """The stack of open spans at any time on one thread: the spans' edges
    cut the timeline into segments, each with the names open over it,
    outermost first."""

    def __init__(self, spans):
        marks = []
        for i, (s, t, name) in enumerate(spans):
            # at one instant, ends before starts; an outer span opens first
            # and closes last
            marks.append((s, 1, -t, i, name))
            marks.append((t, 0, -s, i, name))
        marks.sort()
        self.edges, self.stacks = [], []
        open_ = []
        for when, opens, _, i, name in marks:
            if opens:
                open_.append((i, name))
            else:
                open_.remove((i, name))
            if self.edges and self.edges[-1] == when:
                self.stacks[-1] = tuple(n for _, n in open_)
            else:
                self.edges.append(when)
                self.stacks.append(tuple(n for _, n in open_))

    def at(self, when) -> tuple:
        j = bisect.bisect_right(self.edges, when) - 1
        return self.stacks[j] if j >= 0 else ()


class _Totals:
    """A quantity given to spans: `self_` to the innermost span only,
    `total` to every span open around it."""

    def __init__(self):
        self.self_ = defaultdict(float)
        self.total = defaultdict(float)

    def add(self, stack: tuple, value: float) -> None:
        self.self_[stack[-1] if stack else OUTSIDE] += value
        for name in set(stack) or (OUTSIDE,):
            self.total[name] += value

    def out(self) -> dict:
        return {"self": dict(self.self_), "total": dict(self.total)}


def attribute(events) -> dict | None:
    """From profiler events (`prof.events()`, or objects with the same
    fields): device ms, idle ms and runtime calls by span, each as
    {"self": {span: v}, "total": {span: v}}, and the spans' counts. None
    when no event is an `hnsw.` span or none ran on the card."""
    spans, runtime, dev, host = defaultdict(list), {}, [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append(e)
            continue
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        host.append((s, t))
        if e.name.startswith(PREFIX):
            spans[e.thread].append((s, t, e.name))
        if _is_runtime_call(e.name):
            runtime[e.id] = e
    if not spans or not dev:
        return None
    nest = {th: _Nesting(v) for th, v in spans.items()}

    def stack_at(thread, when) -> tuple:
        if thread in nest:
            return nest[thread].at(when)
        # a thread the profiler names apart from its spans' thread: the
        # deepest stack open at that time on any thread
        return max((n.at(when) for n in nest.values()), key=len)

    device_ms, idle_ms, calls = _Totals(), _Totals(), _Totals()
    unmatched = 0
    for e in dev:
        # a device operation and the runtime call that launched it share
        # the profiler's correlation id
        src = runtime.get(e.id)
        if src is None:
            unmatched += 1
            stack = ()
        else:
            stack = stack_at(src.thread, src.time_range.start)
        device_ms.add(stack, (e.time_range.end - e.time_range.start) * 1e-3)
    for e in runtime.values():
        calls.add(stack_at(e.thread, e.time_range.start), 1)

    busy = []
    for s, t in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], t)
        else:
            busy.append([s, t])
    lo = min([s for s, _ in host] + [b[0] for b in busy])
    hi = max([t for _, t in host] + [b[1] for b in busy])
    edges = [lo] + [v for b in busy for v in b] + [hi]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            mid = (a + b) / 2
            idle_ms.add(max((n.at(mid) for n in nest.values()), key=len), (b - a) * 1e-3)

    return {
        "device_ms": device_ms.out(),
        "idle_ms": idle_ms.out(),
        "runtime_calls": calls.out(),
        "span_counts": dict(Counter(name for v in spans.values() for _, _, name in v)),
        "unmatched_device_ops": unmatched,
    }


def per_batch(report: dict | None, batches: int) -> dict:
    """The span-read per-layer metrics per traced batch: the device ms
    launched in the landmark seeds, the dedup and the merges, the device's
    idle ms while the host is in the beam loop and in the rest of the
    search, and the runtime calls made in the beam loop. Empty without
    spans."""
    if not report or not batches:
        return {}

    def total(kind, name):
        return report[kind]["total"].get(name, 0.0) / batches

    return {
        "api.seeds_ms_per_batch": total("device_ms", "hnsw.search.seeds"),
        "beam.dedup_ms_per_batch": total("device_ms", "hnsw.beam.dedup"),
        "beam.merge_ms_per_batch": total("device_ms", "hnsw.beam.merge"),
        "beam.idle_ms_per_batch": total("idle_ms", "hnsw.search.beam"),
        "api.idle_ms_per_batch": total("idle_ms", "hnsw.search")
        - total("idle_ms", "hnsw.search.beam"),
        "beam.host_launches_per_batch": total("runtime_calls", "hnsw.search.beam"),
    }
