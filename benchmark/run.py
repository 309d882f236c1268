"""Run one cell of the benchmark and print one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's data from the seed, builds the index on the card
(``bulk_build``), brings up the serving tables and warms up the cell's batch
shape. The window then drives the traffic mix for ``--seconds``. Afterwards
the program's state is freed and the plain reference judges every answer of
the window (``compare.py``). With ``--trace 0`` the line carries the cell's
end-to-end metrics; with ``--trace 1`` the per-layer metrics of
``metrics/``, read from a profile of the window's first ``trace_batches``
batches, the launch counts and the build's record.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import glob  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# run as a script, Python puts this folder first on the path, where its
# modules would shadow others; the checkout's root takes its place
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "hnsw_tpu")
END_TO_END_UNITS = {"qps": "queries/s", "recall_at_10": "fraction", "batch_p95_ms": "ms",
                    "serve_mem_gb": "GB", "setup_s": "s"}


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    """A plug-in module (a data or traffic generator, a metric reader) by
    its file."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(name: str, bench_dir: str = HERE) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic mix) of a cell, by name."""
    cell = load_json(os.path.join(bench_dir, "workloads", f"{name}.json"))
    cfg = load_json(os.path.join(bench_dir, "configs", f"{cell['config']}.json"))
    traffic = load_json(os.path.join(bench_dir, "traffic", f"{cell['traffic']}.json"))
    return cell, cfg, traffic


def generators(cfg: dict, traffic: dict, bench_dir: str = HERE):
    """(data generator, traffic generator) modules that a configuration and
    a traffic mix name."""
    data = cfg["data"]["generator"]
    gen = traffic["generator"]
    return (load_module(os.path.join(bench_dir, "data", f"{data}.py"), "benchmark.data." + data),
            load_module(os.path.join(bench_dir, "traffic", f"{gen}.py"),
                        "benchmark.traffic." + gen))


def metric_readers(bench_dir: str = HERE) -> dict:
    """Every per-layer metric reader in metrics/, by metric name."""
    out = {}
    for path in sorted(glob.glob(os.path.join(bench_dir, "metrics", "*.py"))):
        name = os.path.basename(path)[:-3]
        out[name] = load_module(path, "benchmark.metrics." + name.replace(".", "_"))
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str | None:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout else None


class Tracer:
    """Profiles the window's first `n` batches (all of them in a shorter
    window): started before batch 0 and stopped before batch n, each time
    after the card has finished its work."""

    def __init__(self, n: int, probe, device):
        self.n, self.probe, self.device = n, probe, device
        self.prof = None
        self.window_s = 0.0
        self.batches = 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.start()
        self.probe.active = True
        self._t0 = time.perf_counter()

    def stop(self, batches: int) -> None:
        self._sync()
        self.window_s = time.perf_counter() - self._t0
        self.probe.active = False
        self.prof.stop()
        self.batches = batches

    def __call__(self, i: int) -> None:
        if i == 0:
            self.start()
        elif i == self.n:
            self.stop(i)
        self._last = i

    def finish(self) -> None:
        """Stop a profile the window closed before batch n."""
        if self.prof is not None and not self.batches:
            self.stop(self._last)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             bench_dir: str = HERE) -> dict:
    """Run one cell once; returns the result line's object. Decides nothing
    about the card: `main` checks that first."""
    from benchmark import compare, program, tracing

    device = torch.device(device)
    cuda = device.type == "cuda"
    cell, cfg, traffic = cell_spec(name, bench_dir)
    data_mod, gen = generators(cfg, traffic, bench_dir)

    # set-up: data, build, serving tables, warm-up
    x, pool = data_mod.make(cfg, seed, device)
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    index = program.build(cfg, x, seed, device)
    build_s = time.perf_counter() - t0
    wave_log = list(index.wave_log)
    tier = program.serve(index, cfg)
    search = program.searcher(index, traffic["search"])
    log(f"[setup] {name} seed {seed}: data {x.shape} {x.dtype}, bulk_build {build_s:.1f} s, "
        f"{len(wave_log)} waves, serving tier {tier}")
    gen.warm_up(search, pool, traffic, seed)
    probe = program.HopProbe()
    tracer = None
    if trace:
        # the profiler's first session pays its own start-up: spend it here
        warm = Tracer(0, probe, device)
        warm.start()
        warm.stop(0)
        tracer = Tracer(cell["trace_batches"], probe, device)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T_START
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    # the window
    before = program.counts()
    with probe:
        win = gen.run(search, pool, traffic, seed, seconds, on_batch=tracer)
        if tracer is not None:
            tracer.finish()
    after = program.counts()
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    log(f"[window] {win['batches']} batches, {len(win['qid'])} queries in "
        f"{win['window_s']:.3f} s; hop launches "
        + ", ".join(f"{f} {after[f] - before[f]}" for f in program.HOP_COUNTERS
                    if after[f] != before[f]))
    if cuda and after["plain_on_cuda"] != before["plain_on_cuda"]:
        raise RuntimeError("a kernel's plain version ran on CUDA tensors in the window")

    summary, launches = None, None
    if tracer is not None and tracer.batches:
        summary = tracing.summarize(tracer.prof)
        launches = [(t, m0, d, c.shape[0], c.shape[1], int(torch.unique(c).numel()))
                    for t, m0, d, c in probe.launches]
    probe.launches.clear()

    # free the program's state, then judge every answer of the window
    del index, search
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    verdict = compare.judge(cfg, cell["check"], x, pool, win["qid"], win["labels"],
                            win["dists"], device)
    log(f"[check] reference and comparison {time.perf_counter() - t0:.1f} s")

    if trace:
        ctx = {"cfg": cfg, "cell": cell, "window": win, "trace": summary,
               "trace_window_s": tracer.window_s, "trace_batches": tracer.batches,
               "hop_launches": launches, "counts_before": before, "counts_after": after,
               "build_s": build_s, "wave_log": wave_log}
        metrics = {}
        for mname, reader in metric_readers(bench_dir).items():
            # a layer's metric stands beside the end-to-end metric it moves
            if reader.MOVES not in cell["end_to_end"]:
                continue
            v = reader.read(ctx)
            if v is not None:
                metrics[mname] = {"value": float(v), "unit": reader.UNIT}
    else:
        values = {
            "qps": len(win["qid"]) / win["window_s"],
            "recall_at_10": verdict["recall"],
            "batch_p95_ms": float(np.percentile(win["latency_s"], 95)) * 1e3,
            "serve_mem_gb": window_peak / 1e9,
            "setup_s": setup_s,
        }
        metrics = {m: {"value": values[m], "unit": END_TO_END_UNITS[m]}
                   for m in cell["end_to_end"]}
    dev_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": int(max(setup_peak, window_peak)),
    }
    result = {"correct": verdict["correct"], "attempted": int(len(win["qid"])),
              "failed": verdict["bad"], "metrics": metrics, "device": dev_info}
    if trace:
        dev_info["busy_s"] = summary["busy_s"] if summary else 0.0
        dev_info["window_s"] = tracer.window_s
        if summary:
            result["breakdown"] = summary["breakdown"]
    if cuda:
        dev_info["power"] = power_limit()
    result["compared"] = verdict["numbers"]
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell, _, _ = cell_spec(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    leaked = forbidden_modules()
    if leaked:
        log("modules of the JAX stack or the JAX package were loaded: " + ", ".join(leaked))
        return 3
    for name, v in result["compared"].items():
        lim = " ".join(f"{k} {v[k]}" for k in ("min", "max") if k in v)
        log(f"compared {name} {v['value']} {lim}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
