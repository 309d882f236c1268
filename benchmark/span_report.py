"""Run one cell traced, as `run.py --trace 1` does, and add what the
program's own spans and counters read.

    python3 benchmark/span_report.py --workload <cell> --seed <n> --seconds <s>

Prints `run.py`'s result line with one more object, "spans": the span-read
metrics per traced batch (`spans.per_batch`), the program's beam iterations
and host syncs per window batch (`COUNTS`), the upper phase's share of the
bulk build and the serving rebuild's seconds, and the profile's device ms,
idle ms and runtime calls by span, each per traced batch. It reads them by
wrapping, in its own process, the harness's calls that see them: the
profile's summary, the launch counts and the set-up's build and rebuild.
A program without spans or counters reads none of them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import program, run, spans, tracing  # noqa: E402

COUNTERS = ("beam_iters", "host_syncs")


def traced_cell(name: str, seed: int, seconds: float, *, device="cuda",
                bench_dir: str = run.HERE) -> dict:
    """`run.run_cell` traced, with the "spans" object added."""
    seen = {"counts": [], "report": None}
    summarize, counts, build, serve = (tracing.summarize, program.counts, program.build,
                                       program.serve)

    def summarize_too(prof, *a, **kw):
        seen["report"] = spans.attribute(prof.events())
        return summarize(prof, *a, **kw)

    def counts_too():
        out = counts()
        out.update({f: getattr(program.COUNTS, f, None) for f in COUNTERS})
        seen["counts"].append(out)
        return out

    def build_too(*a, **kw):
        index = build(*a, **kw)
        seen["upper_phase_s"] = getattr(index, "upper_phase_s", None)
        return index

    def serve_too(index, cfg):
        tier = serve(index, cfg)
        seen["last_sync_s"] = getattr(index, "last_sync_s", None)
        return tier

    tracing.summarize, program.counts, program.build, program.serve = (
        summarize_too, counts_too, build_too, serve_too)
    try:
        res = run.run_cell(name, seed, seconds, True, device=device, bench_dir=bench_dir)
    finally:
        tracing.summarize, program.counts, program.build, program.serve = (
            summarize, counts, build, serve)

    cell, _, traffic = run.cell_spec(name, bench_dir)
    # every batch of the window has the traffic's size; the profile holds
    # the first trace_batches of them
    batches = res["attempted"] // traffic["batch"]
    traced = min(cell["trace_batches"], batches)
    out = {}
    if "qps" in cell["end_to_end"]:
        out.update(spans.per_batch(seen["report"], traced))
        before, after = seen["counts"]
        for f, metric in zip(COUNTERS, ("beam.iters_per_batch", "beam.host_syncs_per_batch")):
            if before.get(f) is not None and batches:
                out[metric] = (after[f] - before[f]) / batches
    build_s = res["metrics"].get("build.seconds", {}).get("value")
    if seen.get("upper_phase_s") is not None and build_s:
        out["build.upper_share"] = 100.0 * seen["upper_phase_s"] / build_s
    if seen.get("last_sync_s") is not None:
        out["sync.seconds"] = seen["last_sync_s"]
    rep = seen["report"]
    if rep:
        out["by_span"] = {kind: {k: v / traced for k, v in rep[kind]["self"].items()}
                          for kind in ("device_ms", "idle_ms", "runtime_calls")}
        out["span_counts"] = {k: v / traced for k, v in rep["span_counts"].items()}
        out["unmatched_device_ops"] = rep["unmatched_device_ops"]
    res["spans"] = out
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        run.log("span_report needs a CUDA device")
        return 2
    print(json.dumps(traced_cell(args.workload, args.seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
