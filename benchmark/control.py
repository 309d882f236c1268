"""Read the comparison's numbers for the program and for its controls, at a
cell's own size, on several seeds in one process.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 --seconds 10 \
        [--control-seeds 3]

For each seed it makes the cell's data, builds and serves the index as a run
does, drives the cell's traffic for `--seconds`, and judges every answer
(the sound reading). On the first `--control-seeds` seeds it then drives
the same traffic with each of the cell file's `controls` switched on and
judges again. A control is the program in the nearest precision below the
one the configuration states: TF32 matmuls where it states float32 with
TF32 off (`"tf32": true`), or the next rung down the tier ladder with no
exact rescore (`"tier"`, `"rescore": 0`). Each control has to come out not
correct. One JSON line per seed, then a summary of the widest sound
readings and the narrowest control readings.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import compare, program  # noqa: E402
from benchmark.run import cell_spec, generators, log  # noqa: E402


def tf32_err(device) -> float:
    """The widest error of a float32 matmul against float64 under the
    current setting: ~2e-5 in float32, ~1.5e-2 in TF32 (on the H100)."""
    g = torch.Generator(device=device)
    g.manual_seed(0)
    a = torch.randn((256, 128), generator=g, device=device)
    b = torch.randn((128, 256), generator=g, device=device)
    return float((a @ b - (a.double() @ b.double()).float()).abs().max())


def window(cfg, cell, traffic, gen, search, x, pool, seed, seconds, device) -> dict:
    """Drive the traffic for `seconds` and judge every answer."""
    win = gen.run(search, pool, traffic, seed, seconds)
    verdict = compare.judge(cfg, cell["check"], x, pool, win["qid"], win["labels"],
                            win["dists"], device)
    return {"correct": verdict["correct"], "queries": int(len(win["qid"])),
            "numbers": {k: v["value"] for k, v in verdict["numbers"].items()}}


def read_seed(name: str, seed: int, seconds: float, controls: bool, device,
              bench_dir: str = HERE) -> dict:
    cell, cfg, traffic = cell_spec(name, bench_dir)
    data_mod, gen = generators(cfg, traffic, bench_dir)
    x, pool = data_mod.make(cfg, seed, device)
    index = program.build(cfg, x, seed, device)
    program.serve(index, cfg)
    search = program.searcher(index, traffic["search"])
    gen.warm_up(search, pool, traffic, seed)
    out = {"seed": seed, "sound": window(cfg, cell, traffic, gen, search, x, pool, seed,
                                         seconds, device), "controls": {}}
    log(f"[control] {name} seed {seed} sound: {out['sound']}")
    for ctl in cell.get("controls", []) if controls else []:
        if ctl.get("tf32") and device.type != "cuda":
            continue  # TF32 exists only on the card
        spec = dict(traffic["search"])
        if "rescore" in ctl:
            spec["rescore"] = ctl["rescore"]
        if "tier" in ctl:
            program.serve(index, {**cfg, "index": {**cfg["index"], "tier": ctl["tier"]}})
        prev = torch.get_float32_matmul_precision()
        if ctl.get("tf32"):
            torch.set_float32_matmul_precision("high")
        try:
            # the reference switches TF32 off when it judges: read the
            # setting before the window
            err = tf32_err(device) if device.type == "cuda" else None
            search_c = program.searcher(index, spec)
            gen.warm_up(search_c, pool, traffic, seed)
            res = window(cfg, cell, traffic, gen, search_c, x, pool, seed, seconds, device)
            res["f32_matmul_err"] = err
        finally:
            torch.set_float32_matmul_precision(prev)
        if "tier" in ctl:
            program.serve(index, cfg)
        out["controls"][ctl["name"]] = res
        log(f"[control] {name} seed {seed} {ctl['name']}: {res}")
    del index, search
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def summary(rows: list[dict]) -> dict:
    """Per number: the worst sound reading (the lower reading) and, per
    control, the reading least far from sound (its upper reading)."""
    worst = {"recall_at_10": min, "dist_gap": max, "bad_rows": max}
    best = {"recall_at_10": max, "dist_gap": min, "bad_rows": min}
    out = {"sound": {k: f(r["sound"]["numbers"][k] for r in rows) for k, f in worst.items()},
           "sound_correct": all(r["sound"]["correct"] for r in rows), "controls": {}}
    names = {n for r in rows for n in r["controls"]}
    for n in sorted(names):
        got = [r["controls"][n] for r in rows if n in r["controls"]]
        out["controls"][n] = {
            "seeds": len(got),
            "any_correct": any(g["correct"] for g in got),
            **{k: f(g["numbers"][k] for g in got) for k, f in best.items()},
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("no CUDA device")
        return 2
    device = torch.device("cuda")
    rows = []
    for i, s in enumerate(int(v) for v in args.seeds.split(",")):
        rows.append(read_seed(args.workload, s, args.seconds, i < args.control_seeds, device))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
