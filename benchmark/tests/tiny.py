"""Tiny copies of the benchmark's cells for CPU tests: the same files, cut to
3,000 base vectors in 12 clusters, a pool of 400 queries and batches of 128,
written as new data-only cells into a scratch benchmark folder."""

from __future__ import annotations

import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = ("sift1m-l2.speed-b8192", "bigann1m-u8.ef200-b8192")


def _load(path):
    with open(path) as fh:
        return json.load(fh)


def _dump(obj, path):
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=1)


def make_bench(dst: str) -> list[str]:
    """A benchmark folder at `dst` with the generators and readers of the
    real one and a tiny cell `tiny-<cell>` for each real cell, added as data
    only. Returns the tiny cells' names."""
    for kind in ("data", "traffic", "metrics"):
        shutil.copytree(os.path.join(BENCH, kind), os.path.join(dst, kind),
                        ignore=shutil.ignore_patterns("*.json", "__pycache__"))
    for kind in ("configs", "workloads"):
        os.makedirs(os.path.join(dst, kind), exist_ok=True)
    names = []
    for cell_name in CELLS:
        cell = _load(os.path.join(BENCH, "workloads", f"{cell_name}.json"))
        cfg = _load(os.path.join(BENCH, "configs", f"{cell['config']}.json"))
        traffic = _load(os.path.join(BENCH, "traffic", f"{cell['traffic']}.json"))
        cfg.update(n_base=3000, n_queries=400, build={"first_wave": 256})
        cfg["data"]["centers"] = 12
        traffic["batch"] = 128
        cell["config"], cell["traffic"] = "tiny-" + cell["config"], "tiny-" + cell["traffic"]
        _dump(cfg, os.path.join(dst, "configs", cell["config"] + ".json"))
        _dump(traffic, os.path.join(dst, "traffic", cell["traffic"] + ".json"))
        _dump(cell, os.path.join(dst, "workloads", f"tiny-{cell_name}.json"))
        names.append(f"tiny-{cell_name}")
    return names
