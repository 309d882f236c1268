"""The comparison's controls: the program in the nearest precision below the
one each configuration states has to come out not correct, and the program
as configured correct. The tier controls run here at a tiny size; the TF32
control needs the card, and runs there at 20,000 vectors."""

from __future__ import annotations

import pytest
import torch

from benchmark import control
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    dst = str(tmp_path_factory.mktemp("bench"))
    return dst, tiny.make_bench(dst)


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_tier_controls_fail(bench, cell):
    dst, _ = bench
    row = control.read_seed("tiny-" + cell, 23, 0.3, True, torch.device("cpu"), bench_dir=dst)
    assert row["sound"]["correct"], row
    tiers = {n: r for n, r in row["controls"].items() if n != "tf32"}
    assert tiers and not any(r["correct"] for r in tiers.values()), row


@pytest.mark.cuda
def test_tf32_control_fails_on_the_card(tmp_path):
    """At the cell's own batch of 8,192 (cuBLAS takes its TF32 kernels at
    such shapes) over 100,000 vectors, bench.py's size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    import json
    import os

    dst = str(tmp_path)
    tiny.make_bench(dst)
    for kind, name in (("configs", "tiny-sift1m-l2"), ("traffic", "tiny-speed-b8192")):
        path = os.path.join(dst, kind, name + ".json")
        spec = json.load(open(path))
        if kind == "configs":
            spec.update(n_base=100_000, n_queries=10_000)
            spec.pop("build")
            spec["data"]["centers"] = 1024
        else:
            spec["batch"] = 8192
        json.dump(spec, open(path, "w"))
    for seed in (1, 2, 3):
        row = control.read_seed("tiny-sift1m-l2.speed-b8192", seed, 2.0, True,
                                torch.device("cuda"), bench_dir=dst)
        assert row["sound"]["correct"], row
        assert not row["controls"]["tf32"]["correct"], row
