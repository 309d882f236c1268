"""The harness on the CPU at tiny sizes: the manifest and its files, a cell
added as data only, the faults the comparison has to catch, and the modules
a run loads."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.tests import tiny

ROOT = os.path.dirname(tiny.BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    dst = str(tmp_path_factory.mktemp("bench"))
    return dst, tiny.make_bench(dst)


def test_manifest_keys_and_names(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert manifest["paths"] == ["benchmark"]
    assert 1 <= manifest["run_seconds"] <= 51
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    names = [m["name"] for m in metrics] + [c["name"] for c in manifest["configs"]] + [
        w["name"] for w in manifest["workloads"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in manifest["end_to_end"]:
        assert run.END_TO_END_UNITS[m["name"]] == m["unit"]
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in manifest["end_to_end"])


def test_every_config_and_cell_file_parses(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    for c in manifest["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        for key in ("n_base", "dim", "n_queries", "k", "m", "ef_construction", "data",
                    "index", "stored_as", "guarantees", "assumed"):
            assert key in cfg, (c["name"], key)
        assert os.path.exists(os.path.join(tiny.BENCH, "data", cfg["data"]["generator"] + ".py"))
    for w in manifest["workloads"]:
        cell, cfg, traffic = run.cell_spec(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"]) == (
            w["config"], w["traffic"], w["chips"])
        assert len(w["why"]) <= 200
        assert os.path.exists(os.path.join(tiny.BENCH, "traffic", traffic["generator"] + ".py"))
        # the cell reports exactly the end-to-end metrics that list it
        want = [n for n, m in e2e.items() if w["name"] in m.get("workloads", [w["name"]])]
        assert sorted(cell["end_to_end"]) == sorted(want)
        assert {"recall_min", "dist_gap_max"} <= set(cell["check"])
        assert cell["controls"]


def test_every_per_layer_metric_has_a_reader(manifest):
    readers = run.metric_readers()
    e2e = {m["name"] for m in manifest["end_to_end"]}
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["per_layer"]:
        reader = readers[m["name"]]
        assert (reader.UNIT, reader.MOVES) == (m["unit"], m["moves"])
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        # a cell lists the metric exactly when it reports the metric it moves
        reporting = {w for w in cells if m["moves"] in run.cell_spec(w)[0]["end_to_end"]}
        assert set(m["workloads"]) == reporting
    assert set(readers) == {m["name"] for m in manifest["per_layer"]}


@pytest.mark.parametrize("trace", [0, 1])
def test_data_only_cell_runs(bench, trace):
    """A cell added as data files only is found and run; its answers are
    correct and it reports its end-to-end or per-layer metrics."""
    dst, names = bench
    for name in names:
        res = run.run_cell(name, 2**31 + 5, 0.3, bool(trace), device="cpu", bench_dir=dst)
        assert res["correct"], res["compared"]
        assert res["attempted"] > 0 and res["failed"] == 0
        cell, _, _ = run.cell_spec(name, dst)
        if trace:
            # on the CPU only the build's readers find something to read
            assert set(res["metrics"]) == {"build.seconds", "build.search_share"}
            assert res["device"]["window_s"] > 0
        else:
            assert list(res["metrics"]) == cell["end_to_end"]
        assert list(res)[-1] == "compared"


def _fault_unchanged(monkeypatch):
    """The beam loop returns the state it was given."""
    from hnsw_tpu_torch.ops import traversal

    def unchanged(q, graph, beam_d, beam_key, res_d, res_id, *a, k, **kw):
        z = torch.zeros(q.shape[0], dtype=torch.int32)
        return traversal.SearchResults(beam_d[:, :k], beam_key[:, :k] >> 1, z, z, z)

    monkeypatch.setattr(traversal, "_beam_level0", unchanged)


def _fault_half_batch(monkeypatch):
    """Half of each batch is left out; its rows repeat the other half's
    answers."""
    from hnsw_tpu_torch.models.hnsw import HNSWIndex

    orig = HNSWIndex.search

    def half(self, queries, *a, **kw):
        h = (len(queries) + 1) // 2
        d, lab = orig(self, queries[:h], *a, **kw)
        reps = -(-len(queries) // h)
        return np.tile(d, (reps, 1))[: len(queries)], np.tile(lab, (reps, 1))[: len(queries)]

    monkeypatch.setattr(HNSWIndex, "search", half)


def _fault_altered(monkeypatch):
    """The hop kernel's distances come out altered by one part in 10^4."""
    from hnsw_tpu_torch.ops import traversal

    orig = traversal.hop_dist_unified

    def altered(q, table, chosen, space="l2"):
        d, ids = orig(q, table, chosen, space)
        return d * (1 + 1e-4), ids

    monkeypatch.setattr(traversal, "hop_dist_unified", altered)


@pytest.mark.parametrize("fault", [_fault_unchanged, _fault_half_batch, _fault_altered])
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_broken_timed_path_is_not_correct(bench, cell, fault, monkeypatch):
    """A run with the timed path broken underneath comes out not correct
    (one chip: no exchange between chips to leave out)."""
    dst, _ = bench
    fault(monkeypatch)
    res = run.run_cell("tiny-" + cell, 17, 0.3, False, device="cpu", bench_dir=dst)
    assert not res["correct"], res["compared"]


def test_main_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", tiny.CELLS[0], "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def _top_names(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=600)
    return set(out.stdout.split())


def test_run_imports_no_jax(bench):
    """Nothing a run loads, the generators and readers included, has the
    top-level name of the JAX stack or of the JAX package (compared whole:
    hnsw_tpu_torch is the program)."""
    dst, names = bench
    code = ("import sys; sys.path.insert(0, '.'); from benchmark import run; "
            f"run.run_cell({names[0]!r}, 3, 0.2, True, device='cpu', bench_dir={dst!r}); "
            "print(' '.join({m.split('.')[0] for m in sys.modules}))")
    tops = _top_names(code)
    assert "hnsw_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "hnsw_tpu"}


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.'); import benchmark.reference, "
            "benchmark.compare, benchmark.roofline; "
            "print(' '.join({m.split('.')[0] for m in sys.modules}))")
    tops = _top_names(code)
    assert not tops & {"jax", "jaxlib", "flax", "hnsw_tpu", "hnsw_tpu_torch"}
