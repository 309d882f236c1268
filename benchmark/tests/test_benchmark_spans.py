"""Reading a profile by the program's spans (`benchmark/spans.py`) on
hand-made events, and `span_report.py` on a tiny traced CPU run."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from benchmark import span_report, spans
from benchmark.tests import tiny

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _ev(name, s, t, *, dev=CPU, id=0, thread=1):
    return SimpleNamespace(name=name, device_type=dev, time_range=SimpleNamespace(start=s, end=t),
                           id=id, thread=thread)


def _batch():
    """One search: a dedup span whose kernel runs after the span has closed,
    a merge span with a copy, a gap in the beam's own time; microseconds."""
    return [
        _ev("hnsw.search", 0, 100, id=1),
        _ev("hnsw.search.beam", 10, 90, id=2),
        _ev("hnsw.beam.dedup", 20, 30, id=3),
        _ev("aten::eq", 21, 29, id=4),
        # the runtime call sits in the dedup span (its thread is another
        # number, as CUPTI gives it); its kernel runs at 40-60
        _ev("cudaLaunchKernel", 22, 24, id=900, thread=77),
        _ev("hnsw.beam.merge", 30, 50, id=5),
        _ev("cudaMemcpyAsync", 31, 32, id=901),
        _ev("eq_kernel", 40, 60, dev=CUDA, id=900),
        _ev("Memcpy DtoD", 62, 64, dev=CUDA, id=901),
    ]


def test_device_op_goes_to_its_launching_span():
    rep = spans.attribute(_batch())
    dev = rep["device_ms"]
    # the kernel ran inside the merge span's time but was launched in dedup
    assert dev["self"] == {"hnsw.beam.dedup": 0.020, "hnsw.beam.merge": 0.002}
    assert dev["total"]["hnsw.search.beam"] == pytest.approx(0.022)
    assert dev["total"]["hnsw.search"] == pytest.approx(0.022)
    assert rep["unmatched_device_ops"] == 0


def test_gap_goes_to_the_innermost_span():
    idle = spans.attribute(_batch())["idle_ms"]
    # gaps: 0-40 (middle 20: dedup's start), 60-62 (beam), 64-100 (middle
    # 82: beam)
    assert idle["self"] == pytest.approx({"hnsw.beam.dedup": 0.040, "hnsw.search.beam": 0.038})
    assert idle["total"]["hnsw.search"] == pytest.approx(0.078)


def test_runtime_calls_counted_per_span():
    rep = spans.attribute(_batch())
    calls = rep["runtime_calls"]
    assert calls["self"] == {"hnsw.beam.dedup": 1, "hnsw.beam.merge": 1}
    assert calls["total"]["hnsw.search.beam"] == 2
    assert rep["span_counts"]["hnsw.beam.dedup"] == 1
    got = spans.per_batch(rep, 1)
    assert got["beam.host_launches_per_batch"] == 2
    assert got["api.idle_ms_per_batch"] == pytest.approx(0.0)


def test_no_spans_or_no_device_op_reads_nothing():
    evs = _batch()
    assert spans.attribute([e for e in evs if not e.name.startswith("hnsw.")]) is None
    assert spans.attribute([e for e in evs if e.device_type == CPU]) is None
    assert spans.per_batch(None, 8) == {}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    dst = str(tmp_path_factory.mktemp("bench"))
    return dst, tiny.make_bench(dst)


def test_tiny_traced_run_reports_counters_and_setup(bench):
    """On the CPU: the counters in the speed cell, the build's upper share
    and the sync's seconds in both; no device metric."""
    dst, names = bench
    for name in names:
        res = span_report.traced_cell(name, 2**31 + 9, 0.3, device="cpu", bench_dir=dst)
        assert res["correct"]
        got = res["spans"]
        want = {"build.upper_share", "sync.seconds"}
        if "speed" in name:
            want |= {"beam.iters_per_batch", "beam.host_syncs_per_batch"}
            # capped at 14 iterations, checked every 4: 4 checks and 2 copies
            assert got["beam.iters_per_batch"] == 14
            assert got["beam.host_syncs_per_batch"] == 6
        assert set(got) == want
        assert 0 < got["build.upper_share"] < 100 and got["sync.seconds"] > 0
