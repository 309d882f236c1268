"""The port's spans and counters: the hnsw.* spans a profiler records inside
HNSWIndex.search and the beam loop, their scope, the no-op span with no
profiler running, COUNTS' beam iterations and host syncs, the per-query
counts `last_metrics` keeps, and the build's and the sync's seconds.

One serial bulk build at N=1500 on the CPU (recursive upper phase), one
thread, no timing asserts."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

torch.set_num_threads(1)

from hnsw_tpu_torch.models.bulk_build import bulk_build
from hnsw_tpu_torch.models.hnsw import SearchParams, inline_search_kwargs
from hnsw_tpu_torch.ops.gather_kernels import COUNTS
from hnsw_tpu_torch.ops.traversal import search_batch
from hnsw_tpu_torch.utils.trace import NO_SPAN, span

N, D, M, B, K, EF = 1500, 16, 8, 24, 10, 40
ITER_SPANS = ["hnsw.beam.select", "hnsw.beam.hop", "hnsw.beam.dedup", "hnsw.beam.merge",
              "hnsw.beam.stop"]
MODES = {
    "seeds": dict(entry_seeds=4, max_iters=10),
    "descent": dict(max_iters=10),
    "rescore": dict(entry_seeds=4, max_iters=10, rescore=20),
}


@pytest.fixture(scope="module")
def shared():
    rng = np.random.default_rng(71)
    centers = rng.normal(size=(32, D)).astype(np.float32)
    x = centers[rng.integers(0, 32, N)] + 0.5 * rng.normal(size=(N, D)).astype(np.float32)
    q = x[rng.integers(0, N, B)] + 0.05 * rng.normal(size=(B, D)).astype(np.float32)
    index = bulk_build(x, m=M, ef_construction=EF, first_wave=256, upper_recurse_min=50,
                       seed=5, device="cpu")
    index.rebuild_device_tables()
    return {"index": index, "q": q}


def _traced_search(index, q, **params):
    """One search under a CPU profiler: (hnsw.* events by start, the
    beam_iters and host_syncs it added)."""
    before = (COUNTS.beam_iters, COUNTS.host_syncs)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        index.search(q, params=SearchParams(k=K, ef=EF, **params))
    spans = sorted((e for e in prof.events() if e.name.startswith("hnsw.")),
                   key=lambda e: e.time_range.start)
    return spans, (COUNTS.beam_iters - before[0], COUNTS.host_syncs - before[1])


def _children(event):
    kids = [c for c in event.cpu_children if c.name.startswith("hnsw.")]
    return sorted(kids, key=lambda e: e.time_range.start)


@pytest.mark.parametrize("mode", list(MODES))
def test_search_spans_tile_the_call(shared, mode):
    """One hnsw.search root whose children come in the call's order, and in
    the beam a check every 4 iterations and one hnsw.beam.* set per
    iteration, each child inside its parent."""
    spans, (iters, _) = _traced_search(shared["index"], shared["q"], **MODES[mode])
    roots = [e for e in spans if e.name == "hnsw.search"]
    assert len(roots) == 1
    top = _children(roots[0])
    want = ["hnsw.search.h2d", "hnsw.search.seeds", "hnsw.search.beam", "hnsw.search.d2h"]
    if mode == "rescore":
        want.insert(3, "hnsw.search.rescore")
    assert [e.name for e in top] == want
    beam = _children(top[2])
    if mode == "descent":
        assert beam[0].name == "hnsw.search.descent"
        beam = beam[1:]
    assert iters == MODES[mode]["max_iters"]
    expect = []
    for it in range(iters):
        expect += ["hnsw.beam.check"] * (it % 4 == 0) + ITER_SPANS
    assert [e.name for e in beam] == expect
    for parent in [roots[0], top[2]]:
        kids = _children(parent)
        assert parent.time_range.start <= kids[0].time_range.start
        assert kids[-1].time_range.end <= parent.time_range.end
        for a, b in zip(kids, kids[1:]):
            assert a.time_range.end <= b.time_range.start


def test_spans_are_function_scope(shared):
    """No span is a user annotation: under CUDA activity the profiler would
    mirror those as device events and count them as busy time."""
    spans, _ = _traced_search(shared["index"], shared["q"], **MODES["seeds"])
    assert {e.name for e in spans} >= {"hnsw.search", "hnsw.beam.dedup"}
    assert not any(e.is_user_annotation for e in spans)
    assert {e.scope for e in spans} == {0}  # RecordScope::FUNCTION


def test_span_without_profiler_is_one_noop():
    assert not torch.autograd._profiler_enabled()
    assert span("hnsw.search") is span("hnsw.beam.dedup") is NO_SPAN
    with span("hnsw.search") as s:
        assert s is None


@pytest.mark.parametrize("max_iters", [5, 14])
def test_beam_iters_counts_the_capped_loop(shared, max_iters):
    before = COUNTS.beam_iters
    shared["index"].search(shared["q"], params=SearchParams(
        k=K, ef=EF, entry_seeds=4, max_iters=max_iters))
    assert COUNTS.beam_iters - before == max_iters


@pytest.mark.parametrize("collect", [False, True])
def test_host_syncs_are_checks_plus_copies(shared, collect):
    """14 capped iterations check 4 times (iterations 0, 4, 8, 12); the
    answers are 2 copies, the per-query counts 3 more when asked for."""
    spans, (iters, syncs) = _traced_search(shared["index"], shared["q"], entry_seeds=4,
                                           max_iters=14, collect_metrics=collect)
    checks = sum(e.name == "hnsw.beam.check" for e in spans)
    assert (iters, checks) == (14, 4)
    assert syncs == checks + (5 if collect else 2)


@pytest.mark.parametrize("collect", [False, True])
def test_last_metrics_copied_only_when_asked(shared, collect):
    index, q = shared["index"], shared["q"]
    index.search(q, params=SearchParams(k=K, ef=EF, max_iters=12, collect_metrics=collect))
    got = index.last_metrics
    if not collect:
        for v in (got.hops, got.dist_comps, got.last_improve):
            assert v.dtype == np.int32 and v.shape == (B,) and not v.any()
        return
    st = index._sync_device()
    want = search_batch(st.vectors, st.graph, torch.from_numpy(q), k=K, ef=EF,
                        sq_norms=st.sq_norms, **inline_search_kwargs(st), max_iters=12,
                        collect_metrics=True)
    assert got.hops.any()
    for name in ("hops", "dist_comps", "last_improve"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name).numpy())


def test_build_and_sync_keep_their_seconds(shared):
    index = shared["index"]
    assert isinstance(index.upper_phase_s, float) and index.upper_phase_s > 0
    assert isinstance(index.last_sync_s, float) and index.last_sync_s > 0
    assert index.wave_log
