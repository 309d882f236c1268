"""Port parity, batched search: hnsw_tpu_torch's search_batch against the
JAX package's on one shared graph, in the speed, exhaustive, seeded and
descent modes (JAX runs its Pallas hop kernel in interpret mode), plus the
loop's termination cadence.

Each JAX result is computed once per module: interpret mode costs seconds
per call."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import hnsw_tpu.core.graph as jgraph
from hnsw_tpu.models.hnsw import HNSWIndex as JIndex
from hnsw_tpu.models.hnsw import inline_search_kwargs
from hnsw_tpu.ops.traversal import search_batch as j_search

from hnsw_tpu_torch.convert import index_from_parts
from hnsw_tpu_torch.core.spaces import L2Space
from hnsw_tpu_torch.models.bruteforce import BruteforceIndex
from hnsw_tpu_torch.native.hnsw_builder import NativeHNSWBuilder
from hnsw_tpu_torch.ops.topk import bruteforce_topk
from hnsw_tpu_torch.ops.traversal import search_batch

N, D, M, EFC, B, K, EF = 2000, 32, 8, 100, 16, 10, 40
SEEDED = {"expand": 2, "seeds": True}


def _stop_late(view):
    """A custom stop condition (hashable: the JAX search is jitted on it)."""
    return view.it >= 6


MODES = {
    "descent": {},
    "exhaustive_seeded": dict(SEEDED),
    "speed": dict(SEEDED, stop_frontier=1.15, max_iters=14),
    "high_recall": {"stop_frontier": 1.0, "frontier_rank": EF,
                    "collect_metrics": True},
    "patience_stop_fn": dict(SEEDED, stop_patience=2, stop_fn=_stop_late,
                             collect_metrics=True),
}


@pytest.fixture(scope="module")
def shared():
    rng = np.random.default_rng(31)
    centers = rng.normal(size=(64, D)).astype(np.float32)
    x = centers[rng.integers(0, 64, N)] + 0.5 * rng.normal(size=(N, D)).astype(np.float32)
    q = x[rng.integers(0, N, B)] + 0.05 * rng.normal(size=(B, D)).astype(np.float32)
    b = NativeHNSWBuilder(D, "l2", M, EFC, seed=123)
    b.add_batch(x, np.arange(N), n_threads=1)
    g, v, dl = b.export_graph(), b.export_vectors(), b.export_deleted()
    meta = {"space": "l2", "dim": D, "m": M, "ef_construction": EFC}

    t = index_from_parts(g, v, dl, meta, device="cpu")
    st = t._sync_device()
    jg = jgraph.HNSWGraph(g.level0, g.upper, g.upper_slot, g.node_level,
                          g.labels, g.entry_point, g.max_level)
    j = JIndex._from_parts(jg, v, dl, meta)
    j.inline_neighbors = True  # the CPU default is off; serve the unified tier
    j._device = None
    jdev = j._sync_device()
    assert jdev[5][0] == "unified" and len(jdev[5][2]) == g.max_level > 0

    # the same landmark seeds for both packages
    lv, li, lsq = t._landmark_arrays()
    sd, si = bruteforce_topk(torch.from_numpy(q), lv, 4, "l2", x_sq_norms=lsq)
    seeds = (li[si].numpy(), sd.numpy())

    oracle = BruteforceIndex(L2Space(D), device="cpu")
    oracle.add_items(x, np.arange(N))
    _, gt = oracle.search_knn(q, K)
    return {"q": q, "st": st, "jdev": jdev, "seeds": seeds, "gt": gt, "jax": {}}


def _kwargs(mode, seeds):
    kw = {k: v for k, v in MODES[mode].items() if k != "seeds"}
    if MODES[mode].get("seeds"):
        kw["seed_ids"], kw["seed_dists"] = seeds
    return kw


def _run_port(s, mode, **extra):
    st = s["st"]
    kw = _kwargs(mode, s["seeds"])
    if "seed_ids" in kw:
        kw["seed_ids"] = torch.from_numpy(kw["seed_ids"])
        kw["seed_dists"] = torch.from_numpy(kw["seed_dists"])
    kw.update(extra)
    return search_batch(
        st.vectors, st.graph, torch.from_numpy(s["q"]), k=K, ef=EF, space="l2",
        sq_norms=st.sq_norms, unified_table=st.unified,
        upper_tables=st.upper_tables, **kw,
    )


def _run_jax(s, mode):
    if mode not in s["jax"]:
        dg, x, sq, _, _, nbr_vec = s["jdev"]
        kw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
              for k, v in _kwargs(mode, s["seeds"]).items()}
        s["jax"][mode] = j_search(
            x, dg, jnp.asarray(s["q"]), k=K, ef=EF, space="l2", sq_norms=sq,
            **inline_search_kwargs(nbr_vec), interpret=True, **kw,
        )
    return s["jax"][mode]


def _recall(ids, gt):
    return np.mean([len(set(ids[i]) & set(gt[i])) / K for i in range(len(gt))])


@pytest.mark.parametrize("mode", list(MODES))
def test_search_batch_matches_jax(shared, mode):
    got = _run_port(shared, mode)
    want = _run_jax(shared, mode)
    gi, wi = got.ids.numpy(), np.asarray(want.ids)
    # summation order can flip near-ties; the graph and rows are identical
    assert np.mean(gi == wi) >= 0.99
    same = gi == wi
    np.testing.assert_allclose(got.dists.numpy()[same], np.asarray(want.dists)[same],
                               rtol=1e-5, atol=1e-4)
    assert abs(_recall(gi, shared["gt"]) - _recall(wi, shared["gt"])) <= 0.005
    if MODES[mode].get("collect_metrics"):
        np.testing.assert_array_equal(got.hops.numpy(), np.asarray(want.hops))
        np.testing.assert_array_equal(got.dist_comps.numpy(), np.asarray(want.dist_comps))
        np.testing.assert_array_equal(got.last_improve.numpy(),
                                      np.asarray(want.last_improve))


def test_gather_path_matches_jax(shared):
    """The plain row-gather hop (no unified table) against the JAX
    XLA-gather branch."""
    st = shared["st"]
    dg, x, sq, _, _, _ = shared["jdev"]
    got = search_batch(st.vectors, st.graph, torch.from_numpy(shared["q"]), k=K,
                       ef=EF, space="l2", sq_norms=st.sq_norms, expand=2)
    want = j_search(x, dg, jnp.asarray(shared["q"]), k=K, ef=EF, space="l2",
                    sq_norms=sq, expand=2)
    assert np.mean(got.ids.numpy() == np.asarray(want.ids)) >= 0.99


@pytest.mark.parametrize("mode", ["speed", "high_recall", "descent"])
def test_loop_cadence_changes_no_output(shared, mode):
    """Checking termination every 4 (or 7) iterations gives exactly the
    output of checking every iteration, metrics included, with and without
    a per-query mask and a patience stop."""
    rng = np.random.default_rng(5)
    mask = torch.from_numpy(rng.random((B, shared["st"].graph.n_pad)) < 0.7)
    for extra in ({}, {"eligible": mask, "stop_patience": 3}):
        runs = [_run_port(shared, mode, collect_metrics=True, check_every=c, **extra)
                for c in (1, 4, 7)]
        for r in runs[1:]:
            for a, b in zip(runs[0], r):
                assert torch.equal(a, b)


def test_frontier_rank_without_frontier_raises(shared):
    with pytest.raises(ValueError, match="frontier_rank"):
        _run_port(shared, "descent", frontier_rank=EF)
