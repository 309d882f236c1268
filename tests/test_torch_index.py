"""Port parity, the user-facing index: hnsw_tpu_torch's HNSWIndex.search
against the JAX package's on one shared graph with a shared filter, a
deleted label and an exact rescore of 40, plus the index's own surface
(per-query filters, delete marks, the gather path, the table budget)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import hnsw_tpu.core.graph as jgraph
from hnsw_tpu.models.hnsw import HNSWIndex as JIndex
from hnsw_tpu.models.hnsw import SearchParams as JParams

from hnsw_tpu_torch.convert import index_from_parts
from hnsw_tpu_torch.core.spaces import L2Space
from hnsw_tpu_torch.models.bruteforce import BruteforceIndex
from hnsw_tpu_torch.models.hnsw import HNSWIndex, SearchParams
from hnsw_tpu_torch.native.hnsw_builder import NativeHNSWBuilder

N, D, M, EFC, B, K = 1500, 24, 8, 100, 16, 10
LABELS = np.arange(N, dtype=np.int64) * 2 + 5
META = {"space": "l2", "dim": D, "m": M, "ef_construction": EFC}
RESCORE = dict(k=K, ef=48, entry_seeds=4, rescore=40)


@pytest.fixture(scope="module")
def shared():
    rng = np.random.default_rng(41)
    centers = rng.normal(size=(40, D)).astype(np.float32)
    x = centers[rng.integers(0, 40, N)] + 0.5 * rng.normal(size=(N, D)).astype(np.float32)
    q = x[rng.integers(0, N, B)] + 0.05 * rng.normal(size=(B, D)).astype(np.float32)
    b = NativeHNSWBuilder(D, "l2", M, EFC, seed=123)
    b.add_batch(x, LABELS, n_threads=1)
    parts = (b.export_graph(), b.export_vectors(), b.export_deleted())
    allow = np.zeros(LABELS.max() + 1, bool)
    allow[LABELS[rng.random(N) < 0.6]] = True
    # delete the best match of query 0, so the deletion shows in the results
    nearest = LABELS[np.argmin(((x - q[0]) ** 2).sum(-1))]
    allow[nearest] = True
    return {"x": x, "q": q, "parts": parts, "allow": allow, "deleted": int(nearest)}


def _port(s):
    return index_from_parts(*s["parts"], dict(META), device="cpu")


def _oracle(s, allow):
    o = BruteforceIndex(L2Space(D), device="cpu")
    o.add_items(s["x"], LABELS)
    return o.search_knn(s["q"], K, filter_labels=allow)


def _recall(lab, gt):
    return np.mean([len(set(lab[i]) & set(gt[i])) / K for i in range(len(gt))])


def test_index_search_matches_jax_filter_deleted_rescore(shared):
    g, v, dl = shared["parts"]
    t = _port(shared)
    t.mark_deleted(shared["deleted"])
    jg = jgraph.HNSWGraph(g.level0, g.upper, g.upper_slot, g.node_level,
                          g.labels, g.entry_point, g.max_level)
    j = JIndex._from_parts(jg, v, dl, dict(META))
    j.inline_neighbors = True  # the CPU default is off; serve the unified tier
    j._device = None
    j.mark_deleted(shared["deleted"])

    td, tl = t.search(shared["q"], filter_labels=shared["allow"],
                      params=SearchParams(**RESCORE))
    jd, jl = j.search(shared["q"], filter_labels=shared["allow"],
                      params=JParams(**RESCORE))
    assert j._device[5][0] == "unified"
    assert np.mean(tl == jl) >= 0.99
    same = tl == jl
    np.testing.assert_allclose(td[same], jd[same], rtol=1e-5, atol=1e-4)

    allow = shared["allow"].copy()
    allow[shared["deleted"]] = False
    _, gt = _oracle(shared, allow)
    assert abs(_recall(tl, gt) - _recall(jl, gt)) <= 0.005
    assert shared["deleted"] not in tl
    assert np.all(allow[tl[tl >= 0]])


def test_per_query_filter_rows_equal_shared_filter(shared):
    t = _port(shared)
    shared_res = t.search(shared["q"], k=K, ef=48, filter_labels=shared["allow"])
    rows = np.broadcast_to(shared["allow"], (B, shared["allow"].shape[0]))
    per_query = t.search(shared["q"], k=K, ef=48, filter_labels=rows)
    np.testing.assert_array_equal(per_query[1], shared_res[1])
    np.testing.assert_array_equal(per_query[0], shared_res[0])


def test_delete_and_unmark(shared):
    t = _port(shared)
    _, before = t.search(shared["q"][:1], k=K, ef=48)
    assert before[0, 0] == shared["deleted"]
    t.mark_deleted(shared["deleted"])
    _, during = t.search(shared["q"][:1], k=K, ef=48)
    assert shared["deleted"] not in during
    t.unmark_deleted(shared["deleted"])
    _, after = t.search(shared["q"][:1], k=K, ef=48)
    np.testing.assert_array_equal(after, before)


def test_gather_path_and_search_cpu_agree_with_oracle(shared):
    _, gt = _oracle(shared, None)
    unified = _port(shared)
    gather = _port(shared)
    gather.inline_neighbors = False
    _, lu = unified.search(shared["q"], k=K, ef=64)
    _, lg = gather.search(shared["q"], k=K, ef=64)
    assert gather._device.unified is None and unified._device.unified is not None
    _, lc, _ = unified.search_cpu(shared["q"], k=K, ef=64)
    for lab in (lu, lg):
        assert _recall(lab, gt) >= _recall(lc, gt) - 0.01


def test_unified_budget_raises(shared):
    """Below the int4 rung the split tier serves, under its own budget; below
    that the sync raises, it never falls back silently."""
    t = _port(shared)
    t.unified_max_bytes = 1024
    _, lab = t.search(shared["q"][:2], k=K)
    assert t._device.tier == "split" and t._device.unified is None
    assert t._device.nbr_vectors is not None and (lab >= 0).all()
    t.split_max_bytes = 1024
    t._device = None
    with pytest.raises(MemoryError, match="no tier fits.*split budget 1024.*inline_neighbors"):
        t.search(shared["q"][:2], k=K)
    t.inline_neighbors = False  # the caller's explicit choice: plain gathers
    _, lab = t.search(shared["q"][:2], k=K)
    assert t._device.tier is None and t._device.unified is None
    assert (lab >= 0).all()


def test_add_point_builds_and_searches():
    """Serial inserts (add_point), search, then more inserts: the dirty
    index resyncs (past its padded capacity, in full)."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(300, 8)).astype(np.float32)
    idx = HNSWIndex("cosine", dim=8, m=4, ef_construction=40, device="cpu")
    for i in range(200):
        idx.add_point(x[i], i)
    assert idx.num_elements == 200
    unit = x / np.linalg.norm(x, axis=1, keepdims=True)
    np.testing.assert_allclose(idx.get_items([150]), unit[150:151], rtol=1e-6)
    d, lab = idx.search(x[:4], k=3, ef=32)
    assert lab.shape == (4, 3) and np.all(np.isfinite(d))
    np.testing.assert_array_equal(lab[:, 0], np.arange(4))
    for i in range(200, 300):
        idx.add_point(x[i], i)
    assert idx.search(x[250:251], k=1, ef=32)[1][0, 0] == 250


def test_device_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        HNSWIndex("l2", dim=4)
