"""Port parity, the serving tiers below bf16: HNSWIndex.search of
hnsw_tpu_torch on the int8 and int4 tiers against the JAX package's on the
same graph and tier (Pallas in interpret mode); the auto-rescore rule; the
exact l2u8 space; and l2u8 checkpoints across the two packages. bf16 vector
storage is in test_torch_storage.py (its JAX search compiles anew).

Each JAX search runs once per module: interpret mode costs seconds per
call."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import hnsw_tpu.core.graph as jgraph
from hnsw_tpu.models.hnsw import HNSWIndex as JIndex
from hnsw_tpu.models.hnsw import SearchParams as JParams

from hnsw_tpu_torch.convert import index_from_parts
from hnsw_tpu_torch.core import spaces as tspaces
from hnsw_tpu_torch.models.bruteforce import BruteforceIndex
from hnsw_tpu_torch.models.hnsw import HNSWIndex, SearchParams, auto_rescore
from hnsw_tpu_torch.native.hnsw_builder import NativeHNSWBuilder
from hnsw_tpu_torch.ops.gather_kernels import tier_bytes

N, D, M, EFC, B, K = 1500, 24, 8, 100, 16, 10
META = {"space": "l2", "dim": D, "m": M, "ef_construction": EFC}
SEEDED = dict(k=K, ef=32, entry_seeds=4)  # auto rescore on the lossy tiers
JAX_TIER_BYTES = {  # the JAX ladder's own count (lane width 128)
    "unified8": lambda n_pad, m0: n_pad * ((m0 * 128 // 512 + 1) * 512 + 128 + 4),
    "unified4": lambda n_pad, m0: n_pad * ((m0 * 128 // 1024 + 1) * 512 + 128 + 4),
}


@pytest.fixture(scope="module")
def shared():
    rng = np.random.default_rng(43)
    centers = rng.normal(size=(40, D)).astype(np.float32)
    x = centers[rng.integers(0, 40, N)] + 0.7 * rng.normal(size=(N, D)).astype(np.float32)
    q = x[rng.integers(0, N, B)] + 0.3 * rng.normal(size=(B, D)).astype(np.float32)
    b = NativeHNSWBuilder(D, "l2", M, EFC, seed=123)
    b.add_batch(x, np.arange(N), n_threads=1)
    o = BruteforceIndex(tspaces.L2Space(D), device="cpu")
    o.add_items(x, np.arange(N))
    _, gt = o.search_knn(q, K)
    parts = (b.export_graph(), b.export_vectors(), b.export_deleted())
    return {"x": x, "q": q, "parts": parts, "gt": gt, "jax": {}}


def _recall(lab, gt):
    return np.mean([len(set(lab[i]) & set(gt[i])) / K for i in range(len(gt))])


def tier_pair(parts, meta, tier, space_t=None, space_j=None):
    """Port and JAX indexes over one graph, each held to `tier` by a budget
    at that tier's own bytes; `space_t` / `space_j` replace the spaces (the
    way the reference's sweeps switch to bf16 storage)."""
    g, v, dl = parts
    t = index_from_parts(g, v, dl, dict(meta), device="cpu")
    jg = jgraph.HNSWGraph(g.level0, g.upper, g.upper_slot, g.node_level,
                          g.labels, g.entry_point, g.max_level)
    j = JIndex._from_parts(jg, v, dl, dict(meta))
    if space_t is not None:
        t.space, j.space = space_t, space_j
    n_pad, m0 = t._sync_device().graph.level0.shape
    t.rebuild_device_tables(tier_bytes(n_pad, m0, meta["dim"])[tier])
    j.inline_neighbors = True  # the CPU default is off
    j.unified_max_bytes = JAX_TIER_BYTES[tier](n_pad, m0)
    j._device = None
    return t, j


def _jax_search(s, tier):
    if tier not in s["jax"]:
        t, j = tier_pair(s["parts"], META, tier)
        jd, jl = j.search(s["q"], params=JParams(**SEEDED))
        assert j._device[5][0] == tier
        s["jax"][tier] = (t, jd, jl)
    return s["jax"][tier]


@pytest.mark.parametrize("tier", ["unified8", "unified4"])
def test_tier_search_matches_jax(shared, tier):
    t, jd, jl = _jax_search(shared, tier)
    td, tl = t.search(shared["q"], params=SearchParams(**SEEDED))
    assert t._device.tier == tier and t._device.vectors.dtype == torch.float32
    assert np.mean(tl == jl) >= 0.99
    same = tl == jl
    np.testing.assert_allclose(td[same], jd[same], rtol=1e-5, atol=1e-4)
    assert abs(_recall(tl, shared["gt"]) - _recall(jl, shared["gt"])) <= 0.005
    # the auto rescore returned exact f32 distances
    x, q = shared["x"].astype(np.float64), shared["q"].astype(np.float64)
    exact = ((x[tl] - q[:, None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(td, exact, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("tier,exact_i8,want", [
    ("unified", False, 0), ("unified", True, 0), (None, False, 0),
    ("unified8", False, 40), ("unified8", True, 0),
    ("unified4", False, 40), ("unified4", True, 40),
])
def test_auto_rescore_rule(tier, exact_i8, want):
    assert auto_rescore(tier, exact_i8, 10) == want


def test_auto_rescore_applies_on_int8(shared):
    t, _, _ = _jax_search(shared, "unified8")
    auto = t.search(shared["q"], params=SearchParams(**SEEDED))
    explicit = t.search(shared["q"], params=SearchParams(**SEEDED, rescore=4 * K))
    raw = t.search(shared["q"], params=SearchParams(**SEEDED, rescore=0))
    np.testing.assert_array_equal(auto[1], explicit[1])
    np.testing.assert_array_equal(auto[0], explicit[0])
    assert not np.array_equal(auto[0], raw[0])  # int8 distances are not exact


def _exact_u8(q, x, labels):
    qi, xi = q.astype(np.int64), x.astype(np.int64)
    return ((xi[labels] - qi[:, None, :]) ** 2).sum(-1)


@pytest.fixture(scope="module")
def u8_index():
    rng = np.random.default_rng(9)
    n, d = 1200, 32
    x = rng.integers(0, 256, size=(n, d)).astype(np.uint8)
    q = rng.integers(0, 256, size=(16, d)).astype(np.uint8)
    idx = HNSWIndex("l2u8", dim=d, m=8, ef_construction=60, device="cpu")
    idx._builder.add_batch(idx.space.preprocess(x), np.arange(n), n_threads=1)
    return idx, x, q


@pytest.mark.parametrize("tier", ["unified8", "unified"])
def test_l2u8_distances_bit_exact(u8_index, tier):
    """Both the lossless int8 tier (no rescore) and the bf16 tier serve the
    exact integer L2 distance of the uint8 data."""
    idx, x, q = u8_index
    n_pad, m0 = idx._sync_device().graph.level0.shape
    st = idx.rebuild_device_tables(tier_bytes(n_pad, m0, x.shape[1])[tier])
    assert st.tier == tier and idx.space.exact_i8
    if tier == "unified8":
        # lossless codes: every real neighbor's row is its uint8 vector - 128
        real = st.unified.payload.long() < len(x)
        codes = st.unified.codes[real][:, : x.shape[1]].numpy()
        np.testing.assert_array_equal(
            codes, x.astype(np.int64)[st.unified.payload[real].long().numpy()] - 128)
        assert bool((st.unified.scales == 1.0).all())
    d, lab = idx.search(q, params=SearchParams(k=K, ef=64, entry_seeds=4))
    assert (lab >= 0).all()
    np.testing.assert_array_equal(d.astype(np.float64), _exact_u8(q, x, lab))
    gt = np.argsort(((x.astype(np.int64)[None] - q.astype(np.int64)[:, None]) ** 2).sum(-1),
                    axis=1, kind="stable")
    kth = _exact_u8(q, x, gt[:, K - 1 : K])
    assert np.mean(_exact_u8(q, x, lab) <= kth) >= 0.9  # tie-aware recall


def test_l2u8_checkpoint_both_directions(u8_index, tmp_path):
    idx, x, q = u8_index
    port_path = str(tmp_path / "port.npz")
    idx.save(port_path)
    j = JIndex.load(port_path)
    assert j.space.persist_name == "l2u8" and j.space.exact_i8
    np.testing.assert_array_equal(j.get_items([5, 77]), x[[5, 77]].astype(np.float32))
    jax_path = str(tmp_path / "jax.npz")
    j.save(jax_path)
    t = HNSWIndex.load(jax_path, device="cpu")
    assert type(t.space) is tspaces.L2SpaceU8
    np.testing.assert_array_equal(t.get_items([5, 77]), x[[5, 77]].astype(np.float32))
    np.testing.assert_array_equal(t._builder.export_vectors(), idx._builder.export_vectors())
    d, lab = t.search(q[:4], k=K, ef=64)
    np.testing.assert_array_equal(d.astype(np.float64), _exact_u8(q[:4], x, lab))
