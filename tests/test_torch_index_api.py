"""Port parity, the rest of HNSWIndex's single-index API: calibrate_speed_mode
returns the JAX package's SearchParams, a frontier_rank without a frontier
stop is ignored as JAX ignores it, the gather-distance helpers and dist_one
compute JAX's distances, and the device_* accessors return the synced state.

Light by design: one serial build at N=2000, one thread, and each JAX result
once per module (its Pallas kernel runs in interpret mode; the calibration's
default probe and the explicit queries share one batch shape)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import hnsw_tpu.core.graph as jgraph
from hnsw_tpu.models.hnsw import HNSWIndex as JIndex
from hnsw_tpu.models.hnsw import SearchParams as JParams
from hnsw_tpu.ops import distance as jdist

from hnsw_tpu_torch.models.hnsw import HNSWIndex, SearchParams
from hnsw_tpu_torch.native.hnsw_builder import NativeHNSWBuilder
from hnsw_tpu_torch.ops import distance as tdist
from hnsw_tpu_torch.ops.gather_kernels import COUNTS

N, D, M, EFC, B, K, EF = 2000, 16, 8, 60, 16, 10, 40
PROBE = 2000  # the default probe's size here: min(sample=2048, N)
META = {"space": "l2", "dim": D, "m": M, "ef_construction": EFC}


@pytest.fixture(scope="module")
def shared():
    rng = np.random.default_rng(53)
    centers = rng.normal(size=(64, D)).astype(np.float32)
    x = centers[rng.integers(0, 64, N)] + 0.5 * rng.normal(size=(N, D)).astype(np.float32)
    q = x[rng.integers(0, N, PROBE)] + 0.05 * rng.normal(size=(PROBE, D)).astype(np.float32)
    b = NativeHNSWBuilder(D, "l2", M, EFC, seed=123)
    b.add_batch(x, np.arange(N), n_threads=1)
    g, v, dl = b.export_graph(), b.export_vectors(), b.export_deleted()
    jg = jgraph.HNSWGraph(g.level0, g.upper, g.upper_slot, g.node_level,
                          g.labels, g.entry_point, g.max_level)
    j = JIndex._from_parts(jg, v, dl, META)
    j.inline_neighbors = True  # the CPU default is off; serve the unified tier
    j._device = None
    return {"x": x, "q": q, "parts": (g, v, dl), "j": j, "jax": {}}


def _port(s):
    return HNSWIndex._from_parts(*s["parts"], META, device="cpu")


def _params(p) -> dict:
    """SearchParams as a dict of the fields both packages share."""
    return {f: getattr(p, f) for f in (
        "k", "ef", "expand", "max_iters", "collect_metrics", "stop_patience",
        "stop_frontier", "frontier_rank", "rescore", "stop_fn", "entry_seeds",
        "seed_pool")}


@pytest.mark.parametrize("entry_seeds", [0, 4])
@pytest.mark.parametrize("probe", ["default", "explicit"])
def test_calibrate_speed_mode_matches_jax(shared, probe, entry_seeds):
    kw = {"k": K, "ef": EF, "entry_seeds": entry_seeds}
    if probe == "explicit":
        kw["queries"] = shared["q"]
    key = (probe, entry_seeds)
    if key not in shared["jax"]:
        shared["jax"][key] = shared["j"].calibrate_speed_mode(**kw)
    want = shared["jax"][key]
    t = _port(shared)
    got = t.calibrate_speed_mode(**kw)
    assert got is t.speed_params
    assert 0 < got.max_iters < 2 * EF + 16
    assert _params(got) == _params(want)


def test_frontier_rank_without_stop_is_ignored_as_jax(shared):
    """SearchParams(frontier_rank=R) without stop_frontier: JAX ignores the
    rank, and so does the port's HNSWIndex.search (search_batch raises)."""
    q = shared["q"][:B]
    if "rank" not in shared["jax"]:
        shared["jax"]["rank"] = shared["j"].search(q, params=JParams(k=K, ef=EF,
                                                                     frontier_rank=EF))
    jd, jl = shared["jax"]["rank"]
    t = _port(shared)
    td, tl = t.search(q, params=SearchParams(k=K, ef=EF, frontier_rank=EF))
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=0)
    dd, dl = t.search(q, k=K, ef=EF)
    np.testing.assert_array_equal(tl, dl)
    np.testing.assert_array_equal(td, dd)


@pytest.mark.parametrize("space", ["l2", "ip"])
def test_gather_helpers_match_jax(shared, space):
    rng = np.random.default_rng(7)
    x = shared["x"][:300]
    q = shared["q"][:B]
    ids = rng.integers(0, len(x), size=(B, 24)).astype(np.int32)
    sq = (x.astype(np.float32) ** 2).sum(-1)
    tx, tq, tids, tsq = (torch.from_numpy(a) for a in (x, q, ids, sq))
    jx, jq, jids, jsq = (jnp.asarray(a) for a in (x, q, ids, sq))
    tol = {"rtol": 1e-6, "atol": 0}
    if space == "l2":
        for norms in (None, True):
            got = tdist.gather_l2_sq(tq, tx, tids, x_sq_norms=tsq if norms else None)
            want = jdist.gather_l2_sq(jq, jx, jids, x_sq_norms=jsq if norms else None)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    else:
        # 1 - <q, x> cancels near 0, where 1e-6 of the distance is below the
        # rounding of the sum (JAX contracts by a matmul, the port by a
        # product and a sum): the error is held to 1e-6 of sum |q_i x_i|
        _assert_ip_close(tdist.gather_ip_dist(tq, tx, tids),
                         jdist.gather_ip_dist(jq, jx, jids), q[:, None] * x[ids])
    got = tdist.gather_dist(tq, tx, tids, space, x_sq_norms=tsq)
    want = jdist.gather_dist(jq, jx, jids, space, x_sq_norms=jsq)
    if space == "l2":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    else:
        _assert_ip_close(got, want, q[:, None] * x[ids])
    for i in range(4):
        a, b = x[i], q[i]
        got = tdist.dist_one(torch.from_numpy(a), torch.from_numpy(b), space)
        want = jdist.dist_one(jnp.asarray(a), jnp.asarray(b), space)
        assert got.dim() == 0
        if space == "l2":
            np.testing.assert_allclose(float(got), float(want), **tol)
        else:
            _assert_ip_close(got, want, a * b)
    with pytest.raises(ValueError, match="unknown space"):
        tdist.gather_dist(tq, tx, tids, "cosine")


def _assert_ip_close(got, want, products):
    scale = np.abs(products).sum(-1)
    err = np.abs(np.asarray(got, dtype=np.float64) - np.asarray(want, dtype=np.float64))
    assert (err <= 1e-6 * scale).all(), float((err / scale).max())


def test_device_accessors_return_the_synced_state(shared):
    t = _port(shared)
    g = t.device_graph  # the first access syncs
    st = t._device
    assert t._last_sync_mode == "full"
    assert g is st.graph and t.device_vectors is st.vectors
    assert t.device_sq_norms is st.sq_norms and st.sq_norms is not None
    assert t._last_sync_mode == "clean"
    np.testing.assert_array_equal(t.device_vectors[:N].numpy(), shared["parts"][1])
    torch.testing.assert_close(t.device_sq_norms[:N], (t.device_vectors[:N] ** 2).sum(-1))
    assert g.level0.shape[0] == g.n_pad and not t.device_vectors.is_cuda


# ---------------------------------------------------------------------------
# On the card (cuda marker).
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_calibrate_speed_mode_on_cuda_matches_cpu(shared):
    """On the card the calibration probe runs the bf16 hop kernel and picks
    the CPU's max_iters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    want = _port(shared).calibrate_speed_mode(k=K, ef=EF, entry_seeds=4)
    t = HNSWIndex._from_parts(*shared["parts"], META, device="cuda")
    COUNTS.reset()
    got = t.calibrate_speed_mode(k=K, ef=EF, entry_seeds=4)
    assert COUNTS.hop_dist_unified > 0 and COUNTS.plain_on_cuda == 0
    assert t.device_vectors.is_cuda and t._device.tier == "unified"
    assert _params(got) == _params(want)
