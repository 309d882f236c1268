"""Port parity, the split tier (the bulk-build waves' table): the plain
version of the hop_dist_inline kernel against the JAX package's
hop_dist_inline + extract_level0_ids (Pallas in interpret mode), the split
table and the ladder's split rung against JAX's, and search_batch on the
split tier. The CUDA kernel itself runs only on a card (`cuda` marker)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import hnsw_tpu.core.graph as jgraph
from hnsw_tpu.models.hnsw import HNSWIndex as JIndex
from hnsw_tpu.models.hnsw import inline_search_kwargs as j_inline_kwargs
from hnsw_tpu.ops import pallas_gather as jpg
from hnsw_tpu.ops.traversal import search_batch as j_search

from hnsw_tpu_torch.convert import index_from_parts, split_from_jax
from hnsw_tpu_torch.core import graph as tgraph
from hnsw_tpu_torch.models.hnsw import inline_search_kwargs
from hnsw_tpu_torch.native.hnsw_builder import NativeHNSWBuilder
from hnsw_tpu_torch.ops import gather_kernels as gk
from hnsw_tpu_torch.ops.traversal import search_batch

N, D, M, EFC, B, K, EF = 1200, 32, 8, 80, 16, 10, 40
META = {"space": "l2", "dim": D, "m": M, "ef_construction": EFC}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


def _jax_bits(a) -> np.ndarray:
    """bf16 jax array -> its bits as int16 (numpy has no bf16)."""
    return np.asarray(a.view(jnp.int16))


def _random_case(d, m0, seed, n=300, b=16, e=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    level0 = rng.integers(0, n, size=(n, m0)).astype(np.int32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    chosen = rng.integers(0, n, size=(b, e)).astype(np.int32)
    return x, level0, q, chosen


@pytest.mark.parametrize("space,e,m0,d", [
    ("l2", 1, 16, 128), ("l2", 2, 32, 128), ("ip", 2, 16, 128), ("ip", 1, 32, 96),
    ("l2", 2, 16, 96), ("l2", 1, 32, 96), ("ip", 2, 32, 128), ("ip", 1, 16, 96),
])
def test_hop_inline_plain_matches_jax_interpret(space, e, m0, d):
    x, level0, q, chosen = _random_case(d, m0, seed=m0 + d + e, e=e)
    nbr = gk.make_inline_neighbors(torch.from_numpy(x), torch.from_numpy(level0))
    got_d, got_i = gk.hop_dist_inline(
        torch.from_numpy(q), nbr, torch.from_numpy(level0), torch.from_numpy(chosen), space
    )
    j_nbr = jpg.make_inline_neighbors(jnp.asarray(x), jnp.asarray(level0))
    j_tiles = jpg.make_level0_tiles(jnp.asarray(level0))
    want_d, id_tiles = jpg.hop_dist_inline(
        jnp.asarray(q), j_nbr, j_tiles, jnp.asarray(chosen), m0, space, interpret=True
    )
    want_i = jpg.extract_level0_ids(id_tiles, jnp.asarray(chosen), m0)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    # the same f32 operations on the same bf16 values, summed in another order
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("space,e,d", [("l2", 2, 128), ("ip", 1, 96)])
def test_hop_inline_plain_wide_m0_matches_row_gathers(space, e, d):
    """m0 = 64 (M=32), past the JAX kernel's id tile: the split hop against
    the distances of the neighbors' own bf16-rounded rows, in numpy."""
    m0 = 64
    x, level0, q, chosen = _random_case(d, m0, seed=d + e, e=e)
    nbr = gk.make_inline_neighbors(torch.from_numpy(x), torch.from_numpy(level0))
    got_d, got_i = gk.hop_dist_inline(
        torch.from_numpy(q), nbr, torch.from_numpy(level0), torch.from_numpy(chosen), space
    )
    want_i = level0[chosen].reshape(len(q), e * m0)
    rows = torch.from_numpy(x).bfloat16().float().numpy()[want_i]  # [B, E*m0, d]
    if space == "ip":
        want_d = 1.0 - (rows * q[:, None, :]).sum(-1)
    else:
        want_d = ((rows - q[:, None, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("d,m0", [(40, 16), (128, 32), (96, 32)])
def test_split_tables_bit_equal_to_jax(d, m0):
    x, level0, _, _ = _random_case(d, m0, seed=d, n=333)
    t = gk.make_inline_neighbors_chunked(torch.from_numpy(x), torch.from_numpy(level0), chunk=70)
    one_shot = gk.make_inline_neighbors(torch.from_numpy(x), torch.from_numpy(level0))
    assert torch.equal(t, one_shot)
    j_nbr = jpg.make_inline_neighbors_chunked(jnp.asarray(x), jnp.asarray(level0), chunk=128)
    j_tiles = jpg.make_level0_tiles(jnp.asarray(level0))
    w_nbr, w_l0 = split_from_jax(_jax_bits(j_nbr), np.asarray(j_tiles), m0, d)
    assert t.shape == w_nbr.shape == (333, m0, tgraph.round_up(d, 8))
    np.testing.assert_array_equal(_bits(t), _bits(w_nbr))
    np.testing.assert_array_equal(w_l0.numpy(), level0)
    # the lanes the port drops hold nothing
    assert not _jax_bits(j_nbr)[:, :, d:].any()


@pytest.fixture(scope="module")
def shared():
    rng = np.random.default_rng(51)
    centers = rng.normal(size=(48, D)).astype(np.float32)
    x = centers[rng.integers(0, 48, N)] + 0.5 * rng.normal(size=(N, D)).astype(np.float32)
    q = x[rng.integers(0, N, B)] + 0.05 * rng.normal(size=(B, D)).astype(np.float32)
    b = NativeHNSWBuilder(D, "l2", M, EFC, seed=123)
    b.add_batch(x, np.arange(N), n_threads=1)
    g, v, dl = b.export_graph(), b.export_vectors(), b.export_deleted()
    assert g.max_level > 0
    t = index_from_parts(g, v, dl, dict(META), device="cpu")
    t.unified_max_bytes = 0  # below every unified rung: the split tier
    jg = jgraph.HNSWGraph(g.level0, g.upper, g.upper_slot, g.node_level,
                          g.labels, g.entry_point, g.max_level)
    j = JIndex._from_parts(jg, v, dl, dict(META))
    j.inline_neighbors = True  # the CPU default is off
    j.unified_max_bytes = 0
    j._device = None
    return {"q": q, "t": t, "st": t._sync_device(), "jdev": j._sync_device()}


def test_ladder_picks_split_where_jax_does(shared):
    st, jdev = shared["st"], shared["jdev"]
    assert st.tier == "split" == jdev[5][0]
    assert st.unified is None and st.upper_tables is None and st.codes is None
    assert set(inline_search_kwargs(st)) == {"nbr_vectors"}
    # one table: the ids are the graph's own level0
    n_pad, m0 = st.graph.level0.shape
    assert st.nbr_vectors.shape == (n_pad, m0, D) and st.nbr_vectors.dtype == torch.bfloat16
    assert st.nbr_vectors.nbytes == gk.tier_bytes(n_pad, m0, D)["split"]
    w_nbr, w_l0 = split_from_jax(_jax_bits(jdev[5][1]), np.asarray(jdev[5][2]), m0, D)
    np.testing.assert_array_equal(_bits(st.nbr_vectors), _bits(w_nbr))
    np.testing.assert_array_equal(st.graph.level0.numpy(), w_l0.numpy())
    # the rung is taken only under its own budget, after int4. JAX's id tile
    # needs m0 <= 32; the kernel here reads level0 itself, at any m0
    need = gk.tier_bytes(n_pad, m0, D)
    assert gk.pick_tier(n_pad, m0, D, need["unified4"] - 1, None) == "split"
    assert gk.pick_tier(n_pad, m0, D, need["unified4"], 0) == "unified4"
    assert gk.pick_tier(n_pad, m0, D, 0, need["split"]) == "split"
    assert gk.pick_tier(n_pad, m0, D, 0, need["split"] - 1) is None
    assert gk.pick_tier(n_pad, 64, D, 0, None) == "split"
    wide = gk.tier_bytes(n_pad, 64, D)
    assert gk.pick_tier(n_pad, 64, D, 0, wide["split"] - 1) is None
    assert jpg.build_inline_tables(jdev[1], jdev[0], D, 0, need["split"] - 1) is None


@pytest.mark.parametrize("mode", ["descent", "seeded_expand2"])
def test_split_search_matches_jax(shared, mode):
    st = shared["st"]
    dg, x, sq, _, _, nbr_vec = shared["jdev"]
    kw, jkw = {}, {}
    if mode == "seeded_expand2":
        rng = np.random.default_rng(3)
        seeds = np.stack([rng.choice(N, 4, replace=False) for _ in range(B)]).astype(np.int32)
        sd = ((st.vectors.numpy()[seeds] - shared["q"][:, None, :]) ** 2).sum(-1)
        order = np.argsort(sd, axis=1, kind="stable")
        seeds, sd = np.take_along_axis(seeds, order, 1), np.take_along_axis(sd, order, 1)
        kw = dict(expand=2, seed_ids=torch.from_numpy(seeds), seed_dists=torch.from_numpy(sd))
        jkw = dict(expand=2, seed_ids=jnp.asarray(seeds), seed_dists=jnp.asarray(sd))
    got = search_batch(st.vectors, st.graph, torch.from_numpy(shared["q"]), k=K, ef=EF,
                       space="l2", sq_norms=st.sq_norms, **inline_search_kwargs(st), **kw)
    want = j_search(x, dg, jnp.asarray(shared["q"]), k=K, ef=EF, space="l2", sq_norms=sq,
                    **j_inline_kwargs(nbr_vec), interpret=True, **jkw)
    gi, wi = got.ids.numpy(), np.asarray(want.ids)
    # summation order can flip near-ties; the graph and rows are identical
    assert np.mean(gi == wi) >= 0.99
    same = gi == wi
    np.testing.assert_allclose(got.dists.numpy()[same], np.asarray(want.dists)[same],
                               rtol=1e-5, atol=1e-4)


def test_index_search_on_split_tier(shared):
    """HNSWIndex.search serves the split tier (no auto rescore: bf16 rows)."""
    t = shared["t"]
    d, lab = t.search(shared["q"], k=K, ef=EF)
    assert t._device.tier == "split" and (lab >= 0).all() and np.isfinite(d).all()
    unified = index_from_parts(t._builder.export_graph(), t._builder.export_vectors(),
                               t._builder.export_deleted(), dict(META), device="cpu")
    d_u, lab_u = unified.search(shared["q"], k=K, ef=EF)
    assert unified._device.tier == "unified"
    # the same bf16 rows at level 0; the descents differ (row gathers of f32
    # vectors here, bf16 upper tables there), so a beam may end elsewhere
    overlap = np.mean([len(set(lab[i]) & set(lab_u[i])) / K for i in range(B)])
    assert overlap >= 0.98


def test_hop_inline_checks_inputs():
    nbr = torch.zeros((4, 16, 8), dtype=torch.bfloat16)
    level0 = torch.zeros((4, 16), dtype=torch.int32)
    q = torch.zeros((2, 8))
    chosen = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(TypeError, match="bf16 nbr_vectors"):
        gk.hop_dist_inline(q, nbr.float(), level0, chosen)
    with pytest.raises(TypeError, match="bf16 nbr_vectors"):
        gk.hop_dist_inline(q, nbr, level0.long(), chosen)
    with pytest.raises(TypeError, match="f32 queries"):
        gk.hop_dist_inline(q, nbr, level0, chosen.long())
    with pytest.raises(TypeError, match="f32 queries"):
        gk.hop_dist_inline(q.double(), nbr, level0, chosen)
    with pytest.raises(ValueError, match="query width"):
        gk.hop_dist_inline(torch.zeros((2, 9)), nbr, level0, chosen)
    with pytest.raises(ValueError, match="bad shapes nbr_vectors"):
        gk.hop_dist_inline(q, nbr, level0[:, :8], chosen)
    with pytest.raises(ValueError, match="bad shapes q"):
        gk.hop_dist_inline(q, nbr, level0, chosen[:1])
    with pytest.raises(ValueError, match="unknown space"):
        gk.hop_dist_inline(q, nbr, level0, chosen, "hamming")
    gk.COUNTS.reset()
    d, ids = gk.hop_dist_inline(q, nbr, level0, chosen)
    assert d.shape == ids.shape == (2, 16)
    # CPU tensors: the plain version, no launch
    assert dataclasses.astuple(gk.COUNTS) == (0,) * len(dataclasses.fields(gk.COUNTS))


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("space,e,m0,d", [
    ("l2", 2, 32, 128), ("ip", 1, 16, 96), ("l2", 1, 32, 96), ("ip", 2, 32, 128),
    ("l2", 2, 64, 128), ("ip", 1, 64, 96),
])
def test_hop_inline_kernel_matches_plain_on_cuda(cuda_device, space, e, m0, d):
    x, level0, q, chosen = _random_case(d, m0, seed=1, n=500, b=64, e=e)
    x, level0, q, chosen = (torch.from_numpy(a).to(cuda_device) for a in (x, level0, q, chosen))
    nbr = gk.make_inline_neighbors(x, level0)
    gk.COUNTS.reset()
    dk, ik = gk.hop_dist_inline(q, nbr, level0, chosen, space)
    assert gk.COUNTS.hop_dist_inline == 1 and gk.COUNTS.plain_on_cuda == 0
    dp, ip_ = gk.hop_dist_inline_plain(q, nbr, level0, chosen, space)
    torch.cuda.synchronize()
    assert torch.equal(ik, ip_)
    torch.testing.assert_close(dk, dp, rtol=1e-5, atol=1e-4)
