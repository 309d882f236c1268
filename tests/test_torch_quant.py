"""Port parity, the quantized tiers' pieces: the int8, exact-int8 and int4
quantizers, the int8 and int4 node-block tables, the plain versions of the
int8 and int4 hop kernels and of the bf16 gather kernel against the JAX
package (Pallas in interpret mode), and the tier ladder. The CUDA kernels
themselves run only on a card (`cuda` marker)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import hnsw_tpu.core.graph as jgraph
from hnsw_tpu.ops import pallas_gather as jpg

from hnsw_tpu_torch.convert import unified4_from_jax_rows, unified8_from_jax_rows
from hnsw_tpu_torch.core import graph as tgraph
from hnsw_tpu_torch.native.hnsw_builder import NativeHNSWBuilder
from hnsw_tpu_torch.ops import gather_kernels as gk

TIERS = {  # tier -> (port table builder, JAX table builder, JAX hop flag, decoder)
    "int8": (gk.make_unified8_table_chunked, jpg.make_unified8_table_chunked,
             {"int8": True}, unified8_from_jax_rows),
    "int4": (gk.make_unified4_table_chunked, jpg.make_unified4_table_chunked,
             {"int4": True}, unified4_from_jax_rows),
}


def _tables(tier, d, m0, seed=0, n=300):
    """The same random vectors and adjacency through both packages' table
    builders (one zero vector, to cover the scale-1 rule); the JAX builder
    also returns its side tables."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[3] = 0.0
    level0 = rng.integers(0, n, size=(n, m0)).astype(np.int32)
    make_t, make_j, _, _ = TIERS[tier]
    t = make_t(torch.from_numpy(x), torch.from_numpy(level0), chunk=70)
    j = make_j(jnp.asarray(x), jnp.asarray(level0), chunk=128)
    return x, t, j


@pytest.mark.parametrize("which", ["int8", "exact_i8", "int4"])
def test_quantizers_match_jax(which):
    rng = np.random.default_rng(5)
    x = (3.0 * rng.normal(size=(64, 40))).astype(np.float32)
    x[7] = 0.0
    if which == "exact_i8":
        x = np.clip(np.rint(x * 30), -128, 127).astype(np.float32)
    tq = getattr(gk, f"quantize_{which}")
    jq = getattr(jpg, f"quantize_{which}")
    tc, ts = tq(torch.from_numpy(x))
    jc, js = jq(jnp.asarray(x))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy().view(np.int32), np.asarray(js).view(np.int32))


@pytest.mark.parametrize("tier,d,m0", [("int8", 40, 16), ("int4", 40, 16), ("int4", 128, 32)])
def test_quant_tables_equal_jax_rows(tier, d, m0):
    _, t, (j, j_codes, _) = _tables(tier, d, m0)
    want = TIERS[tier][3](np.asarray(j), m0, d)
    assert type(t) is type(want) and t.d_pad == want.d_pad == tgraph.round_up(d, 8)
    for f in ("codes", "scales", "payload"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), getattr(want, f).numpy(), err_msg=f)
    if tier == "int4":
        # the JAX side table's codes (lanes padded to 128) survive the
        # port's two-per-byte packing
        codes = torch.from_numpy(np.asarray(j_codes)[:, : t.d_pad].copy())
        assert torch.equal(gk.unpack_int4(gk.pack_int4(codes)), codes)


@pytest.mark.parametrize("tier", ["int8", "int4"])
@pytest.mark.parametrize("space,e,m0,d", [("l2", 2, 16, 40), ("ip", 2, 16, 40), ("l2", 1, 32, 128),
                                          # d=104: an int4 row of 52 bytes; m0=64: M=32
                                          ("l2", 1, 16, 104), ("ip", 2, 64, 128)])
def test_quant_hop_plain_matches_jax_interpret(tier, space, e, m0, d):
    x, table, (jtab, _, _) = _tables(tier, d, m0, seed=m0 + d)
    rng = np.random.default_rng(d)
    q = rng.normal(size=(16, d)).astype(np.float32)
    chosen = rng.integers(0, x.shape[0], size=(16, e)).astype(np.int32)
    flag = TIERS[tier][2]
    got_d, got_i = gk.hop_dist_unified(torch.from_numpy(q), table, torch.from_numpy(chosen),
                                       space)
    want_d, want_i = jpg.hop_dist_unified(jnp.asarray(q), jtab, jnp.asarray(chosen), m0, space,
                                          interpret=True, **flag)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("space", ["l2", "ip"])
def test_bf16_gather_plain_matches_jax_interpret(space):
    rng = np.random.default_rng(8)
    n, d, b, k = 401, 40, 8, 12  # odd n: the JAX pair path pads a row
    x = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    ids = rng.integers(0, n, size=(b, k)).astype(np.int32)
    got = gk.gather_dist_rows(torch.from_numpy(q), torch.from_numpy(x).to(torch.bfloat16),
                              torch.from_numpy(ids), space).numpy()
    want = np.asarray(jpg.gather_dist_pallas(
        jnp.asarray(q), jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(ids), space=space,
        interpret=True,
    ))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("b,k,d,space", [(1, 160, 104, "l2"), (8, 12, 104, "ip")])
def test_bf16_gather_plain_matches_jax_interpret_shapes(b, k, d, space):
    """K=160 (four of the CUDA kernel's 40-row batches) and d=104 (rows of
    208 bytes) against JAX; one query at K=160, as interpret mode takes
    ~0.07 s a row."""
    rng = np.random.default_rng(k + d)
    n = 401
    x = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    ids = rng.integers(0, n, size=(b, k)).astype(np.int32)
    got = gk.gather_dist_rows(torch.from_numpy(q), torch.from_numpy(x).to(torch.bfloat16),
                              torch.from_numpy(ids), space).numpy()
    want = np.asarray(jpg.gather_dist_pallas(
        jnp.asarray(q), jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(ids), space=space,
        tb=min(b, 8), interpret=True,
    ))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_tier_ladder_picks_each_rung():
    rng = np.random.default_rng(12)
    n, d = 700, 24
    x = rng.normal(size=(n, d)).astype(np.float32)
    b = NativeHNSWBuilder(d, "l2", 8, 40, seed=3)
    b.add_batch(x, np.arange(n), n_threads=1)
    dg = tgraph.graph_device_arrays(b.export_graph())
    xp = torch.from_numpy(tgraph.pad_vectors(x, dg.n_pad))
    need = gk.tier_bytes(dg.n_pad, dg.level0.shape[1], d)
    assert need["unified"] > need["unified8"] > need["unified4"]
    kinds = {"unified": gk.UnifiedTable, "unified8": gk.Unified8Table,
             "unified4": gk.Unified4Table}
    for tier in ("unified", "unified8", "unified4"):
        tabs = gk.build_inline_tables(xp, dg, d, need[tier])
        assert tabs.tier == tier and type(tabs.table) is kinds[tier]
        assert len(tabs.upper_tables) == dg.max_level > 0
        assert all(type(t) is gk.UnifiedTable for t, _ in tabs.upper_tables)
        # the budget counts the [n_pad, d_pad] codes and [n_pad] scales side
        # tables of the quantized tiers, which the row-delta sync reads
        if tier == "unified":
            assert tabs.codes is None and tabs.scales is None
            assert tabs.table.nbytes == need[tier]
        else:
            assert tabs.codes.shape == (dg.n_pad, tgraph.round_up(d, 8))
            assert tabs.codes.dtype == torch.int8 and tabs.scales.shape == (dg.n_pad,)
            assert tabs.table.nbytes + tabs.codes.nbytes + tabs.scales.nbytes == need[tier]
            serve_only = gk.build_inline_tables(xp, dg, d, need[tier], keep_delta_tables=False)
            assert serve_only.tier == tier and serve_only.codes is None
            assert torch.equal(serve_only.table.codes, tabs.table.codes)
    assert gk.build_inline_tables(xp, dg, d, None).tier == "unified"
    assert gk.build_inline_tables(xp, dg, d, None, upper_inline=False).upper_tables == ()
    # below int4: the split rung, one bf16 table under its own budget, with
    # no descent tables; below that MemoryError
    tabs = gk.build_inline_tables(xp, dg, d, need["unified4"] - 1)
    assert tabs.tier == "split" and tabs.upper_tables == () and tabs.codes is None
    assert tabs.table.dtype == torch.bfloat16 and tabs.table.nbytes == need["split"]
    assert gk.build_inline_tables(xp, dg, d, 0, need["split"]).tier == "split"
    with pytest.raises(MemoryError, match="no tier fits.*inline_neighbors=False"):
        gk.build_inline_tables(xp, dg, d, need["unified4"] - 1, need["split"] - 1)
    # JAX's ladder on the same graph picks the same rungs at its own budgets
    jdg = jgraph.graph_device_arrays(b.export_graph())
    d_j, m0 = 128, dg.level0.shape[1]
    j_need = {"unified": dg.n_pad * (m0 * d_j // 256 + 1) * 512,
              "unified8": dg.n_pad * ((m0 * d_j // 512 + 1) * 512 + d_j + 4),
              "unified4": dg.n_pad * ((m0 * d_j // 1024 + 1) * 512 + d_j + 4)}
    for tier, budget in j_need.items():
        got = jpg.build_inline_tables(jnp.asarray(xp.numpy()), jdg, d, budget, 0,
                                      upper_inline=False)
        assert got[0] == tier
    j_split = dg.n_pad * m0 * d_j * 2
    assert jpg.build_inline_tables(jnp.asarray(xp.numpy()), jdg, d, 0, j_split)[0] == "split"
    assert jpg.build_inline_tables(jnp.asarray(xp.numpy()), jdg, d, 0, j_split - 1) is None


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["int8", "int4"])
@pytest.mark.parametrize("space,e,m0,d", [("l2", 2, 32, 128), ("ip", 1, 16, 96)])
def test_quant_hop_kernel_matches_plain_on_cuda(cuda_device, tier, space, e, m0, d):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(500, d)).astype(np.float32)).to(cuda_device)
    level0 = torch.from_numpy(rng.integers(0, 500, (500, m0)).astype(np.int32)).to(cuda_device)
    table = TIERS[tier][0](x, level0)
    q = torch.from_numpy(rng.normal(size=(64, d)).astype(np.float32)).to(cuda_device)
    chosen = torch.from_numpy(rng.integers(0, 500, (64, e)).astype(np.int32)).to(cuda_device)
    dk, ik = gk.hop_dist_unified(q, table, chosen, space)
    dp, ip_ = gk.hop_dist_unified_plain(q, table, chosen, space)
    torch.cuda.synchronize()
    assert torch.equal(ik, ip_)
    torch.testing.assert_close(dk, dp, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("space,d", [("l2", 128), ("ip", 128), ("l2", 30), ("l2", 96),
                                     ("ip", 768)])
def test_bf16_gather_kernel_matches_plain_on_cuda(cuda_device, space, d):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(500, d)).astype(np.float32)).to(cuda_device)
    xb = x.to(torch.bfloat16)
    q = torch.from_numpy(rng.normal(size=(64, d)).astype(np.float32)).to(cuda_device)
    ids = torch.from_numpy(rng.integers(0, 500, (64, 40)).astype(np.int32)).to(cuda_device)
    dk = gk.gather_dist_rows(q, xb, ids, space)
    dp = gk.gather_dist_rows_plain(q, xb, ids, space)
    torch.cuda.synchronize()
    torch.testing.assert_close(dk, dp, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 160])
@pytest.mark.parametrize("d", [30, 96, 128, 768])
@pytest.mark.parametrize("space", ["l2", "ip"])
def test_bf16_gather_kernel_k_and_ids_on_cuda(cuda_device, k, d, space):
    """Both CUDA paths of the bf16 gather (40 rows of a query in flight
    where d % 8 == 0, a warp per row at d=30) at K=1 and K=160 (four
    batches of 40 rows), with ids out of range (NaN)."""
    rng = np.random.default_rng(k + d)
    rows = 500
    xb = torch.from_numpy(rng.normal(size=(rows, d)).astype(np.float32)).to(torch.bfloat16)
    q = torch.from_numpy(rng.normal(size=(64, d)).astype(np.float32))
    ids = rng.integers(0, rows, (64, k)).astype(np.int32)
    ids[0, 0], ids[1, k - 1] = -1, rows
    xb, q, ids = xb.to(cuda_device), q.to(cuda_device), torch.from_numpy(ids).to(cuda_device)
    ok = (ids >= 0) & (ids < rows)
    dk = gk.gather_dist_rows(q, xb, ids, space)
    dp = gk.gather_dist_rows_plain(q, xb, torch.where(ok, ids, 0), space)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(dk), ~ok)
    torch.testing.assert_close(dk[ok], dp[ok], rtol=1e-5, atol=1e-4)
