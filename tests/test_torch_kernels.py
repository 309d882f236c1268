"""Port parity, node-block tables and kernels: the unified tables, the plain
versions of the hop and gather kernels, the beam's bitonic merge and its
expansion pick, against the JAX package (Pallas in interpret mode). The
CUDA kernels themselves run only on a card (`cuda` marker)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import hnsw_tpu.core.graph as jgraph
from hnsw_tpu.ops import pallas_gather as jpg
from hnsw_tpu.ops.traversal import _bitonic_merge_topk as j_merge

from hnsw_tpu_torch.convert import unified_from_jax_rows
from hnsw_tpu_torch.core import graph as tgraph
from hnsw_tpu_torch.native.hnsw_builder import NativeHNSWBuilder
from hnsw_tpu_torch.ops import gather_kernels as gk
from hnsw_tpu_torch.ops.traversal import _bitonic_merge_topk, _select_expand


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


@pytest.fixture(scope="module")
def graph_and_x():
    rng = np.random.default_rng(21)
    n, d = 900, 40  # d=40: the port pads to 40, the JAX table to 128
    x = rng.normal(size=(n, d)).astype(np.float32)
    b = NativeHNSWBuilder(d, "l2", 8, 60, seed=5)
    b.add_batch(x, np.arange(n), n_threads=1)
    g = b.export_graph()
    assert g.max_level >= 2
    return g, tgraph.pad_vectors(x, tgraph.round_up(n + 1, 128))


def test_unified_table_bit_equal_to_jax(graph_and_x):
    g, xp = graph_and_x
    tdg = tgraph.graph_device_arrays(g)
    jdg = jgraph.graph_device_arrays(g)
    t = gk.make_unified_table_chunked(torch.from_numpy(xp), tdg.level0, chunk=100)
    rows = np.asarray(jpg.make_unified_table_chunked(jnp.asarray(xp), jdg.level0))
    j = unified_from_jax_rows(rows, tdg.level0.shape[1], xp.shape[1])
    assert t.vecs.shape == j.vecs.shape == (tdg.n_pad, 16, 40)
    np.testing.assert_array_equal(_bits(t.vecs), _bits(j.vecs))
    np.testing.assert_array_equal(t.payload.numpy(), j.payload.numpy())


def test_upper_tables_bit_equal_to_jax(graph_and_x):
    g, xp = graph_and_x
    tdg = tgraph.graph_device_arrays(g)
    jdg = jgraph.graph_device_arrays(g)
    u_pad = tdg.upper.shape[1]
    sizes = gk.upper_level_sizes_u(tdg.upper_slot, u_pad)
    assert sizes == jpg.upper_level_sizes_u(jdg.upper_slot, u_pad)
    t_tabs = gk.make_upper_tables(
        torch.from_numpy(xp), tdg.upper, tdg.upper_slot, level_sizes=sizes
    )
    j_tabs = jpg.make_upper_tables(
        jnp.asarray(xp), jdg.upper, jdg.upper_slot, level_sizes=sizes
    )
    assert len(t_tabs) == len(j_tabs) == g.max_level
    for (tt, tids), (jt, jids) in zip(t_tabs, j_tabs):
        j = unified_from_jax_rows(np.asarray(jt), 16, xp.shape[1])
        np.testing.assert_array_equal(_bits(tt.vecs), _bits(j.vecs))
        np.testing.assert_array_equal(tt.payload.numpy(), j.payload.numpy())
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))


@pytest.mark.parametrize(
    "space,e,m0,d", [("l2", 2, 16, 40), ("ip", 2, 16, 40), ("l2", 1, 32, 128)]
)
def test_hop_plain_matches_jax_interpret(space, e, m0, d):
    rng = np.random.default_rng(m0 + d)
    n, b = 300, 16
    x = rng.normal(size=(n, d)).astype(np.float32)
    level0 = rng.integers(0, n, size=(n, m0)).astype(np.int32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    chosen = rng.integers(0, n, size=(b, e)).astype(np.int32)
    table = gk.make_unified_table_chunked(torch.from_numpy(x), torch.from_numpy(level0))
    got_d, got_i = gk.hop_dist_unified(
        torch.from_numpy(q), table, torch.from_numpy(chosen), space
    )
    jtab = jpg.make_unified_table(jnp.asarray(x), jnp.asarray(level0))
    want_d, want_i = jpg.hop_dist_unified(
        jnp.asarray(q), jtab, jnp.asarray(chosen), m0, space, interpret=True
    )
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("space", ["l2", "ip"])
def test_gather_plain_matches_jax_interpret(space):
    rng = np.random.default_rng(4)
    n, d, b, k = 400, 40, 8, 10
    x = (3.0 + rng.normal(size=(n, d))).astype(np.float32)
    q = (3.0 + rng.normal(size=(b, d))).astype(np.float32)
    ids = rng.integers(0, n, size=(b, k)).astype(np.int32)
    got = gk.gather_dist_rows(
        torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(ids), space
    ).numpy()
    want = np.asarray(jpg.gather_dist_pallas(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(ids), space=space, interpret=True
    ))
    # norm-expansion form: cancellation error scales with |q|^2 + |x|^2
    scale = (q * q).sum(-1)[:, None] + (x * x).sum(-1)[ids]
    assert np.all(np.abs(got - want) <= 1e-5 * np.abs(want) + 1e-5 * scale)


def test_kernel_wrappers_check_inputs():
    table = gk.UnifiedTable(torch.zeros((4, 16, 8), dtype=torch.bfloat16),
                            torch.zeros((4, 16), dtype=torch.int32))
    q = torch.zeros((2, 8))
    chosen = torch.zeros((2, 1), dtype=torch.int32)
    t8 = gk.Unified8Table(torch.zeros((4, 16, 8), dtype=torch.int8),
                          torch.ones((4, 16)), torch.zeros((4, 16), dtype=torch.int32))
    t4 = gk.Unified4Table(torch.zeros((4, 16, 4), dtype=torch.uint8),
                          torch.ones((4, 16)), torch.zeros((4, 16), dtype=torch.int32))
    # the table's type picks the tier (JAX's int8= / int4= flags), and each
    # tier's tensors must have that tier's dtypes
    with pytest.raises(TypeError, match="not a unified table"):
        gk.hop_dist_unified(q, table.vecs, chosen)
    with pytest.raises(TypeError, match="int8 table codes"):
        gk.hop_dist_unified(q, gk.Unified8Table(t4.codes, t8.scales, t8.payload), chosen)
    with pytest.raises(TypeError, match="int4 table codes"):
        gk.hop_dist_unified(q, gk.Unified4Table(t8.codes[..., :4], t4.scales, t4.payload),
                            chosen)
    with pytest.raises(TypeError, match="bf16 table vecs"):
        gk.hop_dist_unified(q, gk.UnifiedTable(table.vecs.float(), table.payload), chosen)
    with pytest.raises(TypeError):
        gk.hop_dist_unified(q, gk.Unified8Table(t8.codes.float(), t8.scales, t8.payload), chosen)
    with pytest.raises(TypeError):
        gk.gather_dist_rows(q, torch.zeros((4, 8), dtype=torch.float16), chosen)
    with pytest.raises(TypeError):
        gk.hop_dist_unified(q, table, chosen.long())
    with pytest.raises(ValueError):
        gk.hop_dist_unified(torch.zeros((2, 9)), table, chosen)
    with pytest.raises(ValueError):
        gk.gather_dist_rows(q, torch.zeros((4, 8)), chosen, "hamming")
    with pytest.raises(TypeError):
        gk.gather_dist_rows(q.double(), torch.zeros((4, 8)), chosen)
    gk.COUNTS.reset()
    for tab in (table, t8, t4):
        d, ids = gk.hop_dist_unified(q, tab, chosen)
        assert d.shape == ids.shape == (2, 16)
    gk.gather_dist_rows(q, torch.zeros((4, 8)), chosen)
    gk.gather_dist_rows(q, torch.zeros((4, 8), dtype=torch.bfloat16), chosen)
    # CPU tensors: plain versions, no launch
    assert dataclasses.astuple(gk.COUNTS) == (0,) * len(dataclasses.fields(gk.COUNTS))


def test_bitonic_merge_matches_jax_on_ties():
    rng = np.random.default_rng(9)
    b, ef, em = 8, 12, 10
    # distances from a tiny set of values: ties everywhere, +inf included
    vals = np.array([0.5, 1.0, 1.0, 2.0, np.inf], np.float32)
    beam_d = np.sort(vals[rng.integers(0, 5, (b, ef))], axis=1)
    beam_p = rng.integers(0, 1000, (b, ef)).astype(np.int32)
    new_d = vals[rng.integers(0, 5, (b, em))]
    new_p = rng.integers(0, 1000, (b, em)).astype(np.int32)
    gd, gp = _bitonic_merge_topk(*map(torch.from_numpy, (beam_d, beam_p, new_d, new_p)),
                                 ef, 999)
    wd, wp = j_merge(*map(jnp.asarray, (beam_d, beam_p, new_d, new_p)), ef, 999)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))


def test_expansion_pick_matches_top_k():
    """The cumulative-sum pick equals the JAX body's lax.top_k(-key, E)
    selection (ties to the lower index) on beams with tied distances."""
    rng = np.random.default_rng(2)
    b, ef, e, sent = 32, 16, 3, 999
    beam_d = np.sort(rng.choice([0.5, 1.0, 1.0, np.inf], (b, ef)).astype(np.float32), 1)
    beam_key = (rng.integers(0, 500, (b, ef)) * 2 + rng.integers(0, 2, (b, ef))).astype(np.int32)
    beam_id = beam_key >> 1
    unexp = ((beam_key & 1) == 0) & (beam_d < np.inf)
    chosen, new_exp = _select_expand(torch.from_numpy(beam_id), torch.from_numpy(unexp), e, sent)

    key = jnp.where(jnp.asarray(unexp), jnp.asarray(beam_d), jnp.inf)
    sel_d, sel = jax.lax.top_k(-key, e)
    valid = np.asarray(sel_d > -jnp.inf)
    sel = np.asarray(sel)
    want = np.where(valid, np.take_along_axis(beam_id, sel, axis=1), sent)
    want_exp = np.zeros_like(unexp)
    for i in range(b):
        want_exp[i, sel[i][valid[i]]] = True
    np.testing.assert_array_equal(chosen.numpy(), want)
    np.testing.assert_array_equal(new_exp.numpy(), want_exp)


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("space,e,m0,d", [("l2", 2, 32, 128), ("ip", 1, 16, 96)])
def test_hop_kernel_matches_plain_on_cuda(cuda_device, space, e, m0, d):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(500, d)).astype(np.float32)).to(cuda_device)
    level0 = torch.from_numpy(rng.integers(0, 500, (500, m0)).astype(np.int32)).to(cuda_device)
    table = gk.make_unified_table_chunked(x, level0)
    q = torch.from_numpy(rng.normal(size=(64, d)).astype(np.float32)).to(cuda_device)
    chosen = torch.from_numpy(rng.integers(0, 500, (64, e)).astype(np.int32)).to(cuda_device)
    dk, ik = gk.hop_dist_unified(q, table, chosen, space)
    dp, ip_ = gk.hop_dist_unified_plain(q, table, chosen, space)
    torch.cuda.synchronize()
    assert torch.equal(ik, ip_)
    torch.testing.assert_close(dk, dp, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("space", ["l2", "ip"])
def test_gather_kernel_matches_plain_on_cuda(cuda_device, space):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(500, 128)).astype(np.float32)).to(cuda_device)
    q = torch.from_numpy(rng.normal(size=(64, 128)).astype(np.float32)).to(cuda_device)
    ids = torch.from_numpy(rng.integers(0, 500, (64, 40)).astype(np.int32)).to(cuda_device)
    dk = gk.gather_dist_rows(q, x, ids, space)
    dp = gk.gather_dist_rows_plain(q, x, ids, space)
    torch.cuda.synchronize()
    scale = (q * q).sum(-1, keepdim=True) + (x * x).sum(-1)[ids.long()]
    assert bool(((dk - dp).abs() <= 1e-5 * dp.abs() + 1e-5 * scale).all())


def _ring_table(rng, tier, rows, m0, d, dev):
    """A random unified table: bf16 vectors, int8 or int4 codes with scales,
    or l2u8's lossless scale-1 codes ("u8")."""
    d_pad = -(-d // 8) * 8
    payload = torch.from_numpy(rng.integers(0, 1 << 30, (rows, m0)).astype(np.int32))
    if tier == "bf16":
        vecs = torch.from_numpy(rng.normal(size=(rows, m0, d_pad)).astype(np.float32))
        vecs[:, :, d:] = 0
        return gk.UnifiedTable(vecs.to(torch.bfloat16).to(dev), payload.to(dev))
    lo, hi = {"u8": (-128, 127), "int8": (-127, 127), "int4": (-7, 7)}[tier]
    codes = rng.integers(lo, hi + 1, (rows, m0, d_pad)).astype(np.int8)
    codes[:, :, d:] = 0
    scales = np.ones((rows, m0), np.float32) if tier == "u8" else rng.uniform(
        0.01, 0.1, (rows, m0)).astype(np.float32)
    codes, scales = torch.from_numpy(codes), torch.from_numpy(scales).to(dev)
    if tier == "int4":
        return gk.Unified4Table(gk.pack_int4(codes).to(dev), scales, payload.to(dev))
    return gk.Unified8Table(codes.to(dev), scales, payload.to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["bf16", "int8", "u8", "int4"])
@pytest.mark.parametrize("m0", [16, 32, 64, 128])
@pytest.mark.parametrize("d", [96, 128, 104])
@pytest.mark.parametrize("e,b", [(1, 48), (2, 48), (4, 48), (4, 4096)])
def test_hop_ring_shapes_on_cuda(cuda_device, tier, m0, d, e, b):
    """The bf16, int8 and int4 hop kernels (the node-block ring) at every
    shape the wrapper takes (d=104: a 52-byte int4 row), B*E far below
    (B=48) and far above (B=4096, E=4) the persistent grid, with chosen ids
    out of range (NaN, id -1). l2u8's scale-1 codes against integer queries
    give the int64 distances."""
    rng = np.random.default_rng(m0 + d + e)
    rows = 2048
    table = _ring_table(rng, tier, rows, m0, d, cuda_device)
    if tier == "u8":
        q = torch.from_numpy(rng.integers(-128, 128, (b, d)).astype(np.float32))
    else:
        q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    chosen = rng.integers(0, rows, (b, e)).astype(np.int32)
    chosen[0, 0], chosen[1, e - 1], chosen[2, 0] = -1, rows, rows - 1
    q, chosen = q.to(cuda_device), torch.from_numpy(chosen).to(cuda_device)
    ok = (chosen >= 0) & (chosen < rows)
    bad = (~ok).repeat_interleave(m0, dim=1)
    for space in ("l2",) if tier == "u8" else ("l2", "ip"):
        dk, ik = gk.hop_dist_unified(q, table, chosen, space)
        dp, ip_ = gk.hop_dist_unified_plain(q, table, torch.where(ok, chosen, 0), space)
        torch.cuda.synchronize()
        assert torch.equal(ik, ip_.masked_fill(bad, -1))
        assert torch.equal(torch.isnan(dk), bad)
        torch.testing.assert_close(dk[~bad], dp[~bad], rtol=1e-5, atol=1e-4)
        if tier == "u8":
            codes = table.codes[torch.where(ok, chosen, 0).long()][..., :d].long()
            ref = ((codes - q.long()[:, None, None, :]) ** 2).sum(-1).reshape(b, -1)
            assert torch.equal(dk[~bad].long(), ref[~bad])
            assert torch.equal(dk[~bad], ref[~bad].float())


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["bf16", "int8", "int4"])
def test_hop_ring_widest_row_on_cuda(cuda_device, tier):
    """d_pad = 12288, the widest row the wrapper takes: a piece of 2 rows and
    a ring past 48 KB of shared memory."""
    rng = np.random.default_rng(3)
    table = _ring_table(rng, tier, 64, 16, 12288, cuda_device)
    q = torch.from_numpy(rng.normal(size=(8, 12288)).astype(np.float32)).to(cuda_device)
    chosen = torch.from_numpy(rng.integers(0, 64, (8, 2)).astype(np.int32)).to(cuda_device)
    dk, ik = gk.hop_dist_unified(q, table, chosen)
    dp, ip_ = gk.hop_dist_unified_plain(q, table, chosen)
    torch.cuda.synchronize()
    assert torch.equal(ik, ip_)
    torch.testing.assert_close(dk, dp, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_hop_ring_int4_four_row_pieces_on_cuda(cuda_device):
    """d_pad = 12280: an int4 row of 6,140 bytes (4 past a multiple of 16),
    so the ring cuts a block into pieces of 4 rows for 16-byte copies."""
    rng = np.random.default_rng(4)
    table = _ring_table(rng, "int4", 64, 16, 12280, cuda_device)
    q = torch.from_numpy(rng.normal(size=(8, 12280)).astype(np.float32)).to(cuda_device)
    chosen = torch.from_numpy(rng.integers(0, 64, (8, 2)).astype(np.int32)).to(cuda_device)
    for space in ("l2", "ip"):
        dk, ik = gk.hop_dist_unified(q, table, chosen, space)
        dp, ip_ = gk.hop_dist_unified_plain(q, table, chosen, space)
        torch.cuda.synchronize()
        assert torch.equal(ik, ip_)
        torch.testing.assert_close(dk, dp, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["bf16", "int8", "int4"])
def test_hop_wrapper_rejects_m0_not_multiple_of_4_on_cuda(cuda_device, tier):
    """The ring copies ids, scales and rows in 16-byte multiples: on a CUDA
    tensor the wrapper raises for m0 % 4 (the CPU's plain version takes
    it)."""
    table = _ring_table(np.random.default_rng(5), tier, 8, 6, 16, cuda_device)
    q = torch.zeros((2, 16), device=cuda_device)
    chosen = torch.zeros((2, 1), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="m0 6 is not a multiple of 4"):
        gk.hop_dist_unified(q, table, chosen)
