"""The split-tier hop (row 6) on the node-block ring and the f32 row gather
(row 2) with every row of a query in flight, against their plain PyTorch
versions, on a card only (`cuda` marker: the kernels have no CPU mode). No
JAX: the plain versions are the reference here, and their parity with the
JAX package is tested in test_torch_split.py and test_torch_kernels.py."""

import numpy as np
import pytest
import torch

from hnsw_tpu_torch.ops import gather_kernels as gk

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _split_case(dev, m0, d, b, e, rows=700, seed=5):
    rng = np.random.default_rng(seed + m0 + d + e)
    d_pad = -(-d // 8) * 8
    x = torch.from_numpy(rng.normal(size=(rows, d)).astype(np.float32)).to(dev)
    level0 = torch.from_numpy(rng.integers(0, rows, (rows, m0)).astype(np.int32)).to(dev)
    nbr = gk.make_inline_neighbors(x, level0)
    assert nbr.shape == (rows, m0, d_pad)
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(dev)
    chosen = torch.from_numpy(rng.integers(0, rows, (b, e)).astype(np.int32)).to(dev)
    # out of range (NaN, -1), and the sentinel row n_pad - 1 many times
    chosen[0, 0], chosen[1, e - 1], chosen[2:9, 0] = -1, rows, rows - 1
    return q, nbr, level0, chosen


@pytest.mark.cuda
@pytest.mark.parametrize("space", ["l2", "ip"])
@pytest.mark.parametrize("d", [96, 128])
@pytest.mark.parametrize("m0,e", [(32, 2), (64, 1)])
def test_split_hop_ring_matches_plain_and_row1_on_cuda(cuda_device, m0, e, d, space):
    """Row 6 against its plain version (ids equal, distances rtol 1e-5 / atol
    1e-4, NaN and -1 exactly where a chosen id is out of range) and against
    row 1 on the same tensors, bit for bit."""
    q, nbr, level0, chosen = _split_case(cuda_device, m0, d, 256, e)
    rows = nbr.shape[0]
    gk.COUNTS.reset()
    dk, ik = gk.hop_dist_inline(q, nbr, level0, chosen, space)
    assert gk.COUNTS.hop_dist_inline == 1 and gk.COUNTS.plain_on_cuda == 0
    ok = (chosen >= 0) & (chosen < rows)
    dp, ip_ = gk.hop_dist_inline_plain(q, nbr, level0, torch.where(ok, chosen, 0), space)
    bad = (~ok).repeat_interleave(m0, dim=1)
    dp, ip_ = dp.masked_fill(bad, float("nan")), ip_.masked_fill(bad, -1)
    du, iu = gk.hop_dist_unified(q, gk.UnifiedTable(nbr, level0), chosen, space)
    torch.cuda.synchronize()
    assert torch.equal(ik, ip_)
    assert torch.equal(torch.isnan(dk), bad)
    torch.testing.assert_close(dk[~bad], dp[~bad], rtol=1e-5, atol=1e-4)
    assert torch.equal(ik, iu)
    assert torch.equal(dk.view(torch.int32), du.view(torch.int32))


@pytest.mark.cuda
def test_split_hop_ring_checks_m0_on_cuda(cuda_device):
    q, nbr, level0, chosen = _split_case(cuda_device, 32, 128, 8, 1)
    with pytest.raises(ValueError, match="multiple of 4"):
        gk.hop_dist_inline(q, nbr[:, :30].contiguous(), level0[:, :30].contiguous(), chosen)


@pytest.mark.cuda
def test_split_hop_ring_unaligned_query_on_cuda(cuda_device):
    """A query row that is not 16-byte aligned is cloned, not refused."""
    q, nbr, level0, chosen = _split_case(cuda_device, 32, 128, 64, 2)
    chosen = chosen.clamp(0, nbr.shape[0] - 1)
    flat = torch.zeros(q.numel() + 1, device=cuda_device)
    flat[1:] = q.reshape(-1)
    q_off = flat[1:].view(q.shape)  # 4 bytes past a 16-byte boundary
    assert q_off.data_ptr() % 16
    dk, ik = gk.hop_dist_inline(q_off, nbr, level0, chosen)
    dr, ir = gk.hop_dist_inline(q, nbr, level0, chosen)
    torch.cuda.synchronize()
    assert torch.equal(ik, ir) and torch.equal(dk, dr)


@pytest.mark.cuda
@pytest.mark.parametrize("space", ["l2", "ip"])
@pytest.mark.parametrize("kk", [1, 40, 160])
@pytest.mark.parametrize("d", [30, 96, 128, 768])
def test_gather_f32_matches_plain_on_cuda(cuda_device, d, kk, space):
    """Row 2 against its plain version, ids out of range giving NaN; the
    norm expansion cancels, so the tolerance scales with |q|^2 + |x|^2
    (chip_smoke.gather_bad's)."""
    rng = np.random.default_rng(d + kk)
    rows = 3000
    table = torch.from_numpy(rng.normal(size=(rows, d)).astype(np.float32)).to(cuda_device)
    q = torch.from_numpy(rng.normal(size=(64, d)).astype(np.float32)).to(cuda_device)
    ids = torch.from_numpy(rng.integers(0, rows, (64, kk)).astype(np.int32)).to(cuda_device)
    ids[0, 0], ids[1, kk - 1], ids[2, 0] = -1, rows, rows - 1
    ok = (ids >= 0) & (ids < rows)
    safe = torch.where(ok, ids, 0)
    gk.COUNTS.reset()
    dk = gk.gather_dist_rows(q, table, ids, space)
    assert gk.COUNTS.gather_dist_rows == 1 and gk.COUNTS.plain_on_cuda == 0
    dp = gk.gather_dist_rows_plain(q, table, safe, space)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(dk), ~ok)
    scale = (q * q).sum(-1, keepdim=True) + (table * table).sum(-1)[safe.long()]
    assert bool(((dk - dp).abs() <= 1e-5 * dp.abs() + 1e-5 * scale)[ok].all())
