"""The landmark seeds' top-s (ops/topk.py seed_topk): its plain version
against bruteforce_topk on the CPU, and the CUDA kernel
(csrc/seed_topk.cu) against the plain version on a card (`cuda` marker: the
kernel has no CPU mode). No JAX: bruteforce_topk's parity with the JAX
package is tested in test_torch_oracle.py."""

import numpy as np
import pytest
import torch

from hnsw_tpu_torch.models import hnsw as hnsw_mod
from hnsw_tpu_torch.models.hnsw import HNSWIndex, SearchParams
from hnsw_tpu_torch.ops.gather_kernels import COUNTS
from hnsw_tpu_torch.ops.topk import (
    SEED_TOPK_MAX_S,
    bruteforce_topk,
    round_tf32,
    seed_topk,
    seed_topk_plain,
)

torch.set_num_threads(1)

# (NL, s): every s the kernel takes that NL allows
SIZES = [(1, 1)] + [(nl, s) for nl in (127, 16385) for s in (1, 4, 8, 32)]


def _case(b, nl, d, seed=3, dev="cpu"):
    rng = np.random.default_rng(seed + nl + d)
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.normal(size=(nl, d)).astype(np.float32)).to(dev)
    return q, x, (x * x).sum(-1)


def _u8_case(b, nl, d, levels, seed=9, dev="cpu"):
    """l2u8's stored form: integers shifted by -128. With few `levels` most
    distances of a row are equal to others."""
    rng = np.random.default_rng(seed + nl + d + levels)
    q = rng.integers(0, levels, (b, d)).astype(np.float32) - 128.0
    x = rng.integers(0, levels, (nl, d)).astype(np.float32) - 128.0
    xt = torch.from_numpy(x).to(dev)
    return torch.from_numpy(q).to(dev), xt, (xt * xt).sum(-1)


def _exact_lex(q, x, s):
    """float64 distances of integer data (exact) and the s smallest of each
    row by (distance, position)."""
    qd, xd = q.cpu().double().numpy(), x.cpu().double().numpy()
    dist = (qd * qd).sum(1)[:, None] + (xd * xd).sum(1)[None, :] - 2.0 * qd @ xd.T
    pos = np.argsort(dist, axis=1, kind="stable")[:, :s]
    return np.take_along_axis(dist, pos, 1), pos


# ---------------------------------------------------------------------------
# On the CPU: the plain version.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [100, 128, 960])
@pytest.mark.parametrize("nl,s", SIZES)
@pytest.mark.parametrize("space", ["l2", "ip"])
def test_plain_matches_bruteforce_topk(space, nl, s, d):
    """On continuous data (no equal distances) the plain version returns
    bruteforce_topk's distances and positions exactly: the same distance
    blocks, another top-s."""
    q, x, xsq = _case(16, nl, d)
    sq = xsq if space == "l2" else None
    got_d, got_i = seed_topk(q, x, s, space, x_sq_norms=sq)
    want_d, want_i = bruteforce_topk(q, x, s, space, x_sq_norms=sq)
    assert got_i.dtype == torch.int64 and got_d.shape == (16, s)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_d, want_d)


@pytest.mark.parametrize("nl,d,levels", [(16385, 16, 3), (1000, 128, 256)])
@pytest.mark.parametrize("s", [1, 4, 32])
def test_plain_ties_go_to_the_lower_position(nl, d, levels, s):
    """u8-shifted integers: the distances are exact, and among equal
    distances the lower landmark position comes first (lax.top_k's order),
    also across the 16,384-row blocks."""
    q, x, xsq = _u8_case(24, nl, d, levels)
    got_d, got_i = seed_topk_plain(q, x, s, "l2", x_sq_norms=xsq)
    want_d, want_i = _exact_lex(q, x, s + 1)
    np.testing.assert_array_equal(got_i.numpy(), want_i[:, :s])
    np.testing.assert_array_equal(got_d.numpy(), want_d[:, :s].astype(np.float32))
    if levels == 3:  # equal distances straddle the cut
        assert (want_d[:, s - 1] == want_d[:, s]).any()


def test_large_s_takes_bruteforce_topk():
    q, x, xsq = _case(8, 500, 32)
    s = SEED_TOPK_MAX_S + 8
    COUNTS.reset()
    got = seed_topk(q, x, s, "l2", x_sq_norms=xsq)
    want = bruteforce_topk(q, x, s, "l2", x_sq_norms=xsq)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert COUNTS.plain_on_cuda == 0  # counted on CUDA tensors only


def test_round_tf32_keeps_ten_mantissa_bits():
    """Nearest of the values with 10 mantissa bits, ties away from 0, as a
    TF32 matmul takes its f32 inputs."""
    v = torch.from_numpy(np.random.default_rng(2).normal(size=100_000).astype(np.float32)) * 1e3
    r = round_tf32(v)
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((r - v).abs() <= v.abs() * 2.0 ** -11).all()
    ties = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12, 3.0, -128.0, 0.0])
    want = torch.tensor([1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 3.0, -128.0, 0.0])
    assert torch.equal(round_tf32(ties), want)


@pytest.mark.parametrize("bad", [dict(s=0), dict(s=11), dict(space="cosine")])
def test_rejects_what_it_does_not_take(bad):
    q, x, _ = _case(4, 10, 8)
    kw = dict(s=4, space="l2") | bad
    with pytest.raises(ValueError):
        seed_topk(q, x, kw["s"], kw["space"])


def test_search_seeds_through_seed_topk_as_through_bruteforce_topk(monkeypatch):
    """HNSWIndex.search(entry_seeds=4) gives the same labels and distances
    with its seeds from seed_topk as with them from bruteforce_topk."""
    rng = np.random.default_rng(4)
    centers = rng.normal(size=(32, 24)).astype(np.float32)
    x = centers[rng.integers(0, 32, 3000)] + 0.4 * rng.normal(size=(3000, 24)).astype(np.float32)
    q = x[rng.integers(0, 3000, 64)] + 0.05 * rng.normal(size=(64, 24)).astype(np.float32)
    idx = HNSWIndex("l2", dim=24, m=8, ef_construction=64, device="cpu")
    idx._builder.add_batch(x, np.arange(3000), n_threads=1)  # serial: deterministic
    idx._dirty = True
    params = SearchParams(k=10, ef=40, expand=2, stop_frontier=1.15, max_iters=14,
                          entry_seeds=4)
    calls = []

    def counted(*a, **kw):
        calls.append(a[2])
        return seed_topk(*a, **kw)

    monkeypatch.setattr(hnsw_mod, "seed_topk", counted)
    got_d, got_l = idx.search(q, params=params)
    assert calls == [4]
    monkeypatch.setattr(hnsw_mod, "seed_topk", bruteforce_topk)
    want_d, want_l = idx.search(q, params=params)
    np.testing.assert_array_equal(got_l, want_l)
    np.testing.assert_array_equal(got_d, want_d)
    assert (got_l[:, 0] >= 0).all()


# ---------------------------------------------------------------------------
# On the card: the kernel against the plain version.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _kernel(q, x, s, space, xsq):
    """One call of the wrapper, with its launch counted: one seed_topk
    launch, no plain version on CUDA tensors."""
    COUNTS.reset()
    out = seed_topk(q, x, s, space, x_sq_norms=xsq)
    torch.cuda.synchronize()
    assert COUNTS.seed_topk == 1 and COUNTS.plain_on_cuda == 0
    return out


def _assert_close(q, x, space, got, want, exact=True):
    """Distances within f32 rounding of the plain version's (rank by rank);
    positions distinct and equal to the plain version's except where the
    two distances at that rank are within that rounding (near ties summed
    in another order); with `exact`, each returned distance within rounding
    of its landmark's float64 distance."""
    gd, gi = (t.cpu() for t in got)
    wd, wi = (t.cpu() for t in want)
    qd, xd = q.cpu().double(), x.cpu().double()
    if space == "l2":
        scale = (qd * qd).sum(1, keepdim=True) + (xd * xd).sum(1).max()
    else:
        scale = qd.norm(dim=1, keepdim=True) * xd.norm(dim=1).max()
    tol = 1e-5 * scale + 1e-6
    assert ((gd.double() - wd.double()).abs() <= tol).all()
    swapped = gi != wi
    assert ((gd.double() - wd.double()).abs()[swapped] <= tol.expand_as(gd)[swapped]).all()
    assert all(len(set(r)) == len(r) for r in gi.tolist())
    assert (gd[:, 1:] >= gd[:, :-1]).all()
    if not exact:
        return
    rows = xd[gi]  # [B, s, D]
    if space == "l2":
        f64 = ((rows - qd[:, None, :]) ** 2).sum(-1)
    else:
        f64 = 1.0 - (rows * qd[:, None, :]).sum(-1)
    assert ((gd.double() - f64).abs() <= tol).all()


@pytest.mark.cuda
@pytest.mark.parametrize("space", ["l2", "ip"])
def test_kernel_at_the_cells_shape(cuda_device, space):
    """B 8,192 x NL 62,500 x D 128, s 4: the benchmark cells' seeds."""
    q, x, xsq = _case(8192, 62500, 128, dev=cuda_device)
    sq = xsq if space == "l2" else None
    got = _kernel(q, x, 4, space, sq)
    want = seed_topk_plain(q, x, 4, space, x_sq_norms=sq)
    _assert_close(q, x, space, got, want)
    assert (got[1] != want[1]).float().mean() < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("space", ["l2", "ip"])
@pytest.mark.parametrize("d", [100, 128, 960, 7])
@pytest.mark.parametrize("b,nl,s", [(1, 1, 1), (1, 1000, 4), (300, 127, 8), (129, 16385, 32),
                                    (1000, 62500, 4), (2, 300, 1)])
def test_kernel_matches_plain_at_ragged_edges(cuda_device, b, nl, s, d, space):
    """B and NL not multiples of 128, one query, one landmark, D not a
    multiple of the staged chunk (100, 7) or past the old shared-memory
    width (960), every s the kernel takes."""
    q, x, xsq = _case(b, nl, d, dev=cuda_device)
    sq = xsq if space == "l2" else None
    got = _kernel(q, x, s, space, sq)
    want = seed_topk_plain(q, x, s, space, x_sq_norms=sq)
    _assert_close(q, x, space, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,nl,d,levels,s", [(8192, 62500, 128, 256, 4), (500, 16385, 16, 3, 8),
                                             (77, 3000, 128, 2, 32), (64, 1, 128, 256, 1)])
def test_kernel_exact_on_u8_data(cuda_device, b, nl, d, levels, s):
    """u8-shifted integers (l2u8's stored form): distances and positions
    equal to the plain version's, bit for bit, with equal distances to the
    lower position."""
    q, x, xsq = _u8_case(b, nl, d, levels, dev=cuda_device)
    got_d, got_i = _kernel(q, x, s, "l2", xsq)
    want_d, want_i = seed_topk_plain(q, x, s, "l2", x_sq_norms=xsq)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_d, want_d)


@pytest.mark.cuda
def test_kernel_counts_each_call_once(cuda_device):
    q, x, xsq = _case(300, 5000, 64, dev=cuda_device)
    COUNTS.reset()
    for _ in range(3):
        seed_topk(q, x, 4, "l2", x_sq_norms=xsq)
    seed_topk(q, x, 4, "l2")  # |x|^2 summed by the wrapper
    torch.cuda.synchronize()
    assert COUNTS.seed_topk == 4 and COUNTS.plain_on_cuda == 0
    seed_topk(q, x, SEED_TOPK_MAX_S + 1, "l2", x_sq_norms=xsq)  # bruteforce_topk
    assert COUNTS.seed_topk == 4 and COUNTS.plain_on_cuda == 1


@pytest.mark.cuda
@pytest.mark.parametrize("space", ["l2", "ip"])
def test_kernel_follows_the_tf32_setting(cuda_device, space):
    """Where the global float32 matmul setting allows TF32, as it would for
    bruteforce_topk's matmul, the kernel's products take TF32 inputs: its
    answer is the plain version's on rounded inputs, and its distances move
    off the f32 ones by TF32's error, not f32's."""
    q, x, xsq = _case(2048, 20000, 128, dev=cuda_device)
    sq = xsq if space == "l2" else None
    f32 = _kernel(q, x, 8, space, sq)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        got = _kernel(q, x, 8, space, sq)
    finally:
        torch.set_float32_matmul_precision(prev)
    assert not torch.backends.cuda.matmul.allow_tf32
    want = seed_topk_plain(round_tf32(q), round_tf32(x), 8, space, x_sq_norms=sq)
    _assert_close(round_tf32(q), round_tf32(x), space, got, want, exact=False)
    assert (got[0] - f32[0]).abs().max() > 1e-3

