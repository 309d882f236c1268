"""Port parity, exact oracle: pairwise distances, the chunked streaming
top-k and BruteforceIndex of hnsw_tpu_torch against the JAX package, and
the oracle's exactness against float64 on near-tie clustered data."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from hnsw_tpu.core.spaces import L2Space as JL2, get_space as jget_space
from hnsw_tpu.models.bruteforce import BruteforceIndex as JBrute
from hnsw_tpu.ops.distance import pairwise_dist as j_pairwise
from hnsw_tpu.ops.topk import bruteforce_topk as j_bf_topk
from hnsw_tpu.ops.topk import merge_sorted_topk as j_merge

from hnsw_tpu_torch.core.spaces import L2Space, get_space
from hnsw_tpu_torch.models.bruteforce import BruteforceIndex
from hnsw_tpu_torch.ops.distance import matmul_precision, pairwise_dist
from hnsw_tpu_torch.ops.topk import bruteforce_topk, merge_sorted_topk


def _xq(n=3000, d=24, b=20, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(b, d)).astype(np.float32))


@pytest.mark.parametrize("space", ["l2", "ip"])
def test_pairwise_dist_matches_jax(space):
    x, q = _xq(n=500)
    got = pairwise_dist(torch.from_numpy(q), torch.from_numpy(x), space,
                        precision="highest").numpy()
    want = np.asarray(j_pairwise(jnp.asarray(q), jnp.asarray(x), space,
                                 precision="highest"))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_matmul_precision_turns_tf32_off_and_restores():
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with matmul_precision("highest"):
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
        with matmul_precision(None):
            assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("space,chunk", [("l2", 1024), ("ip", 1024), ("l2", None)])
def test_bruteforce_topk_matches_jax(space, chunk):
    x, q = _xq()
    sq = (x * x).sum(-1)
    got_d, got_i = bruteforce_topk(
        torch.from_numpy(q), torch.from_numpy(x), 10, space, chunk_size=chunk,
        x_sq_norms=torch.from_numpy(sq) if space == "l2" else None,
        precision="highest",
    )
    want_d, want_i = j_bf_topk(
        jnp.asarray(q), jnp.asarray(x), 10, space, chunk_size=chunk,
        x_sq_norms=jnp.asarray(sq) if space == "l2" else None,
        precision="highest",
    )
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-4)


def test_merge_sorted_topk_matches_jax():
    rng = np.random.default_rng(8)
    da, db = rng.random((6, 10)).astype(np.float32), rng.random((6, 7)).astype(np.float32)
    ia, ib = rng.integers(0, 99, (6, 10)), rng.integers(0, 99, (6, 7))
    gd, gi = merge_sorted_topk(*map(torch.from_numpy, (da, ia, db, ib)), 8)
    wd, wi = j_merge(*map(jnp.asarray, (da, ia, db, ib)), 8)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("space", ["l2", "ip", "cosine"])
def test_bruteforce_index_matches_jax_and_loads_across(space, tmp_path):
    x, q = _xq(n=1200, d=16, b=12)
    labels = np.arange(1200) * 3 + 7
    t = BruteforceIndex(get_space(space, 16), device="cpu")
    j = JBrute(jget_space(space, 16))
    t.add_items(x, labels)
    j.add_items(x, labels)
    t.remove_point(int(labels[4]))
    j.remove_point(int(labels[4]))
    td, tl = t.search_knn(q, 10)
    jd, jl = j.search_knn(q, 10)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-4)

    allow = np.zeros(labels.max() + 1, bool)
    allow[labels[::2]] = True
    td, tl = t.search_knn(q, 5, filter_labels=allow)
    jd, jl = j.search_knn(q, 5, filter_labels=allow)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-4)

    t.save(str(tmp_path / "t.bf"))
    j.save(str(tmp_path / "j.bf"))
    jt = JBrute.load(str(tmp_path / "t.bf"))
    tj = BruteforceIndex.load(str(tmp_path / "j.bf"), device="cpu")
    np.testing.assert_array_equal(tj.search_knn(q, 10)[1], jt.search_knn(q, 10)[1])
    assert tj.space.persist_name == space


def test_oracle_exact_on_near_tie_clustered_data():
    """The port's copy of the JAX package's test of the same name: the
    oracle must rank near-tie neighbors exactly (float64 ground truth) on
    clustered data, where a reduced-precision matmul (bf16 inputs on the
    TPU, TF32 on the H100) misranks them."""
    rng = np.random.default_rng(123)
    n, dim, nc, k = 20_000, 64, 80, 10
    centers = rng.normal(size=(nc, dim)).astype(np.float32)
    x = centers[rng.integers(0, nc, n)] + 0.5 * rng.normal(size=(n, dim)).astype(
        np.float32
    )
    q = x[rng.integers(0, n, 64)] + 0.05 * rng.normal(size=(64, dim)).astype(
        np.float32
    )
    xsq = (x.astype(np.float64) ** 2).sum(-1)
    d = xsq[None, :] - 2.0 * (q.astype(np.float64) @ x.T.astype(np.float64))
    idx64 = np.argsort(d, axis=1)[:, :k]

    oracle = BruteforceIndex(L2Space(dim), device="cpu")
    oracle.add_items(x, np.arange(n))
    _, labels = oracle.search_knn(q, k)
    agree = np.mean([len(set(labels[i]) & set(idx64[i])) / k for i in range(64)])
    assert agree == 1.0, agree


def test_device_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        BruteforceIndex(L2Space(4))
    # the reference's oracle is constructed the same way on the CPU
    assert JBrute(JL2(4)).num_elements == 0
