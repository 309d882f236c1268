"""Port parity, bf16 vector storage: an index whose space stores vectors in
bf16 (the reference's N=4M serving configuration: int4 tier, bf16 table,
rescore from the bf16 table) in hnsw_tpu_torch and in the JAX package, on
one graph. The port used to upload f32 whatever the space said, so its
squared norms, seeds and rescore differed from the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import hnsw_tpu.core.spaces as jspaces
from hnsw_tpu.models.hnsw import SearchParams as JParams
from test_torch_tiers import tier_pair

from hnsw_tpu_torch.core import spaces as tspaces
from hnsw_tpu_torch.models.hnsw import SearchParams
from hnsw_tpu_torch.native.hnsw_builder import NativeHNSWBuilder

N, D, M, EFC, B, K = 1200, 16, 8, 80, 16, 10
META = {"space": "l2", "dim": D, "m": M, "ef_construction": EFC}
PARAMS = dict(k=K, ef=32, entry_seeds=4)  # auto rescore of 40 on int4


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(17)
    centers = rng.normal(size=(30, D)).astype(np.float32)
    x = centers[rng.integers(0, 30, N)] + 0.7 * rng.normal(size=(N, D)).astype(np.float32)
    q = x[rng.integers(0, N, B)] + 0.3 * rng.normal(size=(B, D)).astype(np.float32)
    b = NativeHNSWBuilder(D, "l2", M, EFC, seed=123)
    b.add_batch(x, np.arange(N), n_threads=1)
    parts = (b.export_graph(), b.export_vectors(), b.export_deleted())
    t, j = tier_pair(parts, META, "unified4",
                     tspaces.L2Space(D, storage_dtype=torch.bfloat16),
                     jspaces.L2Space(D, storage_dtype=jnp.bfloat16))
    jd, jl = j.search(q, params=JParams(**PARAMS))
    assert j._device[5][0] == "unified4"
    return {"t": t, "j": j, "q": q, "x": x, "jax": (jd, jl)}


def test_bf16_storage_state_matches_jax(pair):
    """The vector table is stored in the space's dtype, bit-equal to JAX's,
    and the squared norms come from the stored (bf16-rounded) values."""
    st, jst = pair["t"]._sync_device(), pair["j"]._device
    assert st.vectors.dtype == torch.bfloat16 and jst[1].dtype == jnp.bfloat16
    np.testing.assert_array_equal(st.vectors.view(torch.int16).numpy(),
                                  np.asarray(jst[1]).view(np.int16))
    np.testing.assert_allclose(st.sq_norms.numpy(), np.asarray(jst[2]), rtol=1e-6)
    xb = st.vectors.float()
    np.testing.assert_allclose(st.sq_norms.numpy(), (xb * xb).sum(-1).numpy(), rtol=1e-6)


def test_bf16_storage_search_matches_jax(pair):
    td, tl = pair["t"].search(pair["q"], params=SearchParams(**PARAMS))
    jd, jl = pair["jax"]
    assert pair["t"]._device.tier == "unified4"
    assert np.mean(tl == jl) >= 0.99
    same = tl == jl
    np.testing.assert_allclose(td[same], jd[same], rtol=1e-5, atol=1e-4)
    # the rescore returns the distances to the bf16-rounded vectors
    xb = pair["t"]._device.vectors.float().numpy()[:N].astype(np.float64)
    exact = ((xb[tl] - pair["q"].astype(np.float64)[:, None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(td, exact, rtol=1e-5, atol=1e-4)
