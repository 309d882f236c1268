"""Port parity, the stop-condition searches: epsilon_search and
MultiVectorIndex return the JAX package's (dists, labels, valid) and
documents, through the device beam and through the native CPU engine.

Light by design: one serial build at N=200, one thread, 16 queries, and
each JAX result once per module. The widening ladders reach four beam
widths (64, 128 and 256, and 200 where a document search widens to the
index's size), so the JAX side compiles four (k, ef) shapes.

The graph: document 0 floods the index with 64 vectors packed around one
point, the other 17 documents hold 8 consecutive labels each. Query 0 sits
on the flooding point, the others on perturbed stored vectors."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import hnsw_tpu.core.graph as jgraph
from hnsw_tpu.models import multivector as jmv
from hnsw_tpu.models.hnsw import HNSWIndex as JIndex

import hnsw_tpu_torch
from hnsw_tpu_torch.models import multivector as tmv
from hnsw_tpu_torch.models.hnsw import HNSWIndex
from hnsw_tpu_torch.native.hnsw_builder import NativeHNSWBuilder
from hnsw_tpu_torch.ops.gather_kernels import COUNTS

REPO = Path(__file__).resolve().parents[1]
D, M, EFC, B = 16, 8, 60, 16
N_FLOOD, N_DOCS, PER_DOC = 64, 17, 8
N = N_FLOOD + N_DOCS * PER_DOC  # 200
META = {"space": "l2", "dim": D, "m": M, "ef_construction": EFC}
# (epsilon, min_candidates, max_candidates): ladder widths reached
EPS_CASES = {
    "min1": (1.0, 1, 64),  # 64; query 0's beam is saturated at the bound
    "min8": (0.1, 8, 64),  # 64; most queries have fewer than 8 in range
    "widen": (1.0, 1, 128),  # 64 -> 128: query 0 saturates the first beam
    "to_n": (1e9, 1, 256),  # 64 -> 128 -> 256 >= N: ends at num_elements
}
K_DOCS, OVERSAMPLE = 16, 4  # 64 -> 128 -> 200 (= N) for query 0


def _dists(q, x) -> np.ndarray:
    return ((q[:, None, :].astype(np.float64) - x[None].astype(np.float64)) ** 2).sum(-1)


def _doc_map() -> np.ndarray:
    return np.concatenate([np.zeros(N_FLOOD, np.int64),
                           np.repeat(np.arange(1, N_DOCS + 1), PER_DOC)])


@pytest.fixture(scope="module")
def shared():
    rng = np.random.default_rng(952)
    flood = rng.normal(size=D).astype(np.float32)
    centers = rng.normal(size=(N_DOCS, D)).astype(np.float32)
    x = np.concatenate([
        flood + 0.05 * rng.normal(size=(N_FLOOD, D)).astype(np.float32),
        np.repeat(centers, PER_DOC, axis=0)
        + 0.1 * rng.normal(size=(N_DOCS * PER_DOC, D)).astype(np.float32),
    ])
    q = x[rng.integers(N_FLOOD, N, B)] + 0.05 * rng.normal(size=(B, D)).astype(np.float32)
    q[0] = flood
    full = _dists(q, x)
    for eps, _, _ in EPS_CASES.values():  # no distance on an epsilon's edge
        assert (np.abs(full - eps) > 1e-3 * eps).all()
    # the widening to N ranks every point: no two of a query's distances
    # (to the f32 rows, or to the bf16 rows the device tier reads) are
    # closer than 2e-6 relative, so f32 rounding cannot decide an order
    xb = torch.from_numpy(x).bfloat16().float().numpy()
    for f in (full, _dists(q, xb)):
        s = np.sort(f, axis=1)
        assert (np.diff(s, axis=1) > 2e-6 * s[:, 1:]).all()
    b = NativeHNSWBuilder(D, "l2", M, EFC, seed=123)
    b.add_batch(x, np.arange(N), n_threads=1)
    g, v, dl = b.export_graph(), b.export_vectors(), b.export_deleted()
    jg = jgraph.HNSWGraph(g.level0, g.upper, g.upper_slot, g.node_level,
                          g.labels, g.entry_point, g.max_level)
    j = JIndex._from_parts(jg, v, dl, META)
    j.inline_neighbors = True  # the CPU default is off; serve the unified tier
    j._device = None
    t = HNSWIndex._from_parts(g, v, dl, META, device="cpu")
    return {"x": x, "q": q, "full": full, "parts": (g, v, dl), "j": j, "t": t, "jax": {}}


def _with_docs(mod, index):
    """A MultiVectorIndex over `index` with the shared document map."""
    mv = mod.MultiVectorIndex("l2", index=index)
    mv._doc_arr = _doc_map()
    mv._docs = set(mv._doc_arr.tolist())
    mv._next_label = N
    return mv


def _jax(shared, key, fn):
    if key not in shared["jax"]:
        shared["jax"][key] = fn()
    return shared["jax"][key]


def _assert_same(got, want):
    """Labels, masks and dtypes exact; finite distances to 1e-5 relative,
    infinities where JAX has them."""
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, g.dtype, w.shape, w.dtype)
        if g.dtype.kind == "f":
            np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
            np.testing.assert_allclose(g[np.isfinite(g)], w[np.isfinite(w)], rtol=1e-5, atol=0)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("engine", ["device", "cpu"])
@pytest.mark.parametrize("case", list(EPS_CASES))
def test_epsilon_search_matches_jax(shared, case, engine):
    eps, min_c, max_c = EPS_CASES[case]
    q = shared["q"]
    want = _jax(shared, ("eps", case, engine), lambda: jmv.epsilon_search(
        shared["j"], q, eps, min_candidates=min_c, max_candidates=max_c, engine=engine))
    got = tmv.epsilon_search(shared["t"], q, eps, min_candidates=min_c,
                             max_candidates=max_c, engine=engine)
    _assert_same(got, want)
    d, lab, valid = got
    assert d.shape == (B, max_c)
    within = shared["full"][np.arange(B)[:, None], np.maximum(lab, 0)] <= eps
    assert (valid[:, min_c:] <= within[:, min_c:]).all()  # past min_c only in range
    assert (valid.sum(1) >= min(min_c, N)).all()
    if case == "widen":  # query 0's 64 flooding vectors plus none beyond them
        assert valid[0].sum() == N_FLOOD and valid[0, :N_FLOOD].all()
    if case == "to_n":  # every point is in range: all N found, the rest padding
        assert valid.sum(1).min() == N
        assert np.isinf(d[:, N:]).all() and (lab[:, N:] == -1).all()


@pytest.mark.parametrize("engine", ["device", "cpu"])
def test_multivector_search_matches_jax(shared, engine):
    """The flooding query widens 64 -> 128 -> 200 (the index's size) and
    still returns K_DOCS distinct documents, its own first."""
    q = shared["q"]
    want = _jax(shared, ("docs", engine), lambda: _with_docs(jmv, shared["j"]).search(
        q, k_docs=K_DOCS, oversample=OVERSAMPLE, engine=engine))
    got = _with_docs(tmv, shared["t"]).search(q, k_docs=K_DOCS, oversample=OVERSAMPLE,
                                              engine=engine)
    _assert_same(got, want)
    dd, docs = got
    assert docs[0, 0] == 0 and (docs >= 0).all()
    assert all(len(set(r)) == K_DOCS for r in docs.tolist())
    assert (np.diff(dd, axis=1) >= 0).all()


class _Recorder:
    """An index stub: records add_items calls, builds nothing."""

    dim = D

    def __init__(self):
        self.calls = []

    def add_items(self, vectors, labels):
        self.calls.append((vectors, labels))


def test_pow2_matches_jax():
    xs = list(range(-2, 2100)) + [2**20 - 1, 2**20, 2**20 + 1, 10**9]
    assert [tmv._pow2(v) for v in xs] == [jmv._pow2(v) for v in xs]


def test_aggregate_matches_jax():
    """Seeded beams with missing slots (label -1, or an infinite distance)
    and documents repeated within a row."""
    rng = np.random.default_rng(5)
    b, k, n_vec = 32, 48, 300
    dists = np.sort(rng.random((b, k)).astype(np.float32) * 10, axis=1)
    labels = rng.integers(0, n_vec, size=(b, k)).astype(np.int64)
    labels[rng.random((b, k)) < 0.1] = -1
    dists[rng.random((b, k)) < 0.1] = np.inf
    doc_arr = rng.integers(0, 40, size=n_vec).astype(np.int64)
    for k_docs in (1, 10, 60):
        out = []
        for mod in (tmv, jmv):
            mv = mod.MultiVectorIndex("l2", index=_Recorder())
            mv._doc_arr = doc_arr
            out.append(mv._aggregate(dists, labels, k_docs))
        for g, w in zip(*out):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_add_document_matches_jax():
    rng = np.random.default_rng(9)
    docs = [(7, rng.normal(size=(3, D))), (2, rng.normal(size=(1, D)).astype(np.float32)),
            (7, rng.normal(size=D)), (11, rng.normal(size=(5, D)).tolist())]
    got, want = (mod.MultiVectorIndex("l2", index=_Recorder()) for mod in (tmv, jmv))
    for doc_id, vecs in docs:
        got.add_document(doc_id, vecs)
        want.add_document(doc_id, vecs)
    assert got.num_docs == want.num_docs == 3
    assert got._docs == want._docs and got._next_label == want._next_label == 10
    np.testing.assert_array_equal(got._doc_arr, want._doc_arr)
    assert got._doc_arr.dtype == want._doc_arr.dtype
    assert len(got.index.calls) == len(want.index.calls) == 4
    for (gv, gl), (wv, wl) in zip(got.index.calls, want.index.calls):
        assert gv.dtype == wv.dtype == np.float32 and gv.shape == wv.shape
        np.testing.assert_array_equal(gv, wv)
        assert gl.dtype == wl.dtype
        np.testing.assert_array_equal(gl, wl)


def test_default_device_is_the_card():
    """The default index opens on the card and raises without one; the
    CPU only on request."""
    if torch.cuda.is_available():
        assert tmv.MultiVectorIndex("l2", dim=D).index.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cuda'"):
            tmv.MultiVectorIndex("l2", dim=D)
    mv = hnsw_tpu_torch.MultiVectorIndex("ip", dim=D, m=M, ef_construction=EFC, device="cpu")
    assert isinstance(mv.index, HNSWIndex) and mv.index.device == torch.device("cpu")
    assert (mv.index.space.name, mv.index.dim, mv.index.m, mv.index.ef_construction) == (
        "ip", D, M, EFC)
    assert mv.num_docs == 0 and mv.index.num_elements == 0
    assert hnsw_tpu_torch.epsilon_search is tmv.epsilon_search


def test_multivector_imports_no_jax():
    subprocess.run(
        [sys.executable, "-c",
         "import sys; from hnsw_tpu_torch import MultiVectorIndex, epsilon_search; "
         "import hnsw_tpu_torch.models, hnsw_tpu_torch.native; "
         "assert not [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
         "or m == 'hnsw_tpu' or m.startswith('hnsw_tpu.')], 'jax or hnsw_tpu imported'"],
        check=True, cwd=REPO, timeout=120,
    )


# ---------------------------------------------------------------------------
# On the card (cuda marker).
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_stop_conditions_on_cuda(shared):
    """On the card the ladders run the bf16 hop kernel and return the CPU
    port's answers (the same tier through its plain versions); against the
    native CPU engine (exact f32) the range sets are equal and each rank's
    document distance agrees within bf16's rounding of the stored rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    t = HNSWIndex._from_parts(*shared["parts"], META, device="cuda")
    q, x = shared["q"], shared["x"]
    COUNTS.reset()
    d, lab, valid = tmv.epsilon_search(t, q, 1e9, max_candidates=256)
    dd, docs = _with_docs(tmv, t).search(q, k_docs=K_DOCS, oversample=OVERSAMPLE)
    assert COUNTS.hop_dist_unified > 0 and COUNTS.plain_on_cuda == 0
    assert t._device.tier == "unified"
    _assert_same((d, lab, valid), tmv.epsilon_search(shared["t"], q, 1e9, max_candidates=256))
    _assert_same((dd, docs), _with_docs(tmv, shared["t"]).search(
        q, k_docs=K_DOCS, oversample=OVERSAMPLE))
    _, lab_c, valid_c = tmv.epsilon_search(t, q, 1e9, max_candidates=256, engine="cpu")
    assert all(set(a[va]) == set(c[vc]) for a, va, c, vc in zip(lab, valid, lab_c, valid_c))
    dd_c, _ = _with_docs(tmv, t).search(q, k_docs=K_DOCS, oversample=OVERSAMPLE, engine="cpu")
    # |d(q, x) - d(q, bf16(x))| <= 2 |q - x| |e| + |e|^2, |e| <= 2^-8 |x|
    e = 2.0**-8 * float(np.linalg.norm(x, axis=1).max())
    tol = 2 * np.sqrt(dd_c) * e + e * e + 1e-5 * dd_c
    assert (np.abs(dd - dd_c) <= tol).all()
