"""Port parity, the stop-condition searches over the sharded index:
`stop_fn`, epsilon_search and MultiVectorIndex(index=ShardedHNSWIndex(...))
against the same calls over the JAX package's ShardedHNSWIndex
(tests/test_sharded_stop.py) on one shard set.

Light by design: 320 documents of 5 vectors (N=1,600 in 8 shards of 200,
d=16, M=8, efC=100) go into the port's sharded index through
MultiVectorIndex.add_document, which reaches its add_items (inserts on one
thread: add_batch patched to n_threads=1); the set is saved and loaded into
the JAX index on conftest's 8 virtual CPU devices, which serves plain
gathers there, as the port's index does here. One label is
delete-marked in the set, so every JAX search runs its masked program: one
compile for the stop_fn search, one for the (k=32, ef=32) beam that the
range search and the document search both reach."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from jax.sharding import Mesh

from hnsw_tpu.models import multivector as jmv
from hnsw_tpu.parallel import sharding as jsh

import hnsw_tpu_torch.native.hnsw_builder as tnative
from hnsw_tpu_torch.models import multivector as tmv
from hnsw_tpu_torch.parallel.sharding import ShardedHNSWIndex

S, N, D, M, EFC, B, K, EF = 8, 1600, 16, 8, 100, 16, 10, 48
N_DOCS, PER_DOC, K_DOCS = 320, 5, 5  # K_DOCS * 4 = a first beam of 32
EPS_MIN, EPS_MAX = 2, 32  # a range search of one beam of 32
NOISE = 0.5  # queries this far off a stored vector: 1e-5 relative applies
DEAD = 1598  # delete-marked in the set


def _d2(q, x):
    return ((q[:, None, :].astype(np.float64) - x[None].astype(np.float64)) ** 2).sum(-1)


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    rng = np.random.default_rng(4142)
    x = rng.normal(size=(N, D)).astype(np.float32)
    q = x[rng.integers(0, N, B)] + NOISE * rng.normal(size=(B, D)).astype(np.float32)
    # no two of a query's nearest EPS_MAX + 1 distances, within a shard or
    # over all, lie within 2e-6 relative: f32 sums could order them apart
    full = _d2(q, x)
    for cols in [np.arange(i, N, S) for i in range(S)] + [np.arange(N)]:
        s = np.sort(full[:, cols], axis=1)[:, :EPS_MAX + 1]
        assert (np.diff(s, axis=1) > 2e-6 * s[:, 1:]).all()
    with pytest.MonkeyPatch.context() as mp:
        add = tnative.NativeHNSWBuilder.add_batch
        mp.setattr(tnative.NativeHNSWBuilder, "add_batch",
                   lambda self, v, l, n_threads=0: add(self, v, l, n_threads=1))
        mv = tmv.MultiVectorIndex(
            "l2", D, index=ShardedHNSWIndex("l2", D, num_shards=S, m=M,
                                            ef_construction=EFC, device="cpu",
                                            inline_neighbors=False))
        for doc in range(N_DOCS):
            mv.add_document(doc, x[doc * PER_DOC:(doc + 1) * PER_DOC])
    mv.index.mark_deleted(DEAD)
    prefix = str(tmp_path_factory.mktemp("sharded_stop") / "set")
    mv.index.save(prefix)
    j = jsh.ShardedHNSWIndex("l2", D, mesh=Mesh(np.array(jax.devices()), ("shard",)),
                             m=M, ef_construction=EFC)
    j.load(prefix)
    return {"x": x, "q": q, "mv": mv, "t": mv.index, "j": j}


def _assert_same(got, want):
    """Labels (or documents) exact; finite distances to 1e-5 relative."""
    (gd, gl), (wd, wl) = got, want
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_array_equal(np.isfinite(gd), np.isfinite(wd))
    np.testing.assert_allclose(gd[np.isfinite(gd)], wd[np.isfinite(wd)], rtol=1e-5, atol=0)


def _stop_after_5_jax(view):
    return jnp.broadcast_to(view.it >= 5, view.beam_d.shape[:1])


def _stop_after_5(view):
    return torch.full(view.beam_d.shape[:1], view.it >= 5, dtype=torch.bool,
                      device=view.beam_d.device)


def test_add_document_reaches_add_items(shared):
    """add_document's add_items routes label j to shard j % S, as build
    partitions; the set holds every vector once."""
    t = shared["t"]
    assert shared["mv"].num_docs == N_DOCS and t.num_elements == N
    for i, labs in enumerate(t._shard_labels):
        np.testing.assert_array_equal(labs, np.arange(i, N, S))
    for a, b in zip(t._shard_labels, shared["j"]._shard_labels):
        np.testing.assert_array_equal(a, b)


def test_stop_fn_matches_jax(shared):
    """The custom stop condition reaches every shard-local beam: the port's
    torch view and JAX's, stopped after 5 iterations, give the same
    answers, a valid prefix of the full search's."""
    q, t = shared["q"], shared["t"]
    want = shared["j"].search(q, k=K, ef=EF, stop_fn=_stop_after_5_jax)
    got = t.search(q, k=K, ef=EF, stop_fn=_stop_after_5)
    _assert_same(got, want)
    _, full = t.search(q, k=K, ef=EF)
    assert np.mean(full[:, 0] == got[1][:, 0]) >= 0.9


def test_epsilon_search_matches_jax(shared):
    """test_sharded_epsilon_parity's call on both packages: the same
    (dists, labels, valid), each valid point within epsilon or among the 2
    closest, and high overlap with the exact in-range sets."""
    q, x = shared["q"], shared["x"]
    full = _d2(q, x)
    full[:, DEAD] = np.inf
    eps = float(np.percentile(full.min(axis=1), 90) * 4)
    d, lab, valid = tmv.epsilon_search(shared["t"], q, epsilon=eps,
                                       min_candidates=EPS_MIN, max_candidates=EPS_MAX)
    jd, jl, jv = jmv.epsilon_search(shared["j"], q, epsilon=eps,
                                    min_candidates=EPS_MIN, max_candidates=EPS_MAX)
    _assert_same((d, lab), (np.asarray(jd), np.asarray(jl)))
    np.testing.assert_array_equal(valid, jv)
    assert d.shape == valid.shape == (B, EPS_MAX)
    assert np.all(~valid | (d <= eps) | (np.arange(EPS_MAX)[None, :] < EPS_MIN))
    hits = total = 0
    for i in range(B):
        exact = set(np.argsort(full[i])[:EPS_MAX].tolist()) & set(np.flatnonzero(full[i] <= eps).tolist())
        hits += len(exact & set(lab[i][valid[i]].tolist()))
        total += len(exact)
    assert total > 0 and hits / total >= 0.9


def test_multivector_matches_jax(shared):
    """test_sharded_multivector_matches_single_chip's documents, the port's
    built through add_document: the same top documents and scores as JAX's
    MultiVectorIndex over its sharded index, each score its document's
    exact closest-vector distance for almost every entry."""
    q, x, mv = shared["q"], shared["x"], shared["mv"]
    jm = jmv.MultiVectorIndex("l2", D, index=shared["j"])
    jm._doc_arr = mv._doc_arr.copy()
    jm._docs = set(mv._docs)
    jm._next_label = mv._next_label
    dd, docs = mv.search(q, k_docs=K_DOCS)
    jd, jdocs = jm.search(q, k_docs=K_DOCS)
    _assert_same((dd, docs), (np.asarray(jd), np.asarray(jdocs)))
    full = _d2(q, x)
    full[:, DEAD] = np.inf
    exact = full.reshape(B, N_DOCS, PER_DOC).min(-1)
    ref = exact[np.arange(B)[:, None], docs]
    assert (docs >= 0).all() and (dd >= ref - 1e-4).all()
    assert np.mean(np.abs(dd - ref) <= 1e-3 * np.maximum(ref, 1e-6)) >= 0.95
