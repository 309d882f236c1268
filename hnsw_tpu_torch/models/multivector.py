"""Stop-condition searches: epsilon (range) search and multi-vector
document retrieval (counterpart of hnsw_tpu/models/multivector.py).

Reference capability surface (hnswlib/stop_condition.h):
- EpsilonSearchStopCondition (stop_condition.h:218-275): return points
  within `epsilon`, with at least `min_num_candidates` results (closest
  beyond epsilon included) and at most `max_num_candidates`.
- MultiVectorSearchStopCondition + MultiVectorL2Space/InnerProductSpace
  (stop_condition.h:18-215): every stored vector carries a document id;
  searchStopConditionClosest (hnswalg.h:1327-1378) returns the top-k
  *documents*, each scored by its closest vector.

Both run the fixed-ef batched beam and widen it adaptively: the
reference's heap search stops when the stop condition is satisfied; here
the batch is searched again with a doubled beam while any query is
saturated. The beam widths follow a power-of-two ladder, the same widths
as the JAX package's, so both return the same points. Aggregation is a
dense vectorized reduce (argsort + first-occurrence masks) on the host,
not a per-query loop.
"""

from __future__ import annotations

import numpy as np

from hnsw_tpu_torch.core.spaces import Space, get_space
from hnsw_tpu_torch.models.hnsw import HNSWIndex


def _pow2(x: int) -> int:
    """Round a beam size up to a power of two: the widening ladder visits
    O(log N) beam widths."""
    return 1 << (max(int(x), 1) - 1).bit_length()


def _beam_search(index, queries, k, ef, engine):
    """One widening step: the device batched beam, or the native CPU heap
    engine (`engine="cpu"`, search_cpu), the parity oracle for every
    stop-condition search (the reference runs stop conditions on the CPU
    engine, hnswalg.h:1327-1378)."""
    if engine == "cpu":
        d, l, _ = index.search_cpu(queries, k=k, ef=ef)
        return np.asarray(d), np.asarray(l)
    return index.search(queries, k=k, ef=ef)


def epsilon_search(
    index: HNSWIndex,
    queries: np.ndarray,
    epsilon: float,
    min_candidates: int = 1,
    max_candidates: int = 64,
    ef: int = 0,
    engine: str = "device",
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Range search → (dists [B, max_candidates], labels, valid mask).

    Semantics of EpsilonSearchStopCondition (stop_condition.h:218-275):
    every returned point is either within epsilon (the space's raw
    distance: squared L2, 1 - <q, x> for ip and cosine) or among the
    min_candidates closest overall; at most max_candidates per query;
    padding slots have valid=False, label -1 and distance inf.

    `max_candidates` is an independent bound, not a beam clamp: the beam
    starts small and doubles while any query's beam is saturated with
    within-epsilon points (more may exist beyond it), up to max_candidates
    or the index's size.

    `index` is anything with the `.search(queries, k=, ef=)` /
    `.search_cpu` surface and a `num_elements` property.
    """
    assert min_candidates <= max_candidates
    n = index.num_elements
    beam = _pow2(
        min(
            max(ef, min_candidates, min(max_candidates, 64)),
            max(max_candidates, min_candidates),
        )
    )
    while True:
        # search at the full (power-of-two) beam width; the view below
        # truncates to the semantic bound
        dists, labels = _beam_search(index, queries, beam, beam, engine)
        k_cur = min(beam, max_candidates)
        dists, labels = dists[:, :k_cur], labels[:, :k_cur]
        within = dists <= epsilon
        # saturated: every returned slot is a real within-epsilon point, so
        # the bound, not the data, decided the count; widen if allowed
        saturated = np.all(within & (labels >= 0), axis=1)
        if beam >= max_candidates or beam >= n or not saturated.any():
            break
        beam = _pow2(beam * 2)
    if dists.shape[1] < max_candidates:
        pad = max_candidates - dists.shape[1]
        dists = np.concatenate(
            [dists, np.full((len(dists), pad), np.inf, np.float32)], axis=1
        )
        labels = np.concatenate(
            [labels, np.full((len(labels), pad), -1, np.int64)], axis=1
        )
    rank = np.arange(max_candidates)[None, :]
    valid = ((dists <= epsilon) | (rank < min_candidates)) & (labels >= 0)
    labels = np.where(valid, labels, -1)
    dists = np.where(valid, dists, np.inf)
    return dists, labels, valid


class MultiVectorIndex:
    """Document retrieval over multi-vector documents.

    Each added vector belongs to a document; `search` returns the top-k
    documents scored by their closest vector (MultiVectorSearchStopCondition
    semantics, stop_condition.h:146-215). The reference carries the doc id
    inside the datapoint via MultiVectorL2Space/IPSpace (18-143); here the
    vector -> doc mapping is a side array and aggregation is a dense reduce.
    """

    def __init__(
        self,
        space: Space | str,
        dim: int | None = None,
        m: int = 16,
        ef_construction: int = 200,
        seed: int = 123,
        index=None,
        device="cuda",
    ):
        """`index` replaces the default HNSWIndex with any index exposing
        `.add_items(vectors, labels)` / `.search(q, k=, ef=)` /
        `.search_cpu` / `.num_elements` / `.dim`. Without it an HNSWIndex
        is built on `device` (a card unless the caller asks for the CPU;
        without one the default raises)."""
        if index is not None:
            self.index = index
        else:
            if isinstance(space, str):
                space = get_space(space, dim)
            self.index = HNSWIndex(
                space, m=m, ef_construction=ef_construction, seed=seed,
                device=device,
            )
        self._doc_arr = np.empty(0, dtype=np.int64)  # vector label -> doc id
        self._docs: set[int] = set()
        self._next_label = 0

    def add_document(self, doc_id: int, vectors: np.ndarray) -> None:
        vectors = np.asarray(vectors, dtype=np.float32).reshape(-1, self.index.dim)
        labels = np.arange(self._next_label, self._next_label + len(vectors))
        self._next_label += len(vectors)
        self._doc_arr = np.concatenate(
            [self._doc_arr, np.full(len(vectors), doc_id, np.int64)]
        )
        self._docs.add(doc_id)
        self.index.add_items(vectors, labels)

    @property
    def num_docs(self) -> int:
        return len(self._docs)

    def _aggregate(
        self, dists: np.ndarray, labels: np.ndarray, k_docs: int
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized per-document min-reduce: beam rows are distance-sorted,
        so a stable sort by doc id keeps each doc's closest vector first;
        the first-occurrence mask selects it. Returns (doc_dists, doc_ids,
        distinct count per query)."""
        valid = (labels >= 0) & np.isfinite(dists)
        docs = np.where(valid, self._doc_arr[np.maximum(labels, 0)], np.int64(2**62))
        order = np.argsort(docs, axis=1, kind="stable")
        s_docs = np.take_along_axis(docs, order, axis=1)
        s_d = np.take_along_axis(np.where(valid, dists, np.inf), order, axis=1)
        first = np.ones_like(s_docs, dtype=bool)
        first[:, 1:] = s_docs[:, 1:] != s_docs[:, :-1]
        first &= s_docs < 2**62
        key = np.where(first, s_d, np.inf)
        sel = np.argsort(key, axis=1, kind="stable")[:, :k_docs]
        out_d = np.take_along_axis(key, sel, axis=1).astype(np.float32)
        out_doc = np.where(
            np.isfinite(out_d), np.take_along_axis(s_docs, sel, axis=1), -1
        )
        return out_d, out_doc, first.sum(axis=1)

    def search(
        self, queries: np.ndarray, k_docs: int = 10, ef: int = 0,
        oversample: int = 4, engine: str = "device",
    ) -> tuple[np.ndarray, np.ndarray]:
        """→ (doc_dists [B, k_docs], doc_ids [B, k_docs]; -1 = missing).

        Matches searchStopConditionClosest's guarantee (hnswalg.h:1327-1378):
        the beam widens until k_docs *distinct* documents are found per query
        (or the index is exhausted), so a document flooding the beam with its
        own vectors cannot starve the result of other documents.
        """
        n_vec = self.index.num_elements
        # power-of-two widening ladder, capped at the index's size
        k_vec = min(
            _pow2(max(k_docs * oversample, k_docs)), max(n_vec, 1)
        )
        while True:
            ef_cur = max(ef, k_vec)
            dists, labels = _beam_search(
                self.index, queries, k_vec, ef_cur, engine
            )
            out_d, out_doc, distinct = self._aggregate(dists, labels, k_docs)
            want = min(k_docs, self.num_docs)
            if k_vec >= n_vec or np.all(distinct >= want):
                return out_d, out_doc
            k_vec = min(_pow2(k_vec * 2), n_vec)
