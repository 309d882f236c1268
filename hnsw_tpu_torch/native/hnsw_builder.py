"""numpy-friendly wrapper around the native C++ HNSW builder (port of
hnsw_tpu/native/hnsw_builder.py; numpy and ctypes only).

Host-side graph construction (insert / update / delete-mark) with export to
the padded-CSR HNSWGraph consumed by the device traversal. Also exposes the
single-core CPU search used as the bench baseline (reference semantics:
hnswlib/hnswalg.h searchKnn, hnsw_service/main.cpp:51-97 normal mode).
"""

from __future__ import annotations

import ctypes

import numpy as np

from hnsw_tpu_torch.core.graph import HNSWGraph
from hnsw_tpu_torch.native import load_builder_lib

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _ptr(a: np.ndarray, ty):
    return a.ctypes.data_as(ty)


class NativeHNSWBuilder:
    """Incremental HNSW graph builder backed by the native engine."""

    def __init__(
        self,
        dim: int,
        space: str = "l2",
        m: int = 16,
        ef_construction: int = 200,
        seed: int = 123,
    ):
        self.lib = load_builder_lib()
        self.dim = dim
        self.space = space
        self.m = m
        self.ef_construction = ef_construction
        space_id = {"l2": 0, "ip": 1}[space]
        self._h = ctypes.c_void_p(
            self.lib.hnsw_create(dim, space_id, m, ef_construction, seed)
        )

    @classmethod
    def from_graph(
        cls,
        g: "HNSWGraph",
        vectors: np.ndarray,
        deleted: np.ndarray | None = None,
        space: str = "l2",
        ef_construction: int = 200,
        seed: int = 123,
    ) -> "NativeHNSWBuilder":
        """Rebuild a live builder from a padded-CSR graph (checkpoint/resume,
        reference analog: hnswlib::loadIndex, hnswalg.h:716-822)."""
        n = g.num_nodes
        dim = vectors.shape[1]
        m = g.max_m if g.max_level > 0 else g.max_m0 // 2
        self = cls.__new__(cls)
        self.lib = load_builder_lib()
        self.dim = dim
        self.space = space
        self.m = m
        self.ef_construction = ef_construction

        v = np.ascontiguousarray(vectors, dtype=np.float32)
        labels = np.ascontiguousarray(g.labels, dtype=np.int64)
        node_level = np.ascontiguousarray(g.node_level, dtype=np.int32)
        if deleted is None:
            deleted = np.zeros(n, dtype=np.uint8)
        deleted = np.ascontiguousarray(deleted, dtype=np.uint8)
        level0 = np.ascontiguousarray(g.level0, dtype=np.int32)
        if level0.shape != (n, 2 * m):
            raise ValueError(f"level0 shape {level0.shape} != {(n, 2 * m)}")
        # flat upper links: per node, node_level[i] * m entries (-1 padded),
        # assembled one level at a time with a vectorized scatter (the
        # per-node loop here cost seconds at 1M — 62k upper nodes)
        lv64 = node_level.astype(np.int64)
        off = np.concatenate([[0], np.cumsum(lv64 * m)[:-1]])
        total = int((lv64 * m).sum())
        upper_flat = np.full(max(total, 1), -1, dtype=np.int32)
        mm = min(m, g.upper.shape[2]) if g.max_level > 0 else 0
        for l in range(1, g.max_level + 1):
            nodes = np.where(node_level >= l)[0]
            slots = g.upper_slot[l - 1, nodes]
            ok = slots >= 0
            nodes, slots = nodes[ok], slots[ok]
            if not len(nodes):
                continue
            rows = g.upper[l - 1][slots][:, :mm].astype(np.int32)
            starts = off[nodes] + (l - 1) * m
            upper_flat[starts[:, None] + np.arange(mm)] = rows
        upper_flat = np.ascontiguousarray(upper_flat)

        space_id = {"l2": 0, "ip": 1}[space]
        self._h = ctypes.c_void_p(
            self.lib.hnsw_import(
                dim, space_id, m, ef_construction, seed, n,
                _ptr(v, _F32P), _ptr(labels, _I64P), _ptr(node_level, _I32P),
                _ptr(deleted, _U8P), _ptr(level0, _I32P), _ptr(upper_flat, _I32P),
                g.max_level, g.entry_point,
            )
        )
        return self

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self.lib.hnsw_free(h)
            self._h = None

    # -- mutation -----------------------------------------------------------

    def add(self, vec: np.ndarray, label: int) -> None:
        v = np.ascontiguousarray(vec, dtype=np.float32).reshape(self.dim)
        self.lib.hnsw_add(self._h, _ptr(v, _F32P), label)

    def add_batch(
        self, vecs: np.ndarray, labels: np.ndarray, n_threads: int = 0
    ) -> None:
        """Bulk insert; n_threads=0 uses all host cores (concurrent inserts
        with per-node link locks, reference semantics hnswalg.h:43,255),
        n_threads=1 forces the serial deterministic path."""
        v = np.ascontiguousarray(vecs, dtype=np.float32).reshape(-1, self.dim)
        l = np.ascontiguousarray(labels, dtype=np.int64).reshape(-1)
        if v.shape[0] != l.shape[0]:
            raise ValueError("vecs and labels differ in length")
        self.lib.hnsw_add_batch(
            self._h, _ptr(v, _F32P), _ptr(l, _I64P), v.shape[0], n_threads
        )

    def add_with_level(self, vec: np.ndarray, label: int, level: int) -> None:
        v = np.ascontiguousarray(vec, dtype=np.float32).reshape(self.dim)
        self.lib.hnsw_add_with_level(self._h, _ptr(v, _F32P), label, level)

    def register_level0_batch(self, vecs: np.ndarray, labels: np.ndarray) -> int:
        """Register nodes at level 0 without linking; returns first id."""
        v = np.ascontiguousarray(vecs, dtype=np.float32).reshape(-1, self.dim)
        l = np.ascontiguousarray(labels, dtype=np.int64).reshape(-1)
        return int(
            self.lib.hnsw_register_level0_batch(
                self._h, _ptr(v, _F32P), _ptr(l, _I64P), v.shape[0]
            )
        )

    def connect_batch(self, ids: np.ndarray, selected: np.ndarray) -> None:
        """Apply pre-selected level-0 links (forward + reverse with
        overflow re-prune) for registered nodes."""
        ids = np.ascontiguousarray(ids, dtype=np.uint32).reshape(-1)
        sel = np.ascontiguousarray(selected, dtype=np.int32).reshape(len(ids), -1)
        self.lib.hnsw_connect_batch(
            self._h, ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            len(ids), _ptr(sel, _I32P), sel.shape[1],
        )

    def add_replace(self, vec: np.ndarray, label: int) -> bool:
        """Insert reusing a delete-marked slot when available
        (allow_replace_deleted semantics, hnswalg.h:954-961,879-921).
        Returns True if a deleted slot was reused."""
        v = np.ascontiguousarray(vec, dtype=np.float32).reshape(self.dim)
        return bool(self.lib.hnsw_add_replace(self._h, _ptr(v, _F32P), label))

    def clear(self) -> None:
        """clear() analog (hnswalg.h:149-161): drop all index content,
        keeping the configuration; the builder is immediately reusable."""
        self.lib.hnsw_clear(self._h)

    def mark_deleted(self, label: int) -> None:
        if self.lib.hnsw_mark_deleted(self._h, label) != 0:
            raise KeyError(f"label {label} not in index")

    def unmark_deleted(self, label: int) -> None:
        if self.lib.hnsw_unmark_deleted(self._h, label) != 0:
            raise KeyError(f"label {label} not in index")

    # -- introspection ------------------------------------------------------

    @property
    def size(self) -> int:
        return int(self.lib.hnsw_size(self._h))

    @property
    def max_level(self) -> int:
        return int(self.lib.hnsw_max_level(self._h))

    @property
    def entry_point(self) -> int:
        return int(self.lib.hnsw_entry_point(self._h))

    @property
    def num_deleted(self) -> int:
        return int(self.lib.hnsw_num_deleted(self._h))

    @property
    def capacity(self) -> int:
        """getMaxElements analog (hnswalg.h:213-215): currently allocated
        slot capacity. The builder auto-grows past it (the resizeIndex
        analog is the incremental device sync), so this is informational,
        not a hard limit."""
        return int(self.lib.hnsw_capacity(self._h))

    @property
    def index_file_size(self) -> int:
        """indexFileSize analog (hnswalg.h:658-683): byte size of the
        hnswlib binary save an equivalent index would produce."""
        return int(self.lib.hnsw_index_file_size(self._h))

    def get_data_by_label(self, label: int) -> np.ndarray:
        """getDataByLabel (hnswalg.h:826-851): stored vector for an external
        label; raises KeyError on an absent or delete-marked label, matching
        the reference's throw paths."""
        out = np.empty(self.dim, dtype=np.float32)
        if self.lib.hnsw_get_data_by_label(self._h, int(label), _ptr(out, _F32P)):
            raise KeyError(f"label {label} not found or marked deleted")
        return out

    # -- incremental sync (dirty-row deltas; resizeIndex analog) -------------

    @property
    def dirty_flags(self) -> int:
        """bit 0: upper levels/entry changed; bit 1: in-place vector update
        (caller must do a full device resync)."""
        return int(self.lib.hnsw_dirty_flags(self._h))

    def take_dirty(self) -> np.ndarray:
        """Ids whose level-0 rows changed since the last take/clear; clears
        all dirty state."""
        cnt = int(self.lib.hnsw_dirty_count(self._h))
        out = np.empty(cnt, dtype=np.int32)
        if cnt:
            self.lib.hnsw_take_dirty(self._h, _ptr(out, _I32P))
        else:
            self.lib.hnsw_clear_dirty(self._h)
        return out

    def clear_dirty(self) -> None:
        self.lib.hnsw_clear_dirty(self._h)

    def flush_updates(self) -> int:
        """Merge pending in-place vector updates' level-0 in-neighbors into
        the dirty-row list (their inline rows embed the stale vectors); call
        BEFORE take_dirty. Returns the pending update count."""
        return int(self.lib.hnsw_flush_updates(self._h))

    def take_vec_dirty(self, count: int) -> np.ndarray:
        """Ids whose vectors changed in place since the last take; clears the
        vec-dirty state. `count` comes from flush_updates()."""
        out = np.empty(count, dtype=np.int32)
        if count:
            self.lib.hnsw_take_vec_dirty(self._h, _ptr(out, _I32P))
        return out

    def export_vectors_rows(self, ids: np.ndarray) -> np.ndarray:
        ids = np.ascontiguousarray(ids, dtype=np.int32).reshape(-1)
        out = np.empty((len(ids), self.dim), dtype=np.float32)
        if len(ids):
            self.lib.hnsw_export_vectors_rows(
                self._h, _ptr(ids, _I32P), len(ids), _ptr(out, _F32P)
            )
        return out

    def export_level0_rows(self, ids: np.ndarray) -> np.ndarray:
        ids = np.ascontiguousarray(ids, dtype=np.int32).reshape(-1)
        max_m0 = int(self.lib.hnsw_max_m0(self._h))
        out = np.empty((len(ids), max_m0), dtype=np.int32)
        if len(ids):
            self.lib.hnsw_export_level0_rows(
                self._h, _ptr(ids, _I32P), len(ids), _ptr(out, _I32P)
            )
        return out

    def export_vectors_range(self, start: int, count: int) -> np.ndarray:
        out = np.empty((count, self.dim), dtype=np.float32)
        if count:
            self.lib.hnsw_export_vectors_range(
                self._h, start, count, _ptr(out, _F32P)
            )
        return out

    def export_labels_range(self, start: int, count: int) -> np.ndarray:
        out = np.empty(count, dtype=np.int64)
        if count:
            self.lib.hnsw_export_labels_range(
                self._h, start, count, _ptr(out, _I64P)
            )
        return out

    # -- export to padded-CSR -----------------------------------------------

    def export_vectors(self) -> np.ndarray:
        n = self.size
        out = np.empty((n, self.dim), dtype=np.float32)
        self.lib.hnsw_export_vectors(self._h, _ptr(out, _F32P))
        return out

    def export_deleted(self) -> np.ndarray:
        n = self.size
        out = np.empty(n, dtype=np.uint8)
        self.lib.hnsw_export_deleted(self._h, _ptr(out, _U8P))
        return out

    def export_graph(self) -> HNSWGraph:
        n = self.size
        max_m0 = int(self.lib.hnsw_max_m0(self._h))
        level0 = np.empty((n, max_m0), dtype=np.int32)
        self.lib.hnsw_export_level0(self._h, _ptr(level0, _I32P))
        node_level = np.empty(n, dtype=np.int32)
        self.lib.hnsw_export_levels(self._h, _ptr(node_level, _I32P))
        labels = np.empty(n, dtype=np.int64)
        self.lib.hnsw_export_labels(self._h, _ptr(labels, _I64P))

        ml = self.max_level
        if ml > 0:
            counts = [int(self.lib.hnsw_upper_count(self._h, l)) for l in range(1, ml + 1)]
            u_max = max(counts)
            upper = np.full((ml, u_max, self.m), -1, dtype=np.int32)
            upper_slot = np.full((ml, n), -1, dtype=np.int32)
            for l in range(1, ml + 1):
                c = counts[l - 1]
                ids = np.empty(c, dtype=np.int32)
                links = np.empty((c, self.m), dtype=np.int32)
                self.lib.hnsw_export_upper(
                    self._h, l, _ptr(ids, _I32P), _ptr(links, _I32P)
                )
                upper[l - 1, :c] = links
                upper_slot[l - 1, ids] = np.arange(c, dtype=np.int32)
        else:
            upper = np.zeros((0, 1, 1), dtype=np.int32)
            upper_slot = np.zeros((0, n), dtype=np.int32)

        return HNSWGraph(
            level0=level0,
            upper=upper,
            upper_slot=upper_slot,
            node_level=node_level,
            labels=labels,
            entry_point=self.entry_point,
            max_level=ml,
        )

    def export_adj(self, path: str) -> None:
        """Stream the reference-format `.adj` file straight from the native
        graph (index_builder/build.cpp:14-21) — one buffered C pass, <1s at
        1M vs ~27s for the numpy writer on this host."""
        rc = self.lib.hnsw_export_adj(self._h, path.encode())
        if rc != 0:
            raise OSError(f"adj export to {path!r} failed")

    # -- CPU search (baseline / parity) --------------------------------------

    def search(
        self,
        q: np.ndarray,
        k: int,
        ef: int,
        eligible: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """`eligible`: optional per-internal-id bool mask — the CPU parity
        oracle for the device filter path (BaseFilterFunctor semantics,
        hnswlib/hnswlib.h:128-132)."""
        qv = np.ascontiguousarray(q, dtype=np.float32).reshape(self.dim)
        out_l = np.full(k, -1, dtype=np.int64)
        out_d = np.full(k, np.inf, dtype=np.float32)
        if eligible is None:
            cnt = self.lib.hnsw_search(
                self._h, _ptr(qv, _F32P), k, ef, _ptr(out_l, _I64P), _ptr(out_d, _F32P)
            )
        else:
            el = np.ascontiguousarray(eligible, dtype=np.uint8).reshape(-1)
            if len(el) != self.size:
                raise ValueError("eligible mask length != index size")
            cnt = self.lib.hnsw_search_filtered(
                self._h, _ptr(qv, _F32P), k, ef, _ptr(el, _U8P),
                _ptr(out_l, _I64P), _ptr(out_d, _F32P),
            )
        return out_d[:cnt], out_l[:cnt]

    def search_batch(
        self,
        qs: np.ndarray,
        k: int,
        ef: int,
        eligible: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        q = np.ascontiguousarray(qs, dtype=np.float32).reshape(-1, self.dim)
        nq = q.shape[0]
        out_l = np.full((nq, k), -1, dtype=np.int64)
        out_d = np.full((nq, k), np.inf, dtype=np.float32)
        out_c = np.zeros(nq, dtype=np.int32)
        if eligible is None:
            self.lib.hnsw_search_batch(
                self._h, _ptr(q, _F32P), nq, k, ef,
                _ptr(out_l, _I64P), _ptr(out_d, _F32P), _ptr(out_c, _I32P),
            )
        else:
            el = np.ascontiguousarray(eligible, dtype=np.uint8).reshape(-1)
            if len(el) != self.size:
                raise ValueError("eligible mask length != index size")
            self.lib.hnsw_search_batch_filtered(
                self._h, _ptr(q, _F32P), nq, k, ef, _ptr(el, _U8P),
                _ptr(out_l, _I64P), _ptr(out_d, _F32P), _ptr(out_c, _I32P),
            )
        return out_d, out_l, out_c
