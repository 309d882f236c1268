"""numpy-friendly wrapper over the native vector store (port of
hnsw_tpu/native/vecstore.py; reference analog: RocksDBStore,
storage_service/rocksdb_store.{h,cpp}).

The store is the reference's unchanged ``hnsw_tpu/native/vecstore.cpp``,
compiled by path into ``hnsw_tpu_torch/_build/libvecstore.so``, so a store
written by either package opens in the other."""

from __future__ import annotations

import ctypes

import numpy as np

from hnsw_tpu_torch.native import load_vecstore_lib

__all__ = ["VectorStore", "load_vecstore_lib"]

_F32P = ctypes.POINTER(ctypes.c_float)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_U8P = ctypes.POINTER(ctypes.c_uint8)


class VectorStore:
    def __init__(self, path: str):
        self.lib = load_vecstore_lib()
        self._h = ctypes.c_void_p(self.lib.vs_open(path.encode()))
        if not self._h:
            raise IOError(f"cannot open vector store at {path}")

    def close(self):
        if getattr(self, "_h", None):
            self.lib.vs_close(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def put(self, vec_id: int, vec: np.ndarray) -> None:
        v = np.ascontiguousarray(vec, dtype=np.float32).ravel()
        if self.lib.vs_put(self._h, vec_id, v.size, v.ctypes.data_as(_F32P)) != 0:
            raise IOError("vs_put failed")

    def put_batch(self, ids: np.ndarray, vecs: np.ndarray) -> None:
        vecs = np.ascontiguousarray(vecs, dtype=np.float32)
        for i, vid in enumerate(np.asarray(ids, dtype=np.uint32)):
            self.put(int(vid), vecs[i])
        self.flush()

    def flush(self) -> None:
        self.lib.vs_flush(self._h)

    def get(self, vec_id: int, dim_hint: int = 4096) -> np.ndarray | None:
        out = np.empty(dim_hint, dtype=np.float32)
        d = self.lib.vs_get(self._h, vec_id, out.ctypes.data_as(_F32P), out.size)
        if d < 0:
            return None
        return out[:d].copy()

    def batch_get(self, ids: np.ndarray, dim: int) -> tuple[np.ndarray, np.ndarray]:
        """→ (vecs [n, dim], found [n] bool); missing rows are zero."""
        ids = np.ascontiguousarray(ids, dtype=np.uint32)
        out = np.empty((ids.size, dim), dtype=np.float32)
        found = np.empty(ids.size, dtype=np.uint8)
        self.lib.vs_batch_get(
            self._h,
            ids.ctypes.data_as(_U32P),
            ids.size,
            dim,
            out.ctypes.data_as(_F32P),
            found.ctypes.data_as(_U8P),
        )
        return out, found.astype(bool)

    @property
    def count(self) -> int:
        return int(self.lib.vs_count(self._h))

    def ids(self) -> np.ndarray:
        n = self.count
        out = np.empty(n, dtype=np.uint32)
        if n:
            self.lib.vs_ids(self._h, out.ctypes.data_as(_U32P))
        return out
