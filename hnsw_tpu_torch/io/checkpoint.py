"""Native checkpoint format: padded-CSR graph + vectors + metadata in one
.npz (port of hnsw_tpu/io/checkpoint.py with the same layout, so each
package loads the other's files). The analog of the reference's
saveIndex/loadIndex binary blobs (hnswlib/hnswalg.h:685-713, 716-822), but
array-shaped so a load is immediately device-uploadable. Integrity is
re-checked on load like the reference's corruption scan
(hnswalg.h:754-770).
"""

from __future__ import annotations

import json

import numpy as np

from hnsw_tpu_torch.core.graph import HNSWGraph

FORMAT_VERSION = 1


def save_checkpoint(
    path: str,
    g: HNSWGraph,
    vectors: np.ndarray,
    deleted: np.ndarray | None = None,
    meta: dict | None = None,
    compress: bool = True,
    include_vectors: bool = True,
) -> None:
    """`include_vectors=False` writes a graph-only checkpoint (vectors as an
    empty [n, 0] array): used by bulk_build's periodic elastic-recovery
    saves, where the vectors are deterministically reconstructible from the
    caller's input data and dominate the write (~512MB of ~900MB at 1M on a
    ~14MB/s disk)."""
    if not include_vectors:
        vectors = np.zeros((g.num_nodes, 0), dtype=np.float32)
    m = dict(meta or {})
    m["format_version"] = FORMAT_VERSION
    m["entry_point"] = int(g.entry_point)
    m["max_level"] = int(g.max_level)
    if deleted is None:
        deleted = np.zeros(g.num_nodes, dtype=np.uint8)
    # compress=False for large/periodic saves (mid-build elastic-recovery
    # checkpoints): zlib over ~1GB of float vectors costs minutes on one core
    (np.savez_compressed if compress else np.savez)(
        path,
        meta=np.frombuffer(json.dumps(m).encode(), dtype=np.uint8),
        level0=g.level0,
        upper=g.upper,
        upper_slot=g.upper_slot,
        node_level=g.node_level,
        labels=g.labels,
        vectors=np.asarray(vectors, dtype=np.float32),
        deleted=np.asarray(deleted, dtype=np.uint8),
    )


def load_checkpoint(path: str) -> tuple[HNSWGraph, np.ndarray, np.ndarray, dict]:
    z = np.load(path)
    meta = json.loads(bytes(z["meta"]).decode())
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError("unknown checkpoint version")
    g = HNSWGraph(
        level0=z["level0"],
        upper=z["upper"],
        upper_slot=z["upper_slot"],
        node_level=z["node_level"],
        labels=z["labels"],
        entry_point=meta["entry_point"],
        max_level=meta["max_level"],
    )
    vectors = z["vectors"]
    deleted = z["deleted"]
    n = g.num_nodes
    if not (vectors.shape[0] == deleted.shape[0] == g.node_level.shape[0]
            == g.labels.shape[0] == n):
        raise ValueError("corrupt checkpoint: array lengths differ")
    if n and not 0 <= g.entry_point < n:
        raise ValueError("corrupt checkpoint: entry point")
    if n and g.level0.max() >= n:
        raise ValueError("corrupt checkpoint: link out of range")
    return g, vectors, deleted, meta
