"""Carry the JAX package's state across to the port, from numpy arrays only
(this module imports no jax).

- `index_from_parts` builds the port's index from what the JAX index
  exports: ``export_graph()``, ``export_vectors()``, ``export_deleted()``
  of its builder and its checkpoint meta dict.
- `unified_from_jax_rows` decodes a JAX unified node-block table
  (``[R*s_data, 128]`` int32, hnsw_tpu/ops/pallas_gather.py:298-336) into
  the port's two-tensor layout.
"""

from __future__ import annotations

import numpy as np
import torch

from hnsw_tpu_torch.core.graph import HNSWGraph, round_up
from hnsw_tpu_torch.models.hnsw import HNSWIndex
from hnsw_tpu_torch.ops.gather_kernels import UnifiedTable


def index_from_parts(
    graph: HNSWGraph, vectors: np.ndarray, deleted: np.ndarray | None,
    meta: dict, device="cuda",
) -> HNSWIndex:
    """The port's HNSWIndex over the same graph, internal vectors, delete
    marks and meta (keys space, dim, m, ef_construction)."""
    g = HNSWGraph(
        level0=np.asarray(graph.level0), upper=np.asarray(graph.upper),
        upper_slot=np.asarray(graph.upper_slot),
        node_level=np.asarray(graph.node_level), labels=np.asarray(graph.labels),
        entry_point=int(graph.entry_point), max_level=int(graph.max_level),
    )
    return HNSWIndex._from_parts(g, vectors, deleted, meta, device=device)


def unified_from_jax_rows(rows_int32: np.ndarray, m0: int, d: int) -> UnifiedTable:
    """Decode a JAX unified table into the port's layout (on the CPU).

    Each node block is s_data = m0*d_pad_j/256 + 1 sublanes of 128 int32
    lanes, d_pad_j = d rounded up to 128. With `flat` the block's
    [m0*d_pad_j] bf16 values, sublane s < s_data-1 holds flat[s*256 + l] in
    the low 16 bits of lane l and flat[s*256 + 128 + l] in the high 16 bits;
    the last sublane holds the m0 payload ids in lanes 0..m0-1."""
    d_pad_j = round_up(d, 128)
    sv = m0 * d_pad_j // 256
    rows = np.asarray(rows_int32, dtype=np.int32).reshape(-1, sv + 1, 128)
    bits = rows[:, :sv, :].view(np.uint32)
    halves = np.stack([bits & 0xFFFF, bits >> 16], axis=2)  # [R, sv, 2, 128]
    flat = halves.astype(np.uint16).reshape(rows.shape[0], m0, d_pad_j)
    vec_bits = np.zeros((rows.shape[0], m0, round_up(d, 8)), np.uint16)
    vec_bits[:, :, :d] = flat[:, :, :d]
    vecs = torch.from_numpy(vec_bits.view(np.int16)).view(torch.bfloat16)
    payload = torch.from_numpy(np.ascontiguousarray(rows[:, sv, :m0]))
    return UnifiedTable(vecs, payload)
