"""Carry the JAX package's state across to the port, from numpy arrays only
(this module imports no jax).

- `index_from_parts` builds the port's index from what the JAX index
  exports: ``export_graph()``, ``export_vectors()``, ``export_deleted()``
  of its builder and its checkpoint meta dict.
- `unified_from_jax_rows`, `unified8_from_jax_rows` and
  `unified4_from_jax_rows` decode the JAX unified node-block tables
  (``[R*s_data, 128]`` int32: bf16, int8 and int4 rows of
  hnsw_tpu/ops/pallas_gather.py) into the port's layouts.
- `split_from_jax` decodes the JAX split tier (the lane-padded neighbor
  vectors and the tiled adjacency) into the port's table and level0.
"""

from __future__ import annotations

import numpy as np
import torch

from hnsw_tpu_torch.core.graph import HNSWGraph, round_up
from hnsw_tpu_torch.models.hnsw import HNSWIndex
from hnsw_tpu_torch.ops.gather_kernels import (
    Unified4Table,
    Unified8Table,
    UnifiedTable,
    pack_int4,
)


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


def _quant_table(rows: np.ndarray, sv: int, m0: int, d: int, codes_flat):
    """Shared tail of the int8 and int4 decoders: `codes_flat(words)` maps
    the [R, sv, 128] code words to [R, m0*d_pad_j] int8 codes; the last
    sublane holds the ids in lanes 0..m0-1 and the f32 scale bits in lanes
    m0..2*m0-1. Returns (codes [R, m0, d_pad] int8, scales, payload)."""
    rows = np.asarray(rows, dtype=np.int32).reshape(-1, sv + 1, 128)
    r = rows.shape[0]
    flat = codes_flat(rows[:, :sv, :]).reshape(r, m0, -1)
    codes = np.zeros((r, m0, round_up(d, 8)), np.int8)
    codes[:, :, :d] = flat[:, :, :d]
    scales = np.ascontiguousarray(rows[:, sv, m0 : 2 * m0]).view(np.float32)
    payload = np.ascontiguousarray(rows[:, sv, :m0])
    return torch.from_numpy(codes), torch.from_numpy(scales), torch.from_numpy(payload)


def unified8_from_jax_rows(rows_int32: np.ndarray, m0: int, d: int) -> Unified8Table:
    """Decode a JAX int8 unified table (pack_unified8_rows): a block is
    sv8 = m0*d_pad_j/512 code sublanes plus the id and scale sublane, and
    byte t of the int32 at (sublane s, lane l) is flat code s*512 + t*128 + l."""
    sv8 = m0 * round_up(d, 128) // 512

    def codes_flat(words):  # [R, sv8, 128] int32 -> bytes [R, sv8, 128, 4]
        b = np.ascontiguousarray(words).view(np.int8).reshape(*words.shape, 4)
        return b.transpose(0, 1, 3, 2)

    return Unified8Table(*_quant_table(rows_int32, sv8, m0, d, codes_flat))


def unified4_from_jax_rows(rows_int32: np.ndarray, m0: int, d: int) -> Unified4Table:
    """Decode a JAX int4 unified table (pack_unified4_rows): nibble j of the
    int32 at (sublane i, lane l) of the sv4 = m0*d_pad_j/1024 code sublanes
    is flat code (j*sv4 + i)*128 + l, sign-extended; the codes are repacked
    in the port's nibble order."""
    sv4 = m0 * round_up(d, 128) // 1024

    def codes_flat(words):  # -> [R, 8, sv4, 128]
        nib = [(words << (28 - 4 * j)) >> 28 for j in range(8)]
        return np.stack(nib, axis=1).astype(np.int8)

    codes, scales, payload = _quant_table(rows_int32, sv4, m0, d, codes_flat)
    return Unified4Table(pack_int4(codes), scales, payload)


def split_from_jax(
    nbr_vectors: np.ndarray, level0_tiles: np.ndarray, m0: int, d: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode the JAX split tier into the port's (nbr_vectors [N_pad, m0,
    d_pad] bf16, level0 [N_pad, m0] int32).

    `nbr_vectors` is the JAX table [N_pad, m0, d_pad_j] as bf16 BITS (a
    uint16 or int16 view; numpy has no bf16), lanes padded to 128: the pad
    lanes past d rounded up to 8 are dropped. `level0_tiles` [T, 8, 128]
    int32 is the inverse of make_level0_tiles: node n's ids live in tile
    n // 32, sublane (n % 32) // 4, lanes (n % 4) * 32 onward, which is row n
    of the tiles read as [T * 32, 32]."""
    bits = np.asarray(nbr_vectors).view(np.int16)
    n_pad = bits.shape[0]
    vecs = bits[:, :, : round_up(d, 8)].copy()
    rows = np.asarray(level0_tiles, dtype=np.int32).reshape(-1, 32)
    level0 = rows[:n_pad, :m0].copy()
    return (torch.from_numpy(vecs).view(torch.bfloat16), torch.from_numpy(level0))
