"""Node-block tables and the two CUDA kernels of the query path
(counterpart of hnsw_tpu/ops/pallas_gather.py).

- The unified node-block table: for every node, the bf16 vectors of its m0
  level-0 neighbors and their ids, so one expansion reads one contiguous
  block. The TPU packs a block into int32 sublanes (bf16 pairs plus an id
  sublane); here a table is two tensors, ``vecs [R, m0, d_pad]`` bf16 and
  ``payload [R, m0]`` int32, holding the same bf16 values in the same
  neighbor order. d is padded to a multiple of 8 (16-byte rows); zero lanes
  change neither L2 nor IP. The upper-level descent tables use the same
  layout with neighbor *slots* as the payload.
- ``hop_dist_unified``: distances from each query to the neighbors of its
  chosen nodes, read from a unified table (csrc/hop_dist_unified.cu).
- ``gather_dist_rows``: distances from each query to K rows of an f32
  vector table, the exact rescore (csrc/gather_dist.cu).

Each kernel wrapper takes its plain PyTorch version for CPU tensors only;
for CUDA tensors it launches the kernel or raises. ``COUNTS`` records every
launch, and every call of a plain version on a CUDA tensor, so a run can
show which path it took.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from hnsw_tpu_torch.core.graph import round_up
from hnsw_tpu_torch.ops.distance import gather_dist


@dataclasses.dataclass
class KernelCounts:
    """Launch counts of the CUDA kernels, and calls of their plain versions
    on CUDA tensors (chip_smoke.py holds the main path to zero of those)."""

    hop_dist_unified: int = 0
    gather_dist_rows: int = 0
    plain_on_cuda: int = 0

    def reset(self) -> None:
        self.hop_dist_unified = self.gather_dist_rows = self.plain_on_cuda = 0


COUNTS = KernelCounts()


def _check_space(space: str) -> None:
    if space not in ("l2", "ip"):
        raise ValueError(f"unknown space {space!r} (expected 'l2' or 'ip')")


# ---------------------------------------------------------------------------
# Unified node-block tables.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class UnifiedTable:
    """Node blocks: row r holds m0 neighbor vectors and their payload ids."""

    vecs: torch.Tensor  # [R, m0, d_pad] bf16
    payload: torch.Tensor  # [R, m0] int32

    @property
    def rows(self) -> int:
        return self.vecs.shape[0]

    @property
    def m0(self) -> int:
        return self.vecs.shape[1]

    @property
    def d_pad(self) -> int:
        return self.vecs.shape[2]

    @property
    def nbytes(self) -> int:
        return self.vecs.nbytes + self.payload.nbytes


def unified_table_bytes(rows: int, m0: int, d: int) -> int:
    """Device bytes of a unified table with `rows` node blocks."""
    return rows * m0 * (round_up(d, 8) * 2 + 4)


def _bf16_padded(vectors: torch.Tensor) -> torch.Tensor:
    """f32 [N, d] -> bf16 [N, d_pad]: rounded to bf16 BEFORE any gather (as
    pallas_gather.py:327 does), zero lanes up to a multiple of 8."""
    d = vectors.shape[1]
    xb = vectors.to(torch.bfloat16)
    return F.pad(xb, (0, round_up(d, 8) - d)).contiguous()


def _gather_blocks(xb: torch.Tensor, nbrs: torch.Tensor, chunk: int) -> torch.Tensor:
    """[R, m] neighbor ids -> [R, m, d_pad] bf16 rows, written chunk by
    chunk straight into the output (no transient copy of the table)."""
    r, m = nbrs.shape
    out = torch.empty((r, m, xb.shape[1]), dtype=xb.dtype, device=xb.device)
    flat_out = out.view(r * m, xb.shape[1])
    for s in range(0, r, chunk):
        e = min(s + chunk, r)
        torch.index_select(
            xb, 0, nbrs[s:e].reshape(-1).long(), out=flat_out[s * m : e * m]
        )
    return out


def make_unified_table_chunked(
    vectors: torch.Tensor, level0: torch.Tensor, chunk: int = 1 << 14
) -> UnifiedTable:
    """Level-0 unified table from the [N_pad, D] vector table and the
    sentinel-remapped [N_pad, m0] adjacency: row n holds the neighbors of
    node n. Built in row chunks so peak memory is the table plus the bf16
    copy of the vectors."""
    xb = _bf16_padded(vectors)
    return UnifiedTable(_gather_blocks(xb, level0, chunk), level0.contiguous())


def upper_level_sizes_u(upper_slot: torch.Tensor, u_pad: int) -> tuple[int, ...]:
    """Per-level count of real slots (< u_pad - 1) in the [L, N_pad] slot
    map: each level's descent table is sized to its own population."""
    if upper_slot.shape[0] == 0:
        return ()
    real = torch.where(upper_slot == u_pad - 1, -1, upper_slot)
    return tuple(int(v) + 1 for v in real.max(dim=1).values.tolist())


def make_upper_tables(
    vectors: torch.Tensor, upper: torch.Tensor, upper_slot: torch.Tensor,
    level_sizes=None,
) -> tuple[tuple[UnifiedTable, torch.Tensor], ...]:
    """Per-upper-level unified tables for the greedy descent.

    For level l (1-indexed), row `slot` holds that slot's node's M neighbor
    vectors (M padded to a multiple of 16 with the sentinel) and, as the
    payload, the neighbors' slots at the same level, so the descent never
    reads upper_slot mid-level. Returns ((table_l, slot_to_id_l [U_l]), ...).
    With `level_sizes` each level is sized to its population + a dummy row;
    slot values >= the local size clamp onto the local dummy row, whose
    content (all-sentinel links) is the global dummy row's."""
    ml, u_pad, m = upper.shape
    n_pad = upper_slot.shape[1]
    sent = n_pad - 1
    m_pad = max(16, round_up(m, 16))
    xb = _bf16_padded(vectors)
    out = []
    for l in range(ml):
        if level_sizes is None:
            u_l = u_pad
        else:
            u_l = min(u_pad, round_up(level_sizes[l] + 1, 8))
        nbrs = F.pad(upper[l, :u_l], (0, m_pad - m), value=sent)  # node ids
        nbr_slots = torch.clamp_max(upper_slot[l][nbrs.long()], u_l - 1)
        table = UnifiedTable(
            _gather_blocks(xb, nbrs, 1 << 14), nbr_slots.to(torch.int32).contiguous()
        )
        # slot -> node id; non-members all land on the dummy slot, which is
        # then reset to the sentinel
        ids = torch.full((u_l,), sent, dtype=torch.int32, device=upper.device)
        ids[torch.clamp_max(upper_slot[l], u_l - 1).long()] = torch.arange(
            n_pad, dtype=torch.int32, device=upper.device
        )
        ids[u_l - 1] = sent
        out.append((table, ids))
    return tuple(out)


# ---------------------------------------------------------------------------
# Kernel 1: the unified hop.
# ---------------------------------------------------------------------------


def hop_dist_unified_plain(
    q: torch.Tensor, table: UnifiedTable, chosen: torch.Tensor, space: str = "l2"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the hop kernel: (dists [B, E*m0] f32,
    ids [B, E*m0] int32). The same f32 operations on the same bf16 values,
    summed in torch's order."""
    _check_space(space)
    if q.is_cuda:
        COUNTS.plain_on_cuda += 1
    b, e = chosen.shape
    m0 = table.m0
    qp = F.pad(q.float(), (0, table.d_pad - q.shape[1]))[:, None, None, :]
    idx = chosen.long()
    rows = table.vecs[idx].float()  # [B, E, m0, d_pad]
    if space == "ip":
        d = 1.0 - (rows * qp).sum(-1)
    else:
        diff = rows - qp
        d = (diff * diff).sum(-1)
    return d.reshape(b, e * m0), table.payload[idx].reshape(b, e * m0)


def hop_dist_unified(
    q: torch.Tensor,  # [B, D] f32
    table: UnifiedTable,
    chosen: torch.Tensor,  # [B, E] int32 rows of `table` to expand
    space: str = "l2",
    *,
    int8: bool = False,
    int4: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Expand `chosen` nodes: one contiguous block per (query, chosen) holds
    the m0 neighbor vectors and their payload ids. Returns (dists [B, E*m0]
    f32, ids [B, E*m0] int32). Replaces pallas_gather.hop_dist_unified
    (bf16 rows); the int8 and int4 rows are not ported yet."""
    if int8 or int4:
        raise NotImplementedError(
            "int8/int4 unified rows are not ported yet "
            "(ROADMAP.md queue 2: _hop_dist_unified_kernel int8 and int4)"
        )
    _check_space(space)
    if q.dim() != 2 or chosen.dim() != 2 or chosen.shape[0] != q.shape[0]:
        raise ValueError(f"bad shapes q {tuple(q.shape)} chosen {tuple(chosen.shape)}")
    if q.dtype != torch.float32 or chosen.dtype != torch.int32:
        raise TypeError("hop_dist_unified takes f32 queries and int32 chosen ids")
    if table.vecs.dtype != torch.bfloat16 or table.payload.dtype != torch.int32:
        raise TypeError("hop_dist_unified takes a bf16 table with int32 payload")
    if q.shape[1] > table.d_pad:
        raise ValueError(f"query width {q.shape[1]} > table width {table.d_pad}")
    if q.device.type == "cpu":
        return hop_dist_unified_plain(q, table, chosen, space)
    if not q.is_cuda:
        raise ValueError(f"hop_dist_unified: unsupported device {q.device}")

    from hnsw_tpu_torch.ops.cuda_lib import check, load_kernels

    dev = q.device
    if any(t.device != dev for t in (chosen, table.vecs, table.payload)):
        raise ValueError("hop_dist_unified: tensors on different devices")
    if not (table.vecs.is_contiguous() and table.payload.is_contiguous()):
        raise ValueError("hop_dist_unified: table must be contiguous")
    if table.d_pad % 8 or table.d_pad * 4 > 48 * 1024:
        raise ValueError(f"hop_dist_unified: unsupported d_pad {table.d_pad}")
    b, e = chosen.shape
    m0 = table.m0
    qp = F.pad(q, (0, table.d_pad - q.shape[1])).contiguous()
    ch = chosen.contiguous()
    out_d = torch.empty((b, e * m0), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, e * m0), dtype=torch.int32, device=dev)
    lib = load_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hop_dist_unified_bf16(
            qp.data_ptr(), table.vecs.data_ptr(), table.payload.data_ptr(),
            ch.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            b, e, m0, table.d_pad, table.rows, int(space == "ip"), stream,
        )
    check(rc, "hop_dist_unified_bf16")
    COUNTS.hop_dist_unified += 1
    return out_d, out_i


# ---------------------------------------------------------------------------
# Kernel 2: the f32 row-gather distance (exact rescore).
# ---------------------------------------------------------------------------


def gather_dist_rows_plain(
    q: torch.Tensor, table: torch.Tensor, ids: torch.Tensor, space: str = "l2"
) -> torch.Tensor:
    """Plain PyTorch version of the gather kernel: [B, K] distances in the
    norm-expansion form max(|q|^2 + |x|^2 - 2 q.x, 0) (L2) or 1 - q.x."""
    _check_space(space)
    if q.is_cuda:
        COUNTS.plain_on_cuda += 1
    return gather_dist(q, table, ids, space)


def gather_dist_rows(
    q: torch.Tensor,  # [B, D] f32
    table: torch.Tensor,  # [N, D] f32
    ids: torch.Tensor,  # [B, K] int32, in range
    space: str = "l2",
) -> torch.Tensor:
    """[B, K] distances from q[b] to table[ids[b, j]]. Replaces
    pallas_gather.gather_dist_pallas on an f32 table."""
    _check_space(space)
    if q.dim() != 2 or table.dim() != 2 or ids.dim() != 2:
        raise ValueError("gather_dist_rows takes 2-D q, table and ids")
    if ids.shape[0] != q.shape[0] or table.shape[1] != q.shape[1]:
        raise ValueError(
            f"bad shapes q {tuple(q.shape)} table {tuple(table.shape)} ids {tuple(ids.shape)}"
        )
    if q.dtype != torch.float32 or table.dtype != torch.float32 or ids.dtype != torch.int32:
        raise TypeError("gather_dist_rows takes f32 q and table, int32 ids")
    if q.device.type == "cpu":
        return gather_dist_rows_plain(q, table, ids, space)
    if not q.is_cuda:
        raise ValueError(f"gather_dist_rows: unsupported device {q.device}")

    from hnsw_tpu_torch.ops.cuda_lib import check, load_kernels

    dev = q.device
    if table.device != dev or ids.device != dev:
        raise ValueError("gather_dist_rows: tensors on different devices")
    if not table.is_contiguous():
        raise ValueError("gather_dist_rows: table must be contiguous")
    if table.shape[1] * 4 > 48 * 1024:
        raise ValueError(f"gather_dist_rows: unsupported width {table.shape[1]}")
    b, k = ids.shape
    qc = q.contiguous()
    idc = ids.contiguous()
    out = torch.empty((b, k), dtype=torch.float32, device=dev)
    lib = load_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gather_dist_f32(
            qc.data_ptr(), table.data_ptr(), idc.data_ptr(), out.data_ptr(),
            b, k, table.shape[1], table.shape[0], int(space == "ip"), stream,
        )
    check(rc, "gather_dist_f32")
    COUNTS.gather_dist_rows += 1
    return out
