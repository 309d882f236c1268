"""Node-block tables and the CUDA kernels of the query and bulk-build paths
(counterpart of hnsw_tpu/ops/pallas_gather.py).

- The unified node-block tables: for every node, its m0 level-0 neighbors'
  vectors and their ids, so one expansion reads one contiguous block. The
  TPU packs a block into int32 sublanes; here a table is a few tensors
  holding the same values in the same neighbor order, with d padded to a
  multiple of 8 (zero lanes change neither L2 nor IP). Three tiers:
  ``UnifiedTable`` (bf16 vectors), ``Unified8Table`` (int8 codes and each
  neighbor's f32 scale) and ``Unified4Table`` (4-bit codes, two per byte).
  The upper-level descent tables are bf16 on every tier, with neighbor
  *slots* as the payload.
- The split tier, the bulk-build waves' table: ``make_inline_neighbors``
  gives one bf16 tensor ``[N_pad, m0, d_pad]`` of neighbor vectors; the
  ids are read from the graph's own ``level0``, so a row delta written to
  ``level0`` is at once what the hop sees.
- ``build_inline_tables``: the tier ladder (bf16, else int8, else int4,
  else split).
- ``hop_dist_unified``: distances from each query to the neighbors of its
  chosen nodes, read from a unified table of any tier
  (csrc/hop_dist_unified.cu, csrc/hop_dist_quant.cu; the three tiers share
  the node-block ring of csrc/hop_ring.cuh).
- ``hop_dist_inline``: the same on the split tier, on the same ring with
  the graph's level0 as the payload (csrc/hop_dist_inline.cu).
- ``gather_dist_rows``: distances from each query to K rows of the f32 or
  bf16 vector table, the exact rescore (csrc/gather_dist.cu,
  csrc/gather_dist_bf16.cu: every row of a query in flight at once where a
  row is a whole number of 16-byte chunks, a warp per row otherwise).

Each kernel wrapper takes its plain PyTorch version for CPU tensors only;
for CUDA tensors it launches the kernel or raises. ``COUNTS`` records every
launch, and every call of a plain version on a CUDA tensor, so a run can
show which path it took, beside the search's beam iterations and host
syncs.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from hnsw_tpu_torch.core.graph import round_up
from hnsw_tpu_torch.ops.distance import gather_dist


@dataclasses.dataclass
class KernelCounts:
    """The program's host-side counts: launches of the CUDA kernels, calls
    of their plain versions on CUDA tensors (chip_smoke.py holds the main
    path to zero of those), and the search's own steps. Plain integers,
    bumped on the host: counting costs no device work."""

    hop_dist_unified: int = 0  # bf16 rows
    hop_dist_unified8: int = 0
    hop_dist_unified4: int = 0
    hop_dist_inline: int = 0  # the split tier
    gather_dist_rows: int = 0  # f32 table
    gather_dist_bf16: int = 0
    seed_topk: int = 0  # the landmark seeds (ops/topk.py seed_topk)
    plain_on_cuda: int = 0
    # level-0 beam iterations, counted by the loop itself (ops/traversal.py
    # _beam_level0), not by a kernel wrapper
    beam_iters: int = 0
    # blocking device-to-host reads on the search path: the beam loop's and
    # the greedy descent's termination checks, HNSWIndex.search's copies
    host_syncs: int = 0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)


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


@dataclasses.dataclass(frozen=True)
class Unified8Table:
    """int8 node blocks: row r holds m0 neighbors' codes, each neighbor's
    dequant scale (x ~ code * scale) and their payload ids. The TPU carries
    the scales as f32 bits in the id sublane (pack_unified8_rows)."""

    codes: torch.Tensor  # [R, m0, d_pad] int8
    scales: torch.Tensor  # [R, m0] f32
    payload: torch.Tensor  # [R, m0] int32

    @property
    def rows(self) -> int:
        return self.codes.shape[0]

    @property
    def m0(self) -> int:
        return self.codes.shape[1]

    @property
    def d_pad(self) -> int:
        return self.codes.shape[2]

    @property
    def nbytes(self) -> int:
        return self.codes.nbytes + self.scales.nbytes + self.payload.nbytes


@dataclasses.dataclass(frozen=True)
class Unified4Table:
    """int4 node blocks: as Unified8Table with the codes (in [-7, 7]) packed
    two per byte, the even lane in the low nibble. The nibble order is the
    port's own; the TPU's (pack_unified4_rows) follows its sublane unpack."""

    codes: torch.Tensor  # [R, m0, d_pad // 2] uint8
    scales: torch.Tensor  # [R, m0] f32
    payload: torch.Tensor  # [R, m0] int32

    @property
    def rows(self) -> int:
        return self.codes.shape[0]

    @property
    def m0(self) -> int:
        return self.codes.shape[1]

    @property
    def d_pad(self) -> int:
        return self.codes.shape[2] * 2

    @property
    def nbytes(self) -> int:
        return self.codes.nbytes + self.scales.nbytes + self.payload.nbytes


def tier_bytes(n_pad: int, m0: int, d: int) -> dict[str, int]:
    """Device bytes of each tier's level-0 table over n_pad node blocks of
    m0 neighbors, the budget the ladder holds each tier to. The int8 and int4
    tiers also count the [n_pad, d_pad] codes and [n_pad] scales side tables
    that the row-delta sync re-packs dirty rows from. The split tier is the
    neighbor vectors alone: its ids are the graph's level0."""
    d_pad = round_up(d, 8)
    side = n_pad * d_pad + 4 * n_pad
    return {
        "unified": n_pad * m0 * (2 * d_pad + 4),
        "unified8": n_pad * m0 * (d_pad + 8) + side,
        "unified4": n_pad * m0 * (d_pad // 2 + 8) + side,
        "split": n_pad * m0 * 2 * d_pad,
    }


def _pad_lanes(t: torch.Tensor) -> torch.Tensor:
    """[N, d] -> [N, d_pad]: zero lanes up to a multiple of 8."""
    d = t.shape[1]
    return F.pad(t, (0, round_up(d, 8) - d)).contiguous()


def _bf16_padded(vectors: torch.Tensor) -> torch.Tensor:
    """[N, d] -> bf16 [N, d_pad], rounded to bf16 BEFORE any gather (as
    pallas_gather.py:327 does)."""
    return _pad_lanes(vectors.to(torch.bfloat16))


def _gather_blocks(xb: torch.Tensor, nbrs: torch.Tensor, chunk: int) -> torch.Tensor:
    """[R, m] neighbor ids -> [R, m, W] rows of the [N, W] table `xb`,
    written chunk by chunk straight into the output (no transient copy of
    the table)."""
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
    return UnifiedTable(
        make_inline_neighbors_chunked(vectors, level0, chunk), level0.contiguous()
    )


def make_inline_neighbors_chunked(
    vectors: torch.Tensor, level0: torch.Tensor, chunk: int = 1 << 14
) -> torch.Tensor:
    """The split tier's table [N_pad, m0, d_pad] bf16: row n holds the
    vectors of node n's level-0 neighbors, cast to bf16 before the gather and
    written chunk by chunk (pallas_gather.make_inline_neighbors_chunked; d
    is padded to 8 here, not to the TPU's 128 lanes)."""
    return _gather_blocks(_bf16_padded(vectors), level0, chunk)


def inline_rows(vectors: torch.Tensor, nbrs: torch.Tensor) -> torch.Tensor:
    """[K, m] neighbor ids -> their vectors [K, m, d_pad] bf16: the rows of
    the split table, or of a bf16 unified table, that a row delta rewrites
    (gathered, then rounded: the same values as rounding the table first)."""
    k, m = nbrs.shape
    rows = vectors[nbrs.reshape(-1).long()].to(torch.bfloat16)
    return _pad_lanes(rows).view(k, m, -1)


def make_inline_neighbors(vectors: torch.Tensor, level0: torch.Tensor) -> torch.Tensor:
    """make_inline_neighbors_chunked in one gather (small tables)."""
    return make_inline_neighbors_chunked(vectors, level0, max(1, level0.shape[0]))


# Per-vector symmetric quantizers: the f32 arithmetic of the JAX package
# (amax / 127 or / 7, divide, round half to even, clip), so codes are equal
# and scales bit-equal. A zero vector gets scale 1 and zero codes.


def _quantize(vectors: torch.Tensor, qmax: int) -> tuple[torch.Tensor, torch.Tensor]:
    v = vectors.float()
    amax = v.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / float(qmax), torch.ones_like(amax))
    codes = torch.clamp(torch.round(v / scale[:, None]), -qmax, qmax)
    return codes.to(torch.int8), scale


def quantize_int8(vectors: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(codes [N, D] int8 in [-127, 127], scales [N] f32); x ~ codes * scale."""
    return _quantize(vectors, 127)


def quantize_exact_i8(vectors: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Lossless codes for integer-valued data in [-128, 127] (the l2u8
    space): codes = round(x), scale 1, so dequantized distances are exact."""
    codes = torch.clamp(torch.round(vectors.float()), -128, 127).to(torch.int8)
    return codes, torch.ones(vectors.shape[0], dtype=torch.float32, device=vectors.device)


def quantize_int4(vectors: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(codes [N, D] int8 in [-7, 7], scales [N] f32); x ~ codes * scale."""
    return _quantize(vectors, 7)


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """[..., 2k] int8 codes in [-8, 7] -> [..., k] uint8: lane 2i in the low
    nibble, lane 2i+1 in the high nibble (two's complement)."""
    lo = codes[..., 0::2].to(torch.int32) & 0xF
    hi = codes[..., 1::2].to(torch.int32) & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4: [..., k] uint8 -> [..., 2k] int8."""
    p = packed.to(torch.int32)
    nib = torch.stack([p & 0xF, p >> 4], dim=-1)
    nib = torch.where(nib >= 8, nib - 16, nib)  # sign-extend
    return nib.reshape(*packed.shape[:-1], 2 * packed.shape[-1]).to(torch.int8)


def quantize_for_tier(
    vectors: torch.Tensor, tier: str, exact: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """The side tables of a quantized tier: (codes [N, d_pad] int8 with zero
    pad lanes, scales [N] f32). "unified4" keeps one code per byte here and
    packs two per byte in the node blocks; `exact` picks the l2u8 space's
    lossless scale-1 codes on "unified8"."""
    if tier == "unified4":
        quant = quantize_int4
    else:
        quant = quantize_exact_i8 if exact else quantize_int8
    codes, scales = quant(vectors)
    return _pad_lanes(codes), scales


def quant_rows(tier: str, codes: torch.Tensor, scales: torch.Tensor,
               nbrs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(codes [K, m, W], scales [K, m]) of the neighbor blocks `nbrs` [K, m]
    from a quantized tier's side tables: the rows of a Unified8Table (W =
    d_pad) or Unified4Table (W = d_pad // 2) that a row delta rewrites."""
    blocks = codes[nbrs.long()]
    if tier == "unified4":
        blocks = pack_int4(blocks)
    return blocks, scales[nbrs.long()]


def _quant_table(tier: str, codes: torch.Tensor, scales: torch.Tensor,
                 level0: torch.Tensor, chunk: int):
    """The whole level-0 table of a quantized tier from its side tables. The
    int4 codes are packed before the gather, so no transient is larger than
    the table."""
    if tier == "unified4":
        cls, codes = Unified4Table, pack_int4(codes)
    else:
        cls = Unified8Table
    return cls(_gather_blocks(codes, level0, chunk), scales[level0.long()],
               level0.contiguous())


def make_unified8_table_chunked(
    vectors: torch.Tensor, level0: torch.Tensor, chunk: int = 1 << 14,
    exact: bool = False,
) -> Unified8Table:
    """Level-0 int8 table from per-vector codes and scales; `exact` uses the
    lossless scale-1 codes of the l2u8 space."""
    side = quantize_for_tier(vectors, "unified8", exact)
    return _quant_table("unified8", *side, level0, chunk)


def make_unified4_table_chunked(
    vectors: torch.Tensor, level0: torch.Tensor, chunk: int = 1 << 14
) -> Unified4Table:
    """Level-0 int4 table: codes in [-7, 7], two per byte, and scales."""
    side = quantize_for_tier(vectors, "unified4")
    return _quant_table("unified4", *side, level0, chunk)


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


class InlineTables(NamedTuple):
    """The serving tables of one tier (JAX's tagged tuple)."""

    tier: str  # "unified" | "unified8" | "unified4" | "split"
    # UnifiedTable | Unified8Table | Unified4Table, or on the split tier the
    # [N_pad, m0, d_pad] bf16 neighbor vectors (ids come from dg.level0)
    table: object
    upper_tables: tuple  # ((bf16 UnifiedTable, slot_to_id), ...) per level
    # side tables of the quantized tiers, read by the row-delta sync
    codes: torch.Tensor | None = None  # [N_pad, d_pad] int8
    scales: torch.Tensor | None = None  # [N_pad] f32


def pick_tier(
    n_pad: int, m0: int, dim: int, budget: int | None,
    split_max_bytes: int | None = None,
) -> str | None:
    """The rung build_inline_tables takes for this shape: the bf16 tables if
    they fit `budget` bytes (None: no limit), else int8, else int4, each
    counted by tier_bytes, else the split table under `split_max_bytes`; None
    when no rung applies. JAX's order and the shape conditions of its unified
    rungs (pallas_gather.build_inline_tables) are kept, its TPU row's lane
    width included, so a shape that JAX gives a rung picks the same rung
    here. JAX's split rung also needs m0 <= 32, the width of its id tile;
    the split kernel here reads ids from level0 at any m0, so that condition
    is not carried over and a wide graph (M=32) gets the split rung too."""
    d_pad_j = round_up(dim, 128)  # the TPU row's lane width
    need = tier_bytes(n_pad, m0, dim)

    def fits(tier: str, cap: int | None) -> bool:
        return cap is None or need[tier] <= cap

    if m0 <= 128 and fits("unified", budget):
        return "unified"
    if 2 * m0 <= 128 and m0 * d_pad_j % 512 == 0 and fits("unified8", budget):
        return "unified8"
    if 2 * m0 <= 128 and m0 * d_pad_j % 1024 == 0 and fits("unified4", budget):
        return "unified4"
    if fits("split", split_max_bytes):
        return "split"
    return None


def build_inline_tables(
    x: torch.Tensor, dg, dim: int, budget: int | None,
    split_max_bytes: int | None = None, *, upper_inline: bool = True,
    exact_i8: bool = False, keep_delta_tables: bool = True,
    tier: str | None = None,
) -> InlineTables:
    """Build the tables of the rung pick_tier names (the tier ladder,
    pallas_gather.build_inline_tables). `upper_inline=False` skips the
    per-level descent tables (the search then descends through row gathers);
    `keep_delta_tables=False` drops the quantized tiers' side tables (a
    serve-only index: a later mutation then resyncs in full). Where JAX
    falls silently to XLA gathers below its last rung, this raises
    MemoryError: plain gathers are served only on inline_neighbors=False.
    A `tier` given builds that rung whatever the budgets (the shards of a
    sharded index serve the one rung picked for the largest of them)."""
    n_pad, m0 = dg.level0.shape
    tier = tier or pick_tier(n_pad, m0, dim, budget, split_max_bytes)
    if tier is None:
        need = tier_bytes(n_pad, m0, dim)
        raise MemoryError(
            f"no tier fits: unified budget {budget} bytes (bf16 "
            f"{need['unified']}, int8 {need['unified8']}, int4 "
            f"{need['unified4']}), split budget {split_max_bytes} bytes "
            f"(split {need['split']}); pass "
            "inline_neighbors=False to serve through plain row gathers"
        )
    if tier == "split":
        return InlineTables(tier, make_inline_neighbors_chunked(x, dg.level0), ())
    upper = ()
    if upper_inline and dg.max_level > 0:
        sizes = upper_level_sizes_u(dg.upper_slot, dg.upper.shape[1])
        upper = make_upper_tables(x, dg.upper, dg.upper_slot, level_sizes=sizes)
    if tier == "unified":
        return InlineTables(tier, make_unified_table_chunked(x, dg.level0), upper)
    codes, scales = quantize_for_tier(x, tier, exact_i8)
    table = _quant_table(tier, codes, scales, dg.level0, 1 << 14)
    if not keep_delta_tables:
        codes = scales = None
    return InlineTables(tier, table, upper, codes, scales)


# ---------------------------------------------------------------------------
# Kernels 1, 3 and 4: the unified hop (bf16, int8 and int4 rows).
# ---------------------------------------------------------------------------

# table type -> (tier, C entry, COUNTS field, tensors passed to the kernel
# with their dtypes)
_HOP_TIERS = {
    UnifiedTable: ("bf16", "hop_dist_unified_bf16", "hop_dist_unified",
                   (("vecs", torch.bfloat16), ("payload", torch.int32))),
    Unified8Table: ("int8", "hop_dist_unified_int8", "hop_dist_unified8",
                    (("codes", torch.int8), ("scales", torch.float32),
                     ("payload", torch.int32))),
    Unified4Table: ("int4", "hop_dist_unified_int4", "hop_dist_unified4",
                    (("codes", torch.uint8), ("scales", torch.float32),
                     ("payload", torch.int32))),
}


def _block_rows(table, idx: torch.Tensor) -> torch.Tensor:
    """f32 neighbor rows [*idx.shape, m0, d_pad] of the blocks `idx`, in the
    JAX kernel's arithmetic: bf16 widened, or code * scale in f32."""
    if isinstance(table, UnifiedTable):
        return table.vecs[idx].float()
    codes = table.codes[idx]
    if isinstance(table, Unified4Table):
        codes = unpack_int4(codes)
    return codes.float() * table.scales[idx][..., None]


def hop_dist_unified_plain(
    q: torch.Tensor, table, chosen: torch.Tensor, space: str = "l2"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the hop kernels: (dists [B, E*m0] f32,
    ids [B, E*m0] int32). The same f32 operations on the same values,
    summed in torch's order."""
    _check_space(space)
    if q.is_cuda:
        COUNTS.plain_on_cuda += 1
    b, e = chosen.shape
    m0 = table.m0
    qp = F.pad(q.float(), (0, table.d_pad - q.shape[1]))[:, None, None, :]
    idx = chosen.long()
    rows = _block_rows(table, idx)  # [B, E, m0, d_pad]
    if space == "ip":
        d = 1.0 - (rows * qp).sum(-1)
    else:
        diff = rows - qp
        d = (diff * diff).sum(-1)
    return d.reshape(b, e * m0), table.payload[idx].reshape(b, e * m0)


def hop_dist_unified(
    q: torch.Tensor,  # [B, D] f32
    table: UnifiedTable | Unified8Table | Unified4Table,
    chosen: torch.Tensor,  # [B, E] int32 rows of `table` to expand
    space: str = "l2",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Expand `chosen` nodes: one contiguous block per (query, chosen) holds
    the m0 neighbors' vectors (bf16, int8 or int4 codes) and their payload
    ids. Returns (dists [B, E*m0] f32, ids [B, E*m0] int32). Replaces
    pallas_gather.hop_dist_unified; the table's type picks the tier (the
    JAX flags int8= and int4=)."""
    if type(table) not in _HOP_TIERS:
        raise TypeError(f"hop_dist_unified: not a unified table: {type(table).__name__}")
    kind, entry, counter, fields = _HOP_TIERS[type(table)]
    _check_space(space)
    if q.dim() != 2 or chosen.dim() != 2 or chosen.shape[0] != q.shape[0]:
        raise ValueError(f"bad shapes q {tuple(q.shape)} chosen {tuple(chosen.shape)}")
    if q.dtype != torch.float32 or chosen.dtype != torch.int32:
        raise TypeError("hop_dist_unified takes f32 queries and int32 chosen ids")
    tensors = [getattr(table, name) for name, _ in fields]
    for (name, dtype), t in zip(fields, tensors):
        if t.dtype != dtype:
            raise TypeError(f"hop_dist_unified: {kind} table {name} must be {dtype}")
    if q.shape[1] > table.d_pad:
        raise ValueError(f"query width {q.shape[1]} > table width {table.d_pad}")
    if q.device.type == "cpu":
        return hop_dist_unified_plain(q, table, chosen, space)
    return _ring_launch(entry, counter, kind, q, tensors, chosen, table.m0, table.d_pad,
                        table.rows, space)


def _ring_launch(
    entry: str, counter: str, kind: str, q: torch.Tensor, tensors: list,
    chosen: torch.Tensor, m0: int, d_pad: int, rows: int, space: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch a C entry of the node-block ring (csrc/hop_ring.cuh) on CUDA
    tensors (`tensors`: the table's, in the entry's order). Checks what the
    ring's bulk copies need (16-byte sizes and addresses) and raises
    otherwise."""
    if not q.is_cuda:
        raise ValueError(f"{entry}: unsupported device {q.device}")

    from hnsw_tpu_torch.ops.cuda_lib import check, load_kernels

    dev = q.device
    if any(t.device != dev for t in (chosen, *tensors)):
        raise ValueError(f"{entry}: tensors on different devices")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError(f"{entry}: table must be contiguous and 16-byte aligned")
    if d_pad % 8 or d_pad * 4 > 48 * 1024:
        raise ValueError(f"{entry}: unsupported d_pad {d_pad}")
    if m0 % 4:
        # the ring copies ids, scales and rows in 16-byte multiples
        raise ValueError(f"{entry}: {kind} table m0 {m0} is not a multiple of 4")
    b, e = chosen.shape
    # padded only when narrower than the table: a pad is a copy kernel per call
    qp = q if q.shape[1] == d_pad else F.pad(q, (0, d_pad - q.shape[1]))
    qp = qp.contiguous()
    if qp.data_ptr() % 16:  # the query row is a bulk copy too
        qp = qp.clone()
    ch = chosen.contiguous()
    out_d = torch.empty((b, e * m0), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, e * m0), dtype=torch.int32, device=dev)
    lib = load_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, entry)(
            qp.data_ptr(), *(t.data_ptr() for t in tensors), ch.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(),
            b, e, m0, d_pad, rows, int(space == "ip"), stream,
        )
    check(rc, entry)
    setattr(COUNTS, counter, getattr(COUNTS, counter) + 1)
    return out_d, out_i


# ---------------------------------------------------------------------------
# Kernel 6: the split-tier hop (bf16 neighbor vectors, ids from level0).
# ---------------------------------------------------------------------------


def hop_dist_inline_plain(
    q: torch.Tensor, nbr_vectors: torch.Tensor, level0: torch.Tensor,
    chosen: torch.Tensor, space: str = "l2",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the split hop kernel: (dists [B, E*m0] f32,
    ids [B, E*m0] int32), what pallas_gather.hop_dist_inline followed by
    extract_level0_ids gives."""
    _check_space(space)
    if q.is_cuda:
        COUNTS.plain_on_cuda += 1
    b, e = chosen.shape
    m0, d_pad = nbr_vectors.shape[1:]
    qp = F.pad(q.float(), (0, d_pad - q.shape[1]))[:, None, None, :]
    idx = chosen.long()
    rows = nbr_vectors[idx].float()  # [B, E, m0, d_pad]
    if space == "ip":
        d = 1.0 - (rows * qp).sum(-1)
    else:
        diff = rows - qp
        d = (diff * diff).sum(-1)
    return d.reshape(b, e * m0), level0[idx].reshape(b, e * m0)


def hop_dist_inline(
    q: torch.Tensor,  # [B, D] f32
    nbr_vectors: torch.Tensor,  # [N_pad, m0, d_pad] bf16
    level0: torch.Tensor,  # [N_pad, m0] int32, the graph's own adjacency
    chosen: torch.Tensor,  # [B, E] int32 nodes to expand
    space: str = "l2",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Expand `chosen` nodes on the split tier: the m0 neighbor vectors of
    each come from one contiguous block of `nbr_vectors`, their ids from the
    node's row of `level0`. Returns (dists [B, E*m0] f32, ids [B, E*m0]
    int32). Replaces pallas_gather.hop_dist_inline and extract_level0_ids
    (the TPU kernel returns raw 32-node id tiles that XLA then picks from).
    On CUDA tensors it launches the node-block ring with level0 as the
    payload (csrc/hop_dist_inline.cu)."""
    _check_space(space)
    if q.dim() != 2 or chosen.dim() != 2 or chosen.shape[0] != q.shape[0]:
        raise ValueError(f"bad shapes q {tuple(q.shape)} chosen {tuple(chosen.shape)}")
    if nbr_vectors.dim() != 3 or level0.shape != nbr_vectors.shape[:2]:
        raise ValueError(
            f"bad shapes nbr_vectors {tuple(nbr_vectors.shape)} level0 {tuple(level0.shape)}"
        )
    if q.dtype != torch.float32 or chosen.dtype != torch.int32:
        raise TypeError("hop_dist_inline takes f32 queries and int32 chosen ids")
    if nbr_vectors.dtype != torch.bfloat16 or level0.dtype != torch.int32:
        raise TypeError("hop_dist_inline takes bf16 nbr_vectors and int32 level0")
    rows, m0, d_pad = nbr_vectors.shape
    if q.shape[1] > d_pad:
        raise ValueError(f"query width {q.shape[1]} > table width {d_pad}")
    if q.device.type == "cpu":
        return hop_dist_inline_plain(q, nbr_vectors, level0, chosen, space)
    return _ring_launch("hop_dist_inline", "hop_dist_inline", "split", q,
                        [nbr_vectors, level0], chosen, m0, d_pad, rows, space)


# ---------------------------------------------------------------------------
# Kernels 2 and 5: the row-gather distance of the exact rescore (f32 and
# bf16 vector tables).
# ---------------------------------------------------------------------------


def gather_dist_rows_plain(
    q: torch.Tensor, table: torch.Tensor, ids: torch.Tensor, space: str = "l2"
) -> torch.Tensor:
    """Plain PyTorch version of the gather kernels: [B, K] distances. An f32
    table takes the norm-expansion form max(|q|^2 + |x|^2 - 2 q.x, 0) or
    1 - q.x, as _gather_dist_kernel does; a bf16 table the direct
    difference sum((x - q)^2) or 1 - sum(x q) in f32, as
    _gather_dist_kernel_pair does."""
    _check_space(space)
    if q.is_cuda:
        COUNTS.plain_on_cuda += 1
    if table.dtype == torch.float32:
        return gather_dist(q, table, ids, space)
    rows = table[ids.long()].float()  # [B, K, D]
    q32 = q.float()[:, None, :]
    if space == "ip":
        return 1.0 - (rows * q32).sum(-1)
    diff = rows - q32
    return (diff * diff).sum(-1)


def gather_dist_rows(
    q: torch.Tensor,  # [B, D] f32
    table: torch.Tensor,  # [N, D] f32 or bf16
    ids: torch.Tensor,  # [B, K] int32, in range
    space: str = "l2",
) -> torch.Tensor:
    """[B, K] distances from q[b] to table[ids[b, j]]. Replaces
    pallas_gather.gather_dist_pallas on an f32 table (kernel 2) and on a
    bf16 table (kernel 5)."""
    _check_space(space)
    if q.dim() != 2 or table.dim() != 2 or ids.dim() != 2:
        raise ValueError("gather_dist_rows takes 2-D q, table and ids")
    if ids.shape[0] != q.shape[0] or table.shape[1] != q.shape[1]:
        raise ValueError(
            f"bad shapes q {tuple(q.shape)} table {tuple(table.shape)} ids {tuple(ids.shape)}"
        )
    if (q.dtype != torch.float32 or ids.dtype != torch.int32
            or table.dtype not in (torch.float32, torch.bfloat16)):
        raise TypeError("gather_dist_rows takes f32 q, an f32 or bf16 table, int32 ids")
    if q.device.type == "cpu":
        return gather_dist_rows_plain(q, table, ids, space)
    if not q.is_cuda:
        raise ValueError(f"gather_dist_rows: unsupported device {q.device}")

    from hnsw_tpu_torch.ops.cuda_lib import check, load_kernels

    dev = q.device
    if table.device != dev or ids.device != dev:
        raise ValueError("gather_dist_rows: tensors on different devices")
    if not table.is_contiguous() or table.data_ptr() % 16:
        raise ValueError("gather_dist_rows: table must be contiguous and 16-byte aligned")
    if table.shape[1] * 4 > 48 * 1024:
        raise ValueError(f"gather_dist_rows: unsupported width {table.shape[1]}")
    bf16 = table.dtype == torch.bfloat16
    entry = "gather_dist_bf16" if bf16 else "gather_dist_f32"
    b, k = ids.shape
    qc = q.contiguous()
    if qc.data_ptr() % 16:  # the bf16 kernel copies query rows in 16-byte chunks
        qc = qc.clone()
    idc = ids.contiguous()
    out = torch.empty((b, k), dtype=torch.float32, device=dev)
    lib = load_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, entry)(
            qc.data_ptr(), table.data_ptr(), idc.data_ptr(), out.data_ptr(),
            b, k, table.shape[1], table.shape[0], int(space == "ip"), stream,
        )
    check(rc, entry)
    if bf16:
        COUNTS.gather_dist_bf16 += 1
    else:
        COUNTS.gather_dist_rows += 1
    return out
