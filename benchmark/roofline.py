"""The least time the card could take for the work a hop launch's inputs
need, whatever kernel implements it.

Peaks are NVIDIA's published figures for one H100 SXM (dense, at its 700 W
limit): 3.35 TB/s of HBM and 67 TFLOP/s of float32 outside the tensor
cores. A hop launch reads, for each (query, chosen) pair, the m0 neighbor
rows of the chosen node's block; a block that several pairs of the launch
name need only be read once, so the bytes are the launch's distinct blocks
times the tier's block bytes, plus the query rows and the chosen ids read
and the distances and ids written.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12

# bytes of one neighbor row in a node block, by tier: the values (bf16 or
# int8 codes, or int4 codes two to a byte), the f32 dequant scale of the
# quantized tiers, and the int32 payload id
_ROW_BYTES = {
    "unified": lambda d_pad: 2 * d_pad + 4,
    "unified8": lambda d_pad: d_pad + 4 + 4,
    "unified4": lambda d_pad: d_pad // 2 + 4 + 4,
}
# f32 operations per lane of a neighbor row: difference, multiply, add; the
# quantized tiers dequantize first
_LANE_OPS = {"unified": 3, "unified8": 4, "unified4": 4}


def round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def block_bytes(tier: str, m0: int, d: int) -> int:
    """Bytes of one node block: m0 neighbor rows at d padded to 8 lanes."""
    return m0 * _ROW_BYTES[tier](round_up(d, 8))


def hop_launch_bytes(tier: str, b: int, e: int, distinct: int, m0: int, d: int) -> int:
    """Bytes a hop launch over B queries and E chosen nodes each must move:
    `distinct` blocks, B f32 query rows, B*E int32 chosen ids read; B*E*m0
    f32 distances and int32 ids written."""
    d_pad = round_up(d, 8)
    return (distinct * block_bytes(tier, m0, d) + b * d_pad * 4 + b * e * 4
            + b * e * m0 * 8)


def hop_launch_flops(tier: str, b: int, e: int, m0: int, d: int) -> int:
    """f32 operations of a hop launch: every (query, neighbor) lane."""
    return b * e * m0 * round_up(d, 8) * _LANE_OPS[tier]


def least_seconds(nbytes: float, flops: float) -> float:
    """The larger of bytes over the HBM rate and operations over the f32
    rate."""
    return max(nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S)


def hop_least_seconds(tier: str, launches, m0: int, d: int) -> float:
    """Least seconds of a list of hop launches, each (B, E, distinct)."""
    return sum(
        least_seconds(hop_launch_bytes(tier, b, e, n, m0, d),
                      hop_launch_flops(tier, b, e, m0, d))
        for b, e, n in launches
    )
