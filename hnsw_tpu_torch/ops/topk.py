"""Top-k primitives for distance arrays (counterpart of hnsw_tpu/ops/topk.py).

`torch.topk` orders equal distances arbitrarily where `lax.top_k` prefers
the lower index; on continuous data the two agree, and the traversal, whose
tie order does matter, does not use these helpers for its selections.

`seed_topk`, the seeded entry's top-s over the landmark rows, keeps the
lower index among equal distances: on the card it is one CUDA kernel
(csrc/seed_topk.cu), on the CPU its plain version.
"""

from __future__ import annotations

import torch

from hnsw_tpu_torch.ops.distance import matmul_precision, pairwise_dist
from hnsw_tpu_torch.ops.gather_kernels import COUNTS

# the largest s the seed kernel takes: a row's list is held by one warp
SEED_TOPK_MAX_S = 32
# landmark rows per distance block of the plain version (bruteforce_topk's)
_SEED_CHUNK = 16384


def topk_smallest(dists: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k along the last axis → (dists [., k] ascending, idx [., k])."""
    d, idx = torch.topk(dists, k, dim=-1, largest=False, sorted=True)
    return d, idx


def merge_sorted_topk(
    d_a: torch.Tensor, i_a: torch.Tensor, d_b: torch.Tensor, i_b: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two (dist, id) candidate sets along the last axis, keep the
    smallest k. Inputs need not be sorted."""
    d = torch.cat([d_a, d_b], dim=-1)
    i = torch.cat([i_a, i_b], dim=-1)
    dk, pos = topk_smallest(d, k)
    return dk, torch.gather(i, -1, pos)


def bruteforce_topk(
    q: torch.Tensor,
    x: torch.Tensor,
    k: int,
    space: str = "l2",
    *,
    chunk_size: int | None = None,
    x_sq_norms: torch.Tensor | None = None,
    precision: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k-nearest over x [N, D] for queries q [B, D] → (dists, ids int64).

    The N axis is streamed in chunks of ~16k rows: one [B, D] @ [D, C]
    matmul per chunk and a running [B, k] top-k merge, so device memory
    holds one [B, C] distance block. `precision="highest"` (the recall
    oracle) runs the matmuls in true fp32 with TF32 off."""
    n = x.shape[0]
    b = q.shape[0]
    if chunk_size is None:
        chunk_size = min(n, max(k, 16384))
    if chunk_size % 128 != 0 and chunk_size < n:
        chunk_size = ((chunk_size + 127) // 128) * 128
    chunk_size = min(chunk_size, n)

    with matmul_precision(precision):
        if n <= chunk_size:
            d = pairwise_dist(q, x, space, x_sq_norms=x_sq_norms,
                              precision=precision)
            return topk_smallest(d, min(k, n))

        best_d = torch.full((b, k), torch.inf, device=q.device)
        best_i = torch.full((b, k), -1, dtype=torch.int64, device=q.device)
        for base in range(0, n, chunk_size):
            end = min(base + chunk_size, n)
            sq = None if x_sq_norms is None else x_sq_norms[base:end]
            d = pairwise_dist(q, x[base:end], space, x_sq_norms=sq,
                              precision=precision)  # [B, C]
            cd, ci = topk_smallest(d, min(k, end - base))
            best_d, best_i = merge_sorted_topk(best_d, best_i, cd, ci + base, k)
    return best_d, best_i


def seed_topk_plain(
    q: torch.Tensor, x: torch.Tensor, s: int, space: str = "l2", *,
    x_sq_norms: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the seed kernel: the s smallest distances
    from each query to the rows of x, ascending, equal distances to the
    lower row (a stable sort), as (dists [B, s] f32, rows [B, s] int64).
    Distances in bruteforce_topk's blocks and form (`pairwise_dist`)."""
    if q.is_cuda:
        COUNTS.plain_on_cuda += 1
    n = x.shape[0]
    best_d = best_i = None
    for base in range(0, n, _SEED_CHUNK):
        end = min(base + _SEED_CHUNK, n)
        sq = None if x_sq_norms is None else x_sq_norms[base:end]
        d = pairwise_dist(q, x[base:end], space, x_sq_norms=sq)
        cd, ci = torch.sort(d, dim=-1, stable=True)
        cd, ci = cd[:, :s], ci[:, :s] + base
        if best_d is not None:
            # every earlier row precedes this block's: a stable sort keeps
            # the lower row first among equal distances
            cd, pos = torch.sort(torch.cat([best_d, cd], -1), dim=-1, stable=True)
            cd, ci = cd[:, :s], torch.gather(torch.cat([best_i, ci], -1), -1, pos[:, :s])
        best_d, best_i = cd, ci
    return best_d, best_i


def round_tf32(v: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10-bit mantissa (to nearest, ties away
    from 0), the inputs a TF32 matmul multiplies."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def seed_topk(
    q: torch.Tensor,  # [B, D]
    x: torch.Tensor,  # [NL, D] the landmark rows
    s: int,
    space: str = "l2",
    *,
    x_sq_norms: torch.Tensor | None = None,  # [NL], L2
) -> tuple[torch.Tensor, torch.Tensor]:
    """The seeded entry's exact top-s over the landmark rows → (dists [B, s]
    f32 ascending, rows [B, s] int64), equal distances to the lower row:
    the function of bruteforce_topk(q, x, s, space, x_sq_norms=...) in the
    JAX package's seeded entry, which XLA ran as a matmul and top_k.

    For s <= SEED_TOPK_MAX_S: on CUDA tensors one kernel
    (csrc/seed_topk.cu: f32 FFMA distances and a running top-s in the
    GEMM's epilogue, no [B, NL] block in device memory), on the CPU
    `seed_topk_plain`. A larger s takes bruteforce_topk on either, counted
    in COUNTS.plain_on_cuda on CUDA tensors.

    Like bruteforce_topk's matmul, the kernel follows the global float32
    matmul setting: where it allows TF32
    (`torch.backends.cuda.matmul.allow_tf32`), the products take TF32
    inputs, rounded as `round_tf32` rounds them."""
    if space not in ("l2", "ip"):
        raise ValueError(f"unknown space {space!r} (expected 'l2' or 'ip')")
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"bad shapes q {tuple(q.shape)} x {tuple(x.shape)}")
    b, n = q.shape[0], x.shape[0]
    if not 1 <= s <= n:
        raise ValueError(f"s {s} outside [1, {n}]")
    if s > SEED_TOPK_MAX_S:
        if q.is_cuda:
            COUNTS.plain_on_cuda += 1
        return bruteforce_topk(q, x, s, space, x_sq_norms=x_sq_norms)
    if q.device.type == "cpu":
        return seed_topk_plain(q, x, s, space, x_sq_norms=x_sq_norms)
    if not q.is_cuda:
        raise ValueError(f"seed_topk: unsupported device {q.device}")

    from hnsw_tpu_torch.ops.cuda_lib import check, load_kernels

    dev = q.device
    if x.device != dev or (x_sq_norms is not None and x_sq_norms.device != dev):
        raise ValueError("seed_topk: tensors on different devices")
    qc = q.float().contiguous()
    xc = x.float().contiguous()
    xsq = None
    if space == "l2":
        xsq = (xc * xc).sum(-1) if x_sq_norms is None else x_sq_norms.float().contiguous()
        if xsq.shape != (n,):
            raise ValueError(f"x_sq_norms shape {tuple(xsq.shape)} != ({n},)")
    if torch.backends.cuda.matmul.allow_tf32:
        qc, xc = round_tf32(qc), round_tf32(xc)
    out_d = torch.empty((b, s), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, s), dtype=torch.int64, device=dev)
    if b == 0:
        return out_d, out_i
    lib = load_kernels()
    with torch.cuda.device(dev):
        slices = lib.seed_topk_slices(b, n, s)  # a negative CUDA error on failure
        if slices < 1:
            raise RuntimeError(f"seed_topk_slices: CUDA error {-slices}")
        part_d = part_i = None
        if slices > 1:
            part_d = torch.empty((b, slices, s), dtype=torch.float32, device=dev)
            part_i = torch.empty((b, slices, s), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.seed_topk(
            qc.data_ptr(), xc.data_ptr(), None if xsq is None else xsq.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(),
            None if part_d is None else part_d.data_ptr(),
            None if part_i is None else part_i.data_ptr(),
            b, n, qc.shape[1], s, slices, int(space == "ip"), stream,
        )
    check(rc, "seed_topk")
    COUNTS.seed_topk += 1
    return out_d, out_i
