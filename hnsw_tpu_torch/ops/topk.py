"""Top-k primitives for distance arrays (counterpart of hnsw_tpu/ops/topk.py).

`torch.topk` orders equal distances arbitrarily where `lax.top_k` prefers
the lower index; on continuous data the two agree, and the traversal, whose
tie order does matter, does not use these helpers for its selections.
"""

from __future__ import annotations

import torch

from hnsw_tpu_torch.ops.distance import matmul_precision, pairwise_dist


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
