"""Distance ops (counterpart of hnsw_tpu/ops/distance.py).

Pairwise [B, N] distances are one matmul plus a rank-1 correction,

    ||q - x||^2 = ||q||^2 + ||x||^2 - 2 <q, x>,

and gathered [B, K] distances fetch K rows per query and contract them.
Accumulation is always float32.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def matmul_precision(precision: str | None) -> Iterator[None]:
    """`precision="highest"` runs float32 matmuls in true fp32: TF32 (three
    decimal digits) is switched off for the duration and restored after.
    TF32 on the H100 misranks near-tie neighbors the way the TPU's default
    bf16 matmul inputs did for the reference's oracle. Other values leave
    the global setting as it is."""
    if precision != "highest":
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def pairwise_l2_sq(
    q: torch.Tensor, x: torch.Tensor, *, x_sq_norms: torch.Tensor | None = None,
    precision: str | None = None,
) -> torch.Tensor:
    """Squared-L2 distance between every row of q [B, D] and x [N, D] →
    [B, N], with `x_sq_norms` ([N]) optionally precomputed. EXACTNESS-
    CONTRACT callers (the recall oracle) pass precision="highest"."""
    q32 = q.float()
    qq = (q32 * q32).sum(-1, keepdim=True)  # [B, 1]
    if x_sq_norms is None:
        x32 = x.float()
        x_sq_norms = (x32 * x32).sum(-1)  # [N]
    with matmul_precision(precision):
        qx = q32 @ x.float().T  # [B, N]
    d = qq + x_sq_norms[None, :] - 2.0 * qx
    return d.clamp_min_(0.0)  # cancellation can leave tiny negatives


def pairwise_ip_dist(
    q: torch.Tensor, x: torch.Tensor, *, precision: str | None = None
) -> torch.Tensor:
    """Inner-product distance 1 - <q, x> for all pairs → [B, N]."""
    with matmul_precision(precision):
        qx = q.float() @ x.float().T
    return 1.0 - qx


def pairwise_dist(
    q: torch.Tensor, x: torch.Tensor, space: str, *,
    x_sq_norms: torch.Tensor | None = None, precision: str | None = None,
) -> torch.Tensor:
    if space == "l2":
        return pairwise_l2_sq(q, x, x_sq_norms=x_sq_norms, precision=precision)
    if space == "ip":
        return pairwise_ip_dist(q, x, precision=precision)
    raise ValueError(f"unknown space {space!r} (expected 'l2' or 'ip')")


def gather_l2_sq(
    q: torch.Tensor, x: torch.Tensor, ids: torch.Tensor, *,
    x_sq_norms: torch.Tensor | None = None,
) -> torch.Tensor:
    """Squared-L2 from q[b] to x[ids[b, k]] → [B, K] through a plain row
    gather (the reference's XLA-gather path), with the rows' squared norms
    taken from `x_sq_norms` ([N]) when given. ids must be in range."""
    rows = x[ids.long()].float()  # [B, K, D]
    q32 = q.float()
    qx = (rows * q32[:, None, :]).sum(-1)  # [B, K]
    qq = (q32 * q32).sum(-1, keepdim=True)
    if x_sq_norms is not None:
        xx = x_sq_norms[ids.long()]
    else:
        xx = (rows * rows).sum(-1)
    return (qq + xx - 2.0 * qx).clamp_min_(0.0)


def gather_ip_dist(q: torch.Tensor, x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Inner-product distance 1 - <q[b], x[ids[b, k]]> → [B, K]."""
    rows = x[ids.long()].float()
    return 1.0 - (rows * q.float()[:, None, :]).sum(-1)


def gather_dist(
    q: torch.Tensor, x: torch.Tensor, ids: torch.Tensor, space: str, *,
    x_sq_norms: torch.Tensor | None = None,
) -> torch.Tensor:
    if space == "l2":
        return gather_l2_sq(q, x, ids, x_sq_norms=x_sq_norms)
    if space == "ip":
        return gather_ip_dist(q, x, ids)
    raise ValueError(f"unknown space {space!r} (expected 'l2' or 'ip')")


def dist_one(a: torch.Tensor, b: torch.Tensor, space: str = "l2") -> torch.Tensor:
    """The distance of one pair (a 0-d tensor), for parity checks against the
    reference's scalar distances (hnswlib/space_l2.h:7-24,
    hnswlib/space_ip.h:7-23)."""
    return pairwise_dist(a.reshape(1, -1), b.reshape(1, -1), space)[0, 0]
