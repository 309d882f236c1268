"""Distance spaces (counterpart of hnsw_tpu/core/spaces.py).

A Space is a thin descriptor: the batched kernels in hnsw_tpu_torch.ops are
dispatched by the space's name, and host-side preprocessing (cosine's
normalization) runs at insert and query time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Space:
    """Descriptor for a distance space over dim-dimensional vectors."""

    name: str  # 'l2' | 'ip'
    dim: int
    # dtype the vectors are stored in on the device (distances accumulate f32)
    storage_dtype: torch.dtype = torch.float32

    def preprocess(self, x: np.ndarray) -> np.ndarray:
        """Host-side normalization applied at insert time."""
        return np.asarray(x, dtype=np.float32).reshape(-1, self.dim)

    def decode(self, x: np.ndarray) -> np.ndarray:
        """Inverse of preprocess for data readback."""
        return x

    @property
    def needs_sq_norms(self) -> bool:
        return self.name == "l2"

    @property
    def exact_i8(self) -> bool:
        """True for the lossless int8 tier (the l2u8 space), not yet ported."""
        return False

    @property
    def persist_name(self) -> str:
        """Name written to checkpoints."""
        return self.name


class L2Space(Space):
    """Squared-L2 space."""

    def __init__(self, dim: int, storage_dtype=torch.float32):
        super().__init__(name="l2", dim=dim, storage_dtype=storage_dtype)


class IPSpace(Space):
    """Inner-product distance space, d = 1 - <a, b>."""

    def __init__(self, dim: int, storage_dtype=torch.float32):
        super().__init__(name="ip", dim=dim, storage_dtype=storage_dtype)


class CosineSpace(Space):
    """Cosine distance as L2-normalize + inner product: queries and stored
    vectors are normalized on the host, the device runs the IP path."""

    def __init__(self, dim: int, storage_dtype=torch.float32):
        super().__init__(name="ip", dim=dim, storage_dtype=storage_dtype)

    @property
    def persist_name(self) -> str:
        return "cosine"

    def preprocess(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float32).reshape(-1, self.dim)
        norms = np.linalg.norm(x, axis=1, keepdims=True)
        return x / np.maximum(norms, 1e-30)


def get_space(name: str, dim: int, storage_dtype=torch.float32) -> Space:
    if name == "l2":
        return L2Space(dim, storage_dtype)
    if name == "ip":
        return IPSpace(dim, storage_dtype)
    if name == "cosine":
        return CosineSpace(dim, storage_dtype)
    if name == "l2u8":
        raise NotImplementedError(
            "the l2u8 space needs the lossless int8 unified tier, which is "
            "not ported yet (ROADMAP.md queue 1: int8 and int4 tiers)"
        )
    raise ValueError(
        f"unknown space {name!r} (expected 'l2', 'l2u8', 'ip' or 'cosine')"
    )
