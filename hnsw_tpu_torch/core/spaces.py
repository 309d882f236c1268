"""Distance spaces (counterpart of hnsw_tpu/core/spaces.py).

A Space is a thin descriptor: the batched kernels in hnsw_tpu_torch.ops are
dispatched by the space's name, and host-side preprocessing (cosine's
normalization, l2u8's shift) runs at insert and query time.
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
        """True when stored values are integers in [-128, 127]: the int8
        tier's codes are then lossless (scale 1) and need no rescore."""
        return False

    @property
    def persist_name(self) -> str:
        """Name written to checkpoints."""
        return self.name


class L2Space(Space):
    """Squared-L2 space."""

    def __init__(self, dim: int, storage_dtype=torch.float32):
        super().__init__(name="l2", dim=dim, storage_dtype=storage_dtype)


class L2SpaceU8(Space):
    """Exact uint8 squared-L2 space (the reference's integer L2SpaceI).

    Values are shifted by -128 at insert and query time, so stored vectors
    are integers in [-128, 127]: (a-128)-(b-128) == a-b leaves every
    squared-L2 distance unchanged, and with d <= 128 every partial sum stays
    below 2^24, exact in f32. The int8 tier's scale-1 codes are then
    lossless, and every device path returns the exact integer distance."""

    def __init__(self, dim: int, storage_dtype=torch.float32):
        super().__init__(name="l2", dim=dim, storage_dtype=storage_dtype)

    @property
    def persist_name(self) -> str:
        return "l2u8"

    @property
    def exact_i8(self) -> bool:
        return True

    def preprocess(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x)
        if x.dtype != np.uint8:
            xi = np.rint(np.asarray(x, dtype=np.float32))
            if np.any(xi < 0) or np.any(xi > 255):
                raise ValueError("l2u8 space requires values in [0, 255]")
            x = xi
        return np.asarray(x, dtype=np.float32).reshape(-1, self.dim) - 128.0

    def decode(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(x, dtype=np.float32) + 128.0


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
        return L2SpaceU8(dim, storage_dtype)
    raise ValueError(
        f"unknown space {name!r} (expected 'l2', 'l2u8', 'ip' or 'cosine')"
    )
