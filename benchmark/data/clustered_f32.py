"""Float32 vectors from a clustered Gaussian mixture, SIFT-like in shape:
`centers` centres drawn N(0, 1), each base vector a random centre plus
N(0, spread^2) noise, each query a random base vector plus N(0,
query_noise^2) noise (the 1M sweep's data of the JAX package's tooling,
rewritten in torch). Made on the device from the seed in a few large calls.
"""

from __future__ import annotations

import numpy as np
import torch


def make(cfg: dict, seed: int, device) -> tuple[np.ndarray, np.ndarray]:
    """(base [n_base, dim] float32, queries [n_queries, dim] float32)."""
    p = cfg["data"]
    n, nq, dim = cfg["n_base"], cfg["n_queries"], cfg["dim"]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    centers = torch.randn((p["centers"], dim), generator=g, device=device)
    assign = torch.randint(0, p["centers"], (n,), generator=g, device=device)
    x = centers[assign]
    x += p["spread"] * torch.randn((n, dim), generator=g, device=device)
    pick = torch.randint(0, n, (nq,), generator=g, device=device)
    q = x[pick] + p["query_noise"] * torch.randn((nq, dim), generator=g, device=device)
    return x.cpu().numpy(), q.cpu().numpy()
