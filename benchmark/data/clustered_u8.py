"""uint8 vectors shaped like BIGANN's SIFT descriptors: a clustered Gaussian
mixture (`centers` centres N(0, 1), noise N(0, spread^2)) scaled by `scale`
about 128 and rounded into [0, 255]; each query a random base vector plus
N(0, query_noise^2) noise, rounded and clipped (the uint8 sweep's data of
the JAX package's tooling, rewritten in torch). Made on the device from the
seed in a few large calls.
"""

from __future__ import annotations

import numpy as np
import torch


def make(cfg: dict, seed: int, device) -> tuple[np.ndarray, np.ndarray]:
    """(base [n_base, dim] uint8, queries [n_queries, dim] uint8)."""
    p = cfg["data"]
    n, nq, dim = cfg["n_base"], cfg["n_queries"], cfg["dim"]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    centers = torch.randn((p["centers"], dim), generator=g, device=device)
    assign = torch.randint(0, p["centers"], (n,), generator=g, device=device)
    xf = centers[assign]
    xf += p["spread"] * torch.randn((n, dim), generator=g, device=device)
    x = torch.clamp(torch.round(xf * p["scale"] + 128.0), 0, 255)
    del xf
    pick = torch.randint(0, n, (nq,), generator=g, device=device)
    qf = x[pick] + p["query_noise"] * torch.randn((nq, dim), generator=g, device=device)
    q = torch.clamp(torch.round(qf), 0, 255)
    return x.to(torch.uint8).cpu().numpy(), q.to(torch.uint8).cpu().numpy()
