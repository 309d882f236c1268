"""Padded-CSR HNSW graph containers (counterpart of hnsw_tpu/core/graph.py).

Host layout (numpy, sentinel -1 for absent links):

- ``level0``      [N, maxM0] int32
- ``upper``       [L, U, M]  int32, rows are *slots*; level l>=1 adjacency
- ``upper_slot``  [L, N]     int32, node id -> slot at that level (-1 absent)
- ``node_level``  [N]        int32, the per-node top level
- ``labels``      [N]        int64, internal id -> external label

On the device the sentinel is remapped to the dummy row ``n_pad - 1``, so
every gather is in range; the traversal masks ids ``>= num_nodes``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class HNSWGraph:
    """Host-side (numpy) padded-CSR HNSW graph. Sentinel neighbor id is -1."""

    level0: np.ndarray  # [N, maxM0] int32
    upper: np.ndarray  # [L, U, M] int32 (L may be 0)
    upper_slot: np.ndarray  # [L, N] int32
    node_level: np.ndarray  # [N] int32
    labels: np.ndarray  # [N] int64
    entry_point: int
    max_level: int

    @property
    def num_nodes(self) -> int:
        return int(self.level0.shape[0])

    @property
    def max_m0(self) -> int:
        return int(self.level0.shape[1])

    @property
    def max_m(self) -> int:
        return int(self.upper.shape[2]) if self.upper.size else 0

    def neighbors(self, node: int, level: int) -> np.ndarray:
        """Valid neighbor ids of `node` at `level` (unpadded)."""
        if level == 0:
            row = self.level0[node]
        else:
            slot = self.upper_slot[level - 1, node]
            if slot < 0:
                return np.empty((0,), dtype=np.int32)
            row = self.upper[level - 1, slot]
        return row[row >= 0]


def check_integrity(g: HNSWGraph, require_inbound: bool = True) -> None:
    """Graph invariants: every link in range, no self-loops, no duplicate
    links per list, neighbors present at their level, and (unless
    `require_inbound=False`) every node reachable by an inbound level-0
    edge when N > 1."""
    n = g.num_nodes
    if n == 0:
        return
    if not 0 <= g.entry_point < n:
        raise ValueError(f"entry_point {g.entry_point} out of range")
    if g.node_level[g.entry_point] != g.max_level:
        raise ValueError("entry point not at max level")

    inbound = np.zeros(n, dtype=np.int64)
    for node in range(n):
        for level in range(int(g.node_level[node]) + 1):
            nbrs = g.neighbors(node, level)
            if nbrs.size == 0:
                continue
            where = f"node {node} level {level}"
            if nbrs.min() < 0 or nbrs.max() >= n:
                raise ValueError(f"{where}: neighbor out of range")
            if np.any(nbrs == node):
                raise ValueError(f"{where}: self-loop")
            if len(np.unique(nbrs)) != nbrs.size:
                raise ValueError(f"{where}: duplicate links")
            if level > 0 and not np.all(g.node_level[nbrs] >= level):
                raise ValueError(f"{where}: neighbor below level")
            if level == 0:
                inbound[nbrs] += 1
    if n > 1 and require_inbound and not np.all(inbound > 0):
        raise ValueError(
            f"{int(np.sum(inbound == 0))} nodes with no inbound level-0 edges"
        )


# ---------------------------------------------------------------------------
# Device-side tensors.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Device-resident graph. All ids are in [0, n_pad); ids >= num_nodes are
    the dummy padding row. `upper` may have L=0 rows (single-level graph)."""

    level0: torch.Tensor  # [N_pad, m0_pad] int32
    upper: torch.Tensor  # [L, U_pad, M] int32
    upper_slot: torch.Tensor  # [L, N_pad] int32
    labels: torch.Tensor  # [N_pad] int64
    entry_point: int
    num_nodes: int

    @property
    def n_pad(self) -> int:
        return self.level0.shape[0]

    @property
    def max_level(self) -> int:
        return self.upper.shape[0]


def graph_device_arrays(
    g: HNSWGraph, n_pad: int | None = None, device="cpu"
) -> DeviceGraph:
    """Convert a host graph to device tensors. Sentinel -1 links are remapped
    to `n_pad - 1` (a guaranteed-dummy row) and the level-0 link width is
    padded to a multiple of 16 with that sentinel."""
    n = g.num_nodes
    if n_pad is None:
        n_pad = round_up(n + 1, 128)
    if n_pad <= n:
        raise ValueError("n_pad must leave at least one dummy row")
    sent = n_pad - 1

    level0 = np.full((n_pad, max(16, round_up(g.max_m0, 16))), sent, np.int32)
    level0[:n, : g.max_m0] = np.where(g.level0 < 0, sent, g.level0)

    upper, upper_slot = upper_host_arrays(g, n_pad)

    labels = np.full((n_pad,), -1, dtype=np.int64)
    labels[:n] = g.labels

    return DeviceGraph(
        level0=torch.from_numpy(level0).to(device),
        upper=torch.from_numpy(upper).to(device),
        upper_slot=torch.from_numpy(upper_slot).to(device),
        labels=torch.from_numpy(labels).to(device),
        entry_point=int(g.entry_point),
        num_nodes=n,
    )


def upper_host_arrays(g: HNSWGraph, n_pad: int) -> tuple[np.ndarray, np.ndarray]:
    """Padded upper-level adjacency + slot map as host arrays (sentinel
    remapped: absent links -> n_pad-1, absent slots -> the dummy slot
    u_pad-1)."""
    n = g.num_nodes
    sent = n_pad - 1
    ml = g.max_level
    if ml > 0 and g.upper.size:
        u = g.upper.shape[1]
        u_pad = round_up(u + 1, 8)
        upper = np.full((ml, u_pad, g.max_m), sent, dtype=np.int32)
        upper[:, :u] = np.where(g.upper < 0, sent, g.upper)
        upper_slot = np.full((ml, n_pad), u_pad - 1, dtype=np.int32)
        upper_slot[:, :n] = np.where(g.upper_slot < 0, u_pad - 1, g.upper_slot)
    else:
        upper = np.zeros((0, 1, 1), dtype=np.int32)
        upper_slot = np.zeros((0, n_pad), dtype=np.int32)
    return upper, upper_slot


def pad_vectors(x: np.ndarray, n_pad: int, dtype=np.float32) -> np.ndarray:
    """Pad the vector table to n_pad rows (dummy rows are zero)."""
    n, d = x.shape
    out = np.zeros((n_pad, d), dtype=dtype)
    out[:n] = x
    return out
