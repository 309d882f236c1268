"""`.adj` adjacency-format import/export, byte-compatible with the reference
(port of hnsw_tpu/io/adj.py, numpy only).

Format (reference: index_builder/build.cpp:14-21, writer at 22-107; loader at
hnsw_service/hnsw_graph.cpp:14-151), all little-endian uint32:

    header:  entrypoint, max_level, node_count
    per node (in internal-id order):
        label
        levels            (= top level + 1)
        per level 0..top:
            deg
            deg x neighbor internal ids

An index exported by the reference's `index_builder` or by the JAX package
loads here, and a graph exported here loads in the reference's
`hnsw_service` optimized mode and in the JAX package.
"""

from __future__ import annotations

import numpy as np

from hnsw_tpu_torch.core.graph import HNSWGraph


def _scatter_lists(out, starts, rows, valid):
    """Compact each row's valid entries (row-major order) and scatter them
    into `out` starting at `starts[i]` — the vectorized core of the writer."""
    deg = valid.sum(1)
    total = int(deg.sum())
    if total == 0:
        return
    flat_vals = rows[valid]
    intra = np.arange(total) - np.repeat(
        np.concatenate([[0], np.cumsum(deg)[:-1]]), deg
    )
    out[np.repeat(starts, deg) + intra] = flat_vals


def write_adj(g: HNSWGraph, path: str) -> None:
    """Fully vectorized writer (the per-node Python loop cost minutes at 1M;
    reference streaming writer: index_builder/build.cpp:22-107). One level at
    a time, positions computed with cumsum/repeat — no per-node work."""
    n = g.num_nodes
    node_level = np.asarray(g.node_level, dtype=np.int64)
    levels = node_level + 1

    l0_valid = g.level0 >= 0
    deg0 = l0_valid.sum(1)
    deg_tot = deg0.copy()
    up_rows, up_valid, up_nodes = [], [], []
    for l in range(1, g.max_level + 1):
        nodes = np.where(node_level >= l)[0]
        slots = g.upper_slot[l - 1, nodes]
        rows = g.upper[l - 1][np.maximum(slots, 0)]
        rows = np.where((slots >= 0)[:, None], rows, -1)
        valid = rows >= 0
        up_rows.append(rows)
        up_valid.append(valid)
        up_nodes.append(nodes)
        deg_tot[nodes] += valid.sum(1)

    sizes = 2 + levels + deg_tot  # label, levels, one deg word per level
    out = np.zeros(3 + int(sizes.sum()), dtype="<u4")
    out[0] = max(g.entry_point, 0)
    out[1] = max(g.max_level, 0)
    out[2] = n
    off = 3 + np.concatenate([[0], np.cumsum(sizes)[:-1]])

    out[off] = np.asarray(g.labels, dtype=np.int64) & 0xFFFFFFFF
    out[off + 1] = levels
    out[off + 2] = deg0
    _scatter_lists(out, off + 3, g.level0, l0_valid)
    cur = off + 3 + deg0  # cursor past each node's level-0 block
    for l in range(1, g.max_level + 1):
        nodes = up_nodes[l - 1]
        valid = up_valid[l - 1]
        degl = valid.sum(1)
        out[cur[nodes]] = degl
        _scatter_lists(out, cur[nodes] + 1, up_rows[l - 1], valid)
        cur[nodes] += 1 + degl
    with open(path, "wb") as f:
        f.write(out.tobytes())


def read_adj(path: str, max_m: int | None = None) -> HNSWGraph:
    """Load an `.adj` file into a padded-CSR HNSWGraph.

    `max_m`: upper-level padding width; defaults to the max upper degree
    found (level-0 width defaults to the max level-0 degree found).
    """
    raw = np.fromfile(path, dtype="<u4")
    entry, max_level, n = int(raw[0]), int(raw[1]), int(raw[2])
    pos = 3

    labels = np.zeros(n, dtype=np.int64)
    node_level = np.zeros(n, dtype=np.int32)
    per_node: list[list[np.ndarray]] = []
    for node in range(n):
        labels[node] = int(raw[pos])
        levels = int(raw[pos + 1])
        pos += 2
        node_level[node] = levels - 1
        lists = []
        for _ in range(levels):
            deg = int(raw[pos])
            pos += 1
            lists.append(raw[pos : pos + deg].astype(np.int32))
            pos += deg
        per_node.append(lists)

    max_m0 = max((len(l[0]) for l in per_node), default=1) or 1
    upper_degs = [len(l[lv]) for l in per_node for lv in range(1, len(l))]
    m = max_m if max_m is not None else (max(upper_degs, default=1) or 1)

    level0 = np.full((n, max_m0), -1, dtype=np.int32)
    for node, lists in enumerate(per_node):
        nb = lists[0]
        level0[node, : len(nb)] = nb

    ml = max_level
    if ml > 0:
        counts = [int(np.sum(node_level >= l)) for l in range(1, ml + 1)]
        u_max = max(counts) if counts else 1
        upper = np.full((ml, u_max, m), -1, dtype=np.int32)
        upper_slot = np.full((ml, n), -1, dtype=np.int32)
        slot_ctr = [0] * ml
        for node, lists in enumerate(per_node):
            for lv in range(1, len(lists)):
                s = slot_ctr[lv - 1]
                slot_ctr[lv - 1] += 1
                upper_slot[lv - 1, node] = s
                nb = lists[lv][:m]
                upper[lv - 1, s, : len(nb)] = nb
    else:
        upper = np.zeros((0, 1, 1), dtype=np.int32)
        upper_slot = np.zeros((0, n), dtype=np.int32)

    return HNSWGraph(
        level0=level0,
        upper=upper,
        upper_slot=upper_slot,
        node_level=node_level,
        labels=labels,
        entry_point=entry,
        max_level=ml,
    )
