"""hnswlib binary index (`.bin`) import/export, byte-compatible with stock
hnswlib's saveIndex/loadIndex (port of hnsw_tpu/io/hnswbin.py, numpy only):
an index file written by hnswlib loads here, and a file written here loads
in hnswlib and in the JAX package, byte for byte the file the JAX package
writes for the same graph and vectors.

Format (reference: saveIndex at hnswlib/hnswalg.h:685-713, loadIndex at
716-822, layout constants at 112-130), all little-endian:

    header (96 bytes):
        offsetLevel0_            u64   (always 0)
        max_elements_            u64
        cur_element_count        u64
        size_data_per_element_   u64   = 4 + 4*maxM0 + data_size + 8
        label_offset_            u64   = 4 + 4*maxM0 + data_size
        offsetData_              u64   = 4 + 4*maxM0
        maxlevel_                i32
        enterpoint_node_         u32
        maxM_                    u64
        maxM0_                   u64   (= 2*M)
        M_                       u64
        mult_                    f64   (= 1/ln(M))
        ef_construction_         u64

    level-0 block: cur_element_count x size_data_per_element_ bytes, per
    element:
        u16 level-0 link count | u8 flags (bit0 = DELETE_MARK,
            hnswalg.h:21,873-921) | u8 reserved
        maxM0 x u32 neighbor internal ids (first `count` valid)
        data_size bytes of vector data (f32 for L2Space/IPSpace,
            u8 for L2SpaceI, space_l2.h:294-323)
        u64 external label

    per element, in internal-id order (hnswalg.h:706-712):
        u32 linkListSize  (= element_level * (4 + 4*maxM), 0 if level 0)
        linkListSize bytes: per level 1..element_level,
            u16 count | u16 reserved | maxM x u32 neighbor ids

The reader keeps loadIndex's corruption scan (hnswalg.h:752-771): the file
must end exactly after the last linklist record. Both directions run on the
host; the index moves to the device at its first search.
"""

from __future__ import annotations

import struct

import numpy as np

from hnsw_tpu_torch.core.graph import HNSWGraph

_HEADER = struct.Struct("<QQQQQQiIQQQdQ")  # 96 bytes
_F32_SPACES = ("l2", "ip", "cosine")


def read_bin(path: str, space: str = "l2"):
    """Parse a saveIndex file into (HNSWGraph, vectors, deleted, meta).

    `space` names the persist space the file was built over: 'l2', 'ip' and
    'cosine' expect f32 vector data (dim = data_size / 4), 'l2u8' the
    integer L2SpaceI layout (u8 data, dim = data_size). `vectors` are the
    raw stored values (u8 codes for 'l2u8'), `deleted` the DELETE_MARK bit
    per element."""
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < _HEADER.size:
        raise ValueError(f"{path}: shorter than the 96-byte header")
    (off_l0, max_elements, n, sdpe, label_off, data_off, max_level,
     entry, max_m, max_m0, m, mult, ef_c) = _HEADER.unpack_from(buf, 0)
    if off_l0 != 0:
        raise ValueError(f"{path}: offsetLevel0 {off_l0} != 0 (unsupported)")
    data_size = label_off - data_off
    if data_off != 4 + 4 * max_m0 or sdpe != label_off + 8 or data_size <= 0:
        raise ValueError(
            f"{path}: inconsistent layout (sdpe={sdpe} label_off={label_off} "
            f"data_off={data_off} maxM0={max_m0})"
        )
    if space == "l2u8":
        dim = data_size
    elif space in _F32_SPACES:
        if data_size % 4:
            raise ValueError(
                f"{path}: data_size {data_size} not a multiple of 4 — not an "
                f"f32 space (pass space='l2u8' for L2SpaceI files)"
            )
        dim = data_size // 4
    else:
        raise ValueError(f"unknown space {space!r}")

    # the level-0 block in one vectorized parse
    pos = _HEADER.size
    l0_end = pos + n * sdpe
    if l0_end > len(buf):
        raise ValueError(f"{path}: truncated level-0 block")
    l0 = np.frombuffer(buf, dtype=np.uint8, count=n * sdpe, offset=pos)
    l0 = l0.reshape(n, sdpe)
    counts0 = l0[:, 0:2].copy().view("<u2").reshape(n).astype(np.int64)
    deleted = (l0[:, 2] & 0x01).astype(np.uint8)
    ids0 = l0[:, 4 : 4 + 4 * max_m0].copy().view("<u4").reshape(n, max_m0)
    if n and int(counts0.max(initial=0)) > max_m0:
        raise ValueError(f"{path}: level-0 count exceeds maxM0 (corrupt)")
    level0 = np.where(
        np.arange(max_m0)[None, :] < counts0[:, None], ids0, -1
    ).astype(np.int32)
    raw_vec = l0[:, data_off : data_off + data_size].copy()
    if space == "l2u8":
        vectors = raw_vec
    else:
        vectors = raw_vec.view("<f4").reshape(n, dim)
    labels = (
        l0[:, label_off : label_off + 8].copy().view("<u8").reshape(n)
        .astype(np.int64)
    )

    # Upper linklists: variable-length records whose offsets are all
    # 4-aligned (linkListSize is level * (4 + 4*maxM)), so walk a u32 view.
    # The walk is loadIndex's corruption check too.
    tail_bytes = len(buf) - l0_end
    if tail_bytes % 4:
        raise ValueError(f"{path}: trailing bytes not u32-aligned (corrupt)")
    tail = np.frombuffer(buf, dtype="<u4", count=tail_bytes // 4,
                         offset=l0_end)
    slpe_w = 1 + max_m  # words per level record
    node_level = np.zeros(n, dtype=np.int32)
    starts = np.zeros(n, dtype=np.int64)  # word offset of the first level record
    p = 0
    for i in range(n):
        if p >= len(tail):
            raise ValueError(f"{path}: truncated linklists at element {i}")
        size = int(tail[p])
        if size % (4 * slpe_w):
            raise ValueError(
                f"{path}: element {i} linkListSize {size} not a multiple of "
                f"the per-level record size (corrupt or different maxM)"
            )
        node_level[i] = size // (4 * slpe_w)
        starts[i] = p + 1
        p += 1 + size // 4
    if p != len(tail):
        raise ValueError(f"{path}: {4 * (len(tail) - p)} bytes past the last "
                         f"linklist (corrupt or unsupported)")

    if max_level > 0:
        counts_per = [int((node_level >= l).sum())
                      for l in range(1, max_level + 1)]
        u_max = max(max(counts_per, default=1), 1)
        width = max(int(max_m), 1)
        upper = np.full((max_level, u_max, width), -1, dtype=np.int32)
        upper_slot = np.full((max_level, n), -1, dtype=np.int32)
        for l in range(1, max_level + 1):
            nodes = np.where(node_level >= l)[0]
            if not len(nodes):
                continue
            base = starts[nodes] + (l - 1) * slpe_w
            cnt = (tail[base] & 0xFFFF).astype(np.int64)  # the u16 count
            if int(cnt.max(initial=0)) > max_m:
                raise ValueError(f"{path}: level-{l} count exceeds maxM")
            rows = tail[base[:, None] + 1 + np.arange(max_m)]
            rows = np.where(
                np.arange(max_m)[None, :] < cnt[:, None], rows, -1
            ).astype(np.int32)
            upper_slot[l - 1, nodes] = np.arange(len(nodes), dtype=np.int32)
            upper[l - 1, : len(nodes), :] = rows
    else:
        upper = np.zeros((0, 1, 1), dtype=np.int32)
        upper_slot = np.zeros((0, n), dtype=np.int32)

    g = HNSWGraph(
        level0=level0, upper=upper, upper_slot=upper_slot,
        node_level=node_level, labels=labels,
        entry_point=int(entry) if n else -1,
        max_level=int(max_level),
    )
    meta = {
        "space": space, "dim": int(dim), "m": int(m),
        "max_m": int(max_m), "max_m0": int(max_m0),
        "ef_construction": int(ef_c), "mult": float(mult),
        "max_elements": int(max_elements),
    }
    return g, vectors, deleted, meta


def _front_packed(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(counts, ids): each row's valid (>= 0) ids moved to the front in
    order, the rest zero (hnswlib reads only the first `count` slots)."""
    valid = rows >= 0
    counts = valid.sum(1).astype(np.int64)
    order = np.argsort(~valid, axis=1, kind="stable")
    compacted = np.take_along_axis(rows, order, axis=1)
    keep = np.arange(rows.shape[1])[None, :] < counts[:, None]
    front = np.zeros(rows.shape, dtype="<u4")
    front[keep] = compacted[keep].astype("<u4")
    return counts, front


def write_bin(
    path: str,
    g: HNSWGraph,
    vectors: np.ndarray,
    deleted: np.ndarray | None = None,
    *,
    space: str = "l2",
    m: int | None = None,
    ef_construction: int = 200,
) -> None:
    """Write a saveIndex-layout file that stock hnswlib's loadIndex accepts.

    `vectors` are the stored values: f32 [n, dim] for 'l2', 'ip' and
    'cosine' (cosine rows already L2-normalized, hnswlib's cosine recipe),
    u8 codes [n, dim] for 'l2u8' (loaded over L2SpaceI)."""
    n = g.num_nodes
    if m is None:
        m = g.max_m if g.max_level > 0 else max(g.max_m0 // 2, 1)
    max_m, max_m0 = int(m), 2 * int(m)
    if g.max_m0 > max_m0 or (g.max_level > 0 and g.max_m > max_m):
        raise ValueError(
            f"graph wider than the target layout (level0 {g.max_m0} > "
            f"{max_m0} or upper {g.max_m} > {max_m})"
        )
    if space == "l2u8":
        vec_bytes = np.ascontiguousarray(vectors, dtype=np.uint8).reshape(n, -1)
    elif space in _F32_SPACES:
        vec_bytes = (
            np.ascontiguousarray(vectors, dtype="<f4").reshape(n, -1)
            .view(np.uint8)
        )
    else:
        raise ValueError(f"unknown space {space!r}")
    data_size = vec_bytes.shape[1]
    data_off = 4 + 4 * max_m0
    label_off = data_off + data_size
    sdpe = label_off + 8
    mult = 1.0 / np.log(float(m)) if m > 1 else 1.0

    l0 = np.zeros((n, sdpe), dtype=np.uint8)
    pad0 = np.full((n, max_m0), -1, dtype=np.int32)
    pad0[:, : g.max_m0] = g.level0
    counts0, ids_front = _front_packed(pad0)
    l0[:, 0:2] = counts0.astype("<u2").view(np.uint8).reshape(n, 2)
    if deleted is not None:
        l0[:, 2] = (np.asarray(deleted, dtype=np.uint8) != 0).astype(np.uint8)
    l0[:, 4:data_off] = ids_front.view(np.uint8).reshape(n, 4 * max_m0)
    l0[:, data_off:label_off] = vec_bytes
    l0[:, label_off:] = (
        np.ascontiguousarray(g.labels, dtype="<u8").view(np.uint8)
        .reshape(n, 8)
    )

    # the per-element linklist records
    node_level = np.asarray(g.node_level, dtype=np.int64)
    slpe_w = 1 + max_m
    rec_words = 1 + node_level * slpe_w
    tail = np.zeros(int(rec_words.sum()), dtype="<u4")
    rec_start = np.concatenate([[0], np.cumsum(rec_words)[:-1]]).astype(np.int64)
    tail[rec_start] = (node_level * (4 * slpe_w)).astype("<u4")
    for l in range(1, g.max_level + 1):
        nodes = np.where(node_level >= l)[0]
        if not len(nodes):
            continue
        slots = g.upper_slot[l - 1, nodes]
        rows = np.full((len(nodes), max_m), -1, dtype=np.int32)
        ok = slots >= 0
        src = g.upper[l - 1][slots[ok]][:, : min(max_m, g.upper.shape[2])]
        rows[ok, : src.shape[1]] = src
        cntl, front = _front_packed(rows)
        base = rec_start[nodes] + 1 + (l - 1) * slpe_w
        tail[base] = cntl.astype("<u4")  # the u16 count in the low half
        tail[(base[:, None] + 1 + np.arange(max_m)).ravel()] = front.ravel()

    header = _HEADER.pack(
        0, n, n, sdpe, label_off, data_off,
        int(g.max_level), int(max(g.entry_point, 0)),
        max_m, max_m0, int(m), float(mult), int(ef_construction),
    )
    with open(path, "wb") as f:
        f.write(header)
        f.write(l0.tobytes())
        f.write(tail.tobytes())
