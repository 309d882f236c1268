"""Device-accelerated bulk index construction (counterpart of
hnsw_tpu/models/bulk_build.py).

The reference builds strictly serially: one ef_construction beam search per
inserted point on the CPU (the build hot loop, index_builder/build.cpp:137-145
-> hnswalg.h:954-1267). That search is most of the build's compute. Here it
runs on the card in geometric waves:

  1. Levels are pre-sampled host-side (the geometric distribution of
     hnswalg.h:207-211). The ~1/M of nodes with level >= 1 are inserted by
     the native host engine, or, when there are many, built by a recursive
     bulk_build of that subset: they form the upper hierarchy and the seed
     graph.
  2. The remaining level-0-only nodes are registered unlinked, then linked
     in geometrically growing waves. Per wave:
       a. the device state is brought up to date (HNSWIndex._sync_device:
          the first wave uploads everything, later waves apply the row
          deltas of the previous wave's links),
       b. a batched beam search over that snapshot (search_batch with the
          ef_construction beam, on the split tier through the
          hop_dist_inline kernel) gives candidate lists,
       c. the neighbor-selection heuristic (getNeighborsByHeuristic2,
          hnswalg.h:443-483) runs vectorized on the device: one batched
          matrix product for the candidate-candidate distances, then a
          masked scan over the candidates,
       d. the links (forward, and reverse with overflow re-prune) are
          applied by the native engine (connect_batch).

  Nodes of one wave do not see each other as candidates (they search the
  pre-wave snapshot): the staleness tradeoff of batched ANN construction. The
  geometric wave growth keeps the early, structure-defining edges close to
  incremental quality.

A failing device step raises; a tail wave runs at its own size.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import time

import numpy as np
import torch

from hnsw_tpu_torch.core.graph import HNSWGraph, round_up
from hnsw_tpu_torch.core.spaces import Space, get_space
from hnsw_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from hnsw_tpu_torch.models.hnsw import (
    UNIFIED_WAVE_MAX_BYTES,
    HNSWIndex,
    inline_search_kwargs,
    landmark_arrays,
)
from hnsw_tpu_torch.native.hnsw_builder import NativeHNSWBuilder
from hnsw_tpu_torch.ops.distance import matmul_precision
from hnsw_tpu_torch.ops.gather_kernels import COUNTS, tier_bytes
from hnsw_tpu_torch.ops.topk import seed_topk
from hnsw_tpu_torch.ops.traversal import search_batch


def select_neighbors_device(
    vectors: torch.Tensor,  # [N_pad, D]
    cand_ids: torch.Tensor,  # [W, C] ascending by distance (sentinel >= num_nodes)
    cand_d: torch.Tensor,  # [W, C] distance to the new node (inf = invalid)
    num_nodes: int,
    m: int,
    space: str = "l2",
) -> torch.Tensor:
    """Vectorized getNeighborsByHeuristic2 (hnswalg.h:443-483): scan the
    candidates closest-first, keep one iff it is no farther from the new node
    than from every already-kept candidate; stop at m. Returns kept ids
    [W, m] int32 (-1 padded), closest first."""
    w, c = cand_ids.shape
    in_range = cand_ids < num_nodes
    rows = vectors[torch.where(in_range, cand_ids, 0).long()].float()  # [W, C, D]
    # candidate-candidate distances from one batched matrix product, in true
    # fp32 (TF32 would misrank near-ties)
    with matmul_precision("highest"):
        g = torch.bmm(rows, rows.transpose(1, 2))  # [W, C, C] gram
    if space == "l2":
        sq = (rows * rows).sum(-1)  # [W, C]
        pair = (sq[:, :, None] + sq[:, None, :] - 2.0 * g).clamp_min_(0.0)
    else:
        pair = 1.0 - g
    valid = in_range & torch.isfinite(cand_d)

    keep = torch.zeros((w, c), dtype=torch.bool, device=cand_ids.device)
    count = torch.zeros((w,), dtype=torch.int32, device=cand_ids.device)
    inf = torch.full((), torch.inf, device=cand_ids.device)
    for j in range(c):
        # min distance from candidate j to the already-kept candidates
        min_kept = torch.where(keep, pair[:, j, :], inf).min(-1).values
        # keep on ties: the reference rejects only when a kept neighbor is
        # strictly closer to the candidate than the new node is
        ok = valid[:, j] & (count < m) & (min_kept >= cand_d[:, j])
        keep[:, j] = ok
        count += ok.to(torch.int32)
    # compact the kept ids into [W, m]: kept first, by distance (stable, so
    # ties come out in candidate order)
    key = torch.where(keep, cand_d, inf)
    order = torch.sort(key, dim=-1, stable=True).indices
    kept_ids = torch.where(keep, cand_ids, -1).gather(-1, order)
    return kept_ids[:, :m].to(torch.int32)


def select_neighbors_host(
    vectors: np.ndarray,  # [N, D] host copy
    cand_ids: np.ndarray,  # [W, C]
    cand_d: np.ndarray,  # [W, C]
    num_nodes: int,
    m: int,
    space: str = "l2",
) -> np.ndarray:
    """NumPy mirror of select_neighbors_device (the recursive upper phase
    prunes its level-1 links with it)."""
    w, c = cand_ids.shape
    safe = np.clip(cand_ids, 0, num_nodes - 1)
    rows = vectors[safe]  # [W, C, D]
    g = np.einsum("wcd,wed->wce", rows, rows, optimize=True)
    if space == "l2":
        sq = np.einsum("wcd,wcd->wc", rows, rows)
        pair = np.maximum(sq[:, :, None] + sq[:, None, :] - 2.0 * g, 0.0)
    else:
        pair = 1.0 - g
    valid = (cand_ids < num_nodes) & np.isfinite(cand_d)
    keep = np.zeros((w, c), dtype=bool)
    count = np.zeros(w, dtype=np.int32)
    for j in range(c):
        dj = np.where(keep, pair[:, j, :], np.inf)
        min_kept = dj.min(axis=-1)
        ok = valid[:, j] & (count < m) & (min_kept >= cand_d[:, j])
        keep[:, j] = ok
        count += ok.astype(np.int32)
    key = np.where(keep, cand_d, np.inf)
    order = np.argsort(key, axis=1, kind="stable")
    sel = np.take_along_axis(np.where(keep, cand_ids, -1), order, axis=1)
    return sel[:, :m].astype(np.int32)


def wave_device_step(
    st,  # the index's synced device state
    q: torch.Tensor,  # [W, D] f32 vectors of the wave's nodes, on the device
    *,
    m: int,
    ef_construction: int,
    k_sel: int,
    space: str,
    stop_frontier: float = 0.0,
    entry_seeds: int = 0,
    seed_pool: int = 0,
    timings: dict | None = None,
) -> torch.Tensor:
    """A wave's device step: beam-search the snapshot `st` for each new
    node's k_sel candidates (expand=2; landmark-seeded entry when
    entry_seeds > 0), then select m of them by the heuristic. Returns the
    selected ids [W, m] int32 (-1 padded). With `timings`, adds the search
    and select seconds to it (each ends in a device synchronize)."""
    dg, x, sq = st.graph, st.vectors, st.sq_norms
    t0 = time.time()
    seed_kwargs = {}
    if entry_seeds > 0 and dg.max_level > 0:
        # an exact top-s over the upper-level nodes (plus seed_pool strided
        # level-0 nodes) replaces the greedy descent
        lm = landmark_arrays(dg, x, sq, pool_extra=seed_pool)
        if lm is not None:
            lv, li, lsq = lm
            s = min(entry_seeds, int(li.shape[0]), k_sel)
            sd, si = seed_topk(q, lv, s, space, x_sq_norms=lsq)
            seed_kwargs = {"seed_ids": li[si], "seed_dists": sd}
    res = search_batch(
        x, dg, q, k=k_sel, ef=ef_construction, space=space, sq_norms=sq,
        **inline_search_kwargs(st), expand=2, stop_frontier=stop_frontier,
        **seed_kwargs,
    )
    if timings is not None:
        _device_sync(q)
        timings["search_s"] = timings.get("search_s", 0.0) + time.time() - t0
        t0 = time.time()
    sel = select_neighbors_device(x, res.ids, res.dists, dg.num_nodes, m, space)
    if timings is not None:
        _device_sync(q)
        timings["select_s"] = timings.get("select_s", 0.0) + time.time() - t0
    return sel


def _device_sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _recursive_upper_phase(
    idx, data, labels, levels, hi, space, m, ef_construction, seed,
    first_wave, select_c, verbose, upper_recurse_min,
    wave_stop_frontier=0.0, wave_entry_seeds=0, wave_seed_pool=0,
    device="cuda",
):
    """Build the level>=1 hierarchy by recursing bulk_build on the subset
    (levels shifted down by one), then graft the sub-graph into `idx`'s
    host engine via the array importer. Returns the new engine.

    Mapping (sub node j == main node j, since hi is inserted in order):
    - main level-0 links of upper nodes := sub level-0 (cap 2M): the same
      upper-only initial neighborhood the serial host phase produces; later
      waves re-link them mutually with the rest of the data.
    - main level-1 links := sub level-0 heuristic-pruned to M
      (getNeighborsByHeuristic2 semantics, hnswalg.h:443-483).
    - main level l+1 links := sub level l links, slots reused verbatim.
    """
    nh = len(hi)
    # positional labels: the sub build reorders internally (its own upper
    # nodes insert first); g_sub.labels[j] recovers the input position of sub
    # node j, and everything below is remapped back to input order. `data`
    # is already preprocessed by the enclosing bulk_build, so the sub-build
    # gets the kernel-dispatch space (plain l2/ip pass-through), not the
    # user space: a non-idempotent preprocess (the l2u8 shift) would
    # otherwise be applied twice
    sub = bulk_build(
        data[hi], labels=np.arange(nh, dtype=np.int64),
        space=get_space(space.name, data.shape[1]), m=m,
        ef_construction=ef_construction, seed=seed + 1,
        first_wave=first_wave, select_c=select_c, verbose=verbose,
        upper_recurse_min=upper_recurse_min, _levels=levels[hi] - 1,
        wave_stop_frontier=wave_stop_frontier,
        wave_entry_seeds=wave_entry_seeds,
        wave_seed_pool=wave_seed_pool,
        device=device,
    )
    g_sub = sub._builder.export_graph()
    del sub  # releases its device tables before the main waves allocate
    xh = np.ascontiguousarray(data[hi], dtype=np.float32)
    perm = np.asarray(g_sub.labels, dtype=np.int64)  # sub id -> input pos
    inv = np.empty(nh, dtype=np.int64)
    inv[perm] = np.arange(nh)  # input pos -> sub id

    def remap(ids):
        return np.where(
            ids >= 0, perm[np.clip(ids, 0, nh - 1)], -1
        ).astype(np.int32)

    # level-0 rows in input order, neighbor ids as input positions
    l0 = remap(np.asarray(g_sub.level0, dtype=np.int32))[inv]  # [nh, 2m]

    # level-1 links: prune each node's 2M level-0 candidates to the best M
    # by the diversity heuristic (chunked: the gathered rows are large)
    pruned = np.full((nh, m), -1, dtype=np.int32)
    chunk = 8192
    for s in range(0, nh, chunk):
        e = min(s + chunk, nh)
        ids_c = l0[s:e]
        safe = np.clip(ids_c, 0, nh - 1)
        rows = xh[safe]  # [c, 2m, D]
        qc = xh[s:e][:, None, :]
        if space.name == "l2":
            d_c = ((rows - qc) ** 2).sum(-1)
        else:
            d_c = 1.0 - np.einsum("cmd,cod->cm", rows, qc)
        d_c = np.where(ids_c >= 0, d_c, np.inf).astype(np.float32)
        order = np.argsort(d_c, axis=1, kind="stable")
        ids_s = np.take_along_axis(ids_c, order, axis=1)
        d_s = np.take_along_axis(d_c, order, axis=1)
        pruned[s:e] = select_neighbors_host(xh, ids_s, d_s, nh, m, space.name)

    L = g_sub.max_level + 1
    lv_main = levels[hi].astype(np.int32)
    upper = np.full((L, nh, m), -1, dtype=np.int32)
    upper_slot = np.full((L, nh), -1, dtype=np.int32)
    upper[0, :, :] = pruned
    upper_slot[0, :] = np.arange(nh, dtype=np.int32)
    for l in range(1, L):
        # sub level l == main level l+1; slot numbering is reused (rows are
        # indexed by slot), only the node ids inside rows and the per-node
        # slot lookups need the input-order remap
        su = remap(np.asarray(g_sub.upper[l - 1], dtype=np.int32))
        upper[l, : su.shape[0], : su.shape[1]] = su
        upper_slot[l, :] = g_sub.upper_slot[l - 1, inv]

    g_main = HNSWGraph(
        level0=l0,
        upper=upper,
        upper_slot=upper_slot,
        node_level=lv_main,
        labels=np.asarray(labels[hi], dtype=np.int64),
        entry_point=int(perm[g_sub.entry_point]),
        max_level=L,
    )
    b_new = NativeHNSWBuilder.from_graph(
        g_main, xh, None, space=space.name,
        ef_construction=ef_construction, seed=seed,
    )
    idx._builder = b_new
    return b_new


def _data_fingerprint(data: np.ndarray) -> str:
    """Cheap input-data identity for checkpoint resume validation: hash of
    the first and last rows plus the shape (hashing the whole array would
    cost seconds at 1M rows)."""
    h = hashlib.sha1()
    h.update(np.asarray(data.shape, np.int64).tobytes())
    if data.size:
        h.update(np.ascontiguousarray(data[0]).tobytes())
        h.update(np.ascontiguousarray(data[-1]).tobytes())
    return h.hexdigest()[:16]


def bulk_build(
    data: np.ndarray,
    labels: np.ndarray | None = None,
    space: Space | str = "l2",
    m: int = 16,
    ef_construction: int = 200,
    seed: int = 123,
    first_wave: int = 4096,
    select_c: int = 64,
    verbose: bool = False,
    checkpoint: str | None = None,
    checkpoint_every_s: float = 180.0,
    upper_recurse_min: int = 20_000,
    wave_size: int | None = None,
    wave_stop_frontier: float = 0.0,
    wave_entry_seeds: int = 0,
    wave_seed_pool: int = 0,
    _levels: np.ndarray | None = None,
    device="cuda",
):
    """Build an HNSWIndex with device-accelerated construction.

    Returns the HNSWIndex (host engine fully populated: incremental
    insert/update/delete and persistence all work afterwards). Its
    `wave_log` lists, per wave, the node count, the tier, the sync mode and
    the seconds of the sync, search, select and link stages;
    `upper_phase_s` holds the upper phase's wall seconds, up to the card's
    end of the work (None when the build resumed past it).

    `checkpoint`: path prefix for periodic recovery saves (at a wave
    boundary once `checkpoint_every_s` of build work has elapsed since the
    last save). If `<checkpoint>.npz` and `<checkpoint>.state.json` exist,
    the build RESUMES from the saved wave cursor: the level sampling is
    deterministic in `seed`, so the node-id assignment replays exactly. A
    caller whose process died restarts it and loses at most
    `checkpoint_every_s` of work.

    `device`: where the waves run ("cuda", the default, or "cpu").
    """
    if isinstance(space, str):
        space = get_space(space, data.shape[1])
    data = space.preprocess(data)
    n = data.shape[0]
    if labels is None:
        labels = np.arange(n, dtype=np.int64)
    labels = np.asarray(labels, dtype=np.int64)

    if _levels is None:
        rng = np.random.default_rng(seed)
        # 1) pre-sample levels (hnswalg.h:207-211 distribution)
        mult = 1.0 / math.log(m)
        levels = np.floor(-np.log(rng.uniform(size=n)) * mult).astype(np.int32)
    else:
        levels = np.asarray(_levels, dtype=np.int32)
    hi = np.where(levels >= 1)[0]
    lo = np.where(levels == 0)[0]
    if verbose:
        print(f"bulk_build: {len(hi)} upper nodes (host), {len(lo)} level-0 (device)",
              flush=True)

    state_path = f"{checkpoint}.state.json" if checkpoint else None
    ckpt_path = f"{checkpoint}.npz" if checkpoint else None
    config = {
        "n": n, "seed": seed, "m": m, "dim": int(data.shape[1]),
        "space": space.persist_name, "efc": ef_construction,
        "fp": _data_fingerprint(data),
    }
    resume_pos = resume_wave = None
    if checkpoint and os.path.exists(state_path) and os.path.exists(ckpt_path):
        with open(state_path) as f:
            st = json.load(f)
        # full config + cheap data fingerprint: a stale checkpoint at the
        # same path from a different dataset/config must NOT silently resume
        # (vectors replay from the NEW data against the OLD graph)
        if all(st.get(key) == val for key, val in config.items()):
            g, vecs_ck, deleted_ck, _meta = load_checkpoint(ckpt_path)
            if vecs_ck.shape[1] == 0:
                # graph-only checkpoint: vectors replay deterministically in
                # insertion order (upper nodes first, then registered level-0)
                order = np.concatenate([hi, lo])[: g.num_nodes]
                vecs_ck = np.ascontiguousarray(data[order])
            idx = HNSWIndex(space, m=m, ef_construction=ef_construction,
                            seed=seed, device=device)
            idx._builder = NativeHNSWBuilder.from_graph(
                g, vecs_ck, deleted_ck, space=space.name,
                ef_construction=ef_construction,
            )
            b = idx._builder
            resume_pos, resume_wave = st["pos"], st["wave"]
            upper_phase_s = None  # the saved build ran it
            if verbose:
                print(f"  resume: wave cursor pos={resume_pos} of {len(lo)}", flush=True)
        elif verbose:
            print("  checkpoint config mismatch: rebuilding from scratch", flush=True)

    if resume_pos is None:
        idx = HNSWIndex(space, m=m, ef_construction=ef_construction, seed=seed,
                        device=device)
        b = idx._builder

        t0 = time.time()
        if len(hi) >= upper_recurse_min:
            # Recursive upper phase: the level>=1 subset with every level
            # decremented IS an HNSW of the subset (the geometric level
            # distribution is self-similar), so build it with the same
            # device-wave machinery instead of ~N/M serial host inserts,
            # then graft its graph in as the main hierarchy: sub level-0
            # (cap 2M) becomes the upper nodes' initial main level-0 links
            # AND, heuristic-pruned to M, the main level-1 links; sub level l
            # becomes main level l+1.
            b = _recursive_upper_phase(
                idx, data, labels, levels, hi, space, m, ef_construction,
                seed, first_wave, select_c, verbose, upper_recurse_min,
                wave_stop_frontier=wave_stop_frontier,
                wave_entry_seeds=wave_entry_seeds,
                wave_seed_pool=wave_seed_pool,
                device=device,
            )
        else:
            # host-insert the hierarchy seed (small: ~N/M of the data)
            for i in hi:
                b.add_with_level(data[i], int(labels[i]), int(levels[i]))
        if idx.device.type == "cuda":
            torch.cuda.synchronize(idx.device)
        upper_phase_s = time.time() - t0
        if verbose:
            print(f"  upper phase: {upper_phase_s:.1f}s", flush=True)

        # 2) register level-0 nodes unlinked (so ALL vectors exist now: the
        # device vector table uploads once, and per wave only the touched
        # rows move through the incremental sync)
        first_id = b.register_level0_batch(data[lo], labels[lo])
    else:
        first_id = len(hi)
    idx.growth_headroom = 0.0  # N is fixed for the whole build
    ids_lo = np.arange(first_id, first_id + len(lo), dtype=np.uint32)

    def save_state(pos, wave):
        if not checkpoint:
            return
        t0 = time.time()
        # atomic: a crash mid-save must not corrupt the resume point.
        # Graph-only (vectors replay from `data` on resume): the vectors
        # would be most of the write
        save_checkpoint(
            ckpt_path + ".tmp.npz",
            b.export_graph(),
            np.zeros((0, 0), np.float32),
            b.export_deleted(),
            meta={"space": space.persist_name, "dim": space.dim, "m": m,
                  "ef_construction": ef_construction},
            compress=False,
            include_vectors=False,
        )
        os.replace(ckpt_path + ".tmp.npz", ckpt_path)
        with open(state_path + ".tmp", "w") as f:
            json.dump({"pos": pos, "wave": wave, **config}, f)
        os.replace(state_path + ".tmp", state_path)
        if verbose:
            print(f"  checkpoint @pos={pos}: {time.time() - t0:.1f}s", flush=True)

    # 3) wave linking: first_wave, doubling up to wave_size. Device state is
    # maintained across waves by HNSWIndex._sync_device: the first sync
    # uploads everything, each later wave applies only the connect_batch row
    # deltas (dirty-node tracking in the native engine).
    if wave_size is None:
        wave_size = max(first_wave * 4, 1024)
    k_sel = min(select_c, ef_construction)

    # Wave tier, decided here in the open. The split table when it fits: its
    # row delta is one bf16 row gather and scatter, so the unified budget is
    # clamped to UNIFIED_WAVE_MAX_BYTES and the ladder falls to the split
    # rung. Past the split budget (the index's split_max_bytes, else
    # hnsw.SPLIT_MAX_BYTES, else the free share: read here, at call time)
    # the serving budget stands (a unified rung, int8 at the sizes where bf16
    # does not fit either) without the upper descent tables. Where no rung fits, the first wave's sync raises
    # (build_inline_tables); the waves search through row gathers only on an
    # index made with inline_neighbors off (M > 64). Each wave's verbose line
    # and wave_log entry name the tier it ran on.
    serve = (idx.unified_max_bytes, idx.split_max_bytes, idx.upper_inline)
    n_pad_est = round_up(n + 1, 128)
    m0_pad = max(16, round_up(2 * m, 16))
    split_budget = idx._split_budget()
    split_fits = (split_budget is None
                  or tier_bytes(n_pad_est, m0_pad, space.dim)["split"] <= split_budget)
    if split_fits:
        idx.unified_max_bytes = UNIFIED_WAVE_MAX_BYTES
    else:
        idx.unified_max_bytes = idx._unified_budget()
        idx.upper_inline = False
    idx.split_max_bytes = split_budget
    idx.upper_phase_s = upper_phase_s
    idx.wave_log = []

    def wave_link(rows, ids):
        cnt = len(rows)
        rec = {"cnt": cnt, "hop_dist_inline": COUNTS.hop_dist_inline}
        t0 = time.time()
        idx._dirty = True
        st = idx._sync_device()
        _device_sync(st.vectors)
        rec.update(sync_s=time.time() - t0, tier=st.tier,
                   sync_mode=idx._last_sync_mode,
                   sync_refusal=idx._last_sync_refusal)
        q = torch.from_numpy(np.ascontiguousarray(data[rows])).to(idx.device)
        sel = wave_device_step(
            st, q, m=m, ef_construction=ef_construction, k_sel=k_sel,
            space=space.name, stop_frontier=wave_stop_frontier,
            entry_seeds=wave_entry_seeds, seed_pool=wave_seed_pool, timings=rec,
        ).cpu().numpy()
        rec["hop_dist_inline"] = COUNTS.hop_dist_inline - rec["hop_dist_inline"]
        t0 = time.time()
        b.connect_batch(ids, sel)
        rec["link_s"] = time.time() - t0
        idx.wave_log.append(rec)
        if verbose:
            print(
                f"  wave {cnt}: tier {rec['tier'] or 'row gathers'} sync "
                f"{rec['sync_mode']} {rec['sync_s']:.2f}s search "
                f"{rec['search_s']:.2f}s select {rec['select_s']:.2f}s link "
                f"{rec['link_s']:.2f}s", flush=True,
            )

    pos = resume_pos or 0
    wave = resume_wave or first_wave
    if resume_pos is None:
        save_state(0, first_wave)  # checkpoint the (expensive) upper phase
    last_save = time.time()
    try:
        while pos < len(lo):
            cnt = min(wave, len(lo) - pos)
            wave_link(lo[pos : pos + cnt], ids_lo[pos : pos + cnt])
            pos += cnt
            wave = min(wave * 2, wave_size)
            if pos < len(lo) and time.time() - last_save > checkpoint_every_s:
                save_state(pos, wave)
                last_save = time.time()
    finally:
        # the serving configuration, and the post-build insert headroom
        idx.unified_max_bytes, idx.split_max_bytes, idx.upper_inline = serve
        idx.growth_headroom = 1 / 16
        idx._dirty = True
    if checkpoint:
        save_state(len(lo), wave)
    return idx
