"""Batched HNSW graph traversal (counterpart of hnsw_tpu/ops/traversal.py).

The reference's query path (hnswlib::HierarchicalNSW::searchKnn,
hnswlib/hnswalg.h:1271-1324) is a serial pointer-chase: greedy 1-best
descent over the upper layers, then a heap-driven best-first beam over
level 0. Here, as in the JAX package, it is a batched, fixed-shape, masked
program: every query carries a sorted beam of `ef` entries (distance, id*2 +
expanded flag); each iteration expands the `expand` best unexpanded entries
through the hop kernel of the serving tier (the unified bf16, int8 or int4
tables, or the split table of the bulk-build waves: one contiguous block
per expansion), drops candidates already in the beam or in a short ring history of expanded ids,
and merges the rest into the beam with a bitonic merge.

Filtering and delete-marks are an `eligible` mask over node ids: ineligible
nodes are traversed, only eligible ones enter the separate result list.

Loop cadence: the JAX loop checks `any(alive)` on the device every
iteration; in eager torch that check is a host sync. Here the loop checks
every `check_every` iterations (4 by default) and never runs more than
`max_iters`. An iteration run after every query is finished changes no
output: a finished query has no fresh candidates (`active` is false, so
`fresh` is all false), the merge receives only +inf candidates and leaves
the sorted beam's distances and ids as they are, the result list likewise,
and `hops`, `dist_comps` and `last_improve` do not move (`improved` needs
`active`). It may set expanded flags and push sentinel ids into the ring
history, neither of which is an output. The same holds for the greedy
descent: an iteration at a fixed point improves nothing and changes nothing.

Measurement: while a torch profiler runs, the `hnsw.search.descent` span
(utils/trace.py) holds the descent, and the `hnsw.beam.*` spans tile each
iteration (check, select, hop, dedup, merge, stop). `COUNTS.beam_iters`
counts iterations at the loop itself, `COUNTS.host_syncs` every check that
reads back.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hnsw_tpu_torch.core.graph import DeviceGraph
from hnsw_tpu_torch.ops.distance import gather_dist
from hnsw_tpu_torch.ops.gather_kernels import (
    COUNTS,
    UnifiedTable,
    hop_dist_inline,
    hop_dist_unified,
)
from hnsw_tpu_torch.utils.trace import span

_INF = float("inf")


class SearchResults(NamedTuple):
    dists: torch.Tensor  # [B, k] f32, ascending (inf for missing)
    ids: torch.Tensor  # [B, k] int32 internal ids (>= num_nodes for missing)
    hops: torch.Tensor  # [B] int32 (zeros unless collect_metrics)
    dist_comps: torch.Tensor  # [B] int32 (zeros unless collect_metrics)
    # [B] int32: last iteration (1-based) at which the query's k-th best
    # distance improved (zeros unless collect_metrics)
    last_improve: torch.Tensor | None = None


class StopView(NamedTuple):
    """Read-only view of the per-query beam state handed to a custom stop
    condition (BaseSearchStopCondition analog, hnswlib/hnswlib.h:134-150)."""

    beam_d: torch.Tensor  # [B, ef] current beam distances, ascending
    beam_ids: torch.Tensor  # [B, ef] current beam ids
    res_d: torch.Tensor  # [B, ef] filtered result distances (== beam when no mask)
    it: int  # iteration counter
    hops: torch.Tensor  # [B] per-query hop count (when collect_metrics)


# ---------------------------------------------------------------------------
# Upper-layer greedy descent (reference: hnswalg.h:1278-1303).
# ---------------------------------------------------------------------------


def _greedy_walk(step, cur, cur_d, check_every):
    """Run `step(cur) -> (best_d, best)` until an iteration improves no
    query, checking on the host every `check_every` iterations."""
    while True:
        for _ in range(check_every):
            best_d, best = step(cur)
            improved = best_d < cur_d
            cur = torch.where(improved, best, cur)
            cur_d = torch.where(improved, best_d, cur_d)
        COUNTS.host_syncs += 1
        if not bool(improved.any()):
            return cur, cur_d


def _argmin_pick(d: torch.Tensor, payload: torch.Tensor):
    """(min distance, payload at the first minimum) per row."""
    best = torch.argmin(d, dim=-1, keepdim=True)
    return d.gather(-1, best)[:, 0], payload.gather(-1, best)[:, 0]


def _greedy_descent_level(
    q, vectors, sq_norms, nbr_table, slot_map, cur, cur_d, num_nodes, space,
    check_every=4,
):
    """Batched greedy 1-best walk on one upper level through row gathers."""

    def step(cur):
        nbrs = nbr_table[slot_map[cur.long()].long()]  # [B, M]
        valid = nbrs < num_nodes
        safe = torch.where(valid, nbrs, 0)
        d = gather_dist(q, vectors, safe, space, x_sq_norms=sq_norms)
        return _argmin_pick(torch.where(valid, d, _INF), nbrs)

    return _greedy_walk(step, cur, cur_d, check_every)


def _greedy_descent_inline(
    q, table: UnifiedTable, cur_slot, cur_d, u_pad, space, check_every=4
):
    """Batched greedy 1-best walk on one upper level through the unified
    descent table: one hop-kernel block per query per hop carries the slot's
    M neighbor vectors and the neighbors' slots at the same level. Queries
    parked on the dummy slot (u_pad-1) see only invalid neighbors."""
    dummy = u_pad - 1

    def step(cur_slot):
        d, slots = hop_dist_unified(q, table, cur_slot[:, None], space)
        return _argmin_pick(torch.where(slots < dummy, d, _INF), slots)

    return _greedy_walk(step, cur_slot, cur_d, check_every)


# ---------------------------------------------------------------------------
# Level-0 batched beam search (reference: hnswalg.h:311-440).
# ---------------------------------------------------------------------------


def _bitonic_merge_topk(beam_d, beam_p, new_d, new_p, ef: int, pad_p: int):
    """Merge a sorted beam [B, ef] with an unsorted candidate block [B, EM],
    keep the smallest ef. The block is sorted (stable) and spliced as
    [beam asc | +inf pad | block desc], a bitonic sequence, which one
    log2(W)-stage bitonic merge sorts. The compare-exchange keeps
    `take_a = a <= c`, so payloads of equal distances land where the JAX
    merge puts them."""
    b, em = new_d.shape
    sn_d, order = torch.sort(new_d, dim=-1, stable=True)
    sn_p = new_p.gather(-1, order)
    w = 1 << (ef + em - 1).bit_length()
    pad = w - ef - em
    parts_d, parts_p = [beam_d], [beam_p]
    if pad:
        parts_d.append(beam_d.new_full((b, pad), _INF))
        parts_p.append(beam_p.new_full((b, pad), pad_p))
    parts_d.append(sn_d.flip(-1))
    parts_p.append(sn_p.flip(-1))
    d = torch.cat(parts_d, dim=-1)  # [B, W] bitonic
    p = torch.cat(parts_p, dim=-1)
    step = w // 2
    while step >= 1:
        d2 = d.view(b, -1, 2, step)
        p2 = p.view(b, -1, 2, step)
        a, c = d2[:, :, 0], d2[:, :, 1]
        pa, pc = p2[:, :, 0], p2[:, :, 1]
        take_a = a <= c
        d = torch.stack(
            [torch.where(take_a, a, c), torch.where(take_a, c, a)], dim=2
        ).view(b, w)
        p = torch.stack(
            [torch.where(take_a, pa, pc), torch.where(take_a, pc, pa)], dim=2
        ).view(b, w)
        step //= 2
    return d[:, :ef], p[:, :ef]


def _mask_lookup(eligible: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Eligibility of candidate ids under a shared [N_pad] mask or
    per-query [B, N_pad] masks."""
    idx = ids.long()
    if eligible.dim() == 2:
        if idx.dim() == 1:
            return eligible.gather(1, idx[:, None])[:, 0]
        return eligible.gather(1, idx)
    return eligible[idx]


def _select_expand(beam_id, unexp, expand: int, sent: int):
    """The first `expand` unexpanded finite entries in beam order, which is
    what `lax.top_k(-key, expand)` picks on the ascending beam (ties go to
    the lower index). Returns (chosen [B, E] int32, newly expanded [B, ef])."""
    rank = torch.cumsum(unexp, dim=-1, dtype=torch.int32)
    cols, new_exp = [], torch.zeros_like(unexp)
    for j in range(expand):
        onehot = unexp & (rank == j + 1)
        pick = torch.where(onehot, beam_id, 0).sum(-1, dtype=torch.int32)
        cols.append(torch.where(onehot.any(-1), pick, sent))
        new_exp |= onehot
    return torch.stack(cols, dim=1), new_exp


def search_batch(
    vectors: torch.Tensor,  # [N_pad, D]
    graph: DeviceGraph,
    queries: torch.Tensor,  # [B, D] f32
    *,
    k: int,
    ef: int,
    space: str = "l2",
    sq_norms: torch.Tensor | None = None,
    eligible: torch.Tensor | None = None,  # [N_pad] or [B, N_pad] bool
    entry_ids: torch.Tensor | None = None,  # [B] per-query entry override
    seed_ids: torch.Tensor | None = None,  # [B, S] distinct seeds (skip descent)
    seed_dists: torch.Tensor | None = None,  # [B, S] f32 distances of the seeds
    # level-0 node blocks of any tier (UnifiedTable, Unified8Table or
    # Unified4Table): the hop kernel follows the table's type
    unified_table=None,
    # the split tier's [N_pad, m0, d_pad] bf16 neighbor vectors (ids are
    # read from graph.level0); used when there is no unified_table
    nbr_vectors: torch.Tensor | None = None,
    upper_tables: tuple | None = None,  # ((table_l, slot_to_id_l), ...)
    expand: int = 1,
    max_iters: int = 0,  # 0 => 2*ef + 16
    hist_len: int = 0,  # 0 => ef
    collect_metrics: bool = False,
    stop_patience: int = 0,
    stop_frontier: float = 0.0,
    frontier_rank: int = 0,
    stop_fn=None,
    check_every: int = 4,
) -> SearchResults:
    """Batched HNSW search over a device-resident padded-CSR graph: greedy
    upper-layer descent (or landmark seeds), then the fixed-ef beam at
    level 0. Semantics and parameters are those of the JAX search_batch:

    - `stop_patience` > 0 stops a query after that many iterations without
      top-k improvement;
    - `stop_frontier` > 0 stops a query once its best unexpanded entry is
      farther than stop_frontier x its `frontier_rank`-th best distance
      (0 => k; ef => hnswlib's own lower bound);
    - `stop_fn(StopView) -> [B] bool` is a custom stop condition.

    With neither `unified_table` nor `nbr_vectors` the level-0 hop is a
    plain row gather from `vectors` (the reference's XLA-gather path). `check_every` sets how
    often the loop checks termination on the host (see the module note)."""
    if ef < k:
        raise ValueError("ef must be >= k")
    if frontier_rank > 0 and stop_frontier <= 0:
        raise ValueError(
            "frontier_rank has no effect without stop_frontier > 0"
        )
    if max_iters <= 0:
        max_iters = 2 * ef + 16
    if hist_len <= 0:
        hist_len = ef
    b = queries.shape[0]
    dev = queries.device
    n_pad = graph.n_pad
    num_nodes = graph.num_nodes
    sent = n_pad - 1
    q = queries
    use_mask = eligible is not None

    def empty_lists():
        return (
            torch.full((b, ef), _INF, device=dev),
            torch.full((b, ef), sent * 2, dtype=torch.int32, device=dev),
            torch.full((b, ef), _INF, device=dev),
            torch.full((b, ef), sent, dtype=torch.int32, device=dev),
        )

    if seed_ids is not None:
        # Multi-seed init: the beam starts at the caller's seeds and the
        # upper-layer descent is skipped.
        sid = seed_ids.to(torch.int32)
        s_ok = (sid >= 0) & (sid < num_nodes)
        sid = torch.where(s_ok, sid, sent)
        sd = torch.where(s_ok, seed_dists.float(), _INF)
        beam_d, beam_key, res_d, res_id = empty_lists()
        beam_d, beam_key = _bitonic_merge_topk(
            beam_d, beam_key, sd, sid * 2, ef, sent * 2
        )
        if use_mask:
            e_ok = _mask_lookup(eligible, sid) & (sd < _INF)
            res_d, res_id = _bitonic_merge_topk(
                res_d, res_id, torch.where(e_ok, sd, _INF),
                torch.where(e_ok, sid, sent), ef, sent,
            )
    else:
        cur = torch.full((b,), graph.entry_point, dtype=torch.int32, device=dev)
        if entry_ids is not None:
            # invalid/negative overrides fall back to the graph entry point
            e = entry_ids.to(device=dev, dtype=torch.int32)
            cur = torch.where((e >= 0) & (e < num_nodes), e, cur)
        with span("hnsw.search.descent"):
            # an empty graph (entry point -1) parks on the dummy row at +inf
            ent_ok = (cur >= 0) & (cur < num_nodes)
            cur = torch.where(ent_ok, cur, sent)
            cur_d = gather_dist(q, vectors, cur[:, None], space, x_sq_norms=sq_norms)[:, 0]
            cur_d = torch.where(ent_ok, cur_d, _INF)
            cur, cur_d = _descend(
                q, vectors, sq_norms, graph, upper_tables, cur, cur_d, space,
                check_every,
            )
        beam_d, beam_key, res_d, res_id = empty_lists()
        beam_d[:, 0] = cur_d
        beam_key[:, 0] = cur * 2
        if use_mask:
            e_ok = _mask_lookup(eligible, cur) & (cur_d < _INF)
            res_d[:, 0] = torch.where(e_ok, cur_d, _INF)
            res_id[:, 0] = torch.where(e_ok, cur, sent)

    return _beam_level0(
        q, graph, beam_d, beam_key, res_d, res_id, vectors, sq_norms,
        eligible, unified_table, nbr_vectors, k=k, ef=ef, space=space, expand=expand,
        max_iters=max_iters, hist_len=hist_len,
        collect_metrics=collect_metrics, stop_patience=stop_patience,
        stop_frontier=stop_frontier, frontier_rank=frontier_rank,
        stop_fn=stop_fn, check_every=check_every,
    )


def _descend(q, vectors, sq_norms, graph, upper_tables, cur, cur_d, space,
             check_every):
    """Greedy descent from the top level to level 1: through the unified
    descent tables when given, else through row gathers."""
    if graph.max_level == 0:
        return cur, cur_d
    if upper_tables is None:
        for level in range(graph.max_level, 0, -1):
            cur, cur_d = _greedy_descent_level(
                q, vectors, sq_norms, graph.upper[level - 1],
                graph.upper_slot[level - 1], cur, cur_d, graph.num_nodes,
                space, check_every,
            )
        return cur, cur_d
    top = graph.max_level
    cur_slot = graph.upper_slot[top - 1][cur.long()]
    for level in range(top, 0, -1):
        tab, slot_ids = upper_tables[level - 1]
        u_pad = slot_ids.shape[0]
        # tables are sized per level; slot values from the shared slot map
        # use the global dummy — clamp onto the local dummy row
        cur_slot = torch.clamp_max(cur_slot, u_pad - 1)
        cur_slot, cur_d = _greedy_descent_inline(
            q, tab, cur_slot, cur_d, u_pad, space, check_every
        )
        nid = slot_ids[torch.clamp_max(cur_slot, u_pad - 1).long()]
        # a query parked on the dummy slot keeps its previous node
        cur = torch.where(cur_slot >= u_pad - 1, cur, nid)
        if level > 1:
            cur_slot = graph.upper_slot[level - 2][cur.long()]
    return cur, cur_d


def _beam_level0(
    q, graph, beam_d, beam_key, res_d, res_id, vectors, sq_norms, eligible,
    unified_table, nbr_vectors, *, k, ef, space, expand, max_iters, hist_len,
    collect_metrics, stop_patience, stop_frontier, stop_fn, frontier_rank,
    check_every,
) -> SearchResults:
    """The fixed-ef masked beam loop over level 0 (reference:
    searchBaseLayerST, hnswalg.h:311-440), from an initialized sorted beam."""
    b = q.shape[0]
    dev = q.device
    n_pad, max_m0 = graph.level0.shape
    em = expand * max_m0
    num_nodes = graph.num_nodes
    sent = n_pad - 1
    use_mask = eligible is not None
    use_stop = stop_patience > 0 or stop_frontier > 0 or stop_fn is not None
    track = use_stop or collect_metrics

    hist = torch.full((b, hist_len), sent, dtype=torch.int32, device=dev)
    zeros_b = torch.zeros((b,), dtype=torch.int32, device=dev)
    hops, dist_comps, last_improve, stall = zeros_b, zeros_b, zeros_b, zeros_b
    kd_prev = torch.full((b,), _INF, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    if expand > 1:
        ar = torch.arange(em, device=dev)
        earlier = (ar[None, :] < ar[:, None])[None]  # [1, EM, EM]: j < i

    def alive_any() -> bool:
        with span("hnsw.beam.check"):
            live = ((beam_key & 1) == 0) & (beam_d < _INF)
            alive = live.any(-1)
            if use_stop:
                alive &= ~done
            COUNTS.host_syncs += 1
            return bool(alive.any())

    it = 0
    while it < max_iters and alive_any():
        for _ in range(min(check_every, max_iters - it)):
            COUNTS.beam_iters += 1
            with span("hnsw.beam.select"):
                beam_id = beam_key >> 1
                unexp = ((beam_key & 1) == 0) & (beam_d < _INF)
                active = unexp.any(-1)
                if use_stop:
                    active &= ~done
                chosen, new_exp = _select_expand(beam_id, unexp, expand, sent)
                beam_key2 = beam_key | new_exp.to(torch.int32)

            with span("hnsw.beam.hop"):
                if unified_table is not None:
                    d, nbrs = hop_dist_unified(q, unified_table, chosen, space)
                elif nbr_vectors is not None:
                    d, nbrs = hop_dist_inline(q, nbr_vectors, graph.level0, chosen, space)
                else:
                    nbrs = graph.level0[chosen.long()].reshape(b, em)
                    safe_n = torch.where(nbrs < n_pad, nbrs, sent)
                    d = gather_dist(q, vectors, safe_n, space, x_sq_norms=sq_norms)

            with span("hnsw.beam.dedup"):
                # already in the beam, in the ring history, or repeated
                # earlier in this hop's block (E > 1)
                in_beam = (nbrs[:, :, None] == beam_id[:, None, :]).any(-1)
                in_hist = (nbrs[:, :, None] == hist[:, None, :]).any(-1)
                fresh = (nbrs < num_nodes) & ~in_beam & ~in_hist & active[:, None]
                if expand > 1:
                    eq = nbrs[:, :, None] == nbrs[:, None, :]
                    fresh &= ~(eq & earlier & fresh[:, None, :]).any(-1)

            with span("hnsw.beam.merge"):
                d = torch.where(fresh, d, _INF)
                cand_key = torch.where(fresh, nbrs * 2, sent * 2)
                beam_d, beam_key = _bitonic_merge_topk(
                    beam_d, beam_key2, d, cand_key, ef, sent * 2
                )
                hist = torch.cat([chosen, hist[:, :-expand]], dim=-1)

                if use_mask:
                    safe_n = torch.where(nbrs < n_pad, nbrs, sent)
                    ok = _mask_lookup(eligible, safe_n) & fresh
                    res_d, res_id = _bitonic_merge_topk(
                        res_d, res_id, torch.where(ok, d, _INF),
                        torch.where(ok, nbrs, sent), ef, sent,
                    )
                best = res_d if use_mask else beam_d

            with span("hnsw.beam.stop"):
                if track:
                    # top-k improvement <=> the k-th best distance decreased
                    kd = best[:, k - 1]
                    improved = (kd < kd_prev) & active
                    kd_prev = kd
                if collect_metrics:
                    hops = hops + active.to(torch.int32)
                    dist_comps = dist_comps + fresh.sum(-1, dtype=torch.int32)
                    last_improve = torch.where(improved, it + 1, last_improve)
                if stop_patience > 0:
                    stall = torch.where(improved, 0, stall + 1)
                    done = done | (stall >= stop_patience)
                if stop_frontier > 0:
                    unexp2 = ((beam_key & 1) == 0) & (beam_d < _INF)
                    best_unexp = torch.where(unexp2, beam_d, _INF).min(-1).values
                    rank = min(frontier_rank, ef) if frontier_rank > 0 else k
                    fd = best[:, rank - 1]
                    done = done | ((best_unexp > stop_frontier * fd) & (fd < _INF))
                if stop_fn is not None:
                    view = StopView(beam_d, beam_key >> 1, best, it, hops)
                    done = done | (stop_fn(view) & active)
            it += 1

    if use_mask:
        out_d, out_i = res_d[:, :k], res_id[:, :k]
    else:
        out_d, out_i = beam_d[:, :k], beam_key[:, :k] >> 1
    return SearchResults(out_d, out_i, hops, dist_comps, last_improve)
