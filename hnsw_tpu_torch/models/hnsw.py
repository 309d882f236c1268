"""HNSWIndex — the user-facing index: native host builder + batched device
traversal (counterpart of hnsw_tpu/models/hnsw.py).

Construction runs on the native C++ engine; a search syncs the graph to the
device (padded-CSR tensors, the vector table in the space's storage dtype,
and the tables of the largest tier that fits: the unified bf16, int8 or
int4 node blocks, or the split table) and runs the batched beam there. A
mutation after the first sync is applied to the live tensors as row deltas
(appended and updated vectors, changed level-0 rows and the table rows that
embed them); growth past the padded capacity resyncs in full.

The row deltas write the device tensors in place: a caller that kept the
state of an earlier sync sees its tensors change. A delta that fails midway
drops the device state, so no caller sees it half written: out of memory,
the same sync is full; on any other error the next one is.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hnsw_tpu_torch.core.graph import (
    HNSWGraph,
    graph_device_arrays,
    pad_vectors,
    round_up,
    upper_host_arrays,
)
from hnsw_tpu_torch.core.spaces import Space, get_space
from hnsw_tpu_torch.models.bruteforce import resolve_device
from hnsw_tpu_torch.native.hnsw_builder import NativeHNSWBuilder
from hnsw_tpu_torch.ops.gather_kernels import (
    build_inline_tables,
    gather_dist_rows,
    inline_rows,
    make_upper_tables,
    quant_rows,
    quantize_for_tier,
    upper_level_sizes_u,
)
from hnsw_tpu_torch.ops.topk import bruteforce_topk, topk_smallest
from hnsw_tpu_torch.ops.traversal import SearchResults, search_batch

# Share of the card's free memory the unified tables may take; the rest is
# left for the search's working set ([B, ef] beams, [B, EM, ef] dedup masks).
UNIFIED_FREE_SHARE = 0.8
# Budgets in bytes of the unified tiers' and the split tier's tables for an
# index whose own budget (unified_max_bytes, split_max_bytes) is None; None
# takes UNIFIED_FREE_SHARE of the free memory. Read at each sync and by
# bulk_build's choice of the waves' tier, as the JAX package reads its
# constants of the same names (which hold a TPU's budgets).
UNIFIED_MAX_BYTES: int | None = None
SPLIT_MAX_BYTES: int | None = None
# Bulk-build waves clamp the unified budget to this, so they run the split
# tier: its row delta is one bf16 row gather and scatter.
UNIFIED_WAVE_MAX_BYTES = 0
# Row deltas are applied in slices of this many dirty rows (a bulk-build wave
# dirties 100k+ rows), which bounds the gathered rows held at once.
DELTA_CHUNK = 1 << 15


def free_share(device: torch.device) -> int | None:
    """UNIFIED_FREE_SHARE of the card's free memory in bytes; None (no
    limit) on the CPU."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return int(free * UNIFIED_FREE_SHARE)
    return None


def _apply_row_deltas(
    st: "_DeviceState",
    new_vecs: torch.Tensor,  # [Nb, D] f32 appended or updated vectors
    new_ids: torch.Tensor,  # [Nb] int32 destination rows
    dirty_ids: torch.Tensor,  # [Kb] int32
    dirty_rows: torch.Tensor,  # [Kb, m0_pad] int32
    *,
    exact_i8: bool = False,  # unified8 codes are l2u8's lossless scale-1 codes
    new_sq: torch.Tensor | None = None,  # [Nb] f32 squared norms of new_vecs
) -> None:
    """Apply insert and update deltas to the device state IN PLACE: write the
    new vectors (with their squared norms and, on the quantized tiers, codes
    and scales), scatter the changed level-0 rows, and rewrite the rows of
    the tier's table that embed them (kind "off", "split", "unified",
    "unified8" or "unified4"). A delta is applied at its own size: eager
    torch compiles nothing per shape, so the JAX package's padding of deltas
    to power-of-two buckets has no counterpart here.

    Squared norms and codes are taken from the STORED values (bf16-rounded
    under bf16 storage), as a full sync takes them, so a delta state equals
    a rebuild; the JAX package's delta takes them from the f32 input.
    `new_sq` overrides the new rows' squared norms (a sharded shard's, summed
    as its full sync sums them)."""
    kind = st.tier or "off"
    x = st.vectors
    if new_vecs.shape[0]:
        ni = new_ids.long()
        stored = new_vecs.to(x.dtype)
        x[ni] = stored
        stored = stored.float()
        if st.sq_norms is not None:
            st.sq_norms[ni] = (stored * stored).sum(-1) if new_sq is None else new_sq
        if kind in ("unified8", "unified4"):
            st.codes[ni], st.scales[ni] = quantize_for_tier(stored, kind, exact_i8)
    if dirty_ids.shape[0]:
        di = dirty_ids.long()
        st.graph.level0[di] = dirty_rows
        if kind == "split":
            st.nbr_vectors[di] = inline_rows(x, dirty_rows)
        elif kind != "off":
            # the payload may share level0's storage: writing both is right
            # either way
            table = st.unified
            table.payload[di] = dirty_rows
            if kind == "unified":
                table.vecs[di] = inline_rows(x, dirty_rows)
            else:
                table.codes[di], table.scales[di] = quant_rows(
                    kind, st.codes, st.scales, dirty_rows
                )


def _sq_norms_f64(x: np.ndarray) -> np.ndarray:
    """Squared norms of f32 rows, summed in float64 and rounded to f32."""
    return (x.astype(np.float64) ** 2).sum(-1).astype(np.float32)


def _rescore_topk(q, x, ids, dists, *, k, m, space):
    """Re-rank the first m beam candidates with exact distances from the
    vector table (one gather kernel launch: f32 or bf16 table) and return
    the best k."""
    idm = ids[:, :m]
    safe = torch.clamp(idm, 0, x.shape[0] - 1)
    d_ex = gather_dist_rows(q, x, safe, space)
    d_ex = torch.where(torch.isfinite(dists[:, :m]), d_ex, torch.inf)
    dk, pos = topk_smallest(d_ex, k)
    return dk, idm.gather(-1, pos)


def auto_rescore(tier: str | None, exact_i8: bool, k: int) -> int:
    """The rescore depth when SearchParams.rescore is None: 4*k on the lossy
    tiers (int4, and int8 unless the space's codes are l2u8's lossless
    scale-1 codes), else 0."""
    lossy = tier == "unified4" or (tier == "unified8" and not exact_i8)
    return 4 * k if lossy else 0


def landmark_arrays(dg, x, sq, pool_extra: int = 0):
    """(vectors, ids, sq_norms) of every upper-level node — the graph's own
    1/M sample, the landmark set of the seeded entry mode — plus, with
    `pool_extra` > 0, that many evenly strided level-0 nodes. None when the
    graph has no upper levels."""
    if dg.max_level == 0:
        return None
    u_pad = dg.upper.shape[1]
    slot0 = dg.upper_slot[0].cpu().numpy()
    ids = np.where(slot0 < u_pad - 1)[0].astype(np.int32)
    if not len(ids):
        return None
    if pool_extra > 0:
        n = int(dg.num_nodes)
        mask = np.ones(n, dtype=bool)
        mask[ids[ids < n]] = False
        cand = np.nonzero(mask)[0]
        want = min(pool_extra, len(cand))
        if want > 0:
            sel = cand[np.linspace(0, len(cand) - 1, want).astype(np.int64)]
            ids = np.concatenate([ids, sel.astype(np.int32)])
    li = torch.from_numpy(ids).to(x.device)
    lv = x[li.long()]
    lsq = None if sq is None else sq[li.long()]
    return lv, li, lsq


@dataclasses.dataclass
class SearchParams:
    """Search knobs; each has the meaning it has in the JAX package."""

    k: int = 10
    ef: int = 200
    expand: int = 1  # beam entries expanded per traversal step
    max_iters: int = 0  # 0 => 2*ef + 16
    collect_metrics: bool = False
    stop_patience: int = 0  # >0: stop after this many non-improving steps
    stop_frontier: float = 0.0  # >0: frontier cut multiplier
    frontier_rank: int = 0  # rank the frontier compares against (0 => k)
    # exact re-rank of the top `rescore` candidates (None = auto: 4*k on the
    # lossy int4 and int8 tiers, 0 on bf16 and on l2u8's exact int8 codes)
    rescore: int | None = None
    stop_fn: object = None  # StopView -> [B] bool custom stop condition
    entry_seeds: int = 0  # >0: landmark-seeded entry instead of the descent
    seed_pool: int = 0  # extra strided level-0 landmarks


@dataclasses.dataclass
class _DeviceState:
    graph: object  # DeviceGraph
    vectors: torch.Tensor  # [N_pad, D] in space.storage_dtype
    sq_norms: torch.Tensor | None  # [N_pad] f32 of the stored values (l2)
    deleted: np.ndarray  # [N_pad] bool, host
    labels: np.ndarray  # [N_pad] int64, host (-1 = padding)
    tier: str | None  # "unified" | "unified8" | "unified4" | "split" | None (gathers)
    unified: object  # UnifiedTable | Unified8Table | Unified4Table | None
    upper_tables: tuple | None  # bf16 descent tables of the unified tiers
    nbr_vectors: torch.Tensor | None = None  # the split tier's table
    # side tables of the quantized tiers, read by the row deltas
    codes: torch.Tensor | None = None  # [N_pad, d_pad] int8
    scales: torch.Tensor | None = None  # [N_pad] f32


def inline_search_kwargs(st: _DeviceState) -> dict:
    """search_batch's table arguments for a device state. The split tier
    passes no upper tables: its descent goes through row gathers."""
    if st.tier is None:
        return {}
    if st.tier == "split":
        return {"nbr_vectors": st.nbr_vectors}
    return {"unified_table": st.unified, "upper_tables": st.upper_tables}


class HNSWIndex:
    """Device-resident HNSW index with a native host-side builder."""

    def __init__(
        self,
        space: Space | str,
        dim: int | None = None,
        m: int = 16,
        ef_construction: int = 200,
        seed: int = 123,
        inline_neighbors: bool | None = None,
        allow_replace_deleted: bool = False,
        growth_headroom: float = 1 / 16,
        device="cuda",
    ):
        if isinstance(space, str):
            if dim is None:
                raise ValueError("dim required when space given by name")
            space = get_space(space, dim)
        self._init_common(space, m, ef_construction, allow_replace_deleted,
                          growth_headroom, inline_neighbors, device)
        self._builder = NativeHNSWBuilder(
            self.dim, space.name, m, ef_construction, seed
        )

    def _init_common(self, space, m, ef_construction, allow_replace_deleted,
                     growth_headroom, inline_neighbors, device):
        self.space = space
        self.dim = space.dim
        self.m = m
        self.ef_construction = ef_construction
        self.allow_replace_deleted = allow_replace_deleted
        # device arrays are padded past the current size by this fraction
        self.growth_headroom = growth_headroom
        self.device = resolve_device(device)
        # the unified node-block tiers (one contiguous block read per
        # expansion); False serves through plain row gathers. Unified rows
        # carry up to 128 neighbors.
        if inline_neighbors is None:
            inline_neighbors = True
        self.inline_neighbors = bool(inline_neighbors) and 2 * m <= 128
        # None: UNIFIED_MAX_BYTES, and if that is None UNIFIED_FREE_SHARE of
        # the card's free memory (no limit on the CPU); the ladder picks bf16,
        # else int8, else int4, else the split table under split_max_bytes
        # (None: SPLIT_MAX_BYTES, else the same share)
        self.unified_max_bytes: int | None = None
        self.split_max_bytes: int | None = None
        # False drops the per-level descent tables (the search then descends
        # through row gathers)
        self.upper_inline = True
        # False drops the quantized tiers' codes and scales side tables after
        # the table is built (a serve-only index); a mutation then resyncs
        # in full
        self.keep_delta_tables = True
        # set by a ShardedHNSWIndex on its shards: the tier every shard of
        # the index serves (None: the ladder picks from this index's budget),
        # and squared norms summed in float64 over the f32 rows, as the JAX
        # package's stacked shards sum them
        self._forced_tier: str | None = None
        self._sq_f64 = False
        self._device: _DeviceState | None = None
        self._landmark_cache = None
        self._dirty = True
        self._dirty_deleted = False
        self._synced_n = 0
        self._last_sync_mode: str | None = None
        # why the last dirty sync was not a delta (None when it was)
        self._last_sync_refusal: str | None = None

    # -- construction --------------------------------------------------------

    def add_items(
        self,
        data: np.ndarray,
        labels: np.ndarray | None = None,
        replace_deleted: bool = False,
    ) -> None:
        data = self.space.preprocess(data)
        if labels is None:
            start = self._builder.size
            labels = np.arange(start, start + data.shape[0], dtype=np.int64)
        labels = np.asarray(labels, dtype=np.int64)
        if replace_deleted:
            if not self.allow_replace_deleted:
                raise ValueError("index built with allow_replace_deleted=False")
            for row, lab in zip(data, labels.reshape(-1)):
                self._builder.add_replace(row, int(lab))
        else:
            self._builder.add_batch(data, labels)
        self._dirty = True

    def add_point(
        self, vec: np.ndarray, label: int, replace_deleted: bool = False
    ) -> None:
        v = self.space.preprocess(vec)[0]
        if replace_deleted:
            if not self.allow_replace_deleted:
                raise ValueError("index built with allow_replace_deleted=False")
            self._builder.add_replace(v, label)
        else:
            self._builder.add(v, label)
        self._dirty = True

    def mark_deleted(self, label: int) -> None:
        self._builder.mark_deleted(label)
        self._dirty_deleted = True

    def unmark_deleted(self, label: int) -> None:
        self._builder.unmark_deleted(label)
        self._dirty_deleted = True

    @property
    def num_elements(self) -> int:
        return self._builder.size

    @property
    def deleted_count(self) -> int:
        """getDeletedCount analog (hnswalg.h:221-223)."""
        return self._builder.num_deleted

    @property
    def max_elements(self) -> int:
        """getMaxElements analog (hnswalg.h:213-215): allocated slot
        capacity. Unlike hnswlib this index grows past it."""
        return self._builder.capacity

    @property
    def index_file_size(self) -> int:
        """indexFileSize analog (hnswalg.h:658-683): byte size of the hnswlib
        binary save of an equivalent index (a capacity-planning figure, not
        the size of `save()`'s .npz)."""
        return self._builder.index_file_size

    def clear(self) -> None:
        """clear() analog (hnswalg.h:149-161): drop all index content and
        device state, keeping the configuration; the index stays usable."""
        self._builder.clear()
        self._device = None
        self._landmark_cache = None
        self._dirty = True
        self._dirty_deleted = False
        self._synced_n = 0

    def get_items(self, labels) -> np.ndarray:
        """Stored vectors for external labels (getDataByLabel analog);
        KeyError for an absent or delete-marked label."""
        labs = np.atleast_1d(np.asarray(labels, dtype=np.int64))
        return self.space.decode(np.stack(
            [self._builder.get_data_by_label(int(l)) for l in labs]
        ))

    @property
    def graph(self) -> HNSWGraph:
        return self._builder.export_graph()

    # -- device state --------------------------------------------------------

    def _sync_device(self) -> _DeviceState:
        """Bring the device state up to date: a full sync the first time and
        when the row deltas refuse, else row deltas; delete-marks alone
        refresh only the host mask. `_last_sync_mode` names what ran."""
        self._last_sync_refusal = None
        if self._device is None:
            self._full_sync()
            self._last_sync_mode = "full"
        elif self._dirty:
            if self._try_incremental_sync():
                self._refresh_deleted()
                self._last_sync_mode = "delta"
            else:
                self._full_sync()
                self._last_sync_mode = "full"
        elif self._dirty_deleted:
            self._refresh_deleted()
            self._last_sync_mode = "deleted"
        else:
            self._last_sync_mode = "clean"
        self._dirty = False
        self._dirty_deleted = False
        return self._device

    def _unified_budget(self) -> int | None:
        for cap in (self.unified_max_bytes, UNIFIED_MAX_BYTES):
            if cap is not None:
                return cap
        return free_share(self.device)

    def _split_budget(self) -> int | None:
        for cap in (self.split_max_bytes, SPLIT_MAX_BYTES):
            if cap is not None:
                return cap
        return free_share(self.device)

    def _full_sync(self) -> None:
        """Rebuild every device tensor from the host engine. The previous
        state is released first, so peak memory holds one set of tables."""
        self._device = None
        self._landmark_cache = None  # keyed on the old state's identity
        g = self._builder.export_graph()
        n = g.num_nodes
        headroom = int(n * self.growth_headroom)
        n_pad = round_up(n + 1 + headroom, 128)
        dev = self.device
        dg = graph_device_arrays(g, n_pad, device=dev)
        x_np = pad_vectors(self._builder.export_vectors(), n_pad)
        x = torch.from_numpy(x_np).to(dev, dtype=self.space.storage_dtype)
        sq = None
        if self.space.needs_sq_norms and self._sq_f64:
            sq = torch.from_numpy(_sq_norms_f64(x_np)).to(dev)
        elif self.space.needs_sq_norms:
            # squared norms of the stored (e.g. bf16-rounded) values, in f32
            x32 = x.float()
            sq = (x32 * x32).sum(-1)
            del x32
        del x_np
        tier = table = upper = nbr_vectors = codes = scales = None
        if self.inline_neighbors:
            tier, table, upper, codes, scales = build_inline_tables(
                x, dg, self.dim, self._unified_budget(), self._split_budget(),
                upper_inline=self.upper_inline, exact_i8=self.space.exact_i8,
                keep_delta_tables=self.keep_delta_tables, tier=self._forced_tier,
            )
            if tier == "split":
                table, nbr_vectors = None, table
        deleted = np.zeros(n_pad, dtype=bool)
        deleted[:n] = self._builder.export_deleted().astype(bool)
        labels_np = np.full(n_pad, -1, dtype=np.int64)
        labels_np[:n] = g.labels
        self._device = _DeviceState(
            dg, x, sq, deleted, labels_np, tier, table, upper or None,
            nbr_vectors, codes, scales,
        )
        self._builder.clear_dirty()
        self._synced_n = n

    def _try_incremental_sync(self) -> bool:
        """Apply insert and in-place-update deltas (changed level-0 rows,
        appended and updated vector rows) to the live device tensors. An
        update's staleness is local: the only device rows that embed the old
        vector are its level-0 in-neighbors' table rows (the native engine's
        flush_updates finds them) and the small upper tables (rebuilt
        wholesale when the upper levels changed). Returns False, and says
        why in `_last_sync_refusal`, when a full sync is needed instead."""

        def refuse(why: str) -> bool:
            self._last_sync_refusal = why
            return False

        b = self._builder
        flags = b.dirty_flags
        if flags & 2:
            return refuse("the native engine asks for a full resync")
        st = self._device
        if st.tier in ("unified8", "unified4") and st.codes is None:
            return refuse("side tables dropped (keep_delta_tables=False)")
        dg = st.graph
        n_pad = dg.n_pad
        sent = n_pad - 1
        n = b.size
        old_n = self._synced_n
        if n + 1 > n_pad:
            return refuse("growth past the padded capacity")
        n_new = n - old_n
        n_upd = b.flush_updates()  # must precede take_dirty
        vec_ids = b.take_vec_dirty(n_upd)
        nb = n_new + n_upd
        dirty_ids = b.take_dirty()
        k = dirty_ids.shape[0]
        if k == 0 and n_new == 0 and n_upd == 0 and not (flags & 1):
            return True
        m0_pad = dg.level0.shape[1]
        rows = b.export_level0_rows(dirty_ids)
        rows = np.where(rows < 0, sent, rows).astype(np.int32)
        if rows.shape[1] != m0_pad:
            rows = np.concatenate(
                [rows, np.full((k, m0_pad - rows.shape[1]), sent, np.int32)], axis=1
            )
        if k > n_pad // 2:
            # refreshing k*m0 table rows would cost more than rebuilding the
            # table
            return refuse("more than n_pad // 2 dirty rows")
        new_vecs = np.zeros((nb, self.dim), np.float32)
        new_ids = np.full(nb, sent, np.int32)
        if n_new:
            new_vecs[:n_new] = b.export_vectors_range(old_n, n_new)
            new_ids[:n_new] = np.arange(old_n, n, dtype=np.int32)
        if n_upd:
            # in-place updates ride the same scatter as appended rows
            new_vecs[n_new : n_new + n_upd] = b.export_vectors_rows(vec_ids)
            new_ids[n_new : n_new + n_upd] = vec_ids

        dev = self.device
        # bounded slices; the new vectors ride the first. The engine's dirty
        # lists are drained by now, so a delta that fails midway cannot be
        # retried: the half-written state is dropped, and the sync is full
        try:
            for si, s0 in enumerate(range(0, k, DELTA_CHUNK) or [0]):
                ids_c = dirty_ids[s0 : s0 + DELTA_CHUNK]
                rows_c = rows[s0 : s0 + DELTA_CHUNK]
                first = si == 0
                _apply_row_deltas(
                    st,
                    torch.from_numpy(new_vecs if first else new_vecs[:0]).to(dev),
                    torch.from_numpy(new_ids if first else new_ids[:0]).to(dev),
                    torch.from_numpy(ids_c).to(dev),
                    torch.from_numpy(rows_c).to(dev),
                    exact_i8=self.space.exact_i8,
                    new_sq=torch.from_numpy(
                        _sq_norms_f64(new_vecs if first else new_vecs[:0])
                    ).to(dev) if self._sq_f64 else None,
                )
        except torch.cuda.OutOfMemoryError:
            self._device = self._landmark_cache = None
            return refuse("delta ran out of memory")
        except BaseException:
            # the next sync is full: no caller sees the half-written state
            self._device = self._landmark_cache = None
            raise

        labels_np = st.labels
        labels_changed = n_new > 0
        if n_new:
            labels_np = labels_np.copy()
            labels_np[old_n:n] = b.export_labels_range(old_n, n_new)
        if n_upd:
            # a replace_deleted reuse changes the label at the updated slot
            for i in vec_ids:
                lab = b.export_labels_range(int(i), 1)[0]
                if labels_np[i] != lab:
                    if not labels_changed:
                        labels_np = labels_np.copy()
                        labels_changed = True
                    labels_np[i] = lab
        rep = {"num_nodes": n}
        if flags & 1:
            # upper levels or the entry point changed: re-derive the (small)
            # upper arrays wholesale
            g = b.export_graph()
            upper, upper_slot = upper_host_arrays(g, n_pad)
            rep.update(
                upper=torch.from_numpy(upper).to(dev),
                upper_slot=torch.from_numpy(upper_slot).to(dev),
                entry_point=int(g.entry_point),
            )
        if labels_changed:
            rep["labels"] = torch.from_numpy(labels_np).to(dev)
        dg = dataclasses.replace(dg, **rep)
        upper_tables = st.upper_tables
        if (
            st.tier in ("unified", "unified8", "unified4")
            and (flags & 1)
            and dg.max_level > 0
            and self.upper_inline
        ):
            # the upper tables embed upper adjacency and vectors: rebuild
            # them (~N/M rows) after both were updated
            sizes = upper_level_sizes_u(dg.upper_slot, dg.upper.shape[1])
            upper_tables = make_upper_tables(
                st.vectors, dg.upper, dg.upper_slot, level_sizes=sizes
            )
        self._device = dataclasses.replace(
            st, graph=dg, labels=labels_np, upper_tables=upper_tables
        )
        self._landmark_cache = None  # keyed on the old state's identity
        self._synced_n = n
        return True

    def rebuild_device_tables(self, unified_max_bytes: int | None = None) -> _DeviceState:
        """Drop and rebuild every device tensor, optionally with a new table
        budget, which is how a caller chooses the tier: a budget between two
        tiers' bytes (ops.gather_kernels.tier_bytes) serves the smaller. The
        old tables are released first, so peak memory holds one set."""
        if unified_max_bytes is not None:
            self.unified_max_bytes = unified_max_bytes
        self._device = None
        self._landmark_cache = None  # it holds the old state
        self._dirty = True
        return self._sync_device()

    @property
    def device_graph(self):
        """The synced DeviceGraph (padded-CSR tensors on the index's device)."""
        return self._sync_device().graph

    @property
    def device_vectors(self) -> torch.Tensor:
        """The synced [N_pad, D] vector table in the space's storage dtype."""
        return self._sync_device().vectors

    @property
    def device_sq_norms(self) -> torch.Tensor | None:
        """The synced [N_pad] squared norms (None outside the l2 space)."""
        return self._sync_device().sq_norms

    def _refresh_deleted(self) -> None:
        """Delete-marks touch no graph or vector state: refresh only the
        host-side eligibility mask."""
        st = self._device
        deleted = np.zeros(st.graph.n_pad, dtype=bool)
        n = self._builder.size
        deleted[:n] = self._builder.export_deleted().astype(bool)
        self._device = dataclasses.replace(st, deleted=deleted)

    # -- search ---------------------------------------------------------------

    def search(
        self,
        queries: np.ndarray,
        k: int = 10,
        ef: int = 200,
        *,
        filter_labels: np.ndarray | None = None,
        entry_ids: np.ndarray | None = None,
        entry_seeds: int = 0,
        seed_pool: int = 0,
        params: SearchParams | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched kNN → (dists [B, k], labels [B, k]; label -1 = missing),
        rows ascending by distance.

        `filter_labels`: bool mask over external labels, shared [L] or
        per-query [B, L]. Deleted elements are always excluded.
        `entry_seeds` / `seed_pool`: landmark-seeded entry, shorthand for
        `SearchParams(entry_seeds=, seed_pool=)` when no `params` is given."""
        if params is None:
            params = SearchParams(k=k, ef=max(ef, k), entry_seeds=entry_seeds,
                                  seed_pool=seed_pool)
        st = self._sync_device()
        dg, x, sq = st.graph, st.vectors, st.sq_norms
        labels_np = st.labels
        q_np = self.space.preprocess(queries)
        b0 = q_np.shape[0]
        q = torch.from_numpy(np.ascontiguousarray(q_np)).to(self.device)

        eligible = None
        if st.deleted.any() or filter_labels is not None:
            ok = ~st.deleted
            if filter_labels is not None:
                fl = np.asarray(filter_labels, dtype=bool)
                valid = labels_np >= 0
                if fl.ndim == 2:
                    # per-query masks: label-space rows -> node-space rows
                    if fl.shape[0] != b0:
                        raise ValueError(
                            f"filter_labels rows {fl.shape[0]} != batch {b0}"
                        )
                    allow = np.zeros((b0, ok.shape[0]), dtype=bool)
                    allow[:, valid] = fl[:, labels_np[valid]]
                    ok = ok[None, :] & allow
                else:
                    allow = np.zeros_like(ok)
                    allow[valid] = fl[labels_np[valid]]
                    ok = ok & allow
            eligible = torch.from_numpy(ok).to(self.device)

        m_res = params.rescore
        if m_res is None:
            m_res = auto_rescore(st.tier, self.space.exact_i8, params.k)
        m_res = min(m_res, params.ef)
        # the rescore re-ranks the top m_res beam candidates, so the search
        # must return that many
        k_search = max(params.k, m_res) if m_res >= params.k else params.k
        seed_kwargs = {}
        if params.entry_seeds > 0 and entry_ids is None and dg.max_level > 0:
            lm = self._landmark_arrays(pool_extra=params.seed_pool)
            if lm is not None:
                lv, li, lsq = lm
                s = min(params.entry_seeds, int(li.shape[0]),
                        max(params.ef, k_search))
                sd, si = bruteforce_topk(q, lv, s, self.space.name, x_sq_norms=lsq)
                seed_kwargs = {"seed_ids": li[si], "seed_dists": sd}
        res = search_batch(
            x,
            dg,
            q,
            k=k_search,
            ef=max(params.ef, k_search),
            space=self.space.name,
            sq_norms=sq,
            eligible=eligible,
            entry_ids=None if entry_ids is None else torch.from_numpy(
                np.asarray(entry_ids).astype(np.int32)
            ).to(self.device),
            **inline_search_kwargs(st),
            expand=params.expand,
            max_iters=params.max_iters,
            collect_metrics=params.collect_metrics,
            stop_patience=params.stop_patience,
            stop_frontier=params.stop_frontier,
            # the rank only means something under a frontier stop: the JAX
            # search ignores it without one, search_batch raises
            frontier_rank=params.frontier_rank if params.stop_frontier > 0 else 0,
            stop_fn=params.stop_fn,
            **seed_kwargs,
        )
        if m_res >= params.k and m_res > 0:
            rd, ri = _rescore_topk(
                q, x, res.ids, res.dists, k=params.k, m=m_res,
                space=self.space.name,
            )
            res = SearchResults(rd, ri, res.hops, res.dist_comps, res.last_improve)
        dists = res.dists.cpu().numpy()
        ids = res.ids.cpu().numpy()
        labels = np.where(
            ids < len(labels_np), labels_np[np.minimum(ids, len(labels_np) - 1)], -1
        )
        labels = np.where(np.isfinite(dists), labels, -1)
        self.last_metrics = SearchResults(
            res.dists, res.ids, res.hops.cpu().numpy(),
            res.dist_comps.cpu().numpy(), res.last_improve.cpu().numpy(),
        )
        return dists, labels

    def _landmark_arrays(self, pool_extra: int = 0):
        """landmark_arrays cached per (device state, pool_extra): a sync
        replaces the state object and so invalidates the cache."""
        cache = self._landmark_cache
        if cache is not None and cache[0] is self._device and cache[1] == pool_extra:
            return cache[2]
        st = self._device
        lm = landmark_arrays(st.graph, st.vectors, st.sq_norms, pool_extra=pool_extra)
        self._landmark_cache = (self._device, pool_extra, lm)
        return lm

    def calibrate_speed_mode(
        self,
        queries: np.ndarray | None = None,
        *,
        k: int = 10,
        ef: int = 200,
        expand: int = 2,
        stop_frontier: float = 1.15,
        percentile: float = 99.9,
        margin: int = 2,
        sample: int = 2048,
        seed: int = 0,
        entry_seeds: int = 0,
        seed_pool: int = 0,
    ) -> SearchParams:
        """Tune the frontier-stopped speed mode for this index and operating
        point; returns the SearchParams and stores them as
        `self.speed_params`.

        The batch runs in lockstep, so a batch takes as long as its slowest
        query; the frontier stop (the reference's lower-bound cut,
        hnswalg.h:342-436, relaxed by `stop_frontier`) leaves a tail of
        stragglers far past the p99. Late iterations almost never improve
        the top k, so the iteration cap is the `percentile` of the
        LAST-IMPROVEMENT iteration (when each query's k-th best distance
        last fell) plus `margin`, at least 1; a cap that would not bind
        (>= 2 * max(ef, k) + 16) is left at 0.

        `queries`: the probe batch; by default `sample` stored rows drawn
        with default_rng(seed), plus gaussian noise of 0.05 (self-queries,
        the reference's methodology, bin/experiment.py:160-234)."""
        if queries is None:
            n = self.num_elements
            rng = np.random.default_rng(seed)
            rows = rng.integers(0, n, size=min(sample, n))
            base = self._builder.export_vectors_rows(
                rows.astype(np.int64)
            ).astype(np.float32)
            queries = base + 0.05 * rng.standard_normal(
                base.shape
            ).astype(np.float32)
        probe = SearchParams(
            k=k, ef=max(ef, k), expand=expand,
            stop_frontier=stop_frontier, collect_metrics=True,
            entry_seeds=entry_seeds, seed_pool=seed_pool,
        )
        self.search(queries, params=probe)
        last = np.asarray(self.last_metrics.last_improve)
        cap = max(int(np.percentile(last, percentile)) + int(margin), 1)
        if cap >= 2 * max(ef, k) + 16:
            cap = 0  # the cap would never bind: leave the search uncapped
        self.speed_params = SearchParams(
            k=k, ef=max(ef, k), expand=expand,
            stop_frontier=stop_frontier, max_iters=cap,
            entry_seeds=entry_seeds, seed_pool=seed_pool,
        )
        return self.speed_params

    def search_cpu(
        self,
        queries: np.ndarray,
        k: int = 10,
        ef: int = 200,
        *,
        filter_labels: np.ndarray | None = None,
    ):
        """Single-core native CPU search (the heap-based engine), passed
        through to the builder → (dists, labels, counts)."""
        q = self.space.preprocess(queries)
        if filter_labels is not None:
            fl = np.asarray(filter_labels, dtype=bool)
            labs = self._builder.export_graph().labels
            if fl.ndim == 2:
                if fl.shape[0] != q.shape[0]:
                    raise ValueError("filter_labels rows != number of queries")
                parts = [
                    self._builder.search_batch(q[i : i + 1], k, ef, eligible=fl[i][labs])
                    for i in range(q.shape[0])
                ]
                return tuple(np.concatenate(p) for p in zip(*parts))
            return self._builder.search_batch(q, k, ef, eligible=fl[labs])
        return self._builder.search_batch(q, k, ef, eligible=None)

    # -- persistence ----------------------------------------------------------

    def save(self, path: str, compress: bool = True) -> None:
        """Write the reference's .npz checkpoint (loadable by both packages)."""
        from hnsw_tpu_torch.io.checkpoint import save_checkpoint

        save_checkpoint(
            path,
            self._builder.export_graph(),
            self._builder.export_vectors(),
            self._builder.export_deleted(),
            compress=compress,
            meta={
                "space": self.space.persist_name,
                "dim": self.dim,
                "m": self.m,
                "ef_construction": self.ef_construction,
                "allow_replace_deleted": self.allow_replace_deleted,
            },
        )

    def save_hnswlib(self, path: str) -> None:
        """Write stock hnswlib's saveIndex format (hnswlib/hnswalg.h:685-713),
        which hnswlib's loadIndex reads: f32 rows for 'l2' and 'ip', the
        normalized rows for 'cosine' (load over InnerProductSpace), u8 codes
        for 'l2u8' (L2SpaceI)."""
        from hnsw_tpu_torch.io.hnswbin import write_bin

        vectors = self._builder.export_vectors()
        name = self.space.persist_name
        if name == "l2u8":
            vectors = self.space.decode(vectors)  # back to the u8 range
        write_bin(
            path, self._builder.export_graph(), vectors,
            self._builder.export_deleted(), space=name, m=self.m,
            ef_construction=self.ef_construction,
        )

    def export_adj(self, path: str) -> None:
        """Write the reference-compatible adjacency file (format:
        index_builder/build.cpp:14-21) through the native streaming writer;
        `io.adj.write_adj` writes the same bytes from a graph."""
        self._builder.export_adj(path)

    @classmethod
    def load(cls, path: str, device="cuda") -> "HNSWIndex":
        from hnsw_tpu_torch.io.checkpoint import load_checkpoint

        return cls._from_parts(*load_checkpoint(path), device=device)

    @classmethod
    def _from_parts(cls, g, vectors, deleted, meta, device="cuda",
                    inline_neighbors=None) -> "HNSWIndex":
        """A live index from (graph, internal vectors, deleted mask, meta),
        the shared tail of every loader."""
        self = cls.__new__(cls)
        self._init_common(
            get_space(meta["space"], meta["dim"]), meta["m"],
            meta["ef_construction"],
            bool(meta.get("allow_replace_deleted", False)), 1 / 16,
            inline_neighbors, device,
        )
        self._builder = NativeHNSWBuilder.from_graph(
            g, vectors, deleted, space=self.space.name,
            ef_construction=meta["ef_construction"],
        )
        return self

    @classmethod
    def from_hnswlib(cls, path: str, space: str = "l2", device="cuda") -> "HNSWIndex":
        """Import a stock hnswlib index file (the saveIndex format,
        hnswlib/hnswalg.h:685-822): topology, vectors, labels and delete
        marks. `space` is the space the file was built over: 'l2', 'ip' or
        'cosine' (f32 data) or 'l2u8' (the integer L2SpaceI layout). The
        index lands on `device` at its first search."""
        from hnsw_tpu_torch.io.hnswbin import read_bin

        dev = resolve_device(device)
        g, vectors, deleted, meta = read_bin(path, space=space)
        sp = get_space(space, meta["dim"])
        # the file holds the raw inserted values; the index stores the
        # space's preprocessed form (l2u8's shift, cosine's normalization,
        # which leaves normalized rows as they are)
        internal = sp.preprocess(vectors) if g.num_nodes else np.zeros(
            (0, meta["dim"]), np.float32
        )
        return cls._from_parts(
            g, internal, deleted,
            {"space": space, "dim": meta["dim"], "m": meta["m"],
             "ef_construction": meta["ef_construction"]},
            device=dev,
        )
