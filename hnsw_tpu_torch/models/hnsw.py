"""HNSWIndex — the user-facing index: native host builder + batched device
traversal (counterpart of hnsw_tpu/models/hnsw.py).

Construction runs on the native C++ engine; a search syncs the graph to the
device (padded-CSR tensors, the vector table in the space's storage dtype,
and the unified node-block tables of the largest tier that fits: bf16, int8
or int4) and runs the batched beam there. A dirty index resyncs in full.
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
)
from hnsw_tpu_torch.core.spaces import Space, get_space
from hnsw_tpu_torch.models.bruteforce import resolve_device
from hnsw_tpu_torch.native.hnsw_builder import NativeHNSWBuilder
from hnsw_tpu_torch.ops.gather_kernels import build_inline_tables, gather_dist_rows
from hnsw_tpu_torch.ops.topk import bruteforce_topk, topk_smallest
from hnsw_tpu_torch.ops.traversal import SearchResults, search_batch

# Share of the card's free memory the unified tables may take; the rest is
# left for the search's working set ([B, ef] beams, [B, EM, ef] dedup masks).
UNIFIED_FREE_SHARE = 0.8


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
    tier: str | None  # "unified" | "unified8" | "unified4" | None (gathers)
    unified: object  # UnifiedTable | Unified8Table | Unified4Table | None
    upper_tables: tuple | None  # bf16 descent tables on every tier


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
        # None: UNIFIED_FREE_SHARE of the card's free memory (no limit on
        # the CPU); the ladder picks bf16, else int8, else int4
        self.unified_max_bytes: int | None = None
        self._device: _DeviceState | None = None
        self._landmark_cache = None
        self._dirty = True
        self._dirty_deleted = False

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
        """Bring the device state up to date. Any graph or vector change
        resyncs in full (the incremental row-delta sync is not ported yet:
        same answers, higher cost); delete-marks refresh only the host mask."""
        if self._device is None or self._dirty:
            self._full_sync()
        elif self._dirty_deleted:
            self._refresh_deleted()
        self._dirty = False
        self._dirty_deleted = False
        return self._device

    def _unified_budget(self) -> int | None:
        if self.unified_max_bytes is not None:
            return self.unified_max_bytes
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            return int(free * UNIFIED_FREE_SHARE)
        return None

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
        x = torch.from_numpy(
            pad_vectors(self._builder.export_vectors(), n_pad)
        ).to(dev, dtype=self.space.storage_dtype)
        sq = None
        if self.space.needs_sq_norms:
            # squared norms of the stored (e.g. bf16-rounded) values, in f32
            x32 = x.float()
            sq = (x32 * x32).sum(-1)
            del x32
        tier = table = upper = None
        if self.inline_neighbors:
            tier, table, upper = build_inline_tables(
                x, dg, self.dim, self._unified_budget(), exact_i8=self.space.exact_i8
            )
        deleted = np.zeros(n_pad, dtype=bool)
        deleted[:n] = self._builder.export_deleted().astype(bool)
        labels_np = np.full(n_pad, -1, dtype=np.int64)
        labels_np[:n] = g.labels
        self._device = _DeviceState(
            dg, x, sq, deleted, labels_np, tier, table, upper or None
        )
        self._builder.clear_dirty()

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
            unified_table=st.unified,
            upper_tables=st.upper_tables,
            expand=params.expand,
            max_iters=params.max_iters,
            collect_metrics=params.collect_metrics,
            stop_patience=params.stop_patience,
            stop_frontier=params.stop_frontier,
            frontier_rank=params.frontier_rank,
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

    @classmethod
    def load(cls, path: str, device="cuda") -> "HNSWIndex":
        from hnsw_tpu_torch.io.checkpoint import load_checkpoint

        return cls._from_parts(*load_checkpoint(path), device=device)

    @classmethod
    def _from_parts(cls, g, vectors, deleted, meta, device="cuda") -> "HNSWIndex":
        """A live index from (graph, internal vectors, deleted mask, meta),
        the shared tail of every loader."""
        self = cls.__new__(cls)
        self._init_common(
            get_space(meta["space"], meta["dim"]), meta["m"],
            meta["ef_construction"],
            bool(meta.get("allow_replace_deleted", False)), 1 / 16, None, device,
        )
        self._builder = NativeHNSWBuilder.from_graph(
            g, vectors, deleted, space=self.space.name,
            ef_construction=meta["ef_construction"],
        )
        return self
