"""Sharded HNSW search (counterpart of hnsw_tpu/parallel/sharding.py).

The dataset is partitioned round-robin into one complete HNSW sub-index per
shard. The JAX package stacks every shard's device arrays into [S, ...]
arrays sharded over a mesh axis and searches them inside `shard_map`; here a
shard is one `HNSWIndex`, with its own host builder and its own device state
(tier tables, landmark set, delete mask). All shards serve one tier: the
ladder picks it once for the largest shard, as JAX picks its one static
`kind`, and every shard syncs at that rung. Inserts and updates reach the
device as each shard's own row deltas.

In one process every shard lives here, on `cuda:i % device_count()` when the
index is asked for "cuda", and a search runs the shards one after another,
with the shard-local exact rescore on the lossy tiers, then merges the
[B, S*k] partial results: the reference's all_gather and top-k merge.

With a `torch.distributed` process group of W ranks and `dp` the batch
split, the counterpart of a (dp, shard) mesh: G = W / dp shard groups, rank r
is dp rank r // G and group rank r % G and holds the shards i with
i % G == r % G. Every rank calls every method with the same arguments; each
builds, loads, saves and mutates only its own shards, and keeps the label
map and every shard's size. A search runs the rank's dp slice of the batch
on its shards, one all_gather carries every rank's [S/G, B/dp, k] results,
and every rank merges them in global shard order and returns the whole
[B, k].
"""

from __future__ import annotations

import concurrent.futures
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from hnsw_tpu_torch.core.graph import round_up
from hnsw_tpu_torch.core.spaces import Space, get_space
from hnsw_tpu_torch.io.checkpoint import load_checkpoint
from hnsw_tpu_torch.models import hnsw as hnsw_mod
from hnsw_tpu_torch.models.bruteforce import resolve_device
from hnsw_tpu_torch.models.hnsw import HNSWIndex, SearchParams, free_share
from hnsw_tpu_torch.ops.gather_kernels import pick_tier, tier_bytes

_NO_LIMIT = 1 << 62  # a budget of None (no limit) in a min-reduction


def shard_device(device: torch.device, i: int) -> torch.device:
    """Where shard i (or, under a process group, rank i) lives: "cuda"
    without an index spreads them over the visible cards
    (cuda:i % device_count()); any other device holds them all."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", i % torch.cuda.device_count())
    return device


def rank_layout(world: int, rank: int, dp: int, num_shards: int) -> tuple[int, list[int]]:
    """(dp rank, owned shards) of `rank` among `world` ranks with the batch
    split `dp` ways: G = world / dp shard groups; rank r is dp rank r // G
    and owns the shards i with i % G == r % G."""
    if dp < 1 or world % dp:
        raise ValueError(f"dp={dp} does not divide the world size {world}")
    groups = world // dp
    if num_shards % groups:
        raise ValueError(
            f"num_shards={num_shards} is not a multiple of the {groups} "
            f"shard groups (world size {world}, dp={dp})"
        )
    return rank // groups, list(range(rank % groups, num_shards, groups))


def merge_shard_results(
    dists: list[torch.Tensor], labels: list[torch.Tensor], *, num_shards: int,
    dp: int, k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Reassemble per-rank partial results in global shard order and merge
    them → (dists [B, k], labels [B, k]).

    `dists[r]` and `labels[r]` are rank r's [S/G, B/dp, k'] results (G =
    len(dists) / dp): rank r searched the dp slice r // G of the batch on
    the shards i with i % G == r % G, in ascending order. Each dp slice's
    rows become [B/dp, S*k'] in shard order; a stable sort keeps equal
    distances in shard order, as lax.top_k prefers the lower index. One
    process is W = 1, dp = 1."""
    g = len(dists) // dp
    rows_d, rows_l = [], []
    for r in range(dp):
        rows_d.append(torch.cat(
            [dists[r * g + i % g][i // g] for i in range(num_shards)], dim=1))
        rows_l.append(torch.cat(
            [labels[r * g + i % g][i // g] for i in range(num_shards)], dim=1))
    d, pos = torch.sort(torch.cat(rows_d), dim=-1, stable=True)
    return d[:, :k], torch.cat(rows_l).gather(-1, pos[:, :k])


class ShardedHNSWIndex:
    """Dataset partitioned into one HNSW sub-index per shard.

    Build and add_items run one native builder per shard in a thread pool
    (the C ABI releases the GIL, so shard builds use all host cores — the
    reference's build loop is strictly serial, index_builder/build.cpp
    :137-145).
    `inline_neighbors` is passed to every shard's HNSWIndex (None: the tier
    ladder; False: plain row gathers). `process_group` and `dp` spread the
    shards and the batch over ranks (the module docstring).

    The serve-trim knobs of JAX's index are attributes, read at each sync:
    `upper_inline` (False: no per-level descent tables) and
    `keep_delta_tables` (False: the quantized tiers drop their side tables).
    Set `idx.space = L2Space(dim, storage_dtype=torch.bfloat16)` before
    `build` or `load` to halve the vector table too. Under either trim a
    mutation resyncs its shards in full, as JAX re-stacks."""

    def __init__(
        self,
        space: Space | str,
        dim: int | None = None,
        *,
        num_shards: int,
        m: int = 16,
        ef_construction: int = 200,
        seed: int = 123,
        inline_neighbors: bool | None = None,
        device="cuda",
        process_group=None,
        dp: int = 1,
    ):
        if isinstance(space, str):
            if dim is None:
                raise ValueError("dim required when space given by name")
            space = get_space(space, dim)
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        world, rank = 1, 0
        if process_group is not None:
            world = dist.get_world_size(process_group)
            rank = dist.get_rank(process_group)
        self._rank = rank
        self._dp_rank, self._own = rank_layout(world, rank, dp, num_shards)
        self.space = space
        self.dim = space.dim
        self.num_shards = num_shards
        self.m = m
        self.ef_construction = ef_construction
        self.seed = seed
        self.inline_neighbors = inline_neighbors
        self.group = process_group
        self.dp = dp
        self._world = world
        dev = resolve_device(device)
        if process_group is None:
            self.devices = [shard_device(dev, i) for i in range(num_shards)]
            self._comm_device = self.devices[0]
        else:
            here = shard_device(dev, rank)
            self.devices = [here if i in self._own else None for i in range(num_shards)]
            nccl = dist.get_backend(process_group) == "nccl"
            if nccl and here.type != "cuda":
                raise ValueError("the nccl backend needs the shards on a card")
            if nccl:
                torch.cuda.set_device(here)
            self._comm_device = here if nccl else torch.device("cpu")
        # shards held on each card over the whole group (ranks on one host):
        # a card's free share is split over all of them
        held = [(str(d), 1) for d in self.devices if d is not None]
        if process_group is not None:
            got = [None] * world
            dist.all_gather_object(got, held, group=process_group)
            held = [h for part in got for h in part]
        self._card_shards: dict[str, int] = {}
        for card, n in held:
            self._card_shards[card] = self._card_shards.get(card, 0) + n
        # a per-shard unified-table budget in bytes (None: UNIFIED_MAX_BYTES,
        # else UNIFIED_FREE_SHARE of each card's free memory over the shards
        # every rank holds there)
        self.unified_max_bytes: int | None = None
        self.upper_inline = True
        self.keep_delta_tables = True
        # "full" when a shard's last sync rebuilt its tables, else "delta"
        self.last_sync_mode: str | None = None
        self._tier: str | None = None  # the rung every shard serves
        self._tier_chosen = False
        self._shards: list[HNSWIndex | None] | None = None  # None: not this rank's
        self._shard_labels: list[np.ndarray] | None = None  # per-shard labels
        self._shard_deleted: list[np.ndarray] | None = None  # per-shard bool
        self._label_map: dict[int, tuple[int, int]] | None = None  # label -> (shard, local)
        self._pool: concurrent.futures.ThreadPoolExecutor | None = None  # see _each

    def _new_shard(self, i: int) -> HNSWIndex:
        return HNSWIndex(
            self.space, m=self.m, ef_construction=self.ef_construction,
            seed=self.seed + i, inline_neighbors=self.inline_neighbors,
            device=self.devices[i],
        )

    def _own_shards(self) -> list[HNSWIndex]:
        return [self._shards[i] for i in self._own]

    def _each(self, fn, shards: list[int]) -> list:
        """[fn(i) for i in shards] on the index's pool, a thread a shard (the
        native builder releases the GIL; the pool lives as long as the index,
        as add_document's many small inserts would pay a thread start each);
        inline for one shard, or when torch is held to one host thread."""
        if len(shards) <= 1 or torch.get_num_threads() == 1:
            return [fn(i) for i in shards]
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=len(self._own))
        return list(self._pool.map(fn, shards))

    def build(self, data: np.ndarray, labels: np.ndarray | None = None) -> None:
        data = self.space.preprocess(data)
        n = data.shape[0]
        if labels is None:
            labels = np.arange(n, dtype=np.int64)
        labels = np.asarray(labels, dtype=np.int64)
        s = self.num_shards

        def build_one(i):
            shard = self._new_shard(i)
            # the rows are preprocessed already: straight to the builder;
            # round-robin keeps shards balanced for any input order
            shard._builder.add_batch(data[i::s], labels[i::s])
            return shard

        built = self._each(build_one, self._own)
        self._shards = [None] * s
        for i, shard in zip(self._own, built):
            self._shards[i] = shard
        self._reindex_labels()

    def _reindex_labels(self) -> None:
        """Rebuild the per-shard label tables and the label -> (shard, local)
        map from the shards' builders, gathered over the process group
        (single-index feature parity: filters, deletes and entry overrides
        address elements by external label). The next sync picks the tier."""
        parts = {}
        for i in self._own:
            b = self._shards[i]._builder
            parts[i] = (b.export_labels_range(0, b.size),
                        b.export_deleted().astype(bool))
        if self.group is not None:
            got = [None] * self._world
            dist.all_gather_object(got, parts, group=self.group)
            for p in got:
                parts.update(p)
        self._shard_labels = [parts[i][0] for i in range(self.num_shards)]
        self._shard_deleted = [parts[i][1] for i in range(self.num_shards)]
        self._label_map = {}
        for i, labs in enumerate(self._shard_labels):
            for local, lab in enumerate(labs.tolist()):
                self._label_map[lab] = (i, local)
        self._tier_chosen = False

    def _locate(self, label: int) -> tuple[int, int]:
        loc = self._label_map.get(int(label))
        if loc is None:
            raise KeyError(f"label {label} not in index")
        return loc

    # -- mutation (single-index parity: add and delete by external label) ----

    def add_items(self, data: np.ndarray, labels: np.ndarray | None = None) -> None:
        """Incremental insert (hnsw_tpu's add_items): labels that already
        exist route to their owning shard as in-place updates, which unmark
        them; new rows go round-robin from the currently smallest shards (a
        stable argsort of the sizes keeps the balance). On an index not yet
        built the shards start empty, so this equals `build`. The shards
        insert their rows at once, each in its own order (updates first),
        as `build` does. The devices re-sync as per-shard row deltas on the
        next search."""
        if self._shards is None:
            self._shards = [None] * self.num_shards
            for i in self._own:
                self._shards[i] = self._new_shard(i)
            self._reindex_labels()
        data = self.space.preprocess(data)
        if labels is None:
            start = self.num_elements
            labels = np.arange(start, start + data.shape[0], dtype=np.int64)
        labels = np.asarray(labels, dtype=np.int64).reshape(-1)
        exists = np.asarray([int(l) in self._label_map for l in labels], dtype=bool)
        batches = {i: [] for i in self._own}  # shard -> its (rows, labels) in order
        for row, lab in zip(data[exists], labels[exists]):
            i, local = self._label_map[int(lab)]
            if i in batches:
                batches[i].append((row[None, :], np.asarray([lab])))
            self._shard_deleted[i][local] = False
        data, labels = data[~exists], labels[~exists]
        sizes = np.asarray([len(l) for l in self._shard_labels])
        shard_of = np.argsort(sizes, kind="stable")[
            np.arange(data.shape[0]) % self.num_shards
        ]
        for i in range(self.num_shards):
            sel = shard_of == i
            if not sel.any():
                continue
            labs = labels[sel]
            if i in batches:
                batches[i].append((data[sel], labs))
            first_local = len(self._shard_labels[i])
            self._shard_labels[i] = np.concatenate([self._shard_labels[i], labs])
            self._shard_deleted[i] = np.concatenate(
                [self._shard_deleted[i], np.zeros(len(labs), bool)]
            )
            for off, lab in enumerate(labs.tolist()):
                self._label_map[lab] = (i, first_local + off)

        def insert(i):
            for rows, labs in batches[i]:
                self._shards[i]._builder.add_batch(rows, labs)
            self._shards[i]._dirty = True

        self._each(insert, [i for i in self._own if batches[i]])

    def mark_deleted(self, label: int) -> None:
        shard, local = self._locate(label)
        if self._shards[shard] is not None:
            self._shards[shard].mark_deleted(label)
        self._shard_deleted[shard][local] = True

    def unmark_deleted(self, label: int) -> None:
        shard, local = self._locate(label)
        if self._shards[shard] is not None:
            self._shards[shard].unmark_deleted(label)
        self._shard_deleted[shard][local] = False

    @property
    def num_elements(self) -> int:
        return sum(len(labs) for labs in self._shard_labels)

    # -- persistence ---------------------------------------------------------

    def save(self, path_prefix: str) -> None:
        """Write one .npz checkpoint per shard, {prefix}.shard{i}.npz, and
        {prefix}.meta.json: the JAX package's layout, so each package loads
        the other's sets. Under a process group each shard is written by its
        rank of dp rank 0, the meta by rank 0, and every rank returns once
        all are written."""
        if self._shards is None:
            raise ValueError("nothing built")
        if self._dp_rank == 0:
            for i in self._own:
                self._shards[i].save(f"{path_prefix}.shard{i}.npz")
        if self._rank == 0:
            with open(f"{path_prefix}.meta.json", "w") as f:
                json.dump(
                    {
                        "num_shards": self.num_shards,
                        "space": self.space.persist_name,
                        "dim": self.dim,
                        "m": self.m,
                        "ef_construction": self.ef_construction,
                    },
                    f,
                )
        if self.group is not None:
            dist.barrier(group=self.group)

    def load(self, path_prefix: str) -> None:
        """Restore this rank's shards from a save()d checkpoint set, each on
        its device (the shard count must match this index's)."""
        with open(f"{path_prefix}.meta.json") as f:
            meta = json.load(f)
        if meta["num_shards"] != self.num_shards:
            raise ValueError(
                f"checkpoint has {meta['num_shards']} shards, index has "
                f"{self.num_shards}"
            )
        shard_meta = {
            "space": self.space.persist_name, "dim": self.dim, "m": meta["m"],
            "ef_construction": meta["ef_construction"],
        }
        self._shards = [None] * self.num_shards
        for i in self._own:
            g, vectors, deleted, _ = load_checkpoint(f"{path_prefix}.shard{i}.npz")
            shard = HNSWIndex._from_parts(
                g, vectors, deleted, shard_meta, device=self.devices[i],
                inline_neighbors=self.inline_neighbors,
            )
            shard.space = self.space  # the space this index was opened with
            self._shards[i] = shard
        self._reindex_labels()

    # -- device state ---------------------------------------------------------

    def _reduce(self, value: int, op) -> int:
        """`value` reduced over the process group (itself in one process)."""
        if self.group is None:
            return value
        t = torch.tensor([value], dtype=torch.int64, device=self._comm_device)
        dist.all_reduce(t, op=op, group=self.group)
        return int(t.item())

    def _budget(self, cap: int | None) -> int | None:
        """A per-shard table budget in bytes, the same on every rank: `cap`,
        else UNIFIED_FREE_SHARE of each card's free memory divided by the
        shards every rank holds there (None, no limit, on the CPU), the
        least over cards."""
        if cap is None:
            cards = {self.devices[i] for i in self._own}
            shares = {d: free_share(d) for d in cards}
            if None not in shares.values():
                cap = min(s // self._card_shards[str(d)] for d, s in shares.items())
        cap = self._reduce(_NO_LIMIT if cap is None else cap, dist.ReduceOp.MIN)
        return None if cap == _NO_LIMIT else cap

    def _pick_tier(self) -> str | None:
        """The rung for the largest shard's padded size, the n_pad JAX stacks
        every shard at (sharding.py:196-197), or None for plain gathers."""
        first = self._shards[self._own[0]]
        if not first.inline_neighbors:
            return None
        n_max = max(len(labs) for labs in self._shard_labels)
        n_pad = round_up(n_max + 1 + int(n_max * first.growth_headroom), 128)
        m0 = max(16, round_up(2 * first.m, 16))
        budget = self._budget(self.unified_max_bytes
                              if self.unified_max_bytes is not None
                              else hnsw_mod.UNIFIED_MAX_BYTES)
        split = self._budget(hnsw_mod.SPLIT_MAX_BYTES)
        tier = pick_tier(n_pad, m0, self.dim, budget, split)
        if tier is None:
            raise MemoryError(
                f"no tier fits the largest shard (n_pad {n_pad}): unified "
                f"budget {budget} bytes a shard, split budget {split} "
                f"({tier_bytes(n_pad, m0, self.dim)}); pass "
                "inline_neighbors=False to serve through plain row gathers"
            )
        return tier

    def rebuild_device_tables(self, unified_max_bytes: int | None = None) -> str | None:
        """Drop and rebuild every shard's device tensors on one rung, picked
        by the ladder for the largest shard; returns it (None: plain
        gathers). An explicit `unified_max_bytes` is a per-shard budget (JAX
        budgets each device's one shard) and stays the index's budget. The
        old tables are released first, so peak memory holds one set."""
        if self._shards is None:
            raise ValueError("call build() or load() first")
        if unified_max_bytes is not None:
            self.unified_max_bytes = unified_max_bytes
        for shard in self._own_shards():
            shard._device = shard._landmark_cache = None
        self._tier = self._pick_tier()
        for shard in self._own_shards():
            self._configure(shard)
            shard.rebuild_device_tables()
        self._tier_chosen = True
        self.last_sync_mode = "full"
        return self._tier

    def _configure(self, shard: HNSWIndex) -> None:
        """What a shard's full sync reads from the index: the common rung,
        the trim knobs, and squared norms summed as JAX's stack sums them
        (float64 over the f32 rows, sharding.py:237)."""
        shard._forced_tier = self._tier
        shard.upper_inline = self.upper_inline
        shard.keep_delta_tables = self.keep_delta_tables
        shard._sq_f64 = True

    def _sync(self) -> None:
        """Bring every shard's device state up to date: its row deltas, or a
        full sync where its own sync refuses one. As JAX does (sharding.py
        :922-927), a trimmed index (bf16 vectors or no side tables) takes
        every mutation in full. When a full sync moves the largest shard's
        rung, every shard resyncs at the new one."""
        if not self._tier_chosen:
            self.rebuild_device_tables()
            return
        trim = (not self.keep_delta_tables
                or self.space.storage_dtype != torch.float32)
        code = 0  # 2: a shard synced in full, 1: by row deltas
        for shard in self._own_shards():
            self._configure(shard)
            if trim and shard._dirty:
                shard._device = shard._landmark_cache = None
            shard._sync_device()
            code = max(code, {"full": 2, "delta": 1}.get(shard._last_sync_mode, 0))
        code = self._reduce(code, dist.ReduceOp.MAX)
        if code == 2 and self._pick_tier() != self._tier:
            self.rebuild_device_tables()
        elif code:
            self.last_sync_mode = ("delta", "full")[code - 1]

    # -- search ---------------------------------------------------------------

    def search(
        self,
        queries: np.ndarray,
        k: int = 10,
        ef: int = 200,
        expand: int = 1,
        *,
        filter_labels: np.ndarray | None = None,
        entry_labels: np.ndarray | None = None,
        stop_patience: int = 0,
        stop_frontier: float = 0.0,
        frontier_rank: int = 0,
        max_iters: int = 0,
        entry_seeds: int = 0,
        seed_pool: int = 0,
        stop_fn: object = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched kNN over all shards → (dists [B, k] f32, labels [B, k]
        int64; label -1 = missing), rows ascending.

        `filter_labels` is a bool mask over external labels, shared [L] or
        per-query [B, L]; delete-marked elements are always excluded.
        `entry_labels` overrides each query's entry point by external label:
        the owning shard starts there, every other shard at its own entry
        point (as does every shard for an absent label). The other knobs are
        HNSWIndex's SearchParams, applied to every shard-local beam; the
        lossy tiers rescore shard-locally (4*k) before the merge, so the
        merged distances are exact and comparable across shards. Under a
        process group every rank returns the whole answer."""
        params = SearchParams(
            k=k, ef=max(ef, k), expand=expand, max_iters=max_iters,
            stop_patience=stop_patience, stop_frontier=stop_frontier,
            frontier_rank=frontier_rank, stop_fn=stop_fn,
            entry_seeds=entry_seeds, seed_pool=seed_pool,
        )
        d, lab = self._local_search(queries, params, filter_labels, entry_labels)
        if self.group is None:
            all_d, all_l = [d], [lab]
        else:
            all_d = [torch.empty_like(d) for _ in range(self._world)]
            all_l = [torch.empty_like(lab) for _ in range(self._world)]
            dist.all_gather(all_d, d, group=self.group)
            dist.all_gather(all_l, lab, group=self.group)
        d, lab = merge_shard_results(all_d, all_l, num_shards=self.num_shards,
                                     dp=self.dp, k=k)
        b0 = len(queries)
        return d[:b0].cpu().numpy(), lab[:b0].cpu().numpy()

    def _local_search(
        self, queries, params: SearchParams, filter_labels, entry_labels,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """This rank's part of a search: its dp slice of the batch (padded to
        B/dp rows a rank) on its own shards → ([S/G, B/dp, k] dists,
        labels) on the device the results are gathered on."""
        if self._shards is None:
            raise ValueError("call build() or load() first")
        self._sync()
        queries = np.asarray(queries)
        b0 = queries.shape[0]
        # each dp rank takes a contiguous slice; padded rows repeat query 0
        # and are cut from the answer
        b_loc = -(-b0 // self.dp)
        sl = slice(self._dp_rank * b_loc, (self._dp_rank + 1) * b_loc)

        def local(a):
            a = np.asarray(a)
            pad = b_loc * self.dp - b0
            if pad:
                a = np.concatenate([a, np.repeat(a[:1], pad, axis=0)])
            return a[sl]

        q = local(queries)
        fl = filter_labels
        if fl is not None and np.ndim(fl) == 2:
            if len(fl) != b0:
                raise ValueError(f"filter_labels rows {len(fl)} != batch {b0}")
            fl = local(fl)
        ent = None
        if entry_labels is not None:
            entry_labels = np.asarray(entry_labels).reshape(-1)
            ent = np.full((self.num_shards, len(entry_labels)), -1, dtype=np.int32)
            for j, lab in enumerate(entry_labels.tolist()):
                loc = self._label_map.get(lab)
                if loc is not None:
                    ent[loc[0], j] = loc[1]
            ent = local(ent.T).T
        parts = [
            self._shards[i].search(
                q, filter_labels=fl, entry_ids=None if ent is None else ent[i],
                params=params,
            )
            for i in self._own
        ]
        dev = self._comm_device
        return (torch.from_numpy(np.stack([p[0] for p in parts])).to(dev),
                torch.from_numpy(np.stack([p[1] for p in parts])).to(dev))


# ---------------------------------------------------------------------------
# A dry run of the distributed form (__graft_entry__.dryrun_multichip's
# counterpart): gloo ranks on the CPU, tiny shapes.
# ---------------------------------------------------------------------------


_DRYRUN_JOIN_S = 600  # how long dryrun_multiproc waits for each rank


def _dryrun_rank(rank: int, world: int, store: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        dp = 2 if world >= 4 and world % 2 == 0 else 1
        x = np.random.default_rng(1).normal(size=(max(256 * world, 1024), 64))
        x = x.astype(np.float32)
        idx = ShardedHNSWIndex("l2", 64, num_shards=world // dp, m=8,
                               ef_construction=50, device="cpu",
                               process_group=dist.group.WORLD, dp=dp)
        idx.build(x)
        d, labels = idx.search(x[:32], k=5, ef=32)
        if d.shape != (32, 5) or labels.shape != (32, 5) or labels.min() < 0:
            raise RuntimeError(f"rank {rank}: shapes {d.shape} {labels.shape}, "
                               f"least label {labels.min()}")
        # self-queries find themselves through the merge, with the descent
        # and with landmark-seeded entries
        for seeds in (0, 4):
            _, labels = idx.search(x[:32], k=5, ef=32, entry_seeds=seeds)
            hit = float(np.mean(labels[:, 0] == np.arange(32)))
            if hit < 0.9:
                raise RuntimeError(f"rank {rank}: self-hit {hit} with entry_seeds={seeds}")
    finally:
        dist.destroy_process_group()


def dryrun_multiproc(n_procs: int) -> None:
    """Start `n_procs` gloo ranks on the CPU (dp=2 when n_procs >= 4 and
    even, else dp=1; one shard per rank of a dp group), build a tiny
    sharded index and check every rank's shapes, that every label is
    found, and that self-queries find themselves (plain and with
    entry_seeds=4). Raises if a rank fails or outlives _DRYRUN_JOIN_S."""
    import multiprocessing
    import tempfile

    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="hnsw_dryrun_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_dryrun_rank, args=(r, n_procs, store))
                 for r in range(n_procs)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(_DRYRUN_JOIN_S)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise RuntimeError(f"dryrun_multiproc({n_procs}): rank exit codes {codes}")
