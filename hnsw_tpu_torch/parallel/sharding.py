"""Sharded HNSW search in one process (counterpart of
hnsw_tpu/parallel/sharding.py).

The dataset is partitioned round-robin into one complete HNSW sub-index per
shard. The JAX package stacks every shard's device arrays into [S, ...]
arrays sharded over a mesh axis and searches them inside `shard_map`; here a
shard is one `HNSWIndex`, with its own host builder and its own device state
(tier tables, landmark set, delete mask), on `cuda:i % device_count()` when
the index is asked for "cuda". A search runs every shard's beam, with the
shard-local exact rescore on the lossy tiers, one shard after another, and
merges the [B, S*k] partial results on shard 0's device: the reference's
all_gather and top-k merge.
"""

from __future__ import annotations

import concurrent.futures
import json

import numpy as np
import torch

from hnsw_tpu_torch.core.spaces import Space, get_space
from hnsw_tpu_torch.io.checkpoint import load_checkpoint
from hnsw_tpu_torch.models.bruteforce import resolve_device
from hnsw_tpu_torch.models.hnsw import HNSWIndex, SearchParams


def shard_device(device: torch.device, i: int) -> torch.device:
    """Where shard i lives: "cuda" without an index spreads the shards over
    the visible cards (cuda:i % device_count()); any other device holds them
    all."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", i % torch.cuda.device_count())
    return device


class ShardedHNSWIndex:
    """Dataset partitioned into one HNSW sub-index per shard.

    Build runs one native builder per shard in a thread pool (the C ABI
    releases the GIL, so shard builds use all host cores — the reference's
    build loop is strictly serial, index_builder/build.cpp:137-145).
    `inline_neighbors` is passed to every shard's HNSWIndex (None: the tier
    ladder; False: plain row gathers). Every shard must serve the same tier.
    """

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
    ):
        if isinstance(space, str):
            if dim is None:
                raise ValueError("dim required when space given by name")
            space = get_space(space, dim)
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.space = space
        self.dim = space.dim
        self.num_shards = num_shards
        self.m = m
        self.ef_construction = ef_construction
        self.seed = seed
        self.inline_neighbors = inline_neighbors
        dev = resolve_device(device)
        self.devices = [shard_device(dev, i) for i in range(num_shards)]
        self._shards: list[HNSWIndex] | None = None
        self._shard_labels: list[np.ndarray] | None = None  # per-shard labels
        self._shard_deleted: list[np.ndarray] | None = None  # per-shard bool
        self._label_map: dict[int, tuple[int, int]] | None = None  # label -> (shard, local)

    def build(self, data: np.ndarray, labels: np.ndarray | None = None) -> None:
        data = self.space.preprocess(data)
        n = data.shape[0]
        if labels is None:
            labels = np.arange(n, dtype=np.int64)
        labels = np.asarray(labels, dtype=np.int64)
        s = self.num_shards
        # round-robin partition keeps shards balanced for any input order
        parts = [np.arange(i, n, s) for i in range(s)]

        def build_one(i):
            shard = HNSWIndex(
                self.space, m=self.m, ef_construction=self.ef_construction,
                seed=self.seed + i, inline_neighbors=self.inline_neighbors,
                device=self.devices[i],
            )
            # the rows are preprocessed already: straight to the builder
            shard._builder.add_batch(data[parts[i]], labels[parts[i]])
            return shard

        with concurrent.futures.ThreadPoolExecutor(max_workers=s) as ex:
            self._shards = list(ex.map(build_one, range(s)))
        self._reindex_labels()

    def _reindex_labels(self) -> None:
        """Rebuild the per-shard label tables and the label -> (shard, local)
        map from the shards' builders (single-index feature parity: filters,
        deletes and entry overrides address elements by external label)."""
        self._shard_labels = []
        self._shard_deleted = []
        self._label_map = {}
        for i, shard in enumerate(self._shards):
            b = shard._builder
            g = b.export_graph()
            self._shard_labels.append(g.labels.copy())
            self._shard_deleted.append(b.export_deleted().astype(bool))
            for local, lab in enumerate(g.labels):
                self._label_map[int(lab)] = (i, local)

    def _locate(self, label: int) -> tuple[int, int]:
        loc = self._label_map.get(int(label))
        if loc is None:
            raise KeyError(f"label {label} not in index")
        return loc

    # -- mutation (single-index parity: delete by external label) ------------

    def mark_deleted(self, label: int) -> None:
        shard, local = self._locate(label)
        self._shards[shard].mark_deleted(label)
        self._shard_deleted[shard][local] = True

    def unmark_deleted(self, label: int) -> None:
        shard, local = self._locate(label)
        self._shards[shard].unmark_deleted(label)
        self._shard_deleted[shard][local] = False

    @property
    def num_elements(self) -> int:
        return sum(shard.num_elements for shard in self._shards)

    # -- persistence ---------------------------------------------------------

    def save(self, path_prefix: str) -> None:
        """Write one .npz checkpoint per shard, {prefix}.shard{i}.npz, and
        {prefix}.meta.json: the JAX package's layout, so each package loads
        the other's sets."""
        if self._shards is None:
            raise ValueError("nothing built")
        for i, shard in enumerate(self._shards):
            shard.save(f"{path_prefix}.shard{i}.npz")
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

    def load(self, path_prefix: str) -> None:
        """Restore every shard from a save()d checkpoint set, each on its
        device (the shard count must match this index's)."""
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
        shards = []
        for i in range(self.num_shards):
            g, vectors, deleted, _ = load_checkpoint(f"{path_prefix}.shard{i}.npz")
            shard = HNSWIndex._from_parts(
                g, vectors, deleted, shard_meta, device=self.devices[i],
                inline_neighbors=self.inline_neighbors,
            )
            shard.space = self.space  # the space this index was opened with
            shards.append(shard)
        self._shards = shards
        self._reindex_labels()

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
        merged distances are exact and comparable across shards."""
        if self._shards is None:
            raise ValueError("call build() or load() first")
        tiers = [shard._sync_device().tier for shard in self._shards]
        if len(set(tiers)) > 1:
            raise ValueError(
                f"the shards serve different tiers {tiers}: every shard must "
                "serve the same one"
            )
        params = SearchParams(
            k=k, ef=max(ef, k), expand=expand, max_iters=max_iters,
            stop_patience=stop_patience, stop_frontier=stop_frontier,
            frontier_rank=frontier_rank, stop_fn=stop_fn,
            entry_seeds=entry_seeds, seed_pool=seed_pool,
        )
        ent = None
        if entry_labels is not None:
            entry_labels = np.asarray(entry_labels).reshape(-1)
            ent = np.full((self.num_shards, len(entry_labels)), -1, dtype=np.int32)
            for j, lab in enumerate(entry_labels):
                loc = self._label_map.get(int(lab))
                if loc is not None:
                    ent[loc[0], j] = loc[1]
        parts = [
            shard.search(
                queries, filter_labels=filter_labels,
                entry_ids=None if ent is None else ent[i], params=params,
            )
            for i, shard in enumerate(self._shards)
        ]
        # [B, S*k] in shard order; a stable sort keeps equal distances in
        # shard order, as lax.top_k prefers the lower index
        dev = self._shards[0].device
        d = torch.from_numpy(np.concatenate([p[0] for p in parts], axis=1)).to(dev)
        lab = torch.from_numpy(np.concatenate([p[1] for p in parts], axis=1)).to(dev)
        d, pos = torch.sort(d, dim=-1, stable=True)
        return d[:, :k].cpu().numpy(), lab.gather(-1, pos[:, :k]).cpu().numpy()
