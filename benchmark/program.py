"""The system under test, hnsw_tpu_torch, driven through its public entry
points: ``bulk_build`` for the index, ``HNSWIndex.rebuild_device_tables``
for the serving tables, ``HNSWIndex.search`` for the timed path. The
benchmark takes from the program only these calls, the kernel launch counts
(``ops.gather_kernels.COUNTS``), the bulk build's ``wave_log`` and, in a
traced run, the ids each hop launch was given.
"""

from __future__ import annotations

import math

from hnsw_tpu_torch import SearchParams, bulk_build
from hnsw_tpu_torch.ops import traversal
from hnsw_tpu_torch.ops.gather_kernels import (
    COUNTS,
    Unified4Table,
    Unified8Table,
    UnifiedTable,
    tier_bytes,
)

# the tier ladder, largest rung first (ops.gather_kernels.pick_tier)
_LADDER = ("unified", "unified8", "unified4")
_TABLE_TIER = {UnifiedTable: "unified", Unified8Table: "unified8", Unified4Table: "unified4"}
HOP_COUNTERS = ("hop_dist_unified", "hop_dist_unified8", "hop_dist_unified4")


def build(cfg: dict, x, seed: int, device):
    """The index, built on the card by the device-wave bulk build (with the
    configuration's own `build` options, if it states any)."""
    return bulk_build(x, space=cfg["index"]["space"], m=cfg["m"],
                      ef_construction=cfg["ef_construction"], seed=seed, device=device,
                      **cfg.get("build", {}))


def tier_budget(n: int, m: int, dim: int, tier: str) -> int | None:
    """A table budget under which the ladder serves `tier`: None (the
    default budget) for the top rung, else halfway between this rung's
    bytes at a padded size of 1.25 n and the rung above's at n, which
    brackets any padding the sync adds."""
    rung = _LADDER.index(tier)
    if rung == 0:
        return None
    m0 = 2 * m
    lo = tier_bytes(math.ceil(1.25 * n / 128) * 128, m0, dim)[tier]
    hi = tier_bytes(n, m0, dim)[_LADDER[rung - 1]]
    if lo >= hi:
        raise ValueError(f"no budget separates {tier} from {_LADDER[rung - 1]}")
    return (lo + hi) // 2


def serve(index, cfg: dict) -> str:
    """Rebuild the serving tables on the configuration's tier; raises if
    the ladder picks another."""
    index.unified_max_bytes = tier_budget(index.num_elements, cfg["m"], cfg["dim"],
                                          cfg["index"]["tier"])
    st = index.rebuild_device_tables()
    if st.tier != cfg["index"]["tier"]:
        raise RuntimeError(f"served tier {st.tier}, the configuration states "
                           f"{cfg['index']['tier']}")
    return st.tier


def searcher(index, search: dict):
    """The timed path: queries (numpy) -> (distances, labels) on the host."""
    params = SearchParams(**search)

    def run(queries):
        return index.search(queries, params=params)

    return run


def counts() -> dict:
    """The hop kernels' launch counts so far, and the calls of a kernel's
    plain version on CUDA tensors."""
    return {f: getattr(COUNTS, f) for f in (*HOP_COUNTERS, "plain_on_cuda")}


class HopProbe:
    """While `active`, keeps every level-0 hop launch's table tier, shape
    and `chosen` ids (a reference: the search never writes them again), by
    rebinding the traversal's hop entry; nothing is read back meanwhile."""

    def __init__(self):
        self.launches: list = []
        self.active = False

    def __enter__(self):
        self._orig = orig = traversal.hop_dist_unified

        def probed(q, table, chosen, space="l2"):
            if self.active:
                self.launches.append((_TABLE_TIER[type(table)], table.m0, q.shape[1], chosen))
            return orig(q, table, chosen, space)

        traversal.hop_dist_unified = probed
        return self

    def __exit__(self, *exc):
        traversal.hop_dist_unified = self._orig
        return False
