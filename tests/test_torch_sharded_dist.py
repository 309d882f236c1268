"""Port parity, the distributed form of the sharded index: a
`torch.distributed` group of W ranks with the batch split dp ways, the
counterpart of the JAX package's (dp, shard) mesh.

Tier-1 runs no process: W ranks are simulated in one (each rank's layout
set by `rank_layout` on one loaded index, its part of a search by
`_local_search`), and their partial results go through
`merge_shard_results`, which must give the one-process `search`'s answer
bit for bit. The runs of real gloo processes on the CPU (2 ranks at dp=1,
4 at dp=2, held to the one-process answer and to the JAX mesh on the same
set) and `dryrun_multiproc(4)` are `slow`: they start processes and open
sockets. One thread, serial builds (N=1,600, d=16, M=8, efC=100)."""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from jax.sharding import Mesh

from hnsw_tpu.parallel import sharding as jsh

from hnsw_tpu_torch.models.hnsw import HNSWIndex, SearchParams
from hnsw_tpu_torch.parallel.sharding import (
    ShardedHNSWIndex,
    dryrun_multiproc,
    merge_shard_results,
    rank_layout,
)

REPO = Path(__file__).resolve().parents[1]
N, D, M, EFC, B, K, EF = 1600, 16, 8, 100, 15, 10, 48  # B = 15: dp=2 pads a row
NOISE = 0.5  # queries this far off a stored vector: 1e-5 relative applies


def _make_set(x, s, prefix):
    t = ShardedHNSWIndex("l2", D, num_shards=s, m=M, ef_construction=EFC, device="cpu")
    t._shards = []
    for i in range(s):
        shard = HNSWIndex("l2", dim=D, m=M, ef_construction=EFC, seed=123 + i, device="cpu")
        shard._builder.add_batch(x[i::s], np.arange(i, N, s), n_threads=1)
        t._shards.append(shard)
    t._reindex_labels()
    t.save(prefix)


def _port(prefix, s, **kw):
    t = ShardedHNSWIndex("l2", D, num_shards=s, m=M, ef_construction=EFC,
                         device="cpu", inline_neighbors=False, **kw)
    t.load(prefix)
    return t


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    rng = np.random.default_rng(2024)
    x = rng.normal(size=(N, D)).astype(np.float32)
    q = x[rng.integers(0, N, B)] + NOISE * rng.normal(size=(B, D)).astype(np.float32)
    prefix = str(tmp_path_factory.mktemp("sharded_dist") / "set")
    _make_set(x, 8, prefix)
    mask = np.random.default_rng(7).random((B, N)) < 0.5
    # a label of every shard group for the even queries, absent for the odd
    entry = np.where(np.arange(B) % 2 == 0, 1000 + np.arange(B), 10**9)
    return {"x": x, "q": q, "prefix": prefix, "mask": mask, "entry": entry}


def test_rank_layout():
    """G = W / dp shard groups: rank r is dp rank r // G and owns the shards
    i with i % G == r % G; W % dp and S % G must be 0."""
    assert rank_layout(1, 0, 1, 8) == (0, list(range(8)))
    assert rank_layout(2, 1, 1, 8) == (0, [1, 3, 5, 7])
    assert [rank_layout(4, r, 2, 8) for r in range(4)] == [
        (0, [0, 2, 4, 6]), (0, [1, 3, 5, 7]), (1, [0, 2, 4, 6]), (1, [1, 3, 5, 7])]
    assert rank_layout(2, 1, 2, 8) == (1, list(range(8)))
    for bad in ((4, 0, 3, 8), (3, 0, 1, 8), (2, 0, 0, 8)):
        with pytest.raises(ValueError):
            rank_layout(*bad)


@pytest.mark.parametrize("world,dp", [(2, 1), (4, 1), (4, 2), (2, 2)])
def test_merge_matches_one_process(shared, world, dp):
    """W simulated ranks, each its dp slice of the batch on its shards,
    reassembled and merged: the one-process answer bit for bit, with a
    per-query filter and entry labels sliced with the batch too."""
    q = shared["q"]
    t = _port(shared["prefix"], 8)
    params = SearchParams(k=K, ef=EF)
    cases = [(None, None), (shared["mask"], shared["entry"])]
    want = [t.search(q, k=K, ef=EF, filter_labels=fl, entry_labels=en) for fl, en in cases]
    for (fl, en), (wd, wl) in zip(cases, want):
        parts = []
        for r in range(world):
            t._dp_rank, t._own = rank_layout(world, r, dp, 8)
            t.dp = dp
            parts.append(t._local_search(q, params, fl, en))
        d, lab = merge_shard_results([p[0] for p in parts], [p[1] for p in parts],
                                     num_shards=8, dp=dp, k=K)
        assert d.shape == (-(-B // dp) * dp, K)
        np.testing.assert_array_equal(d[:B].numpy(), wd)
        np.testing.assert_array_equal(lab[:B].numpy(), wl)
        t._dp_rank, t._own, t.dp = rank_layout(1, 0, 1, 8) + (1,)


def test_budget_counts_every_rank_on_a_card(monkeypatch):
    """Two ranks of a group on one card (as a bare "cuda" gives when ranks
    outnumber cards): the card's free share is divided over the shards both
    ranks hold there, not only this rank's four. The group is simulated in
    this process: its collectives answer as the other rank would."""
    from hnsw_tpu_torch.parallel import sharding as sh

    monkeypatch.setattr(sh.dist, "get_world_size", lambda group: 2)
    monkeypatch.setattr(sh.dist, "get_rank", lambda group: 0)
    monkeypatch.setattr(sh.dist, "get_backend", lambda group: "gloo")
    monkeypatch.setattr(sh.dist, "all_gather_object",
                        lambda out, obj, group: out.__setitem__(slice(None), [obj, obj]))
    monkeypatch.setattr(sh.dist, "all_reduce", lambda t, op, group: None)
    monkeypatch.setattr(sh, "free_share", lambda device: 8_000_000)
    t = ShardedHNSWIndex("l2", D, num_shards=8, m=M, ef_construction=EFC, device="cpu",
                         process_group=object())
    assert t._own == [0, 2, 4, 6] and t._card_shards == {"cpu": 8}
    assert t._budget(None) == 1_000_000
    assert t._budget(3_000) == 3_000


# -- gloo processes (slow) ---------------------------------------------------

WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from hnsw_tpu_torch.parallel.sharding import ShardedHNSWIndex
rank, world, dp, shards = map(int, sys.argv[1:5])
store, prefix, data, out = sys.argv[5:9]
dist.init_process_group("gloo", init_method="file://" + store, world_size=world, rank=rank)
try:
    z = np.load(data)
    idx = ShardedHNSWIndex("l2", z["q"].shape[1], num_shards=shards, m=8,
                           ef_construction=100, device="cpu", inline_neighbors=False,
                           process_group=dist.group.WORLD, dp=dp)
    idx.load(prefix)
    res = {}
    for name in ("a", "b", "c"):
        if name == "b":
            idx.add_items(z["extra"], z["extra_labels"])
        if name == "c":
            idx.mark_deleted(int(z["victim"]))
        res["d" + name], res["l" + name] = idx.search(z["q"], k=10, ef=48)
    res["mode"] = np.array(idx.last_sync_mode)
    res["n"] = np.array(idx.num_elements)
    idx.save(prefix + ".grown")
    np.savez(out + f".{rank}.npz", **res)
finally:
    dist.destroy_process_group()
"""


def _run_ranks(tmp_path, world, dp, shards, prefix, data):
    store = str(tmp_path / "store")
    out = str(tmp_path / "out")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(world), str(dp), str(shards), store,
         prefix, data, out], cwd=REPO) for r in range(world)]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert codes == [0] * world
    return [dict(np.load(f"{out}.{r}.npz")) for r in range(world)]


@pytest.mark.slow
@pytest.mark.parametrize("world,dp", [(2, 1), (4, 2)])
def test_gloo_ranks_match_one_process_and_jax(shared, tmp_path, world, dp):
    """Every rank returns the one-process answer bit for bit through a
    search, add_items (in-place updates and new rows routed by the
    replicated maps), a delete, and save; the search before the mutation
    equals the JAX (dp, shard) mesh's on the same set."""
    s = 8 if dp == 1 else 4
    q, prefix = shared["q"], str(tmp_path / "set")
    _make_set(shared["x"], s, prefix)
    rng = np.random.default_rng(3)
    extra = rng.normal(size=(16, D)).astype(np.float32)
    extra_labels = np.concatenate([np.arange(N, N + 12), [5, 17, 400, 1501]])
    data = str(tmp_path / "data.npz")
    np.savez(data, q=q, extra=extra, extra_labels=extra_labels, victim=17)
    got = _run_ranks(tmp_path, world, dp, s, prefix, data)
    t = _port(prefix, s)
    want = {}
    for name in ("a", "b", "c"):
        if name == "b":
            t.add_items(extra, extra_labels)
        if name == "c":
            t.mark_deleted(17)
        want["d" + name], want["l" + name] = t.search(q, k=K, ef=EF)
    for res in got:
        for key, val in want.items():
            np.testing.assert_array_equal(res[key], val)
        assert str(res["mode"]) == t.last_sync_mode and int(res["n"]) == t.num_elements
    grown = _port(prefix + ".grown", s)
    assert grown._label_map == t._label_map
    np.testing.assert_array_equal(grown.search(q, k=K, ef=EF)[1], want["lc"])

    devs = np.array(jax.devices())
    mesh = Mesh(devs.reshape(dp, 8 // dp), ("dp", "shard") if dp > 1 else ("x", "shard"))
    j = jsh.ShardedHNSWIndex("l2", D, mesh=mesh, dp_axis="dp" if dp > 1 else None,
                             m=M, ef_construction=EFC)
    j.load(prefix)
    jd, jl = j.search(q, k=K, ef=EF)
    np.testing.assert_array_equal(want["la"], jl)
    np.testing.assert_allclose(want["da"], jd, rtol=1e-5, atol=0)


@pytest.mark.slow
def test_dryrun_multiproc():
    dryrun_multiproc(4)
