"""Port parity, the sharded index in one process: ShardedHNSWIndex's build,
deletes, checkpoint sets and merged search against the JAX package's
ShardedHNSWIndex on the same shard set.

Light by design: the shard graphs are built once, serially, by the port's
builder (N=1,600 in 8 shards of 200, d=16, M=8, efC=100), saved as a
checkpoint set and loaded into both packages; the JAX side runs on
conftest's 8 virtual CPU devices. JAX serves the plain gathers there, so the
broad matrix runs the port with inline_neighbors=False; two cases force the
bf16 unified and the int4 tier on both sides. One thread, 32 queries, each
JAX result once per module.

The data: labels 8 and 9 (shards 0 and 1) hold the same vector, and query 0
lies near it."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from jax.sharding import Mesh

from hnsw_tpu.parallel import sharding as jsh

import hnsw_tpu_torch.native.hnsw_builder as tnative
from hnsw_tpu_torch.models.hnsw import HNSWIndex
from hnsw_tpu_torch.ops.gather_kernels import tier_bytes
from hnsw_tpu_torch.parallel import sharding as port_sharding
from hnsw_tpu_torch.parallel.sharding import ShardedHNSWIndex

REPO = Path(__file__).resolve().parents[1]
S, N, D, M, EFC, B, K, EF = 8, 1600, 16, 8, 100, 16, 10, 48
DUP = (8, 9)  # one vector under two labels, on shards 0 and 1
ABSENT = 10**9
# queries lie this far (per coordinate) from a stored vector: their nearest
# distances (~4) stand well above the f32 norm expansion's absolute rounding
# (a few ulps of |q|^2 + |x|^2 ~ 32, about 1e-5), so a relative tolerance
# of 1e-5 applies
NOISE = 0.5


def _mesh():
    return Mesh(np.array(jax.devices()), ("shard",))


def _port(**kw):
    return ShardedHNSWIndex("l2", D, num_shards=S, m=M, ef_construction=EFC,
                            device="cpu", **kw)


def _jax_index():
    return jsh.ShardedHNSWIndex("l2", D, mesh=_mesh(), m=M, ef_construction=EFC)


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    rng = np.random.default_rng(1606)
    x = rng.normal(size=(N, D)).astype(np.float32)
    x[DUP[1]] = x[DUP[0]]
    q = x[rng.integers(0, N, B)] + NOISE * rng.normal(size=(B, D)).astype(np.float32)
    q[0] = x[DUP[0]] + NOISE * rng.normal(size=D).astype(np.float32)
    # within each shard, no two of a query's nearest 13 distances (past
    # every k here) lie closer than 2e-6 relative: the packages' f32 sums
    # (JAX's sharded norms are summed in float64) cannot order the answers
    full = ((q[:, None, :].astype(np.float64) - x[None].astype(np.float64)) ** 2).sum(-1)
    for i in range(S):
        s = np.sort(full[:, i::S], axis=1)[:, :13]
        assert (np.diff(s, axis=1) > 2e-6 * s[:, 1:]).all()
    t = _port(inline_neighbors=False)
    t._shards = []
    for i in range(S):
        shard = HNSWIndex("l2", dim=D, m=M, ef_construction=EFC, seed=123 + i,
                          inline_neighbors=False, device="cpu")
        shard._builder.add_batch(x[i::S], np.arange(i, N, S), n_threads=1)
        t._shards.append(shard)
    t._reindex_labels()
    prefix = str(tmp_path_factory.mktemp("sharded") / "set")
    t.save(prefix)
    t = _port(inline_neighbors=False)
    t.load(prefix)
    j = _jax_index()
    j.load(prefix)
    assert j._arrays.kind == "off"
    return {"x": x, "q": q, "t": t, "j": j, "prefix": prefix, "jax": {}}


def _jax(shared, key, fn):
    if key not in shared["jax"]:
        shared["jax"][key] = fn()
    return shared["jax"][key]


def _assert_same(got, want):
    """Labels exact (int64 here; JAX's are int32 without x64); finite
    distances (f32 on both sides) to 1e-5 relative, infinities where JAX
    has them."""
    (gd, gl), (wd, wl) = got, want
    assert gd.dtype == wd.dtype == np.float32 and gl.dtype == np.int64
    assert gd.shape == gl.shape == wd.shape == wl.shape
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_array_equal(np.isfinite(gd), np.isfinite(wd))
    np.testing.assert_allclose(gd[np.isfinite(gd)], wd[np.isfinite(wd)], rtol=1e-5, atol=0)


def _stop_after_5_jax(view):
    return jnp.broadcast_to(view.it >= 5, view.beam_d.shape[:1])


def _stop_after_5(view):
    return torch.full(view.beam_d.shape[:1], view.it >= 5, dtype=torch.bool,
                      device=view.beam_d.device)


def _per_query_mask():
    return np.random.default_rng(7).random((B, N)) < 0.5


def _entry_labels():
    # a label on one shard for the even queries, an absent one for the odd
    return np.where(np.arange(B) % 2 == 0, 1234, ABSENT)


FEW = np.array([3, 17, 40, 666, 1599])  # 5 eligible labels on 5 shards
# Each set of static knobs compiles the JAX search anew (~3 s on one core),
# so knobs share cases: the seeds ride the frontier stop with max_iters
# (seed_pool reuses that compile), frontier_rank (read only under a frontier
# stop: JAX ignores it, the port drops it) the patience stop, expand=2 the
# stop_fn, and the three [L] masks one shape.
SPEED = {"entry_seeds": 4, "stop_frontier": 1.15, "max_iters": 14}
CASES = {  # name -> (kwargs, stop_fn of the JAX side or None)
    "descent": ({}, None),
    "seeds_frontier": (SPEED, None),
    "seed_pool": ({**SPEED, "seed_pool": 64}, None),
    "patience_frontier_rank": ({"stop_patience": 3, "frontier_rank": 2 * K}, None),
    "expand2_stop_fn": ({"expand": 2, "stop_fn": _stop_after_5}, _stop_after_5_jax),
    "filter_even": ({"filter_labels": np.arange(N) % 2 == 0}, None),
    "filter_per_query": ({"filter_labels": _per_query_mask()}, None),
    "entry_labels": ({"entry_labels": _entry_labels()}, None),
    "k_past_filter": ({"filter_labels": np.isin(np.arange(N), FEW)}, None),
}


def _search(idx, q, kw):
    return idx.search(q, **{"k": K, "ef": EF, **kw})


@pytest.mark.parametrize("case", list(CASES))
def test_search_matches_jax(shared, case):
    kw, jax_stop = CASES[case]
    q = shared["q"]
    jkw = dict(kw, stop_fn=jax_stop) if jax_stop else kw
    want = _jax(shared, case, lambda: _search(shared["j"], q, jkw))
    got = _search(shared["t"], q, kw)
    _assert_same(got, want)
    d, lab = got
    assert (d[:, 1:] >= d[:, :-1]).all()
    if case == "filter_even":
        assert (lab >= 0).all() and (lab % 2 == 0).all()
        for i in range(1, S, 2):  # shards with nothing eligible
            dd, ll = shared["t"]._shards[i].search(q, k=K, ef=EF, filter_labels=kw["filter_labels"])
            assert np.isinf(dd).all() and (ll == -1).all()
    if case == "k_past_filter":
        # k=10 past 5 eligible labels: -1 / inf padding. The masked beam may
        # return an eligible label more than once (JAX's does the same)
        assert np.isin(lab, np.append(FEW, -1)).all() and (lab[:, 0] >= 0).all()
        assert (lab == -1).any() and ((lab == -1) == np.isinf(d)).all()


def test_duplicates_come_back_in_shard_order(shared):
    """Equal distances on two shards merge in shard order (lax.top_k
    prefers the lower index; torch.topk does not promise it)."""
    got = _search(shared["t"], shared["q"], {})
    _assert_same(got, _jax(shared, "descent", lambda: _search(shared["j"], shared["q"], {})))
    d, lab = got
    assert tuple(lab[0, :2]) == DUP and d[0, 0] == d[0, 1]


def test_delete_in_one_shard_matches_jax(shared):
    """One delete in shard 0: JAX then masks every shard, the port only the
    one that holds it; every query's answer agrees."""
    t, j, q = shared["t"], shared["j"], shared["q"]
    victim = DUP[0]
    for idx in (t, j):
        idx.mark_deleted(victim)
    try:
        want = _search(j, q, {})
        got = _search(t, q, {})
        assert [sd.any() for sd in t._shard_deleted] == [True] + [False] * (S - 1)
    finally:
        for idx in (t, j):
            idx.unmark_deleted(victim)
    _assert_same(got, want)
    assert victim not in got[1] and got[1][0, 0] == DUP[1]
    for a, b in zip(t._shard_deleted, j._shard_deleted):
        np.testing.assert_array_equal(a, b)
    _assert_same(_search(t, q, {}), _jax(shared, "descent", lambda: _search(j, q, {})))


@pytest.mark.parametrize("tier", ["unified", "unified4"])
def test_tier_matches_jax(shared, tier):
    """A unified tier forced on both sides: JAX through the stacked arrays'
    budget (Pallas in interpret mode), the port through each shard's; int4
    rescores 4*k shard-locally on both. The level-0 tiers are what sharding
    serves; the upper levels descend through row gathers on both sides (the
    descent tables are the single index's, held by its own tests), which
    spares their interpret-mode compile."""
    prefix, q = shared["prefix"], shared["q"]
    j = _jax_index()
    j.load(prefix)
    n_pad = j._arrays.level0.shape[1]
    d_pad = 128  # the TPU row's lane width
    u8 = n_pad * (M * 2 * d_pad // 512 + 1) * 512 + n_pad * d_pad + 4 * n_pad
    u4 = n_pad * (M * 2 * d_pad // 1024 + 1) * 512 + n_pad * d_pad + 4 * n_pad
    budget = 1 << 40 if tier == "unified" else (u4 + u8) // 2
    shards = [(b.export_graph(), b.export_vectors()) for b in j._builders]
    j._arrays = jsh.build_sharded_arrays(shards, j.space, _mesh(), "shard",
                                         inline_neighbors=True, unified_max_bytes=budget,
                                         upper_inline=False)
    assert j._arrays.kind == tier and j._arrays.upper_tabs == ()
    t = _port()
    t.upper_inline = False
    t.load(prefix)
    need = tier_bytes(n_pad, 2 * M, D)
    assert t.rebuild_device_tables(
        None if tier == "unified" else (need["unified4"] + need["unified8"]) // 2) == tier
    assert [(sh._device.tier, sh._device.upper_tables) for sh in t._shards] == [(tier, None)] * S
    # k=4 on int4 (a rescore of 16): the Pallas kernels compile in
    # interpret mode for ~10 s (bf16) and ~20 s (int4) on one core
    kw = {"k": 4} if tier == "unified4" else {}
    _assert_same(_search(t, q, kw), _search(j, q, kw))


def _small_shards(sizes):
    """A port index of S shards of the given sizes (serial builds)."""
    rng = np.random.default_rng(5)
    t = _port()
    t._shards = []
    for i, n in enumerate(sizes):
        shard = HNSWIndex("l2", dim=D, m=M, ef_construction=EFC, seed=123 + i, device="cpu")
        shard._builder.add_batch(rng.normal(size=(n, D)).astype(np.float32),
                                 np.arange(1000 * i, 1000 * i + n), n_threads=1)
        t._shards.append(shard)
    t._reindex_labels()
    return t


def test_one_tier_for_every_shard(monkeypatch):
    """Every shard serves the rung the ladder picks at the largest shard's
    n_pad (JAX's one `kind`, sharding.py:196-197), where a smaller shard
    alone would take a higher one; a growth that moves that rung re-syncs
    every shard at the new one; the default budget is the free share of
    each card over the shards it holds. Inserts run on one thread."""
    add = tnative.NativeHNSWBuilder.add_batch
    monkeypatch.setattr(tnative.NativeHNSWBuilder, "add_batch",
                        lambda self, v, l, n_threads=0, _add=add: _add(self, v, l, n_threads=1))
    # shards of 100 rows pad to 128, the one of 150 to 256
    small, large = tier_bytes(128, 2 * M, D), tier_bytes(256, 2 * M, D)
    budget = small["unified"]
    assert large["unified8"] > budget >= large["unified4"]
    t = _small_shards([150] + [100] * (S - 1))
    assert t.rebuild_device_tables(budget) == "unified4"
    assert [(sh._device.tier, sh._device.graph.n_pad) for sh in t._shards] == (
        [("unified4", 256)] + [("unified4", 128)] * (S - 1))
    small_alone = t._shards[1]
    small_alone._forced_tier = None
    assert small_alone.rebuild_device_tables(budget).tier == "unified"

    # every shard grows past its 128 rows: the largest n_pad moves to 256
    t = _small_shards([100] * S)
    assert t.rebuild_device_tables(budget) == "unified"
    rng = np.random.default_rng(6)
    extra = rng.normal(size=(29 * S, D)).astype(np.float32)
    t.add_items(extra, np.arange(50_000, 50_000 + len(extra)))
    d, lab = t.search(extra[:8], k=1, ef=EF)
    assert t.last_sync_mode == "full" and (lab[:, 0] == np.arange(50_000, 50_008)).all()
    assert {(sh._device.tier, sh._device.graph.n_pad) for sh in t._shards} == {("unified4", 256)}

    # no budget: UNIFIED_FREE_SHARE of the card over its S shards
    monkeypatch.setattr(port_sharding, "free_share", lambda dev: S * budget)
    t = _small_shards([150] + [100] * (S - 1))
    t.search(extra[:8], k=1, ef=EF)
    assert t._tier == "unified4" and t.last_sync_mode == "full"


def test_build_matches_jax():
    """`build`: round-robin ownership and shard i seeded seed + i give JAX's
    label maps and shard graphs (whose answers the cases above hold). 60
    rows a shard: the native builder inserts fewer than 64 rows serially, so
    the threaded build is deterministic."""
    rng = np.random.default_rng(11)
    n = 60 * S
    x = rng.normal(size=(n, D)).astype(np.float32)
    labels = 5000 + 3 * np.arange(n)[::-1]
    t = _port(inline_neighbors=False)
    t.build(x, labels)
    j = _jax_index()
    j.build(x, labels)
    assert t._label_map == j._label_map and t.num_elements == j.num_elements == n
    for i, (a, b) in enumerate(zip(t._shard_labels, j._shard_labels)):
        np.testing.assert_array_equal(a, labels[i::S])
        np.testing.assert_array_equal(a, b)
        tg, jg = t._shards[i].graph, j._builders[i].export_graph()
        assert tg.entry_point == jg.entry_point and tg.max_level == jg.max_level
        for f in ("level0", "upper", "upper_slot", "node_level"):
            np.testing.assert_array_equal(getattr(tg, f), getattr(jg, f))
        np.testing.assert_array_equal(t._shards[i]._builder.export_vectors(),
                                      j._builders[i].export_vectors())


def test_absent_label_raises_keyerror(shared):
    t = shared["t"]
    for fn in (t.mark_deleted, t.unmark_deleted):
        with pytest.raises(KeyError):
            fn(ABSENT)
    assert t.num_elements == shared["j"].num_elements == N


def test_jax_saved_set_loads_into_the_port(shared, tmp_path):
    """The JAX package's save() loads here (the fixture loads the port's
    save() into JAX) and answers as both fixture indexes do."""
    prefix = str(tmp_path / "jax_set")
    shared["j"].save(prefix)
    with open(prefix + ".meta.json") as f, open(shared["prefix"] + ".meta.json") as g:
        assert json.load(f) == json.load(g)
    t = _port(inline_neighbors=False)
    t.load(prefix)
    _assert_same(_search(t, shared["q"], {}),
                 _jax(shared, "descent", lambda: _search(shared["j"], shared["q"], {})))
    with pytest.raises(ValueError, match="shards"):
        ShardedHNSWIndex("l2", D, num_shards=4, device="cpu").load(prefix)


def test_default_device_is_the_card():
    """Shards open on the card, shard i on cuda:i % device_count(), and the
    index raises without one; the CPU only on request."""
    if torch.cuda.is_available():
        idx = ShardedHNSWIndex("l2", D, num_shards=3)
        n = torch.cuda.device_count()
        assert idx.devices == [torch.device("cuda", i % n) for i in range(3)]
    else:
        with pytest.raises(RuntimeError, match="device='cuda'"):
            ShardedHNSWIndex("l2", D, num_shards=3)
    assert _port().devices == [torch.device("cpu")] * S


def test_sharding_imports_no_jax():
    subprocess.run(
        [sys.executable, "-c",
         "import sys; from hnsw_tpu_torch.parallel.sharding import ShardedHNSWIndex; "
         "assert not [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
         "or m == 'hnsw_tpu' or m.startswith('hnsw_tpu.')], 'jax or hnsw_tpu imported'"],
        check=True, cwd=REPO, timeout=120,
    )
