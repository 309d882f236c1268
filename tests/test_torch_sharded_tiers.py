"""Port parity, the sharded index's tier ladder and row deltas:
ShardedHNSWIndex.rebuild_device_tables, add_items, last_sync_mode and the
serve-trim knobs, held to the JAX package's ShardedHNSWIndex on the cases
of tests/test_sharded_tiers.py.

Light by design: the shard graphs are built once, serially, by the port's
builder (N=1,600 in 8 shards of 200, d=16, M=8, efC=100), saved as a
checkpoint set and loaded into both packages; the JAX side runs on
conftest's 8 virtual CPU devices. JAX searches its bf16 and quantized rungs
through Pallas in interpret mode, whose compiles take 10-20 s each on one
core, so in tier-1 the rung each budget picks is held to the kind of JAX's
stacked arrays, the searches held to JAX's run through plain gathers (kind
"off") on both sides, and the port's delta on every rung is held to its own
rebuild at the same rung; the searches on JAX's rungs are `slow`. Inserts
run on one thread: both packages' add_batch is patched to n_threads=1
(the threaded insert's graph depends on scheduling).

Budgets are per shard, in each package's own bytes: JAX counts rows of
128 lanes, the port's tables pad d to 8 (ops.gather_kernels.tier_bytes),
so the same rung takes a smaller budget here."""

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from jax.sharding import Mesh

import hnsw_tpu.native.hnsw_builder as jnative
from hnsw_tpu.ops.pallas_gather import unified_row_sublanes
from hnsw_tpu.parallel import sharding as jsh

import hnsw_tpu_torch.native.hnsw_builder as tnative
from hnsw_tpu_torch.core.spaces import L2Space
from hnsw_tpu_torch.models.hnsw import HNSWIndex
from hnsw_tpu_torch.ops.gather_kernels import tier_bytes
from hnsw_tpu_torch.parallel.sharding import ShardedHNSWIndex

S, N, D, M, EFC, B, K, EF = 8, 1600, 16, 8, 100, 16, 10, 48
N_PAD, M0 = 256, 16  # every shard of 200: round_up(200 + 1 + 12, 128)
# queries lie this far (per coordinate) from a stored vector, so their
# nearest distances stand well above the f32 norm expansion's rounding and
# 1e-5 relative applies (tests/test_torch_sharded.py)
NOISE = 0.5
N_NEW = 64
UPD_LABELS = 100 + 101 * np.arange(8)  # 8 in-place updates, one per shard
# delete-marked in the saved set: every JAX search then runs its masked
# program, one compile for the module's searches through plain gathers
DEAD = 1599


def _jax_budget(tier):
    """JAX's per-device budget between two rungs (build_sharded_arrays'
    byte counts, d padded to 128 lanes)."""
    d_pad = 128
    uni = N_PAD * unified_row_sublanes(M0, d_pad)[1] * 512
    side = N_PAD * d_pad + 4 * N_PAD
    u8 = N_PAD * (M0 * d_pad // 512 + 1) * 512 + side
    u4 = N_PAD * (M0 * d_pad // 1024 + 1) * 512 + side
    return {"unified": 1 << 40, "unified8": (u8 + uni) // 2,
            "unified4": (u4 + u8) // 2, "split": 0}[tier]


def _port_budget(tier):
    need = tier_bytes(N_PAD, M0, D)
    return {"unified": 1 << 40, "unified8": (need["unified8"] + need["unified"]) // 2,
            "unified4": (need["unified4"] + need["unified8"]) // 2, "split": 0}[tier]


def _mesh():
    return Mesh(np.array(jax.devices()), ("shard",))


def _port(prefix, **kw):
    t = ShardedHNSWIndex("l2", D, num_shards=S, m=M, ef_construction=EFC,
                         device="cpu", **kw)
    t.load(prefix)
    return t


def _jax(prefix):
    j = jsh.ShardedHNSWIndex("l2", D, mesh=_mesh(), m=M, ef_construction=EFC)
    j.load(prefix)
    return j


def _near_ties(q, x, owner, top):
    """Whether, within some shard, two of a query's nearest `top` distances
    lie within 2e-6 relative: the packages' f32 sums could order them
    differently."""
    full = ((q[:, None, :].astype(np.float64) - x[None].astype(np.float64)) ** 2).sum(-1)
    for i in range(S):
        s = np.sort(full[:, owner == i], axis=1)[:, :top]
        if not (np.diff(s, axis=1) > 2e-6 * s[:, 1:]).all():
            return True
    return False


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    rng = np.random.default_rng(1717)
    x = rng.normal(size=(N, D)).astype(np.float32)
    q = x[rng.integers(0, N, B)] + NOISE * rng.normal(size=(B, D)).astype(np.float32)
    extra = rng.normal(size=(N_NEW, D)).astype(np.float32)
    upd = rng.normal(size=(len(UPD_LABELS), D)).astype(np.float32)
    # the data after the mutation: new row j goes to shard j % S (the
    # smallest shards first, all equal), each update stays on its shard
    after = np.concatenate([x, extra])
    after[UPD_LABELS] = upd
    owner = np.arange(len(after)) % S
    assert not _near_ties(q, x, owner[:N], K + 3)
    assert not _near_ties(q, after, owner, K + 3)
    t = ShardedHNSWIndex("l2", D, num_shards=S, m=M, ef_construction=EFC, device="cpu")
    t._shards = []
    for i in range(S):
        shard = HNSWIndex("l2", dim=D, m=M, ef_construction=EFC, seed=123 + i,
                          device="cpu")
        shard._builder.add_batch(x[i::S], np.arange(i, N, S), n_threads=1)
        t._shards.append(shard)
    t._reindex_labels()
    t.mark_deleted(DEAD)
    prefix = str(tmp_path_factory.mktemp("sharded_tiers") / "set")
    t.save(prefix)
    return {"x": x, "q": q, "extra": extra, "upd": upd, "prefix": prefix}


@pytest.fixture
def serial(monkeypatch):
    """Both packages' inserts on one thread."""
    for mod in (jnative, tnative):
        add = mod.NativeHNSWBuilder.add_batch
        monkeypatch.setattr(
            mod.NativeHNSWBuilder, "add_batch",
            lambda self, v, l, n_threads=0, _add=add: _add(self, v, l, n_threads=1))


def _mutate(idx, shared):
    idx.add_items(shared["extra"], np.arange(N, N + N_NEW))
    idx.add_items(shared["upd"], UPD_LABELS)


def _search(idx, q, k=K):
    return idx.search(q, k=k, ef=EF)


def _assert_same(got, want):
    """Labels exact; distances to 1e-5 relative."""
    (gd, gl), (wd, wl) = got, want
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=0)


def _recall(got, x, q):
    full = ((q[:, None, :].astype(np.float64) - x[None].astype(np.float64)) ** 2).sum(-1)
    gt = np.argsort(full, axis=1)[:, :K]
    return np.mean([len(set(got[i]) & set(gt[i])) / K for i in range(len(q))])


def _self_hits(idx, vecs, labels):
    _, lab = idx.search(vecs, k=1, ef=EF)
    return float(np.mean(lab[:, 0] == labels))


@pytest.mark.parametrize("tier", ["off", "unified", "unified8", "unified4", "split"])
def test_tier_per_budget_matches_jax(shared, tier):
    """A per-shard budget between two rungs gives every shard the rung JAX's
    stacked arrays take (test_sharded_tiers.py:60-82), and it serves."""
    j = _jax(shared["prefix"])
    shards = [(b.export_graph(), b.export_vectors()) for b in j._builders]
    arrays = jsh.build_sharded_arrays(
        shards, j.space, _mesh(), "shard", inline_neighbors=tier != "off",
        unified_max_bytes=None if tier == "off" else _jax_budget(tier),
        upper_inline=False)
    assert arrays.kind == tier
    assert arrays.level0.shape[1] == N_PAD
    t = _port(shared["prefix"], inline_neighbors=tier != "off")
    got = t.rebuild_device_tables(None if tier == "off" else _port_budget(tier))
    want = None if tier == "off" else tier
    assert got == want and t.last_sync_mode == "full"
    assert [(s._device.tier, s._device.graph.n_pad) for s in t._shards] == [(want, N_PAD)] * S
    d, lab = _search(t, shared["q"])
    assert np.isfinite(d).all() and (d[:, 1:] >= d[:, :-1]).all()
    # the floors of test_sharded_tiers.py: the quantized rungs rescore
    # shard-locally, so they are navigation-limited
    assert _recall(lab, shared["x"], shared["q"]) >= (0.93 if tier in ("unified8", "unified4") else 0.95)


@pytest.mark.parametrize("tier", ["unified", "unified8", "unified4", "split"])
def test_delta_equals_rebuild(shared, serial, tier):
    """Inserts and in-place updates sync as row deltas on every rung, are
    found at rank 1, and the delta state answers as a rebuild at the same
    rung (test_incremental_delta_per_tier, port side)."""
    q = shared["q"]
    t = _port(shared["prefix"])
    t.rebuild_device_tables(_port_budget(tier))
    _mutate(t, shared)
    assert _self_hits(t, np.concatenate([shared["extra"], shared["upd"]]),
                      np.concatenate([np.arange(N, N + N_NEW), UPD_LABELS])) >= 0.9
    assert t.last_sync_mode == "delta"
    delta = _search(t, q)
    assert t.rebuild_device_tables() == tier
    _assert_same(_search(t, q), delta)


def test_delta_and_delete_match_jax(shared, serial):
    """The same inserts and updates in both packages: the same routing and
    label maps, a delta on both, the same answers; then a delete after the
    delta (test_delete_after_delta)."""
    q = shared["q"]
    t = _port(shared["prefix"], inline_neighbors=False)
    j = _jax(shared["prefix"])
    for idx in (t, j):
        _search(idx, q)
        _mutate(idx, shared)
    want = _search(j, q)
    _assert_same(_search(t, q), want)
    assert t.last_sync_mode == j.last_sync_mode == "delta"
    assert t._label_map == j._label_map and t.num_elements == j.num_elements == N + N_NEW
    for a, b in zip(t._shard_labels, j._shard_labels):
        np.testing.assert_array_equal(a, b)
    victim = int(want[1][0, 0])
    for idx in (t, j):
        idx.mark_deleted(victim)
    want = _search(j, q)
    _assert_same(_search(t, q), want)
    assert victim not in want[1]


def test_trim_takes_full_and_serves(shared, serial):
    """The serve-trim configuration (test_serve_trim_config): bf16 vectors,
    the int8 rung without its side tables, no upper tables. The squared
    norms are JAX's stack's, float64 sums over the f32 rows
    (sharding.py:237), not f32 sums over the stored bf16 values; a mutation
    takes a full sync and serves."""
    q, x = shared["q"], shared["x"]
    t = ShardedHNSWIndex("l2", D, num_shards=S, m=M, ef_construction=EFC, device="cpu")
    t.space = L2Space(D, storage_dtype=torch.bfloat16)
    t.upper_inline = False
    t.keep_delta_tables = False
    t.load(shared["prefix"])
    assert t.rebuild_device_tables(_port_budget("unified8")) == "unified8"
    for i, s in enumerate(t._shards):
        st = s._device
        assert st.vectors.dtype == torch.bfloat16
        assert st.codes is None and st.scales is None and st.upper_tables is None
        rows = x[i::S]
        want = (rows.astype(np.float64) ** 2).sum(-1).astype(np.float32)
        np.testing.assert_array_equal(st.sq_norms[: len(rows)].numpy(), want)
        stored = torch.from_numpy(rows).bfloat16().float()
        assert not np.array_equal((stored * stored).sum(-1).numpy(), want)
    assert _recall(_search(t, q)[1], x, q) >= 0.93
    t.add_items(shared["extra"][:16], np.arange(N, N + 16))
    assert _self_hits(t, shared["extra"][:16], np.arange(N, N + 16)) >= 0.9
    assert t.last_sync_mode == "full"
    assert [s._device.tier for s in t._shards] == ["unified8"] * S


def test_upper_growth_stays_delta(shared, serial):
    """Four waves of inserts that add upper-level nodes to every shard still
    sync as row deltas, and the delta state answers as a rebuild
    (test_upper_growth_stays_delta)."""
    q = shared["q"]
    t = _port(shared["prefix"])
    t.rebuild_device_tables(_port_budget("unified"))

    def uppers():
        return [int((s._device.graph.upper_slot[0] < s._device.graph.upper.shape[1] - 1).sum())
                for s in t._shards]

    before = uppers()
    rng = np.random.default_rng(11)
    base = N
    for _ in range(4):
        extra = rng.normal(size=(96, D)).astype(np.float32)
        t.add_items(extra, np.arange(base, base + 96))
        assert _self_hits(t, extra[:8], np.arange(base, base + 8)) >= 0.9
        assert t.last_sync_mode == "delta"
        base += 96
    assert sum(uppers()) > sum(before)
    delta = _search(t, q)
    t.rebuild_device_tables()
    _assert_same(_search(t, q), delta)


def test_jax_set_saved_after_add_items_loads(shared, serial, tmp_path):
    """A set JAX saves after add_items (the way a grown index crosses over)
    loads into the port, which answers as the JAX index."""
    j = _jax(shared["prefix"])
    _mutate(j, shared)
    prefix = str(tmp_path / "grown")
    j.save(prefix)
    t = _port(prefix, inline_neighbors=False)
    assert t._label_map == j._label_map
    _assert_same(_search(t, shared["q"]), _search(j, shared["q"]))


# -- JAX's own rungs (Pallas in interpret mode) ------------------------------


def _force_jax_tier(j, tier, **kw):
    shards = [(b.export_graph(), b.export_vectors()) for b in j._builders]
    j._arrays = jsh.build_sharded_arrays(
        shards, j.space, _mesh(), "shard", inline_neighbors=True,
        unified_max_bytes=_jax_budget(tier), **kw)
    for b in j._builders:
        b.clear_dirty()
    j._synced_n = [b.size for b in j._builders]
    j._pending_delta = False
    assert j._arrays.kind == tier


@pytest.mark.slow
@pytest.mark.parametrize("tier", ["unified", "split"])
def test_rung_delta_matches_jax(shared, serial, tier):
    """test_incremental_delta_per_tier on both packages: the same answers
    before and after the mutation, a delta on both."""
    q = shared["q"]
    j = _jax(shared["prefix"])
    _force_jax_tier(j, tier)
    t = _port(shared["prefix"])
    assert t.rebuild_device_tables(_port_budget(tier)) == tier
    _assert_same(_search(t, q), _search(j, q))
    for idx in (t, j):
        _mutate(idx, shared)
    _assert_same(_search(t, q), _search(j, q))
    assert t.last_sync_mode == j.last_sync_mode == "delta"


@pytest.mark.slow
def test_trim_matches_jax(shared, serial):
    """test_serve_trim_config on both packages: the int8 rung over bf16
    vectors, side and upper tables dropped; the same answers before and
    after a mutation, which syncs in full on both."""
    import jax.numpy as jnp

    from hnsw_tpu.core.spaces import L2Space as JL2Space

    q = shared["q"]
    j = jsh.ShardedHNSWIndex("l2", D, mesh=_mesh(), m=M, ef_construction=EFC)
    j.space = JL2Space(D, storage_dtype=jnp.bfloat16)
    j.upper_inline = False
    j.keep_delta_tables = False
    j.load(shared["prefix"])
    _force_jax_tier(j, "unified8", upper_inline=False, keep_delta_tables=False)
    t = ShardedHNSWIndex("l2", D, num_shards=S, m=M, ef_construction=EFC, device="cpu")
    t.space = L2Space(D, storage_dtype=torch.bfloat16)
    t.upper_inline = False
    t.keep_delta_tables = False
    t.load(shared["prefix"])
    assert t.rebuild_device_tables(_port_budget("unified8")) == "unified8"
    _assert_same(_search(t, q), _search(j, q))
    for idx in (t, j):
        idx.add_items(shared["extra"][:16], np.arange(N, N + 16))
        assert _self_hits(idx, shared["extra"][:16], np.arange(N, N + 16)) >= 0.9
    # JAX's re-stack picks its kind from its module budget again, where
    # the port keeps the index's budget: only the mode is compared
    assert t.last_sync_mode == j.last_sync_mode == "full"


@pytest.mark.slow
def test_pooled_inserts_equal_inline(shared, serial):
    """add_items inserts into the shards from a thread each when torch may
    use more than one host thread: every shard's graph, and so every
    answer, equals the inline inserts' of one thread."""
    q = shared["q"]
    graphs, answers = [], []
    for threads in (1, 4):
        torch.set_num_threads(threads)
        try:
            t = _port(shared["prefix"], inline_neighbors=False)
            _mutate(t, shared)
        finally:
            torch.set_num_threads(1)
        graphs.append([s._builder.export_graph() for s in t._shards])
        answers.append(_search(t, q))
    for a, b in zip(*graphs):
        np.testing.assert_array_equal(a.level0, b.level0)
    np.testing.assert_array_equal(answers[0][1], answers[1][1])
    np.testing.assert_array_equal(answers[0][0], answers[1][0])
