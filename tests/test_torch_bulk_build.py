"""Port parity, the device-wave bulk build: hnsw_tpu_torch's neighbor
selection, one wave's device step and whole builds against the JAX
package's on the same data (JAX on the split tier, its Pallas hop kernel in
interpret mode), plus the port's own recursive upper phase, checkpoint
resume, seeded waves and inserts after a build. Builds are at N <= 2000.

The JAX bulk_build picks `inline_neighbors` by its backend (off on the CPU):
the tests wrap HNSWIndex.__init__ at run time to turn it on, so its waves
take the split tier as they do on the chip. Nothing in hnsw_tpu changes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import hnsw_tpu.models.bulk_build as jbb
import hnsw_tpu.models.hnsw as jhnsw
from hnsw_tpu.ops.traversal import search_batch as j_search

import hnsw_tpu_torch.models.bulk_build as tbb
import hnsw_tpu_torch.models.hnsw as thnsw
from hnsw_tpu_torch.convert import index_from_parts
from hnsw_tpu_torch.core.graph import check_integrity, round_up
from hnsw_tpu_torch.core.spaces import L2Space
from hnsw_tpu_torch.models.bruteforce import BruteforceIndex
from hnsw_tpu_torch.models.hnsw import HNSWIndex
from hnsw_tpu_torch.native.hnsw_builder import NativeHNSWBuilder
from hnsw_tpu_torch.ops.gather_kernels import tier_bytes

D = 24


def _data(n, seed=0, d=D):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _recall(got, gt):
    k = gt.shape[1]
    return np.mean([len(set(got[i]) & set(gt[i])) / k for i in range(len(gt))])


def _oracle_gt(x, q, k=10):
    o = BruteforceIndex(L2Space(x.shape[1]), device="cpu")
    o.add_items(x, np.arange(len(x)))
    return o.search_knn(q, k)[1]


def _graph_arrays(g):
    return {"level0": g.level0, "upper": g.upper, "upper_slot": g.upper_slot,
            "node_level": g.node_level, "labels": g.labels,
            "entry": np.array([g.entry_point, g.max_level])}


# ---------------------------------------------------------------------------
# (e) the neighbor-selection heuristic.
# ---------------------------------------------------------------------------


def _select_case(space, seed, n=500, w=48, c=24, ties=False):
    """Candidate lists as a wave's search returns them: ascending by
    distance, some invalid (sentinel ids, inf distances). With `ties`, the
    vectors come from a tiny integer grid, so distances tie everywhere."""
    rng = np.random.default_rng(seed)
    if ties:
        x = rng.integers(-1, 2, size=(n, 6)).astype(np.float32)
    else:
        x = rng.normal(size=(n, D)).astype(np.float32)
    q = x[rng.integers(0, n, w)] + (0 if ties else 0.1) * rng.normal(
        size=(w, x.shape[1])).astype(np.float32)
    ids = np.stack([rng.choice(n, c, replace=False) for _ in range(w)]).astype(np.int32)
    if space == "l2":
        d = ((x[ids] - q[:, None, :]) ** 2).sum(-1)
    else:
        d = 1.0 - np.einsum("wcd,wd->wc", x[ids], q)
    d = d.astype(np.float32)
    order = np.argsort(d, axis=1, kind="stable")
    ids, d = np.take_along_axis(ids, order, 1), np.take_along_axis(d, order, 1)
    tail = rng.integers(c // 2, c + 1, w)  # rows with an invalid tail
    invalid = np.arange(c)[None, :] >= tail[:, None]
    ids = np.where(invalid, n + 7, ids).astype(np.int32)
    d = np.where(invalid, np.inf, d).astype(np.float32)
    x_pad = np.concatenate([x, np.zeros((8, x.shape[1]), np.float32)])
    return x_pad, ids, d, n


@pytest.mark.parametrize("space,m,ties", [
    ("l2", 8, False), ("ip", 8, False), ("l2", 4, True), ("l2", 16, False), ("ip", 4, True),
])
def test_select_neighbors_device_matches_jax_and_host(space, m, ties):
    x, ids, d, n = _select_case(space, seed=m + ties, ties=ties)
    got = tbb.select_neighbors_device(
        torch.from_numpy(x), torch.from_numpy(ids), torch.from_numpy(d), n, m, space
    )
    assert got.dtype == torch.int32 and got.shape == (len(ids), m)
    want = jbb.select_neighbors_device(
        jnp.asarray(x), jnp.asarray(ids), jnp.asarray(d), jnp.asarray(n, jnp.int32), m, space
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    host = tbb.select_neighbors_host(x, ids, d, n, m, space)
    np.testing.assert_array_equal(got.numpy(), host)
    np.testing.assert_array_equal(host, jbb.select_neighbors_host(x, ids, d, n, m, space))
    kept = (got.numpy() >= 0).sum(1)
    assert kept.min() >= 1 and kept.max() <= m
    if m == 4:  # the cap at m is reached
        assert kept.max() == m


# ---------------------------------------------------------------------------
# (f) one wave's device step on a shared snapshot.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def snapshot():
    """A half-built index: 500 nodes linked, 150 registered and unlinked
    (what a wave sees), synced on the split tier in both packages."""
    x = _data(650, seed=3)
    t = HNSWIndex("l2", dim=D, m=8, ef_construction=48, device="cpu")
    j = jhnsw.HNSWIndex("l2", dim=D, m=8, ef_construction=48, inline_neighbors=True)
    for idx in (t, j):
        idx.unified_max_bytes = 0
        idx._builder.add_batch(x[:500], np.arange(500), n_threads=1)
        idx._builder.register_level0_batch(x[500:], np.arange(500, 650))
        idx._dirty = True
    st, jdev = t._sync_device(), j._sync_device()
    assert st.tier == "split" == jdev[5][0]
    return {"x": x, "t": t, "st": st, "jdev": jdev}


def _port_step(s, q, **kw):
    return tbb.wave_device_step(
        s["st"], torch.from_numpy(q), m=8, ef_construction=48, k_sel=32, space="l2", **kw
    ).numpy()


def test_wave_step_matches_jax(snapshot):
    q = snapshot["x"][500:564]
    timings = {}
    got = _port_step(snapshot, q, timings=timings)
    assert set(timings) == {"search_s", "select_s"}
    # the JAX wave's device step (bulk_build.wave_link: search_step, then
    # select_step), on its own synced state
    dg, x, sq, _, _, nbr_vec = snapshot["jdev"]
    res = j_search(x, dg, jnp.asarray(q), k=32, ef=48, space="l2", sq_norms=sq,
                   **jhnsw.inline_search_kwargs(nbr_vec), expand=2, interpret=True)
    want = jbb.select_neighbors_device(x, res.ids, res.dists, dg.num_nodes, 8, "l2")
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got < 500).all() and ((got >= 0).sum(1) >= 1).all()  # linked nodes only


def test_wave_step_ignores_rows_riding_along(snapshot):
    """A tail wave runs at its own size here, where the JAX package pads it
    with zero queries to a compiled shape: a row's selection does not depend
    on what else is in the batch."""
    q = snapshot["x"][564:600]
    alone = _port_step(snapshot, q)
    padded = _port_step(snapshot, np.concatenate([q, np.zeros((28, D), np.float32)]))
    np.testing.assert_array_equal(alone, padded[: len(q)])
    # landmark-seeded entry (the upper-level nodes) and the frontier stop
    seeded = _port_step(snapshot, q, entry_seeds=4, stop_frontier=1.15)
    assert seeded.shape == alone.shape and (seeded < 500).all()
    assert np.mean(seeded[:, 0] == alone[:, 0]) >= 0.9  # the same nearest neighbor


# ---------------------------------------------------------------------------
# (g) whole builds.
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_waves_on_split(monkeypatch):
    """Turn inline_neighbors on in every JAX HNSWIndex made from here on
    (bulk_build's default is the backend's: off on the CPU) and record the
    sync mode of each of its syncs."""
    modes = []
    init, sync = jhnsw.HNSWIndex.__init__, jhnsw.HNSWIndex._sync_device

    def init_inline(self, *a, **kw):
        init(self, *a, **kw)
        self.inline_neighbors = True

    def sync_recorded(self):
        out = sync(self)
        modes.append((out[5][0] if out[5] else None, self._last_sync_mode))
        return out

    monkeypatch.setattr(jhnsw.HNSWIndex, "__init__", init_inline)
    monkeypatch.setattr(jhnsw.HNSWIndex, "_sync_device", sync_recorded)
    return modes


def test_bulk_build_matches_jax(jax_waves_on_split):
    x = _data(600, seed=0)
    kw = dict(m=8, ef_construction=48, first_wave=128)
    t = tbb.bulk_build(x, device="cpu", **kw)
    j = jbb.bulk_build(x, **kw)
    log = t.wave_log
    assert [w["cnt"] for w in log] == [128, 256, 151]
    # the same tier and the same full/delta decisions, wave by wave: the
    # 256-wave dirties more than n_pad // 2 rows, so the last sync is full
    assert [(w["tier"], w["sync_mode"]) for w in log] == jax_waves_on_split
    assert [w["sync_mode"] for w in log] == ["full", "delta", "full"]
    assert log[2]["sync_refusal"] == "more than n_pad // 2 dirty rows"
    assert all(w["hop_dist_inline"] == 0 for w in log)  # CPU: no launches
    # the serving configuration is back
    assert (t.unified_max_bytes, t.split_max_bytes, t.upper_inline, t.inline_neighbors,
            t.growth_headroom) == (None, None, True, True, 1 / 16)
    gt_, gj = t.graph, j.graph
    # equal levels and upper phase: the hierarchy is built on the host, by
    # the same engine, before the waves
    for key in ("upper", "upper_slot", "node_level", "labels", "entry"):
        np.testing.assert_array_equal(_graph_arrays(gt_)[key], _graph_arrays(gj)[key],
                                      err_msg=key)
    check_integrity(gt_, require_inbound=False)
    q = x[:64] + 0.01 * _data(64, seed=1)
    gt = _oracle_gt(x, q)
    _, lab = t.search(q, k=10, ef=100)
    assert t._device.tier == "unified"
    assert _recall(lab, gt) >= 0.95
    # the wave steps giving equal selections, the level-0 links come out
    # equal too. Should a near-tie fall the other way in one framework's
    # sums, every later wave differs: the graphs are then held to serve the
    # same recall
    if not np.array_equal(gt_.level0, gj.level0):
        meta = {"space": "l2", "dim": D, "m": 8, "ef_construction": 48}
        jt = index_from_parts(gj, j._builder.export_vectors(), None, meta, device="cpu")
        differ = np.flatnonzero((gt_.level0 != gj.level0).any(1))
        print(f"graphs diverge from node {differ[0]} on ({len(differ)} rows differ)")
        assert abs(_recall(lab, gt) - _recall(jt.search(q, k=10, ef=100)[1], gt)) <= 0.02


def test_bulk_build_recall_and_incremental_after():
    x = _data(2000, seed=4)
    q = x[:64] + 0.01 * _data(64, seed=5)
    gt = _oracle_gt(x, q)
    bulk = tbb.bulk_build(x, m=8, ef_construction=64, first_wave=256, device="cpu")
    assert bulk.num_elements == 2000
    counts = [w["cnt"] for w in bulk.wave_log]
    assert counts[:2] == [256, 512] and sum(counts) == int((bulk.graph.node_level == 0).sum())
    check_integrity(bulk.graph, require_inbound=False)
    _, l_bulk = bulk.search(q, k=10, ef=100)
    host = HNSWIndex("l2", dim=D, m=8, ef_construction=64, device="cpu")
    host._builder.add_batch(x, np.arange(2000), n_threads=1)
    _, l_host = host.search(q, k=10, ef=100)
    r_bulk, r_host = _recall(l_bulk, gt), _recall(l_host, gt)
    assert r_bulk >= r_host - 0.02 and r_bulk >= 0.9, (r_bulk, r_host)
    # the host engine is fully populated: inserts afterwards sync as deltas
    extra = _data(50, seed=6)
    bulk._builder.add_batch(extra, np.arange(5000, 5050), n_threads=1)
    bulk._dirty = True
    d, lab = bulk.search(extra[:8], k=1, ef=64)
    assert bulk._last_sync_mode == "delta" and bulk.num_elements == 2050
    np.testing.assert_array_equal(lab[:, 0], np.arange(5000, 5008))
    bulk.mark_deleted(5000)
    assert 5000 not in bulk.search(extra[:1], k=5, ef=64)[1]


def test_bulk_build_recursive_upper():
    """upper_recurse_min=50: the upper hierarchy is itself bulk-built (with
    its own recursion below it) and grafted in."""
    x = _data(2000, seed=7)
    q = x[:64] + 0.01 * _data(64, seed=8)
    gt = _oracle_gt(x, q)
    kw = dict(m=8, ef_construction=64, first_wave=256, device="cpu")
    rec = tbb.bulk_build(x, upper_recurse_min=50, **kw)
    host = tbb.bulk_build(x, **kw)
    g = rec.graph
    assert rec.num_elements == 2000 and g.max_level >= 2 and g.upper.shape[2] == 8
    np.testing.assert_array_equal(g.node_level, host.graph.node_level)
    np.testing.assert_array_equal(np.sort(g.labels), np.arange(2000))
    check_integrity(g, require_inbound=False)
    r_rec = _recall(rec.search(q, k=10, ef=100)[1], gt)
    r_host = _recall(host.search(q, k=10, ef=100)[1], gt)
    assert r_rec >= r_host - 0.02 and r_rec >= 0.9, (r_rec, r_host)


def test_bulk_build_checkpoint_resume(tmp_path, monkeypatch):
    """Kill the build in its third wave, resume from the checkpoint: the
    finished graph equals a straight-through build's."""
    x = _data(1500, seed=9)
    kw = dict(m=8, ef_construction=48, first_wave=256, device="cpu")
    ck = str(tmp_path / "b")
    calls = {"n": 0}
    orig = NativeHNSWBuilder.connect_batch

    def dying_connect(self, ids, sel):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("simulated process death")
        return orig(self, ids, sel)

    monkeypatch.setattr(NativeHNSWBuilder, "connect_batch", dying_connect)
    with pytest.raises(RuntimeError, match="simulated"):
        tbb.bulk_build(x, checkpoint=ck, checkpoint_every_s=0.0, **kw)
    monkeypatch.setattr(NativeHNSWBuilder, "connect_batch", orig)

    resumed = tbb.bulk_build(x, checkpoint=ck, checkpoint_every_s=0.0, **kw)
    straight = tbb.bulk_build(x, **kw)
    assert 0 < len(resumed.wave_log) < len(straight.wave_log)  # it did resume
    for key, a in _graph_arrays(resumed.graph).items():
        np.testing.assert_array_equal(a, _graph_arrays(straight.graph)[key], err_msg=key)
    np.testing.assert_array_equal(resumed._builder.export_vectors(),
                                  straight._builder.export_vectors())
    # a checkpoint of other data at the same path is not resumed
    other = tbb.bulk_build(_data(1500, seed=10), checkpoint=ck, **kw)
    assert len(other.wave_log) == len(straight.wave_log)
    assert tbb._data_fingerprint(x) == jbb._data_fingerprint(x) != tbb._data_fingerprint(x[:-1])


def test_bulk_build_seeded_waves_and_wide_m(monkeypatch):
    x = _data(1200, seed=11)
    q = x[:64] + 0.01 * _data(64, seed=12)
    gt = _oracle_gt(x, q)
    seeded = tbb.bulk_build(x, m=8, ef_construction=64, first_wave=256, device="cpu",
                            wave_stop_frontier=1.15, wave_entry_seeds=4, wave_seed_pool=64)
    check_integrity(seeded.graph, require_inbound=False)
    assert _recall(seeded.search(q, k=10, ef=100)[1], gt) >= 0.9
    # M=32: m0 = 64 is past the JAX kernel's id tile; here the waves run the
    # split tier all the same
    wide = tbb.bulk_build(x, m=32, ef_construction=64, first_wave=512, device="cpu")
    assert [w["tier"] for w in wide.wave_log] == ["split", "split"]
    assert wide.inline_neighbors and wide.unified_max_bytes is None
    # a build whose waves fit no rung raises at its first wave's sync and
    # leaves the serving configuration as it was
    monkeypatch.setattr(HNSWIndex, "_split_budget", lambda self: 0)
    monkeypatch.setattr(HNSWIndex, "_unified_budget", lambda self: 0)
    with pytest.raises(MemoryError, match="no tier fits"):
        tbb.bulk_build(x[:300], m=8, ef_construction=32, device="cpu")
    monkeypatch.undo()
    check_integrity(wide.graph, require_inbound=False)
    _, lab = wide.search(q, k=10, ef=100)
    assert wide._device.tier == "unified" and _recall(lab, gt) >= 0.9


def test_bulk_build_past_the_split_budget_waves_on_int8(jax_waves_on_split, monkeypatch):
    """Both packages' SPLIT_MAX_BYTES below the split table and
    UNIFIED_MAX_BYTES at the int8 table's size (each package's own count):
    the waves fall to the int8 unified tier, without the upper descent
    tables, and sync by row deltas; the port takes JAX's tier and sync
    sequence, and the two graphs serve recall within 0.02."""
    x = _data(600, seed=0)
    n_pad, m0 = round_up(600 + 1, 128), 16
    monkeypatch.setattr(thnsw, "SPLIT_MAX_BYTES", 0)
    monkeypatch.setattr(thnsw, "UNIFIED_MAX_BYTES", tier_bytes(n_pad, m0, D)["unified8"])
    monkeypatch.setattr(jhnsw, "SPLIT_MAX_BYTES", 0)
    # the JAX ladder's int8 count (its lane width 128, scales in the block)
    monkeypatch.setattr(jhnsw, "UNIFIED_MAX_BYTES",
                        n_pad * ((m0 * 128 // 512 + 1) * 512 + 128 + 4))
    kw = dict(m=8, ef_construction=48, first_wave=128)
    t = tbb.bulk_build(x, device="cpu", **kw)
    j = jbb.bulk_build(x, **kw)
    log = t.wave_log
    assert [(w["tier"], w["sync_mode"]) for w in log] == jax_waves_on_split
    assert [w["tier"] for w in log] == ["unified8"] * 3
    assert [w["sync_mode"] for w in log] == ["full", "delta", "full"]
    assert (t.unified_max_bytes, t.split_max_bytes, t.upper_inline) == (None, None, True)
    check_integrity(t.graph, require_inbound=False)
    q = x[:64] + 0.01 * _data(64, seed=1)
    gt = _oracle_gt(x, q)
    meta = {"space": "l2", "dim": D, "m": 8, "ef_construction": 48}
    jt = index_from_parts(j.graph, j._builder.export_vectors(), None, meta, device="cpu")
    r_t, r_j = (_recall(idx.search(q, k=10, ef=100)[1], gt) for idx in (t, jt))
    assert t._device.tier == "unified8"  # the constant still holds the serving budget
    assert r_t >= 0.9 and abs(r_t - r_j) <= 0.02, (r_t, r_j)


def test_bulk_build_recursive_upper_u8(jax_waves_on_split):
    """l2u8 with the recursive upper phase (upper_recurse_min=50), against the
    JAX package (the reference's tests/test_u8_space.py regression): the sub-
    build is handed the already shifted data and must not shift it again.
    Both give the same levels and the same tiers and syncs; served on the
    lossless int8 tier the port's distances equal the int64 ones, and the
    two graphs serve tie-aware recall within 0.02."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, size=(1200, 32)).astype(np.uint8)
    q = rng.integers(0, 256, size=(16, 32)).astype(np.uint8)
    kw = dict(space="l2u8", m=8, ef_construction=64, first_wave=256, upper_recurse_min=50)
    t = tbb.bulk_build(x, device="cpu", **kw)
    j = jbb.bulk_build(x, **kw)
    assert t.space.persist_name == "l2u8" and t.space.exact_i8 and t.num_elements == 1200
    g = t.graph
    assert g.max_level >= 2
    np.testing.assert_array_equal(g.node_level, j.graph.node_level)
    np.testing.assert_array_equal(np.sort(g.labels), np.arange(1200))
    check_integrity(g, require_inbound=False)
    # the main build's waves (JAX's list also holds its sub-builds' syncs)
    modes = [(w["tier"], w["sync_mode"]) for w in t.wave_log]
    assert modes == jax_waves_on_split[-len(modes):]
    xi, qi = x.astype(np.int64), q.astype(np.int64)
    exact = ((qi[:, None, :] - xi[None, :, :]) ** 2).sum(-1)
    kth = np.sort(exact, axis=1)[:, 9]
    meta = {"space": "l2u8", "dim": 32, "m": 8, "ef_construction": 64}
    jt = index_from_parts(j.graph, j._builder.export_vectors(), None, meta, device="cpu")
    recalls = []
    for idx in (t, jt):
        n_pad = round_up(1200 + 1 + 1200 // 16, 128)
        idx.unified_max_bytes = tier_bytes(n_pad, 16, 32)["unified8"]
        d, lab = idx.search(q, k=10, ef=200)
        assert idx._device.tier == "unified8" and (lab >= 0).all()
        got = np.take_along_axis(exact, lab, axis=1)
        np.testing.assert_array_equal(d.astype(np.float64), got.astype(np.float64))
        recalls.append(float(np.mean(got <= kth[:, None])))
    assert recalls[0] >= 0.9 and abs(recalls[0] - recalls[1]) <= 0.02, recalls
