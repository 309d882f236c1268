"""Port parity, the incremental row-delta sync: the same host-engine operations
through hnsw_tpu_torch's HNSWIndex and the JAX package's, for every table
kind (off, split, unified, unified8, unified4). Both take the same
full/delta decisions, a delta state equals a from-scratch rebuild bit for
bit, and it equals JAX's delta state (level0, vectors, tables, side tables,
upper arrays, labels). The JAX side never searches here (interpret mode costs
seconds per call): it only syncs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import hnsw_tpu.models.hnsw as jhnsw
from hnsw_tpu.models.hnsw import HNSWIndex as JIndex

import hnsw_tpu_torch.models.hnsw as thnsw
from hnsw_tpu_torch.convert import (
    split_from_jax,
    unified4_from_jax_rows,
    unified8_from_jax_rows,
    unified_from_jax_rows,
)
from hnsw_tpu_torch.core.graph import check_integrity
from hnsw_tpu_torch.core.spaces import L2Space
from hnsw_tpu_torch.models.hnsw import HNSWIndex
from hnsw_tpu_torch.ops.gather_kernels import tier_bytes

N, D, M, EFC = 600, 24, 8, 60
KINDS = ["off", "split", "unified", "unified8", "unified4"]
JAX_TIER_BYTES = {  # the JAX ladder's own count (lane width 128)
    "unified8": lambda n_pad, m0: n_pad * ((m0 * 128 // 512 + 1) * 512 + 128 + 4),
    "unified4": lambda n_pad, m0: n_pad * ((m0 * 128 // 1024 + 1) * 512 + 128 + 4),
}
DECODERS = {"unified": unified_from_jax_rows, "unified8": unified8_from_jax_rows,
            "unified4": unified4_from_jax_rows}


def _data(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)


def _pair(kind, **kw):
    """A port index and a JAX index held to table kind `kind`."""
    n_pad, m0 = 768, 16  # of the N=600 graph with the default headroom
    t = HNSWIndex("l2", dim=D, m=M, ef_construction=EFC, device="cpu",
                  inline_neighbors=kind != "off", **kw)
    j = JIndex("l2", dim=D, m=M, ef_construction=EFC, inline_neighbors=kind != "off", **kw)
    if kind == "split":
        t.unified_max_bytes = j.unified_max_bytes = 0
    elif kind in JAX_TIER_BYTES:
        t.unified_max_bytes = tier_bytes(n_pad, m0, D)[kind]
        j.unified_max_bytes = JAX_TIER_BYTES[kind](n_pad, m0)
    return t, j


def _both(t, j, op):
    """Apply one host-engine operation to both indexes (serial and deterministic:
    the same C++ engine on the same calls gives the same graph)."""
    for idx in (t, j):
        op(idx)
        idx._dirty = True


def _sync_modes(t, j):
    t._sync_device()
    j._sync_device()
    return t._last_sync_mode, j._last_sync_mode


def _bits(a: torch.Tensor) -> np.ndarray:
    return a.contiguous().view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()


def _port_state(idx) -> dict:
    """Every device tensor of the port's state, as numpy (bf16 as bits)."""
    st = idx._device
    out = {"level0": st.graph.level0, "upper": st.graph.upper,
           "upper_slot": st.graph.upper_slot, "labels": st.graph.labels,
           "vectors": st.vectors}
    if st.sq_norms is not None:
        out["sq_norms"] = st.sq_norms
    if st.tier == "split":
        out["nbr_vectors"] = st.nbr_vectors
    elif st.tier is not None:
        for f in ("vecs", "codes", "scales", "payload"):
            if hasattr(st.unified, f):
                out[f"table.{f}"] = getattr(st.unified, f)
        if st.codes is not None:
            out["side.codes"], out["side.scales"] = st.codes, st.scales
        for l, (tab, ids) in enumerate(st.upper_tables or ()):
            out[f"upper{l}.vecs"], out[f"upper{l}.payload"] = tab.vecs, tab.payload
            out[f"upper{l}.ids"] = ids
    out = {k: _bits(v).copy() for k, v in out.items()}
    out["host_labels"] = st.labels.copy()
    out["scalars"] = np.array([st.graph.num_nodes, st.graph.entry_point])
    return out


def _jax_state(j, kind) -> dict:
    """The JAX state decoded into the port's layouts."""
    dg, x, sq, _, labels_np, nbr_vec = j._device
    m0 = dg.level0.shape[1]
    out = {"level0": np.asarray(dg.level0), "upper": np.asarray(dg.upper),
           "upper_slot": np.asarray(dg.upper_slot), "labels": np.asarray(dg.labels),
           "vectors": np.asarray(x), "sq_norms": np.asarray(sq),
           "host_labels": labels_np,
           "scalars": np.array([int(dg.num_nodes), int(dg.entry_point)])}
    if kind == "split":
        nbr, l0 = split_from_jax(np.asarray(nbr_vec[1].view(jnp.int16)),
                                 np.asarray(nbr_vec[2]), m0, D)
        out["nbr_vectors"] = _bits(nbr)
        np.testing.assert_array_equal(l0.numpy(), out["level0"])
    elif kind != "off":
        tab = DECODERS[kind](np.asarray(nbr_vec[1]), m0, D)
        for f in ("vecs", "codes", "scales", "payload"):
            if hasattr(tab, f):
                out[f"table.{f}"] = _bits(getattr(tab, f))
        if kind != "unified":
            out["side.codes"] = np.asarray(nbr_vec[3])[:, :D]
            out["side.scales"] = np.asarray(nbr_vec[4])
        for l, (rows, ids) in enumerate(nbr_vec[2]):
            u = unified_from_jax_rows(np.asarray(rows), 16, D)
            out[f"upper{l}.vecs"], out[f"upper{l}.payload"] = _bits(u.vecs), u.payload.numpy()
            out[f"upper{l}.ids"] = np.asarray(ids)
    return out


def _assert_states_equal(got: dict, want: dict, approx=()):
    """Equal key by key, floats bit for bit; `approx` keys to rtol 1e-6."""
    assert set(got) == set(want)
    for key in got:
        if key in approx:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)
        elif got[key].dtype == np.float32:  # bit for bit
            np.testing.assert_array_equal(got[key].view(np.int32), want[key].view(np.int32),
                                          err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _assert_equals_jax(t, j, kind, after_delta=False):
    """The port's state against JAX's. The squared norms are the same f32
    squares summed in another order by the two frameworks. After a delta the
    scales of new rows may differ in the last bit: JAX quantizes them inside
    a jitted program, where XLA divides by 127 (or 7) through a reciprocal,
    while its full sync, like the port, divides (so there JAX's own delta
    and rebuild differ too); the codes come out equal."""
    approx = ("sq_norms", "table.scales", "side.scales") if after_delta else ("sq_norms",)
    _assert_states_equal(_port_state(t), _jax_state(j, kind), approx=approx)


def _rebuilt(t) -> dict:
    """The state a from-scratch sync of the same host engine gives, at the same
    padded size (the headroom is recomputed from the larger N otherwise)."""
    n_pad = t._device.graph.n_pad
    saved = t.growth_headroom
    t.growth_headroom = (n_pad - 120 - t.num_elements) / t.num_elements
    t._device = None
    t._dirty = True
    st = t._sync_device()
    t.growth_headroom = saved
    assert t._last_sync_mode == "full" and st.graph.n_pad == n_pad
    return _port_state(t)


@pytest.mark.parametrize("kind", KINDS)
def test_sync_modes_and_delta_state_match_jax(kind, monkeypatch):
    """One scenario through both packages: build, insert, update in place,
    reuse a deleted slot under a new label, delete-mark, nothing, growth."""
    monkeypatch.setattr(thnsw, "DELTA_CHUNK", 64)  # several slices per delta
    t, j = _pair(kind, allow_replace_deleted=True)
    x = _data(N)
    _both(t, j, lambda i: i._builder.add_batch(x, np.arange(N), n_threads=1))
    assert _sync_modes(t, j) == ("full", "full")
    assert (t._device.tier or "off") == kind
    assert j._device[5] is None if kind == "off" else j._device[5][0] == kind
    _assert_equals_jax(t, j, kind)

    extra = _data(30, seed=5)
    _both(t, j, lambda i: i._builder.add_batch(extra, np.arange(N, N + 30), n_threads=1))
    assert _sync_modes(t, j) == ("delta", "delta")
    _assert_equals_jax(t, j, kind, after_delta=True)

    upd = _data(5, seed=7)
    for v, lab in zip(upd, (3, 77, 150, 410, 612)):  # in-place vector updates
        _both(t, j, lambda i: i._builder.add(v, lab))
    assert _sync_modes(t, j) == ("delta", "delta")
    _assert_equals_jax(t, j, kind, after_delta=True)

    _both(t, j, lambda i: i.mark_deleted(17))
    v_new = _data(1, seed=9)[0]
    _both(t, j, lambda i: i.add_point(v_new, 5000, replace_deleted=True))
    assert _sync_modes(t, j) == ("delta", "delta")
    assert t.num_elements == N + 30 and t.deleted_count == j.deleted_count == 0
    delta = _port_state(t)
    _assert_equals_jax(t, j, kind, after_delta=True)
    assert delta["host_labels"][17] == 5000 == delta["labels"][17]
    # the live tensors after three deltas equal a from-scratch rebuild
    d1, l1 = t.search(np.concatenate([x[20:32], extra[:3], upd, v_new[None]]), k=3, ef=40)
    assert t._last_sync_mode == "clean"
    want = np.r_[np.arange(20, 32), N, N + 1, N + 2, 3, 77, 150, 410, 612, 5000]
    assert np.mean(l1[:, 0] == want) >= 0.9  # an approximate search
    assert l1[-1, 0] == 5000 and d1[-1, 0] < 1e-3
    check_integrity(t.graph, require_inbound=False)
    _assert_states_equal(delta, _rebuilt(t))
    d2, l2 = t.search(np.concatenate([x[20:32], extra[:3], upd, v_new[None]]), k=3, ef=40)
    np.testing.assert_array_equal(l1, l2)
    np.testing.assert_array_equal(d1, d2)

    j._device = None  # as _rebuilt did for the port
    j._sync_device()
    level0_before = t._device.graph.level0
    _both(t, j, lambda i: i.mark_deleted(40))
    t._dirty = j._dirty = False  # a delete-mark alone
    assert _sync_modes(t, j) == ("deleted", "deleted")
    assert t._device.graph.level0 is level0_before and t._device.deleted[40]
    assert _sync_modes(t, j) == ("clean", "clean")
    assert t.deleted_count == j.deleted_count == 1
    assert (t.max_elements, t.index_file_size) == (j.max_elements, j.index_file_size)

    if kind in JAX_TIER_BYTES:  # the rung's budget at the size grown to
        t.unified_max_bytes = tier_bytes(896, 16, D)[kind]
        j.unified_max_bytes = JAX_TIER_BYTES[kind](896, 16)
    grow = _data(200, seed=11)  # past the padded capacity
    _both(t, j, lambda i: i._builder.add_batch(grow, np.arange(6000, 6200), n_threads=1))
    assert _sync_modes(t, j) == ("full", "full")
    assert t._last_sync_refusal == "growth past the padded capacity"
    assert t._device.graph.n_pad == 896 and (t._device.tier or "off") == kind
    _assert_equals_jax(t, j, kind)


def test_replace_deleted_requires_flag_and_appends_when_none_deleted():
    t = HNSWIndex("l2", dim=D, m=M, ef_construction=EFC, device="cpu")
    t._builder.add_batch(_data(50), np.arange(50), n_threads=1)
    with pytest.raises(ValueError, match="allow_replace_deleted"):
        t.add_point(_data(1)[0], 99, replace_deleted=True)
    t, _ = _pair("unified", allow_replace_deleted=True)
    t._builder.add_batch(_data(100), np.arange(100), n_threads=1)
    t._sync_device()
    fresh = _data(3, seed=4)
    t.add_items(fresh, np.array([200, 201, 202]), replace_deleted=True)  # serial adds
    d, lab = t.search(fresh, k=1, ef=80)
    assert t.num_elements == 103 and t._last_sync_mode == "delta"
    np.testing.assert_array_equal(lab[:, 0], [200, 201, 202])


def test_delta_at_its_own_size_leaves_the_sentinel_row_clean():
    """Deltas are applied unpadded (JAX pads them to power-of-two buckets with
    writes to the sentinel row, to spare a compile per size): a one-row delta
    gives the rebuild's state, and the sentinel row stays all-sentinel links
    and a zero vector. The slice size and the waves' budget are JAX's."""
    assert thnsw.DELTA_CHUNK == jhnsw.DELTA_CHUNK
    assert thnsw.UNIFIED_WAVE_MAX_BYTES == jhnsw.UNIFIED_WAVE_MAX_BYTES == 0
    t, _ = _pair("split")
    t._builder.add_batch(_data(N), np.arange(N), n_threads=1)
    t._sync_device()
    t._builder.add(_data(1, seed=6)[0], N)
    t._dirty = True
    st = t._sync_device()
    assert t._last_sync_mode == "delta"
    sent = st.graph.n_pad - 1
    assert (st.graph.level0[sent] == sent).all() and not st.vectors[sent].any()
    assert not st.nbr_vectors[sent].any() and st.sq_norms[sent] == 0
    _assert_states_equal(_port_state(t), _rebuilt(t))


@pytest.mark.parametrize("kind", ["split", "unified"])
def test_many_dirty_rows_resync_in_full(kind):
    """More than n_pad // 2 dirty rows: rebuilding the table is cheaper, as
    in the JAX package (a bulk-build wave on a small index)."""
    t, j = _pair(kind)
    x = _data(N)
    _both(t, j, lambda i: i._builder.add_batch(x[:300], np.arange(300), n_threads=1))
    for i in (t, j):
        i.growth_headroom = 1.5
    assert _sync_modes(t, j) == ("full", "full")
    _both(t, j, lambda i: i._builder.add_batch(x[300:], np.arange(300, N), n_threads=1))
    assert _sync_modes(t, j) == ("full", "full")
    assert t._last_sync_refusal == "more than n_pad // 2 dirty rows"
    _assert_equals_jax(t, j, kind)


@pytest.mark.parametrize("kind", ["unified8", "unified4"])
def test_dropped_side_tables_resync_in_full(kind):
    t, j = _pair(kind)
    t.keep_delta_tables = j.keep_delta_tables = False
    x = _data(N)
    _both(t, j, lambda i: i._builder.add_batch(x, np.arange(N), n_threads=1))
    assert _sync_modes(t, j) == ("full", "full")
    assert t._device.tier == kind and t._device.codes is None and t._device.scales is None
    assert j._device[5][3] is None
    _both(t, j, lambda i: i._builder.add_batch(_data(5, 3), np.arange(N, N + 5), n_threads=1))
    assert _sync_modes(t, j) == ("full", "full")
    assert "side tables dropped" in t._last_sync_refusal


@pytest.mark.parametrize("kind", ["split", "unified", "unified8", "unified4"])
def test_bf16_storage_delta_equals_rebuild(kind):
    """Under bf16 storage the port's delta takes the norms, codes and scales
    of new rows from the STORED (rounded) values, as a full sync does, so a
    delta state equals a rebuild bit for bit (the JAX delta takes them from
    the f32 input)."""
    t, _ = _pair(kind)
    t.space = L2Space(D, storage_dtype=torch.bfloat16)
    t._builder.add_batch(_data(N), np.arange(N), n_threads=1)
    t._sync_device()
    assert t._device.vectors.dtype == torch.bfloat16 and t._device.tier == kind
    t._builder.add_batch(_data(30, seed=5), np.arange(N, N + 30), n_threads=1)
    t._builder.add(_data(1, seed=8)[0], 44)
    t._dirty = True
    t._sync_device()
    assert t._last_sync_mode == "delta"
    _assert_states_equal(_port_state(t), _rebuilt(t))


def test_delta_does_not_depend_on_payload_aliasing():
    """The unified payload may or may not share level0's storage."""
    states = []
    for alias in (True, False):
        t, _ = _pair("unified")
        t._builder.add_batch(_data(N), np.arange(N), n_threads=1)
        st = t._sync_device()
        shares = st.unified.payload.data_ptr() == st.graph.level0.data_ptr()
        if not alias:
            object.__setattr__(st.unified, "payload", st.unified.payload.clone())
        elif not shares:
            object.__setattr__(st.unified, "payload", st.graph.level0)
        t._builder.add_batch(_data(30, seed=5), np.arange(N, N + 30), n_threads=1)
        t._dirty = True
        t._sync_device()
        assert t._last_sync_mode == "delta"
        states.append(_port_state(t))
    _assert_states_equal(*states)
    np.testing.assert_array_equal(states[0]["level0"], states[0]["table.payload"])


def test_delta_keeps_no_stale_landmarks_and_clear_resets():
    t, _ = _pair("unified")
    x = _data(N)

    def add(rows, labels):  # serial: a threaded build is not deterministic
        t._builder.add_batch(rows, labels, n_threads=1)
        t._dirty = True

    add(x[:500], np.arange(500))
    t.search(x[:4], k=3, ef=40, entry_seeds=4)
    assert t._landmark_cache is not None
    add(x[500:520], np.arange(500, 520))
    d, lab = t.search(x[500:504], k=1, ef=40, entry_seeds=4)
    assert t._last_sync_mode == "delta"
    np.testing.assert_array_equal(lab[:, 0], np.arange(500, 504))
    assert t._landmark_cache[0] is t._device

    t.clear()
    assert t.num_elements == 0 and t._device is None and t._landmark_cache is None
    add(x[:50], np.arange(100, 150))
    d, lab = t.search(x[:3], k=1, ef=20)
    assert t._last_sync_mode == "full"
    np.testing.assert_array_equal(lab[:, 0], [100, 101, 102])


@pytest.mark.parametrize("kind", ["split", "unified", "unified8"])
@pytest.mark.parametrize("error", ["out_of_memory", "other"])
def test_delta_failing_midway_leaves_no_half_written_state(kind, error, monkeypatch):
    """A delta that raises after writing part of its rows, with the engine's
    dirty lists already drained: out of memory, the same sync drops the
    state and runs in full; on any other error the state is dropped, the
    error reaches the caller and the next sync is full. Either way the state
    and the search results equal a fresh full sync's of the same graph."""
    monkeypatch.setattr(thnsw, "DELTA_CHUNK", 16)  # several slices
    t, _ = _pair(kind)
    x, extra = _data(N), _data(30, seed=5)
    t._builder.add_batch(x, np.arange(N), n_threads=1)
    t._sync_device()
    t._builder.add_batch(extra, np.arange(N, N + 30), n_threads=1)
    t._dirty = True
    real, calls = thnsw._apply_row_deltas, []

    def fails_in_second_slice(st, new_vecs, new_ids, dirty_ids, dirty_rows, **kw):
        calls.append(dirty_ids.shape[0])
        if len(calls) < 2:
            return real(st, new_vecs, new_ids, dirty_ids, dirty_rows, **kw)
        h = dirty_ids.shape[0] // 2  # half of this slice's rows, then the error
        real(st, new_vecs, new_ids, dirty_ids[:h], dirty_rows[:h], **kw)
        if error == "out_of_memory":
            raise torch.cuda.OutOfMemoryError("simulated: out of memory in a delta slice")
        raise RuntimeError("simulated: a delta slice failed")

    monkeypatch.setattr(thnsw, "_apply_row_deltas", fails_in_second_slice)
    q = np.concatenate([x[20:32], extra[:4]])
    if error == "out_of_memory":
        d1, l1 = t.search(q, k=3, ef=40)
        assert t._last_sync_refusal == "delta ran out of memory"
    else:
        with pytest.raises(RuntimeError, match="a delta slice failed"):
            t.search(q, k=3, ef=40)
        assert t._device is None and t._landmark_cache is None and t._dirty
        d1, l1 = t.search(q, k=3, ef=40)
    assert t._last_sync_mode == "full" and len(calls) == 2 and calls[1] > 1
    np.testing.assert_array_equal(l1[12:, 0], np.arange(N, N + 4))
    state = _port_state(t)
    _assert_states_equal(state, _rebuilt(t))
    d2, l2 = t.search(q, k=3, ef=40)
    np.testing.assert_array_equal(l1, l2)
    np.testing.assert_array_equal(d1, d2)
