"""Port parity, host layer: spaces, graphs, the native builder and
checkpoints of hnsw_tpu_torch against the JAX package on the same inputs.

Light by design (one thread, serial builds at N <= 2000), so it does not
disturb the timing-sensitive tests that share the machine."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import hnsw_tpu.core.graph as jgraph
import hnsw_tpu.core.spaces as jspaces
from hnsw_tpu.models.hnsw import HNSWIndex as JIndex
from hnsw_tpu.native.hnsw_builder import NativeHNSWBuilder as JBuilder

from hnsw_tpu_torch.convert import index_from_parts
from hnsw_tpu_torch.core import graph as tgraph
from hnsw_tpu_torch.core import spaces as tspaces
from hnsw_tpu_torch.models.hnsw import HNSWIndex as TIndex
from hnsw_tpu_torch.native.hnsw_builder import NativeHNSWBuilder as TBuilder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D, M, EFC = 1500, 32, 8, 100
META = {"space": "l2", "dim": D, "m": M, "ef_construction": EFC}


def _data(seed=11):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(48, D)).astype(np.float32)
    return centers[rng.integers(0, 48, N)] + 0.5 * rng.normal(size=(N, D)).astype(
        np.float32
    )


@pytest.fixture(scope="module")
def built():
    x = _data()
    b = TBuilder(D, "l2", M, EFC, seed=123)
    b.add_batch(x, np.arange(N) + 1000, n_threads=1)
    return x, b


def _assert_graphs_equal(a, b):
    for f in ("level0", "upper", "upper_slot", "node_level", "labels"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert int(a.entry_point) == int(b.entry_point)
    assert int(a.max_level) == int(b.max_level)


def test_port_imports_no_jax():
    subprocess.run(
        [sys.executable, "-c",
         "import hnsw_tpu_torch, sys; assert 'jax' not in sys.modules"],
        check=True, cwd=REPO, timeout=120,
    )


def test_builder_serial_matches_reference(built):
    x, tb = built
    jb = JBuilder(D, "l2", M, EFC, seed=123)
    jb.add_batch(x, np.arange(N) + 1000, n_threads=1)
    _assert_graphs_equal(tb.export_graph(), jb.export_graph())
    np.testing.assert_array_equal(tb.export_vectors(), jb.export_vectors())
    dt, lt, _ = tb.search_batch(x[:32], 10, 64)
    dj, lj, _ = jb.search_batch(x[:32], 10, 64)
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_array_equal(dt, dj)


def test_check_integrity(built):
    g = built[1].export_graph()
    tgraph.check_integrity(g, require_inbound=False)
    bad = tgraph.HNSWGraph(
        g.level0.copy(), g.upper, g.upper_slot, g.node_level, g.labels,
        g.entry_point, g.max_level,
    )
    bad.level0[5, 0] = 5
    with pytest.raises(ValueError, match="self-loop"):
        tgraph.check_integrity(bad, require_inbound=False)


@pytest.mark.parametrize("n_pad", [None, 2048])
def test_device_graph_matches_jax(built, n_pad):
    g = built[1].export_graph()
    tg = tgraph.graph_device_arrays(g, n_pad)
    jg = jgraph.graph_device_arrays(g, n_pad)
    for f in ("level0", "upper", "upper_slot", "labels"):
        np.testing.assert_array_equal(
            getattr(tg, f).numpy(), np.asarray(getattr(jg, f)), err_msg=f
        )
    assert tg.entry_point == int(jg.entry_point)
    assert tg.num_nodes == int(jg.num_nodes)
    assert (tg.n_pad, tg.max_level) == (jg.n_pad, jg.max_level)
    x = built[0]
    np.testing.assert_array_equal(
        tgraph.pad_vectors(x, tg.n_pad), jgraph.pad_vectors(x, jg.n_pad)
    )


def test_spaces_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 8)).astype(np.float32)
    u8 = rng.integers(0, 256, size=(5, 8)).astype(np.uint8)
    for name in ("l2", "ip", "cosine", "l2u8"):
        ts, js = tspaces.get_space(name, 8), jspaces.get_space(name, 8)
        assert (ts.name, ts.persist_name, ts.needs_sq_norms, ts.exact_i8) == (
            js.name, js.persist_name, js.needs_sq_norms, js.exact_i8
        )
        data = u8 if name == "l2u8" else x
        np.testing.assert_array_equal(ts.preprocess(data), js.preprocess(data))
        np.testing.assert_array_equal(ts.decode(ts.preprocess(data)),
                                      js.decode(js.preprocess(data)))
    u = tspaces.get_space("l2u8", 8)
    assert type(u) is tspaces.L2SpaceU8 and u.exact_i8 and u.persist_name == "l2u8"
    np.testing.assert_array_equal(u.preprocess(u8), u8.astype(np.float32) - 128.0)
    np.testing.assert_array_equal(u.decode(u.preprocess(u8)), u8.astype(np.float32))
    np.testing.assert_array_equal(u.preprocess(u8.astype(np.float32)), u.preprocess(u8))
    for bad in (np.full((1, 8), 256.0), np.full((1, 8), -1.0)):
        with pytest.raises(ValueError, match=r"\[0, 255\]"):
            u.preprocess(bad)
        with pytest.raises(ValueError):
            jspaces.get_space("l2u8", 8).preprocess(bad)
    with pytest.raises(ValueError):
        tspaces.get_space("hamming", 8)


def _jax_index(g, vectors, deleted):
    jg = jgraph.HNSWGraph(
        g.level0, g.upper, g.upper_slot, g.node_level, g.labels,
        g.entry_point, g.max_level,
    )
    return JIndex._from_parts(jg, vectors, deleted, dict(META))


def test_checkpoint_jax_to_port(built, tmp_path):
    g, v = built[1].export_graph(), built[1].export_vectors()
    deleted = np.zeros(N, np.uint8)
    deleted[7] = 1
    path = str(tmp_path / "jax.npz")
    _jax_index(g, v, deleted).save(path)
    t = TIndex.load(path, device="cpu")
    _assert_graphs_equal(t.graph, g)
    np.testing.assert_array_equal(t._builder.export_vectors(), v)
    np.testing.assert_array_equal(t._builder.export_deleted(), deleted)
    np.testing.assert_array_equal(t.get_items([1003]), v[3:4])
    assert (t.m, t.ef_construction, t.space.persist_name) == (M, EFC, "l2")


def test_checkpoint_port_to_jax(built, tmp_path):
    g, v = built[1].export_graph(), built[1].export_vectors()
    t = index_from_parts(g, v, None, dict(META), device="cpu")
    t.mark_deleted(1009)
    path = str(tmp_path / "port.npz")
    t.save(path)
    j = JIndex.load(path)
    _assert_graphs_equal(j.graph, g)
    np.testing.assert_array_equal(j._builder.export_vectors(), v)
    assert j._builder.export_deleted()[9] == 1
    assert j._builder.export_deleted().sum() == 1
