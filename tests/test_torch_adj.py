"""Port parity, the `.adj` adjacency format: files written by each package
(its numpy writer and its native builder's streaming writer) are byte-equal,
and read back to the same graph in both, in the l2 and cosine spaces.

Light by design: serial builds at N <= 1200, no threads, no sockets."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import hnsw_tpu.core.graph as jgraph
from hnsw_tpu.io.adj import read_adj as j_read_adj
from hnsw_tpu.io.adj import write_adj as j_write_adj
from hnsw_tpu.native.hnsw_builder import NativeHNSWBuilder as JBuilder

from hnsw_tpu_torch.core.graph import check_integrity
from hnsw_tpu_torch.core.spaces import get_space
from hnsw_tpu_torch.io.adj import read_adj, write_adj
from hnsw_tpu_torch.models.hnsw import HNSWIndex
from hnsw_tpu_torch.native.hnsw_builder import NativeHNSWBuilder as TBuilder

D, M, EFC = 16, 8, 60
FIELDS = ("level0", "upper", "upper_slot", "node_level", "labels")


def _built(space, n, seed):
    """The same serial build in both packages' builders."""
    x = get_space(space, D).preprocess(np.random.default_rng(seed).normal(size=(n, D)))
    labels = np.arange(n, dtype=np.int64) * 5 + 3_000_000_000  # past 2^31
    tb = TBuilder(D, get_space(space, D).name, M, EFC, seed=123)
    jb = JBuilder(D, get_space(space, D).name, M, EFC, seed=123)
    tb.add_batch(x, labels, n_threads=1)
    jb.add_batch(x, labels, n_threads=1)
    return tb, jb


def _same_graph(a, b):
    """Equal as graphs: labels, levels, entry point and every neighbor list
    (a graph read from an .adj pads and slots its upper levels its own
    way)."""
    np.testing.assert_array_equal(np.asarray(a.labels), np.asarray(b.labels))
    np.testing.assert_array_equal(np.asarray(a.node_level), np.asarray(b.node_level))
    assert (int(a.entry_point), int(a.max_level)) == (int(b.entry_point), int(b.max_level))
    for node in range(a.num_nodes):
        for lv in range(int(a.node_level[node]) + 1):
            np.testing.assert_array_equal(a.neighbors(node, lv), b.neighbors(node, lv))


@pytest.mark.parametrize("space,n", [("l2", 1200), ("cosine", 900), ("l2", 1)])
def test_adj_bytes_and_reads_match_jax(space, n, tmp_path):
    tb, jb = _built(space, n, seed=n)
    g = tb.export_graph()
    jg_built = jb.export_graph()
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(g, f), getattr(jg_built, f), err_msg=f)
    jg = jgraph.HNSWGraph(g.level0, g.upper, g.upper_slot, g.node_level, g.labels,
                          g.entry_point, g.max_level)
    paths = {name: str(tmp_path / f"{name}.adj")
             for name in ("port_numpy", "port_native", "jax_numpy", "jax_native")}
    write_adj(g, paths["port_numpy"])
    tb.export_adj(paths["port_native"])
    j_write_adj(jg, paths["jax_numpy"])
    jb.export_adj(paths["jax_native"])
    blobs = {name: open(p, "rb").read() for name, p in paths.items()}
    assert len(set(blobs.values())) == 1, {k: len(v) for k, v in blobs.items()}
    for p in paths.values():
        mine, theirs = read_adj(p), j_read_adj(p)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(mine, f), np.asarray(getattr(theirs, f)),
                                          err_msg=f)
        assert (mine.entry_point, mine.max_level) == (theirs.entry_point, theirs.max_level)
        _same_graph(mine, g)
        check_integrity(mine, require_inbound=False)  # pruning may orphan a node


def test_index_export_adj_reads_back(tmp_path):
    """HNSWIndex.export_adj writes what write_adj writes for its graph."""
    x = np.random.default_rng(4).normal(size=(600, D)).astype(np.float32)
    idx = HNSWIndex("l2", dim=D, m=M, ef_construction=EFC, device="cpu")
    idx._builder.add_batch(x, np.arange(600), n_threads=1)
    a, b = str(tmp_path / "a.adj"), str(tmp_path / "b.adj")
    idx.export_adj(a)
    write_adj(idx.graph, b)
    assert open(a, "rb").read() == open(b, "rb").read()
    g = read_adj(a, max_m=M)
    assert g.upper.shape[2] == M
    _same_graph(g, idx.graph)
