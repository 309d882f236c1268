"""Port parity, the vector store and the RSS helpers: a store written by
the JAX package's VectorStore opens in the port's and the other way round
(put, get, batch_get, bulk iteration over ids, last write wins), both over
the reference's unchanged vecstore.cpp; the port's library is built in its
own build directory.

Light by design: no threads, no sockets, a few hundred vectors."""

import os

import numpy as np
import pytest

from hnsw_tpu.native.vecstore import VectorStore as JStore

from hnsw_tpu_torch.buildutil import BUILD_DIR
from hnsw_tpu_torch.native.vecstore import VectorStore as TStore
from hnsw_tpu_torch.native.vecstore import load_vecstore_lib
from hnsw_tpu_torch.utils.rss import apply_mem_cap, current_rss_kb, release_host_memory

D = 24


def _fill(store, rng):
    """Puts one at a time, a batch, and an overwrite; returns what a reader
    must see."""
    want = {}
    x = rng.normal(size=(300, D)).astype(np.float32)
    for i in range(100):
        store.put(i * 7, x[i])
        want[i * 7] = x[i]
    ids = np.arange(100, 300, dtype=np.uint32) * 7 + 3
    store.put_batch(ids, x[100:])
    want.update(zip(ids.tolist(), x[100:]))
    store.put(14, x[299])  # last write wins
    want[14] = x[299]
    store.flush()
    return want


def _check(store, want):
    assert store.count == len(want)
    assert sorted(store.ids().tolist()) == sorted(want)
    for vid in (0, 14, 693, 703, 2096):
        np.testing.assert_array_equal(store.get(vid), want[vid])
    assert store.get(5) is None
    # bulk iteration, as the storage service's /vec/bulk reads the store
    ids = store.ids()
    vecs, found = store.batch_get(ids, D)
    assert found.all()
    np.testing.assert_array_equal(vecs, np.stack([want[int(i)] for i in ids]))
    vecs, found = store.batch_get(np.array([14, 5]), D)
    assert found.tolist() == [True, False] and not vecs[1].any()


@pytest.mark.parametrize("writer,reader", [(JStore, TStore), (TStore, JStore),
                                           (TStore, TStore)])
def test_store_written_by_one_reads_in_the_other(writer, reader, tmp_path):
    path = str(tmp_path / "vec.log")
    w = writer(path)
    want = _fill(w, np.random.default_rng(5))
    w.close()
    r = reader(path)
    _check(r, want)
    r.close()


def test_vecstore_library_builds_into_the_port(tmp_path):
    lib = load_vecstore_lib()
    assert os.path.dirname(lib._name) == BUILD_DIR
    assert os.path.basename(lib._name) == "libvecstore.so"
    with pytest.raises(IOError):
        TStore(str(tmp_path / "missing" / "vec.log"))


def test_rss_helpers():
    assert current_rss_kb() > 0
    assert apply_mem_cap(0) is False
    release_host_memory()
    assert current_rss_kb() > 0
