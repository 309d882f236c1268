"""Port parity, the deployment path: hnsw_tpu_torch.service's query engine
against the JAX package's on one serial-built graph, in normal construction
(from a .npz checkpoint) and optimized construction (from an .adj plus the
vectors the storage service would send), on the CPU's plain row gathers;
the micro-batcher, the builder CLI and the package's imports.

Light by design: one thread, a serial build at N=1500, each JAX search run
once per module, and no socket, server or subprocess (the jax-free import
check aside). The HTTP round trip carries the `slow` marker. The tier
ladder's tables on both sides are in test_torch_service_tiers.py."""

import json
import os
import struct
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from hnsw_tpu.io.adj import read_adj as j_read_adj
from hnsw_tpu.io.checkpoint import load_checkpoint as j_load_checkpoint
from hnsw_tpu.service import query_service as jqs

from hnsw_tpu_torch.models.hnsw import HNSWIndex
from hnsw_tpu_torch.native.vecstore import VectorStore
from hnsw_tpu_torch.service import builder_cli
from hnsw_tpu_torch.service import query_service as tqs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D, M, EFC, B, K, EF = 1500, 24, 8, 100, 16, 10, 48
LABELS = np.arange(N, dtype=np.int64) * 3 + 7
MODES = {
    "speed": {"stop_frontier": 1.15, "max_iters": 14, "entry_seeds": 4, "ef": 40},
    # JAX ignores a rank without a frontier stop; the port's engine must too
    "rank_only": {"frontier_rank": EF},
    "rescore": {"rescore": 40, "entry_seeds": 4},
}


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("svc")
    rng = np.random.default_rng(17)
    x = rng.normal(size=(N, D)).astype(np.float32)
    q = rng.normal(size=(B, D)).astype(np.float32)
    idx = HNSWIndex("l2", dim=D, m=M, ef_construction=EFC, device="cpu")
    idx._builder.add_batch(x, LABELS, n_threads=1)
    ckpt = str(tmp / "index.npz")
    idx.save(ckpt)
    idx.export_adj(ckpt + ".adj")
    # delete each query's nearest label, so the marks show in the results
    d2 = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    dead = LABELS[np.unique(d2.argmin(1))]
    for lab in dead:
        idx.mark_deleted(int(lab))
    ckpt_del = str(tmp / "index_del.npz")
    idx.save(ckpt_del)
    # the storage service's bulk stream: every (id, vector) record, in the
    # store's order, not the graph's
    perm = rng.permutation(N)
    bulk = (LABELS[perm], x[perm])
    allow = [None if i % 3 == 0 else LABELS[rng.random(N) < 0.5] for i in range(B)]
    return {"x": x, "q": q, "ckpt": ckpt, "ckpt_del": ckpt_del, "bulk": bulk,
            "dead": dead, "allow": allow, "entry": rng.integers(0, N, B),
            "jax": {}, "port": {}}


def _fake_fetch(bulk):
    def fetch(storage, dim, retries=3):
        assert dim == D
        return bulk[0].copy(), bulk[1].copy()

    return fetch


def _engines(s, kind, monkeypatch):
    """(JAX engine, port engine) of one construction, cached per module."""
    if kind not in s["port"]:
        kw = {"modes": MODES}
        graph, optimized = s["ckpt"], False
        if kind == "deleted":
            graph = s["ckpt_del"]
        elif kind == "optimized":
            graph, optimized = s["ckpt"] + ".adj", True
            monkeypatch.setattr(jqs, "_fetch_bulk_vectors", _fake_fetch(s["bulk"]))
            monkeypatch.setattr(tqs, "_fetch_bulk_vectors", _fake_fetch(s["bulk"]))
        elif kind == "calibrated":
            kw = {"auto_speed": 99.0}
        args = (graph, optimized, "http://storage.invalid", D, EF, K)
        s["jax"][kind] = jqs.build_engine(*args, **kw)
        s["port"][kind] = tqs.build_engine(*args, device="cpu", **kw)
    return s["jax"][kind], s["port"][kind]


# (construction, mode, request keywords); the rescore case runs half the
# batch: the JAX side's Pallas gather costs seconds per query in interpret
# mode
CASES = {
    "default": ("normal", None, {}),
    "speed": ("normal", "speed", {}),
    "rank_only": ("normal", "rank_only", {}),
    "rescore": ("normal", "rescore", {"rows": 8}),
    "deleted": ("deleted", None, {}),
    "deleted_seeded": ("deleted", "speed", {}),
    "filters": ("normal", None, {"filters": True}),
    "entry_id": ("normal", None, {"entry_ids": True}),
    "optimized": ("optimized", None, {}),
    "optimized_speed": ("optimized", "speed", {}),
    "calibrated": ("calibrated", None, {}),
}


def _search(s, eng, case):
    kind, mode, kw = CASES[case]
    rows = kw.get("rows", B)
    return eng.search(
        s["q"][:rows], K, EF,
        entry_ids=s["entry"][:rows] if kw.get("entry_ids") else None,
        mode=mode, filters=s["allow"][:rows] if kw.get("filters") else None,
    )


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_jax(shared, case, monkeypatch):
    je, te = _engines(shared, CASES[case][0], monkeypatch)
    key = ("search", case)
    if key not in shared["jax"]:
        shared["jax"][key] = _search(shared, je, case)
    jd, jl = shared["jax"][key]
    td, tl = _search(shared, te, case)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=0)
    assert te.max_iters == je.max_iters and te.stop_frontier == je.stop_frontier
    if case.startswith("deleted"):
        assert not np.isin(tl, shared["dead"]).any()
    if case == "filters":
        for i, allow in enumerate(shared["allow"]):
            if allow is not None:
                assert np.isin(tl[i][tl[i] >= 0], allow).all()


def test_calibration_sets_max_iters(shared, monkeypatch):
    je, te = _engines(shared, "calibrated", monkeypatch)
    assert te.max_iters == je.max_iters > 0
    assert te.stop_frontier == je.stop_frontier == 1.15
    assert te.modes["default"] == je.modes["default"]


def test_rank_only_serves_the_default_search(shared, monkeypatch):
    _, te = _engines(shared, "normal", monkeypatch)
    d0, l0 = te.search(shared["q"], K, EF)
    d1, l1 = te.search(shared["q"], K, EF, mode="rank_only")
    np.testing.assert_array_equal(l1, l0)
    np.testing.assert_array_equal(d1, d0)


def test_mode_menu_rejects_unknown_keys():
    with pytest.raises(ValueError, match="unknown keys"):
        tqs._Engine(np.zeros((4, 2), np.float32), _tiny_graph(), "l2", 8, 2,
                    "normal", modes={"speed": {"ef": 10}, "bad": {"beam": 3}},
                    device="cpu")


def _tiny_graph():
    from hnsw_tpu_torch.core.graph import HNSWGraph

    level0 = np.array([[1, 2], [0, 3], [0, 3], [1, 2]], np.int32)
    return HNSWGraph(level0, np.zeros((0, 1, 1), np.int32), np.zeros((0, 4), np.int32),
                     np.zeros(4, np.int32), np.arange(4, dtype=np.int64), 0, 0)


def test_optimized_rejects_a_store_that_lacks_a_label(shared, monkeypatch):
    ids, vecs = shared["bulk"]
    short = (ids[ids != LABELS[5]], vecs[ids != LABELS[5]])
    monkeypatch.setattr(tqs, "_fetch_bulk_vectors", _fake_fetch(short))
    with pytest.raises(ValueError, match="label mismatch"):
        tqs.build_engine(shared["ckpt"], True, "http://storage.invalid", D, EF, K,
                         device="cpu")


def test_engine_without_cuda_raises(shared):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tqs.build_engine(shared["ckpt"], False, "", D, EF, K)


def test_bucket_matches_jax():
    for k in range(1, 70):
        for ef in range(1, 300, 7):
            assert tqs._MicroBatcher._bucket(k, ef) == jqs._MicroBatcher._bucket(k, ef)


def test_micro_batcher_equals_search_at_bucket(shared, monkeypatch):
    """64 submits from 4 threads with mixed (k, ef), modes, entry ids and
    filters: each answer is the engine's own search of that query at its
    (k, ef) bucket, cut to its k. The seeded mode's seed distances come
    from one matmul over the micro-batch, whose float sums depend on the
    batch's size, so distances are held to 1e-5 relative; labels exactly."""
    _, te = _engines(shared, "normal", monkeypatch)
    rng = np.random.default_rng(3)
    reqs = []
    for i in range(64):
        k, ef = int(rng.choice([1, 5, 10])), int(rng.choice([12, 20, 48, 60]))
        mode = ["speed", None][i % 2]
        entry = int(rng.integers(0, N)) if i % 5 == 0 else None
        filt = LABELS[rng.random(N) < 0.5] if i % 7 == 0 else None
        reqs.append((shared["q"][i % B] + 0.01 * i, k, ef, entry, mode, filt))
    mb = tqs._MicroBatcher(te)
    got = [None] * len(reqs)

    def client(part):
        for i in part:
            got[i] = mb.submit(*reqs[i])

    threads = [threading.Thread(target=client, args=(range(t, 64, 4),)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and all(g is not None for g in got)
    for i, (qv, k, ef, entry, mode, filt) in enumerate(reqs):
        kb, efb = tqs._MicroBatcher._bucket(k, ef)
        wd, wl = te.search(qv[None], kb, efb,
                           entry_ids=None if entry is None else np.array([entry]),
                           mode=mode, filters=None if filt is None else [filt])
        np.testing.assert_array_equal(got[i][1], wl[0][:k])
        np.testing.assert_allclose(got[i][0], wd[0][:k], rtol=1e-5, atol=0)


def _same_graph(a, b):
    """Equal as graphs: labels, levels, entry point and every neighbor list
    (the .adj reader pads and slots the upper levels its own way)."""
    np.testing.assert_array_equal(np.asarray(a.labels), np.asarray(b.labels))
    np.testing.assert_array_equal(np.asarray(a.node_level), np.asarray(b.node_level))
    assert int(a.entry_point) == int(b.entry_point)
    assert int(a.max_level) == int(b.max_level)
    for node in range(a.num_nodes):
        for lv in range(int(a.node_level[node]) + 1):
            np.testing.assert_array_equal(a.neighbors(node, lv), b.neighbors(node, lv))


def test_builder_cli_outputs_load_in_jax(tmp_path):
    n = 2000
    db, out = str(tmp_path / "vec.log"), str(tmp_path / "idx.npz")
    builder_cli.main([str(n), str(D), db, out, str(M), str(EFC)], n_threads=1)
    g, vecs, deleted, meta = j_load_checkpoint(out)
    assert meta["space"] == "l2" and meta["m"] == M and meta["dim"] == D
    data = np.random.default_rng(123).normal(size=(n, D)).astype(np.float32)
    np.testing.assert_array_equal(vecs, data[np.asarray(g.labels)])
    assert not deleted.any()
    _same_graph(g, j_read_adj(out + ".adj"))
    store = VectorStore(db)
    assert store.count == n
    got, found = store.batch_get(np.arange(n), D)
    assert found.all()
    np.testing.assert_array_equal(got, data)
    store.close()


def test_service_imports_no_jax():
    subprocess.run(
        [sys.executable, "-c",
         "import sys; import hnsw_tpu_torch.service.query_service, "
         "hnsw_tpu_torch.service.storage_service, "
         "hnsw_tpu_torch.service.builder_cli, hnsw_tpu_torch.io.adj, "
         "hnsw_tpu_torch.native.vecstore, hnsw_tpu_torch.utils.rss; "
         "assert not [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
         "or m == 'hnsw_tpu' or m.startswith('hnsw_tpu.')], 'jax or hnsw_tpu imported'"],
        check=True, cwd=REPO, timeout=120,
    )


# ---------------------------------------------------------------------------
# The HTTP round trip (sockets and server threads: slow marker).
# ---------------------------------------------------------------------------


def _post(url, body, ctype="application/json"):
    req = urllib.request.Request(url, data=body, method="POST")
    req.add_header("Content-Type", ctype)
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.read()


@pytest.mark.slow
def test_http_round_trip(shared, tmp_path):
    from http.server import ThreadingHTTPServer

    from hnsw_tpu_torch.service import storage_service

    x, q = shared["x"], shared["q"]
    db = str(tmp_path / "store.log")
    st = VectorStore(db)
    st.put_batch(LABELS, x)
    st.close()

    servers = []

    def start(handler):
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        servers.append(httpd)
        return f"http://127.0.0.1:{httpd.server_address[1]}"

    class Storage(storage_service.StorageHandler):
        store = VectorStore(db)

    try:
        storage = start(Storage)
        code, resp = _post(f"{storage}/vec/put",
                           struct.pack("<II", 99999, D) + x[0].tobytes(),
                           "application/octet-stream")
        assert (code, resp) == (200, b"OK")
        assert json.loads(_get(f"{storage}/vec/get?id=99999")[1])["values"] == x[0].tolist()
        body = struct.pack("<II", 1, D) + struct.pack("<I", 99998) + x[1].tobytes()
        assert _post(f"{storage}/vec/put_batch", body, "application/octet-stream")[1] == b"OK"
        out = json.loads(_post(f"{storage}/vec/batch_get",
                               json.dumps([int(LABELS[2]), 424242]).encode())[1])
        assert out[0] == x[2].tolist() and out[1] is None
        with pytest.raises(urllib.error.HTTPError):
            _get(f"{storage}/vec/get?id=424242")

        normal = tqs.build_engine(shared["ckpt"], False, storage, D, EF, K,
                                  modes=MODES, device="cpu")
        # the bulk stream holds the two extra ids too: the label mapping
        # picks the graph's rows out of it
        opt = tqs.build_engine(shared["ckpt"], True, storage, D, EF, K, device="cpu")

        def query_server(engine):
            class Handler(tqs.QueryHandler):
                pass

            Handler.engine, Handler.batcher = engine, tqs._MicroBatcher(engine)
            return start(Handler)

        urls = {"normal": query_server(normal), "optimized": query_server(opt)}
        want_d, want_l = normal.search(q, K, EF)
        for name, url in urls.items():
            info = json.loads(_get(f"{url}/info")[1])
            assert info["nodes"] == N and info["dim"] == D and info["mode"] == name
            assert json.loads(_get(f"{url}/mem")[1])["rss_kb"] > 0
            res = json.loads(_post(f"{url}/search_batch",
                                   json.dumps({"queries": q.tolist()}).encode())[1])
            assert [[r["id"] for r in row] for row in res["results"]] == want_l.tolist()
            one = json.loads(_post(f"{url}/search",
                                   json.dumps({"query": q[0].tolist()}).encode())[1])
            kb, efb = tqs._MicroBatcher._bucket(K, EF)
            bd, bl = normal.search(q[:1], kb, efb)
            assert [r["id"] for r in one["results"]] == bl[0][:K].tolist()
            assert ("mode" in one) == (name == "optimized")
        res = json.loads(_post(f"{urls['normal']}/search_batch", json.dumps(
            {"queries": q.tolist(), "mode": "rank_only"}).encode())[1])
        assert [[r["id"] for r in row] for row in res["results"]] == want_l.tolist()
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{urls['normal']}/search", json.dumps({"query": [0.0]}).encode())
        assert e.value.code == 400
    finally:
        for httpd in servers:
            httpd.shutdown()
