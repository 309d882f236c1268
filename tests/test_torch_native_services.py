"""The native C++ service frontends built by the port: the reference's
storage_main.cpp and query_main.cpp, compiled by path with
hnsw_tpu_torch.native.build_binary into hnsw_tpu_torch/_build/, serving an
.adj that the port exported; the port's search_cpu on the same graph is the
reference. The C++ programs are the reference's own, unchanged: their
endpoints, /info, connection handling and start-up retry are tested in
tests/test_native_services.py, so this file tests only what the port adds,
the build and a search round trip over a graph the port exported.

Every test here starts processes and opens sockets, so all are `slow`."""

import json
import os
import socket
import struct
import subprocess
import time
import urllib.request

import numpy as np
import pytest

from hnsw_tpu_torch.buildutil import BUILD_DIR
from hnsw_tpu_torch.models.hnsw import HNSWIndex
from hnsw_tpu_torch.native import build_binary
from hnsw_tpu_torch.native.hnsw_builder import NativeHNSWBuilder

pytestmark = pytest.mark.slow

N, DIM = 300, 16


def _serial_index(x, m, efc) -> HNSWIndex:
    """An index over `x` (labels 0..n-1) built on one thread."""
    b = NativeHNSWBuilder(DIM, "l2", m, efc, seed=123)
    b.add_batch(x, np.arange(len(x)), n_threads=1)
    meta = {"space": "l2", "dim": DIM, "m": m, "ef_construction": efc}
    return HNSWIndex._from_parts(b.export_graph(), b.export_vectors(),
                                 b.export_deleted(), meta, device="cpu")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_ready(port, proc, timeout=90):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if proc.poll() is not None:
            raise RuntimeError(f"service died rc={proc.returncode}")
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/mem", timeout=2) as r:
                r.read()
            return
        except OSError:
            time.sleep(0.2)
    raise TimeoutError("service not ready")


def _post(url, body, timeout=30):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def _put_batch(port, x):
    rec = np.zeros(len(x), dtype=[("id", "<u4"), ("vec", "<f4", (DIM,))])
    rec["id"] = np.arange(len(x))
    rec["vec"] = x
    return _post(f"http://127.0.0.1:{port}/vec/put_batch",
                 struct.pack("<II", len(x), DIM) + rec.tobytes())


def _start(args):
    return subprocess.Popen(args, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def _stop(procs):
    for p in procs:
        p.terminate()
    for p in procs:
        p.wait(timeout=10)


@pytest.fixture(scope="module")
def native_stack(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("native_svc")
    x = np.random.default_rng(3).normal(size=(N, DIM)).astype(np.float32)
    idx = _serial_index(x, 8, 100)
    adj = str(tmp / "index.adj")
    idx.export_adj(adj)

    storage_bin, query_bin = build_binary("storage_main"), build_binary("query_main")
    procs = []
    try:
        s_port = _free_port()
        procs.append(_start([storage_bin, str(tmp / "store.log"), str(s_port)]))
        _wait_ready(s_port, procs[-1])
        assert _put_batch(s_port, x) == (200, b"OK")
        ports = {}
        for mode, flag in (("normal", "0"), ("optimized", "1")):
            ports[mode] = _free_port()
            procs.append(_start([
                query_bin, "--graph", adj, "--storage", f"http://127.0.0.1:{s_port}",
                "--port", str(ports[mode]), "--dim", str(DIM), "--ef", "100",
                "--optimized", flag, "--mem_cap_mb", "2048"]))
            _wait_ready(ports[mode], procs[-1])
        yield x, idx, s_port, ports
    finally:
        _stop(procs)


def test_build_binary_writes_into_the_port_build_dir():
    ref_dir = os.path.join(os.path.dirname(BUILD_DIR), os.pardir, "hnsw_tpu", "native")
    before = sorted(os.listdir(ref_dir))
    for name in ("storage_main", "query_main"):
        path = build_binary(name)
        assert path == os.path.join(BUILD_DIR, f"bin_{name}") and os.access(path, os.X_OK)
        assert build_binary(name) == path  # fresh: no rebuild
    assert sorted(os.listdir(ref_dir)) == before


@pytest.mark.parametrize("mode", ["normal", "optimized"])
def test_native_query_search_matches_search_cpu(native_stack, mode):
    """Both modes return the port's search_cpu ids on the exported graph
    (searchKnn semantics over the .adj)."""
    x, idx, _, ports = native_stack
    _, l_ref, _ = idx.search_cpu(x[:8], 5, 100)
    for i in range(8):
        body = json.dumps({"query": x[i].tolist(), "k": 5, "ef": 100}).encode()
        code, resp = _post(f"http://127.0.0.1:{ports[mode]}/search", body)
        assert code == 200
        j = json.loads(resp)
        got = [r["id"] for r in j["results"]]
        assert got[0] == i, (mode, i, got)
        assert set(got) == set(l_ref[i][: len(got)].tolist())
        assert j["rss_kb"] > 0
        assert j.get("mode") == ("optimized" if mode == "optimized" else None)
