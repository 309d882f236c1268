"""Storage service: HTTP vector store over the native log-structured store
(port of hnsw_tpu/service/storage_service.py; host only, it touches no
device).

Endpoint and wire-format parity with the reference storage_service
(storage_service/main.cpp:20-72):

  POST /vec/put        binary body [u32 id][u32 dim][dim x f32] -> "OK"/"ERR"
  GET  /vec/get?id=N   -> {"id": N, "values": [...]} (404 if missing)
  POST /vec/batch_get  JSON [id, ...] -> [[floats] | null, ...]

Additions over the reference (its batch endpoint exists but the search path
never used it, SURVEY.md §5):

  POST /vec/put_batch  binary [u32 count][u32 dim] + count x (u32 id + dim f32)
  GET  /vec/bulk?dim=D -> binary stream [u32 count][u32 dim] + count x
                          (u32 id + dim x f32) — feeds whole device arrays.
  GET  /mem            -> {"rss_kb": ...}
"""

from __future__ import annotations

import argparse
import json
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from hnsw_tpu_torch.native.vecstore import VectorStore
from hnsw_tpu_torch.utils.rss import apply_mem_cap, current_rss_kb


class StorageHandler(BaseHTTPRequestHandler):
    store: VectorStore = None  # set by serve()
    lock = threading.Lock()
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):  # quiet
        pass

    def _send(self, code: int, body: bytes, ctype: str = "application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, obj):
        self._send(code, json.dumps(obj).encode())

    def do_GET(self):
        url = urlparse(self.path)
        if url.path == "/vec/get":
            try:
                vec_id = int(parse_qs(url.query)["id"][0])
            except (KeyError, ValueError):
                self._send(400, b"bad id", "text/plain")
                return
            v = self.store.get(vec_id)
            if v is None:
                self._send(404, b"not found", "text/plain")
                return
            self._json(200, {"id": vec_id, "values": v.tolist()})
        elif url.path == "/vec/bulk":
            try:
                dim = int(parse_qs(url.query)["dim"][0])
            except (KeyError, ValueError):
                self._send(400, b"bad dim", "text/plain")
                return
            ids = self.store.ids()
            vecs, found = self.store.batch_get(ids, dim)
            ids, vecs = ids[found], vecs[found]
            # vectorized framing: one structured array, no per-record loop
            rec = np.zeros(
                len(ids), dtype=[("id", "<u4"), ("vec", "<f4", (dim,))]
            )
            rec["id"] = ids
            rec["vec"] = vecs
            body = struct.pack("<II", len(ids), dim) + rec.tobytes()
            self._send(200, body, "application/octet-stream")
        elif url.path == "/mem":
            self._json(200, {"rss_kb": current_rss_kb()})
        elif url.path == "/info":
            self._json(200, {"count": self.store.count})
        else:
            self._send(404, b"not found", "text/plain")

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        if self.path == "/vec/put":
            if len(body) < 8:
                self._send(400, b"short body", "text/plain")
                return
            vec_id, dim = struct.unpack_from("<II", body)
            if len(body) != 8 + dim * 4:
                self._send(400, b"bad length", "text/plain")
                return
            vec = np.frombuffer(body, dtype="<f4", offset=8)
            try:
                with self.lock:
                    self.store.put(vec_id, vec)
                    self.store.flush()
                self._send(200, b"OK", "text/plain")
            except IOError:
                self._send(200, b"ERR", "text/plain")
        elif self.path == "/vec/put_batch":
            if len(body) < 8:
                self._send(400, b"short body", "text/plain")
                return
            count, dim = struct.unpack_from("<II", body)
            rec = 4 + dim * 4
            if len(body) != 8 + count * rec:
                self._send(400, b"bad length", "text/plain")
                return
            with self.lock:
                for i in range(count):
                    off = 8 + i * rec
                    (vec_id,) = struct.unpack_from("<I", body, off)
                    vec = np.frombuffer(body, dtype="<f4", offset=off + 4, count=dim)
                    self.store.put(vec_id, vec)
                self.store.flush()
            self._send(200, b"OK", "text/plain")
        elif self.path == "/vec/batch_get":
            try:
                ids = json.loads(body)
                assert isinstance(ids, list)
            except (ValueError, AssertionError):
                self._send(400, b"bad json", "text/plain")
                return
            out = []
            for vec_id in ids:
                v = self.store.get(int(vec_id))
                out.append(None if v is None else v.tolist())
            self._json(200, out)
        else:
            self._send(404, b"not found", "text/plain")


def serve(dbpath: str = "./vec_store.log", port: int = 8081):
    StorageHandler.store = VectorStore(dbpath)
    httpd = ThreadingHTTPServer(("0.0.0.0", port), StorageHandler)
    print(f"Starting storage_service on port {port} with db {dbpath}", flush=True)
    httpd.serve_forever()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dbpath", nargs="?", default="./vec_store.log")
    ap.add_argument("port", nargs="?", type=int, default=8081)
    # RLIMIT_AS self-cap (reference main.cpp:19-22 parity); 0 = off
    ap.add_argument("--mem_cap_mb", type=int, default=0)
    args = ap.parse_args()
    if args.mem_cap_mb > 0:
        if apply_mem_cap(args.mem_cap_mb):
            print(f"RLIMIT_AS capped at {args.mem_cap_mb} MB", flush=True)
    serve(args.dbpath, args.port)


if __name__ == "__main__":
    main()
