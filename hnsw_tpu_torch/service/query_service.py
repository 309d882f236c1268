"""Query service: HTTP JSON search API over the card-resident index (port of
hnsw_tpu/service/query_service.py; the wire format is the same byte for
byte).

Endpoint parity with the reference hnsw_service (hnsw_service/main.cpp):

  POST /search  {"query": [floats], "k": int, "ef": int, "entry_id": int?}
                -> {"results": [{"id", "distance"}...], "rss_kb", "mode"}
  GET  /info    -> {"nodes", "dim", "ef", "mode", ("storage")}
  GET  /mem     -> {"rss_kb"}            (main.cpp:149-153)

plus /search_batch {"queries": [[...]...], ...} for bulk clients.

Two modes, like the reference (main.cpp:51-147):
- normal: loads a full native checkpoint (vectors + graph) and serves from
  device memory.
- optimized (storage/compute split): loads only the adjacency file
  (reference .adj format) and fetches the vectors from the storage service
  in ONE bulk transfer at startup, uploaded once to the card, not one HTTP
  GET per visited node per query (the reference's dominant cost,
  hnsw_graph.cpp:174-212). Host RSS stays low: the vectors live on the card.

The engine runs on the card (`--device cuda`, the default) unless the
caller asks for the CPU; without CUDA a `cuda` engine raises, it never
serves from the CPU instead. On the card it serves from the tier ladder's
tables (the unified bf16, int8 or int4 node blocks, else the split table)
through the hand-written hop and rescore kernels; on the CPU through plain
row gathers, as the JAX engine does off the TPU.

Concurrent single-query requests are coalesced by a micro-batcher into one
device call (the reference handles them one pointer-chase at a time).

Speed knobs (flags, reported by /info): `--stop_frontier` /
`--stop_patience` enable the adaptive-termination speed mode, `--max_iters`
caps the lockstep hop budget (batch time = slowest query), `--rescore M`
re-ranks the top M candidates exactly (default: auto, 4k on the lossy int8
and int4 tiers), and `--auto_speed P` tunes frontier + budget at startup
from a hop-distribution probe at percentile P (e.g. 99).

`--modes '{"speed": {"stop_frontier": 1.15, "max_iters": 14,
"entry_seeds": 4, "ef": 160}, "quality": {}}'` registers named SearchParams
variants, and a request routes with `"mode": "speed"` — per-request
quality-vs-speed in one process, the analog of the reference's per-request
ef/k overrides (hnsw_service/main.cpp:63-64,118-120). A mode's "ef" pins
its serve beam width; without it the request's ef applies. The flat flags
define the "default" mode. A mode is a set of parameters, not a compiled
program: warming builds the CUDA kernels once and runs each mode once.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import NamedTuple

import numpy as np
import torch

from hnsw_tpu_torch.utils.rss import current_rss_kb


class _Launch(NamedTuple):
    """A search in flight: the results' copies to pinned host memory, and
    the CUDA event recorded after them (None on the CPU)."""

    dists: torch.Tensor  # [B, k] f32, host
    ids: torch.Tensor  # [B, k] int32, host
    b0: int
    event: torch.cuda.Event | None


class _Engine:
    """Device-resident search state shared by both modes."""

    #: knobs a named mode may override. "ef" pins the mode's serve beam
    #: width (None = the request's ef): the headline speed mode narrows to
    #: ef=160 under seeded entry, a property of the MODE, not of the
    #: client's request.
    MODE_KEYS = ("stop_frontier", "stop_patience", "rescore", "max_iters",
                 "entry_seeds", "seed_pool", "ef", "frontier_rank")

    def __init__(self, vectors, graph, space, default_ef, default_k, mode,
                 storage=None, deleted=None, stop_frontier=0.0,
                 stop_patience=0, rescore=None, max_iters=0,
                 auto_speed=0.0, entry_seeds=0, seed_pool=0, modes=None,
                 hbm_trim=False, device="cuda", tables=None):
        """`vectors`: [N, D] internal-order vectors, a numpy array or a
        tensor (already on the card in the optimized mode). `tables`: build
        the tier ladder's tables; None builds them on the card only (the
        JAX engine's rule, with the card in the TPU's place)."""
        from hnsw_tpu_torch.core.graph import graph_device_arrays, round_up
        from hnsw_tpu_torch.core.spaces import get_space
        from hnsw_tpu_torch.models.bruteforce import resolve_device

        self.device = resolve_device(device)
        dim = int(vectors.shape[1])
        # `space` arrives as the checkpoint's persist name (l2 | l2u8 | ip |
        # cosine); the descriptor gives the kernels their dispatch name and
        # incoming queries the space's preprocessing (stored vectors are
        # already preprocessed at build time)
        self.space_obj = get_space(space, dim)
        self.space = self.space_obj.name
        self.persist_space = space
        self.mode = mode
        self.storage = storage
        self.default_ef = default_ef
        self.default_k = default_k
        self.stop_frontier = float(stop_frontier)
        self.stop_patience = int(stop_patience)
        self.rescore = rescore  # None = auto (4k on the lossy tiers)
        # lockstep hop budget: the batch traverses in lockstep, so batch
        # time = the slowest query's iterations (0 = uncapped)
        self.max_iters = int(max_iters)
        self.num_nodes = graph.num_nodes
        self.dim = dim
        n_pad = round_up(graph.num_nodes + 1, 128)
        self.dg = graph_device_arrays(graph, n_pad, device=self.device)
        # --hbm_trim (the N=4M serve residency configuration): a bf16 vector
        # table, read by the rescore and the seed matmul, and no per-level
        # upper descent tables
        self.hbm_trim = bool(hbm_trim)
        dtype = torch.bfloat16 if self.hbm_trim else torch.float32
        self.x = torch.zeros((n_pad, dim), dtype=dtype, device=self.device)
        self.x[: graph.num_nodes] = torch.as_tensor(vectors).to(self.device, dtype)
        x32 = self.x.float()
        self.sq = (x32 * x32).sum(-1) if self.space_obj.needs_sq_norms else None
        del x32
        self.inline = None  # InlineTables of the tier served, or None
        if tables is None:
            tables = self.device.type == "cuda"
        if tables:
            self.inline = self._build_tables()
        self.labels_np = self.dg.labels.cpu().numpy()
        # markDelete semantics (hnswalg.h:853-900): delete-marked elements
        # are never returned
        self.eligible = None
        self._elig_host = None  # host copy, base for per-request filters
        if deleted is not None and np.any(deleted):
            elig = np.ones(n_pad, dtype=bool)
            elig[: len(deleted)] = ~np.asarray(deleted, dtype=bool)
            self._elig_host = elig
            self.eligible = torch.from_numpy(elig).to(self.device)
        # landmark-seeded entry: one matmul over the upper-level nodes
        # replaces the greedy descent
        self.entry_seeds = int(entry_seeds)
        self.seed_pool = int(seed_pool)
        self._lm_cache: dict = {}  # pool_extra -> landmark arrays (or None)
        if auto_speed:
            self._calibrate(float(auto_speed))
        # named mode menu: "default" = the flat knobs above (post-
        # calibration); each extra mode overrides a subset of MODE_KEYS,
        # routed per request via "mode"
        base = {k: getattr(self, k, None) for k in self.MODE_KEYS}
        self.modes = {"default": base}
        for name, over in (modes or {}).items():
            bad = set(over) - set(self.MODE_KEYS)
            if bad:
                raise ValueError(
                    f"mode {name!r}: unknown keys {sorted(bad)} "
                    f"(allowed: {list(self.MODE_KEYS)})"
                )
            self.modes[name] = {**base, **over}

    def _build_tables(self):
        """The same tier ladder as HNSWIndex's sync (bf16 unified, int8,
        int4, split), under the module budgets of models.hnsw (None: a share
        of the card's free memory). The service never mutates, so the
        quantized tiers' delta side tables are dropped."""
        from hnsw_tpu_torch.models import hnsw
        from hnsw_tpu_torch.ops.gather_kernels import build_inline_tables

        def budget(cap):
            return cap if cap is not None else hnsw.free_share(self.device)

        return build_inline_tables(
            self.x, self.dg, self.dim, budget(hnsw.UNIFIED_MAX_BYTES),
            budget(hnsw.SPLIT_MAX_BYTES), upper_inline=not self.hbm_trim,
            exact_i8=self.space_obj.exact_i8, keep_delta_tables=False,
        )

    @property
    def tier(self) -> str | None:
        return self.inline.tier if self.inline is not None else None

    def _table_kwargs(self) -> dict:
        """search_batch's table arguments for the tier served."""
        t = self.inline
        if t is None:
            return {}
        if t.tier == "split":
            return {"nbr_vectors": t.table}
        return {"unified_table": t.table, "upper_tables": t.upper_tables or None}

    def _landmarks(self, pool_extra: int):
        """Landmark arrays for the seeded entry, cached per pool size
        (modes with different seed_pool need different pools)."""
        pool_extra = int(pool_extra)
        if pool_extra not in self._lm_cache:
            from hnsw_tpu_torch.models.hnsw import landmark_arrays

            self._lm_cache[pool_extra] = landmark_arrays(
                self.dg, self.x, self.sq, pool_extra=pool_extra
            )
        return self._lm_cache[pool_extra]

    def warm_modes(self, batch: int = 16):
        """Build the CUDA kernels and run every registered mode once at
        startup, so no request pays for a compile or a first launch."""
        if self.device.type == "cuda":
            from hnsw_tpu_torch.ops.cuda_lib import load_kernels

            load_kernels()
        q = np.zeros((batch, self.dim), dtype=np.float32)
        for name in self.modes:
            self.search(q, self.default_k, self.default_ef, mode=name)

    def _calibrate(self, percentile, frontier=1.15, sample=2048, margin=2):
        """Startup auto-tune of the speed mode (the service twin of
        HNSWIndex.calibrate_speed_mode): probe a frontier-stopped search on
        perturbed stored vectors — the reference's self-query methodology,
        bin/experiment.py:160-234 — and cap the lockstep hop budget at the
        `percentile` tail of the LAST-IMPROVEMENT distribution + `margin`.
        Leaves an explicit --max_iters untouched."""
        from hnsw_tpu_torch.ops.traversal import search_batch

        if not self.stop_frontier:
            self.stop_frontier = frontier
        rng = np.random.default_rng(0)
        b = min(sample, self.num_nodes)
        b = max((b // 16) * 16, 16)
        rows = torch.from_numpy(
            rng.integers(0, self.num_nodes, size=b).astype(np.int64)
        ).to(self.device)
        q = self.x[rows].float() + 0.05 * torch.from_numpy(
            rng.standard_normal((b, self.dim)).astype(np.float32)
        ).to(self.device)
        ef = max(self.default_ef, self.default_k)
        res = search_batch(
            self.x, self.dg, q, k=self.default_k, ef=ef, space=self.space,
            sq_norms=self.sq, **self._table_kwargs(), expand=2,
            eligible=self.eligible, stop_frontier=self.stop_frontier,
            collect_metrics=True, **self._seed_kwargs(q, self.default_k, ef),
        )
        last = res.last_improve.cpu().numpy()
        cap = int(np.percentile(last, percentile)) + int(margin)
        default_cap = 2 * ef + 16
        if not self.max_iters and cap < default_cap:
            self.max_iters = cap

    def _seed_kwargs(self, q, k, ef, entry_seeds=None, seed_pool=None):
        """seed_ids/seed_dists for the landmark-seeded entry mode (empty
        dict when off or no landmarks)."""
        entry_seeds = self.entry_seeds if entry_seeds is None else int(entry_seeds)
        seed_pool = self.seed_pool if seed_pool is None else int(seed_pool)
        if entry_seeds <= 0:
            return {}
        lm = self._landmarks(seed_pool)
        if lm is None:
            return {}
        from hnsw_tpu_torch.ops.topk import bruteforce_topk

        lv, li, lsq = lm
        s = min(entry_seeds, int(li.shape[0]), max(ef, k))
        sd, si = bruteforce_topk(q, lv, s, self.space, x_sq_norms=lsq)
        return {"seed_ids": li[si], "seed_dists": sd}

    def search(self, queries: np.ndarray, k: int, ef: int, entry_ids=None,
               mode: str | None = None, filters=None):
        return self.search_resolve(
            self.search_launch(queries, k, ef, entry_ids, mode, filters)
        )

    def _eligible_for(self, filters, b0):
        """Eligibility for a batch: the shared deleted-mark mask when no
        request carries a filter, or a dense per-query [b0, n_pad] mask
        (per-request label allowlists, the per-query BaseFilterFunctor path)
        when any does. Requests with and without filters coexist in one
        micro-batch."""
        if filters is None or not any(f is not None for f in filters):
            return self.eligible
        n_pad = self.dg.n_pad
        base = np.ones(n_pad, dtype=bool) if self._elig_host is None else self._elig_host
        mask = np.empty((b0, n_pad), dtype=bool)
        mask[:] = base[None, :]
        for i, allow in enumerate(filters):
            if allow is None:
                continue
            row = np.isin(self.labels_np, np.asarray(allow, dtype=np.int64))
            mask[i] = row & base
        return torch.from_numpy(mask).to(self.device)

    def search_launch(self, queries: np.ndarray, k: int, ef: int,
                      entry_ids=None, mode: str | None = None,
                      filters=None) -> _Launch:
        """Run the device search and start the copy of its results to the
        host WITHOUT waiting for it: returns a handle for search_resolve.
        The micro-batcher resolves batch N-1 while batch N runs."""
        from hnsw_tpu_torch.models.hnsw import _rescore_topk, auto_rescore
        from hnsw_tpu_torch.ops.traversal import search_batch

        cfg = self.modes[mode or "default"]
        if cfg.get("ef"):
            ef = int(cfg["ef"])
        b0 = queries.shape[0]
        q = torch.from_numpy(
            np.ascontiguousarray(self.space_obj.preprocess(queries))
        ).to(self.device)
        ent = None
        if entry_ids is not None:
            ent = torch.from_numpy(
                np.asarray(entry_ids, dtype=np.int32).reshape(b0)
            ).to(self.device)
        # exact re-rank of the top candidates (auto on the lossy tiers, the
        # same policy as HNSWIndex.search); the search must RETURN m_res
        # candidates for the rescore to have anything to re-rank
        m_res = cfg["rescore"]
        if m_res is None:
            m_res = auto_rescore(self.tier, self.space_obj.exact_i8, k)
        m_res = min(int(m_res), max(ef, k))
        k_search = max(k, m_res) if m_res >= k else k
        seed_kwargs = {} if ent is not None else self._seed_kwargs(
            q, k_search, max(ef, k_search),
            entry_seeds=cfg["entry_seeds"], seed_pool=cfg["seed_pool"],
        )
        stop_frontier = float(cfg["stop_frontier"] or 0.0)
        res = search_batch(
            self.x,
            self.dg,
            q,
            k=k_search,
            ef=max(ef, k_search),
            space=self.space,
            sq_norms=self.sq,
            entry_ids=ent,
            **self._table_kwargs(),
            expand=2,
            eligible=self._eligible_for(filters, b0),
            stop_frontier=stop_frontier,
            # the rank only means something under a frontier stop; the JAX
            # search ignores it without one, this one raises
            frontier_rank=int(cfg.get("frontier_rank") or 0) if stop_frontier > 0 else 0,
            stop_patience=int(cfg["stop_patience"] or 0),
            max_iters=int(cfg["max_iters"] or 0),
            **seed_kwargs,
        )
        dists, ids = res.dists, res.ids
        if m_res >= k and m_res > 0:
            dists, ids = _rescore_topk(
                q, self.x, ids, dists, k=k, m=m_res, space=self.space
            )
        if self.device.type != "cuda":
            return _Launch(dists, ids, b0, None)
        d_host = torch.empty(dists.shape, dtype=dists.dtype, pin_memory=True)
        i_host = torch.empty(ids.shape, dtype=ids.dtype, pin_memory=True)
        d_host.copy_(dists, non_blocking=True)
        i_host.copy_(ids, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return _Launch(d_host, i_host, b0, event)

    def search_resolve(self, handle: _Launch):
        """Wait for a search_launch handle's results → (dists, labels)."""
        if handle.event is not None:
            handle.event.synchronize()
        dists = handle.dists.numpy()[: handle.b0]
        ids = handle.ids.numpy()[: handle.b0]
        labels = np.where(
            np.isfinite(dists),
            self.labels_np[np.minimum(ids, len(self.labels_np) - 1)], -1,
        )
        return dists, labels


class _MicroBatcher:
    """Coalesce concurrent /search requests into one device call."""

    def __init__(self, engine: _Engine, window_ms: float = 2.0, max_batch: int = 256):
        self.engine = engine
        self.window = window_ms / 1000.0
        self.max_batch = max_batch
        self.lock = threading.Lock()
        self.pending: list = []  # (query, k, ef, entry, event, out, mode, filter)
        self.kick = threading.Condition(self.lock)
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def submit(self, query, k, ef, entry_id, mode=None, filter_labels=None):
        ev = threading.Event()
        out = {}
        with self.lock:
            self.pending.append(
                (query, k, ef, entry_id, ev, out, mode, filter_labels)
            )
            self.kick.notify()
        ev.wait()
        if "error" in out:
            raise RuntimeError(out["error"])
        return out["dists"], out["labels"]

    @staticmethod
    def _bucket(k: int, ef: int) -> tuple[int, int]:
        """Quantize (k, ef) up to a power-of-two ladder: clients asking for
        different ef coalesce into ONE device call, computed at the bucket
        ef >= every request's ef (a quality floor, never a cut). The bucket
        sets the beam width, so it decides the results: kept as the JAX
        engine has it."""
        kb = 1 << (max(k, 1) - 1).bit_length()
        efb = 1 << (max(ef, kb, 1) - 1).bit_length()
        return kb, efb

    def _run(self):
        # 1-deep pipeline: launch batch N's device call, THEN resolve batch
        # N-1's results while N's copy is in flight. `inflight` holds
        # (items, handle) pairs launched but not yet resolved.
        inflight: list = []
        while True:
            with self.lock:
                # resolve any inflight work BEFORE sleeping for new
                # requests: the last batch's waiters must not hang on the
                # arrival of a next one
                while not self.pending and not inflight:
                    self.kick.wait()
                batch = []
                if self.pending:
                    # collect for the window on the condition variable (no
                    # spin-poll): each arrival notifies, the deadline
                    # bounds it
                    deadline = time.time() + self.window
                    while len(self.pending) < self.max_batch:
                        left = deadline - time.time()
                        if left <= 0:
                            break
                        self.kick.wait(timeout=left)
                    batch = self.pending[: self.max_batch]
                    self.pending = self.pending[self.max_batch :]
            # group by the (k, ef) BUCKET + mode
            groups: dict = {}
            for item in batch:
                key = self._bucket(item[1], item[2]) + (item[6],)
                groups.setdefault(key, []).append(item)
            launched: list = []
            for (k, ef, mode), items in groups.items():
                q = np.stack([it[0] for it in items])
                ents = [it[3] for it in items]
                ent = (
                    np.asarray([e if e is not None else -1 for e in ents], np.int32)
                    if any(e is not None for e in ents)
                    else None
                )
                if ent is not None:
                    # rows without an override start at the graph's entry
                    ent = np.where(ent < 0, int(self.engine.dg.entry_point), ent)
                filts = [it[7] for it in items]
                if not any(f is not None for f in filts):
                    filts = None
                try:
                    h = self.engine.search_launch(
                        q, k, ef, ent, mode=mode, filters=filts
                    )
                except Exception as exc:  # launch-time errors surface now
                    for it in items:
                        it[5]["error"] = str(exc)
                        it[4].set()
                    continue
                launched.append((items, h))
            # resolve the PREVIOUS launches while the new ones execute
            for items, h in inflight:
                try:
                    d, l = self.engine.search_resolve(h)
                    for i, it in enumerate(items):
                        # slice back to the request's own k (bucket k >= it)
                        it[5]["dists"] = d[i][: it[1]]
                        it[5]["labels"] = l[i][: it[1]]
                except Exception as exc:  # surface errors to all waiters
                    for it in items:
                        it[5]["error"] = str(exc)
                for it in items:
                    it[4].set()
            inflight = launched


def _fetch_bulk_vectors(storage: str, dim: int, retries: int = 3):
    """One bulk transfer from the storage service → (ids, vecs), parsed
    STREAMING into a preallocated buffer: buffering the whole body and then
    copying it out doubles transient host RSS, the metric the optimized mode
    exists to keep low (reference RSS methodology, bin/experiment.py:
    237-290).

    Retries with linear backoff like the reference's per-vector fetch
    (hnsw_graph.cpp:184-209, retry x3), so a storage service that is still
    coming up or briefly restarting does not kill the query service."""
    import struct

    rec_size = 4 + 4 * dim
    for attempt in range(retries):
        try:
            with urllib.request.urlopen(
                f"{storage}/vec/bulk?dim={dim}", timeout=300
            ) as r:
                head = r.read(8)
                count, d = struct.unpack("<II", head)
                if d != dim:
                    raise ValueError(f"the store holds dim {d}, not {dim}")
                buf = np.empty(count * rec_size, dtype=np.uint8)
                got = 0
                total = count * rec_size
                while got < total:
                    chunk = r.read(min(1 << 22, total - got))
                    if not chunk:
                        raise IOError("short bulk body")
                    buf[got : got + len(chunk)] = np.frombuffer(
                        chunk, dtype=np.uint8
                    )
                    got += len(chunk)
            rec = buf.view([("id", "<u4"), ("vec", "<f4", (dim,))])
            return rec["id"].astype(np.int64), rec["vec"]
        except Exception:
            if attempt == retries - 1:
                raise
            time.sleep(1.0 * (attempt + 1))


def build_engine(
    graph_file: str,
    optimized: bool,
    storage: str,
    dim: int,
    ef: int,
    k: int,
    stop_frontier: float = 0.0,
    stop_patience: int = 0,
    rescore: int | None = None,
    max_iters: int = 0,
    auto_speed: float = 0.0,
    entry_seeds: int = 0,
    seed_pool: int = 0,
    modes: dict | None = None,
    hbm_trim: bool = False,
    device: str = "cuda",
    tables: bool | None = None,
) -> _Engine:
    from hnsw_tpu_torch.models.bruteforce import resolve_device

    dev = resolve_device(device)  # fail before any loading without CUDA
    speed = dict(
        stop_frontier=stop_frontier, stop_patience=stop_patience,
        rescore=rescore, max_iters=max_iters, auto_speed=auto_speed,
        entry_seeds=entry_seeds, seed_pool=seed_pool, modes=modes,
        hbm_trim=hbm_trim, device=dev, tables=tables,
    )
    if not optimized:
        from hnsw_tpu_torch.io.checkpoint import load_checkpoint

        g, vectors, deleted, meta = load_checkpoint(graph_file)
        return _Engine(
            vectors, g, meta.get("space", "l2"), ef, k, "normal",
            deleted=deleted, **speed,
        )
    # optimized: adjacency-only + vectors from the storage service
    from hnsw_tpu_torch.io.adj import read_adj

    adj_path = graph_file if graph_file.endswith(".adj") else graph_file + ".adj"
    g = read_adj(adj_path)
    ids, vecs = _fetch_bulk_vectors(storage, dim)
    # map storage ids (= labels) onto graph internal order (vectorized)
    sort_idx = np.argsort(ids)
    pos = np.searchsorted(ids, g.labels, sorter=sort_idx)
    order = sort_idx[np.minimum(pos, len(ids) - 1)]
    if not np.array_equal(ids[order], g.labels):
        raise ValueError("storage/graph label mismatch")
    # the fetched rows go to the card as they are and are put in the
    # graph's order there: no second copy of them on the host
    rows = torch.as_tensor(vecs).to(dev)
    vectors = rows[torch.from_numpy(order).to(dev)]
    del rows
    return _Engine(vectors, g, "l2", ef, k, "optimized", storage, **speed)


class QueryHandler(BaseHTTPRequestHandler):
    engine: _Engine = None
    batcher: _MicroBatcher = None
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def _json(self, code, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path.startswith("/info"):
            info = {
                "nodes": self.engine.num_nodes,
                "dim": self.engine.dim,
                "ef": self.engine.default_ef,
                "mode": self.engine.mode,
                "space": self.engine.persist_space,
            }
            if self.engine.stop_frontier or self.engine.stop_patience:
                info["stop_frontier"] = self.engine.stop_frontier
                info["stop_patience"] = self.engine.stop_patience
            if self.engine.max_iters:
                info["max_iters"] = self.engine.max_iters
            if self.engine.rescore is not None:
                info["rescore"] = self.engine.rescore
            if self.engine.storage:
                info["storage"] = self.engine.storage
            if len(self.engine.modes) > 1:
                info["modes"] = self.engine.modes
            self._json(200, info)
        elif self.path.startswith("/mem"):
            self._json(200, {"rss_kb": current_rss_kb()})
        else:
            self._json(404, {"error": "not found"})

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        try:
            j = json.loads(self.rfile.read(length))
        except ValueError:
            self._json(400, {"error": "bad json"})
            return
        try:
            if self.path == "/search":
                q = np.asarray(j["query"], dtype=np.float32)
                if q.shape != (self.engine.dim,):
                    self._json(400, {"error": f"query must have dim {self.engine.dim}"})
                    return
                k = int(j.get("k", self.engine.default_k))
                ef = int(j.get("ef", self.engine.default_ef))
                entry = j.get("entry_id")
                mode = j.get("mode")
                if mode is not None and mode not in self.engine.modes:
                    self._json(400, {
                        "error": f"unknown mode {mode!r}",
                        "modes": sorted(self.engine.modes),
                    })
                    return
                # per-request label allowlist (per-query BaseFilterFunctor):
                # requests with different filters coalesce into one batch
                filt = j.get("filter")
                if filt is not None:
                    filt = np.asarray(filt, dtype=np.int64)
                d, l = self.batcher.submit(q, k, ef, entry, mode, filt)
                results = [
                    {"id": int(l[i]), "distance": float(d[i])}
                    for i in range(len(l))
                    if l[i] >= 0
                ]
                resp = {"results": results, "rss_kb": current_rss_kb()}
                if self.engine.mode == "optimized":
                    resp["mode"] = "optimized"
                self._json(200, resp)
            elif self.path == "/search_batch":
                q = np.asarray(j["queries"], dtype=np.float32)
                k = int(j.get("k", self.engine.default_k))
                ef = int(j.get("ef", self.engine.default_ef))
                mode = j.get("mode")
                if mode is not None and mode not in self.engine.modes:
                    self._json(400, {
                        "error": f"unknown mode {mode!r}",
                        "modes": sorted(self.engine.modes),
                    })
                    return
                filts = j.get("filters")
                if filts is not None:
                    filts = [
                        None if f is None else np.asarray(f, dtype=np.int64)
                        for f in filts
                    ]
                d, l = self.engine.search(q, k, ef, mode=mode, filters=filts)
                self._json(
                    200,
                    {
                        "results": [
                            [
                                {"id": int(l[b, i]), "distance": float(d[b, i])}
                                for i in range(l.shape[1])
                                if l[b, i] >= 0
                            ]
                            for b in range(l.shape[0])
                        ],
                        "rss_kb": current_rss_kb(),
                    },
                )
            else:
                self._json(404, {"error": "not found"})
        except Exception as exc:
            self._json(500, {"error": str(exc)})


def serve(engine: _Engine, port: int = 8080):
    QueryHandler.engine = engine
    QueryHandler.batcher = _MicroBatcher(engine)
    httpd = ThreadingHTTPServer(("0.0.0.0", port), QueryHandler)
    print(f"hnsw query service ({engine.mode}) listening on port {port}", flush=True)
    httpd.serve_forever()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="./hnsw_index.npz")
    ap.add_argument("--storage", default="http://127.0.0.1:8081")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--ef", type=int, default=200)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--optimized", default="0")
    ap.add_argument("--dim", type=int, default=128)
    # adaptive-termination speed mode + exact rescore (service-wide)
    ap.add_argument("--stop_frontier", type=float, default=0.0)
    ap.add_argument("--stop_patience", type=int, default=0)
    ap.add_argument("--rescore", type=int, default=None)
    ap.add_argument("--max_iters", type=int, default=0)
    # >0: percentile (e.g. 99) — auto-tune the speed mode at startup by
    # probing the frontier-stopped hop distribution on stored vectors and
    # capping the lockstep hop budget there
    ap.add_argument("--auto_speed", type=float, default=0.0)
    # >0: landmark-seeded entry — start the beam at the best S upper-level
    # nodes (one matmul) instead of the greedy descent
    ap.add_argument("--entry_seeds", type=int, default=0)
    # >0 (with --entry_seeds): add this many strided level-0 nodes to the
    # landmark pool
    ap.add_argument("--seed_pool", type=int, default=0)
    # named per-request mode menu, e.g.
    # '{"speed": {"stop_frontier": 1.15, "max_iters": 14, "entry_seeds": 4},
    #   "high_recall": {"entry_seeds": 8, "seed_pool": 65536}}'
    # selected per request via the JSON "mode" field; the flat flags above
    # define "default"
    ap.add_argument("--modes", type=str, default=None)
    # build the kernels and run every mode once at startup
    ap.add_argument("--warm", type=int, default=1)
    # the memory-edge serve configuration: bf16 vector table + no
    # per-level upper descent tables. Pair with --entry_seeds: seeded modes
    # never descend, so the dropped tables cost nothing.
    ap.add_argument("--hbm_trim", type=int, default=0)
    # RLIMIT_AS self-cap (reference main.cpp:19-22). Default 0 = OFF: the
    # CUDA context maps a large address space, so a blanket cap would kill
    # the engine
    ap.add_argument("--mem_cap_mb", type=int, default=0)
    # where the engine runs: cuda (default; raises without a card) or cpu
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.mem_cap_mb > 0:
        from hnsw_tpu_torch.utils.rss import apply_mem_cap

        if apply_mem_cap(args.mem_cap_mb):
            print(f"RLIMIT_AS capped at {args.mem_cap_mb} MB", flush=True)
    optimized = args.optimized in ("1", "true", "True")
    engine = build_engine(
        args.graph, optimized, args.storage, args.dim, args.ef, args.k,
        stop_frontier=args.stop_frontier, stop_patience=args.stop_patience,
        rescore=args.rescore, max_iters=args.max_iters,
        auto_speed=args.auto_speed, entry_seeds=args.entry_seeds,
        seed_pool=args.seed_pool,
        modes=json.loads(args.modes) if args.modes else None,
        hbm_trim=bool(args.hbm_trim), device=args.device,
    )
    if args.warm:
        engine.warm_modes()
    # all hot state now lives on the card; return the build-time host
    # buffers (checkpoint arrays, bulk-fetch staging) to the OS so the
    # serving RSS reflects the steady state, not the transient peak
    from hnsw_tpu_torch.utils.rss import release_host_memory

    release_host_memory()
    serve(engine, args.port)


if __name__ == "__main__":
    main()
