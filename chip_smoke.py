"""Drive the PyTorch/CUDA port (hnsw_tpu_torch) end to end on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 0  the device: name and power limit; CUDA is required (no CPU path).
Phase 1  builds the CUDA kernels from hnsw_tpu_torch/csrc and holds each
         against its plain PyTorch version on the card, at the main path's
         shapes, with times from CUDA events.
Phase 2  the main path at bench.py's operating point (N=100k clustered
         vectors, d=128, M=16, efC=200, k=10): host build, device sync, then
         (a) the seeded speed mode at batch 8192, (b) the default descent at
         ef=200 and (c) the high-recall mode with exact rescore, each gated on
         recall against the port's exact fp32 oracle, with the kernels'
         launch counts read around each mode.

Prints a {"kernels": [...]} line, the card's name and power limit, and as
its last line {"ok": true, "device": {...}}. Exits non-zero on any failure.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

N, DIM, M, EF_C, K = 100_000, 128, 16, 200, 10
BATCH = 8192
SEED = 123
EXPECTED_RECALL = 0.9945  # bench.py's operating point, for information only


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def smi_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def make_dataset(n, dim, rng, n_clusters=1024, spread=0.5):
    """bench.py's clustered gaussian mixture (copied, not imported)."""
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32)
    assign = rng.integers(0, n_clusters, size=n)
    return centers[assign] + spread * rng.normal(size=(n, dim)).astype(np.float32)


def cuda_ms(fn, reps: int = 20) -> float:
    """Device time per call of `fn`, from CUDA events. The card first spins
    for ~10 ms so that every launch is queued before the start event runs:
    the events then time the device's work, not the host's launch cost."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def timed_pair(kernel, plain) -> tuple[float, float]:
    """Kernel and plain times in turns (plain, kernel, kernel, plain)."""
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


# ---------------------------------------------------------------------------
# Phase 1: each kernel against its plain version.
# ---------------------------------------------------------------------------


def phase1(dev) -> dict:
    import torch

    from hnsw_tpu_torch.ops import gather_kernels as gk
    from hnsw_tpu_torch.ops.cuda_lib import LOG_PATH, load_kernels

    t0 = time.time()
    load_kernels()
    log(f"[phase1] kernels built and loaded in {time.time() - t0:.1f}s")
    with open(LOG_PATH) as fh:
        for line in fh:
            if "registers" in line or "spill" in line:
                log("[phase1] ptxas:", line.strip())

    rng = np.random.default_rng(7)
    out = {}

    def hop_case(b, e, m0, d, space, rows, timed):
        vecs = torch.from_numpy(
            rng.normal(size=(rows, m0, -(-d // 8) * 8)).astype(np.float32)
        ).to(dev).to(torch.bfloat16)
        vecs[:, :, d:] = 0
        table = gk.UnifiedTable(
            vecs.contiguous(),
            torch.from_numpy(rng.integers(0, 1 << 30, size=(rows, m0)).astype(np.int32)).to(dev),
        )
        q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(dev)
        chosen = torch.from_numpy(rng.integers(0, rows, size=(b, e)).astype(np.int32)).to(dev)
        dk, ik = gk.hop_dist_unified(q, table, chosen, space)
        dp, ip_ = gk.hop_dist_unified_plain(q, table, chosen, space)
        torch.cuda.synchronize()
        if not torch.equal(ik, ip_):
            fail(f"hop ids differ at B={b} E={e} m0={m0} d={d} {space}")
        if not torch.allclose(dk, dp, rtol=1e-5, atol=1e-4):
            fail(f"hop dists differ at B={b} E={e} m0={m0} d={d} {space}: "
                 f"max {float((dk - dp).abs().max())}")
        err = float((dk - dp).abs().max())
        msg = f"[phase1] hop B={b} E={e} m0={m0} d={d} {space}: ok, max_abs_err {err:.3e}"
        res = {"err": err}
        if timed:
            ms, pms = timed_pair(lambda: gk.hop_dist_unified(q, table, chosen, space),
                                 lambda: gk.hop_dist_unified_plain(q, table, chosen, space))
            gb = b * e * m0 * (table.d_pad * 2 + 4) / 1e9
            msg += (f", kernel {ms:.4f} ms ({gb / ms * 1e3:.0f} GB/s), "
                    f"plain {pms:.4f} ms")
            res.update(ms=ms, plain_ms=pms)
        log(msg)
        return res

    # 16384 node blocks of 8 KB: 134 MB, past the 50 MB L2 like the real table
    hop = [
        hop_case(1024, 2, 32, 128, "l2", 16384, True),
        hop_case(1024, 2, 32, 128, "ip", 16384, False),
        hop_case(1024, 1, 16, 128, "l2", 4096, True),
        hop_case(1024, 2, 32, 96, "l2", 16384, False),
        hop_case(8192, 2, 32, 128, "l2", 16384, True),
    ]
    out["hop"] = {"max_abs_err": max(h["err"] for h in hop),
                  "ms": hop[0]["ms"], "plain_ms": hop[0]["plain_ms"]}

    def gather_case(b, kk, d, space, rows, timed):
        table = torch.from_numpy(rng.normal(size=(rows, d)).astype(np.float32)).to(dev)
        q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(dev)
        ids = torch.from_numpy(rng.integers(0, rows, size=(b, kk)).astype(np.int32)).to(dev)
        dk = gk.gather_dist_rows(q, table, ids, space)
        dp = gk.gather_dist_rows_plain(q, table, ids, space)
        torch.cuda.synchronize()
        # the norm-expansion form cancels: atol scales with |q|^2 + |x|^2
        scale = (q * q).sum(-1, keepdim=True) + (table * table).sum(-1)[ids.long()]
        bad = (dk - dp).abs() > 1e-5 * dp.abs() + 1e-5 * scale
        if bool(bad.any()):
            fail(f"gather dists differ at B={b} K={kk} d={d} {space}")
        err = float((dk - dp).abs().max())
        msg = f"[phase1] gather B={b} K={kk} d={d} {space}: ok, max_abs_err {err:.3e}"
        res = {"err": err}
        if timed:
            ms, pms = timed_pair(lambda: gk.gather_dist_rows(q, table, ids, space),
                                 lambda: gk.gather_dist_rows_plain(q, table, ids, space))
            gb = b * kk * d * 4 / 1e9
            msg += (f", kernel {ms:.4f} ms ({gb / ms * 1e3:.0f} GB/s), "
                    f"plain {pms:.4f} ms")
            res.update(ms=ms, plain_ms=pms)
        log(msg)
        return res

    gat = [
        gather_case(1024, 40, 128, "l2", 200_000, True),
        gather_case(1024, 40, 128, "ip", 200_000, False),
    ]
    out["gather"] = {"max_abs_err": max(g["err"] for g in gat),
                     "ms": gat[0]["ms"], "plain_ms": gat[0]["plain_ms"]}
    return out


# ---------------------------------------------------------------------------
# Phase 2: the main path.
# ---------------------------------------------------------------------------


def recall(got: np.ndarray, gt: np.ndarray) -> float:
    return float(np.mean([len(set(got[i]) & set(gt[i])) / K for i in range(len(gt))]))


def phase2(dev) -> dict:
    import torch

    from hnsw_tpu_torch import BruteforceIndex, HNSWIndex, L2Space, SearchParams
    from hnsw_tpu_torch.ops.gather_kernels import COUNTS

    rng = np.random.default_rng(SEED)
    x = make_dataset(N, DIM, rng)
    q = x[rng.integers(0, N, BATCH)] + 0.05 * rng.normal(size=(BATCH, DIM)).astype(np.float32)

    t0 = time.time()
    idx = HNSWIndex("l2", dim=DIM, m=M, ef_construction=EF_C, device=dev)
    idx.add_items(x)
    log(f"[phase2] host build N={N} d={DIM} M={M} efC={EF_C}: {time.time() - t0:.1f}s")

    t0 = time.time()
    oracle = BruteforceIndex(L2Space(DIM), device=dev)
    oracle.add_items(x, np.arange(N))
    gt_d, gt = oracle.search_knn(q, K)
    log(f"[phase2] exact fp32 oracle, {BATCH} queries: {time.time() - t0:.1f}s")

    t0 = time.time()
    st = idx._sync_device()
    torch.cuda.synchronize()
    log(f"[phase2] device sync: {time.time() - t0:.1f}s, n_pad {st.graph.n_pad}, "
        f"unified table {st.unified.nbytes / 1e9:.3f} GB, "
        f"{len(st.upper_tables or ())} upper tables, max_level {st.graph.max_level}")

    launches = {"hop_dist_unified": 0, "gather_dist_rows": 0}

    def run_mode(name, qs, reps, **kw):
        idx.search(qs[:16], **kw)  # warm-up (allocator, kernel load)
        torch.cuda.synchronize()
        COUNTS.reset()
        times = []
        for _ in range(reps):
            t = time.time()
            d, lab = idx.search(qs, **kw)
            times.append(time.time() - t)
        counts = (COUNTS.hop_dist_unified, COUNTS.gather_dist_rows, COUNTS.plain_on_cuda)
        launches["hop_dist_unified"] += counts[0]
        launches["gather_dist_rows"] += counts[1]
        if counts[2]:
            fail(f"mode {name}: a plain version ran on CUDA tensors {counts[2]} times")
        if counts[0] == 0:
            fail(f"mode {name}: the hop kernel was never launched")
        if d.shape != (len(qs), K) or not np.isfinite(d).all() or (lab < 0).any():
            fail(f"mode {name}: malformed results")
        qps = len(qs) / float(np.median(times))
        return d, lab, qps, counts

    # (a) speed mode, bench.py:233-261
    pa = SearchParams(k=K, ef=160, expand=2, stop_frontier=1.15, max_iters=14, entry_seeds=4)
    _, lab_a, qps_a, c_a = run_mode("a", q, 5, params=pa)
    rec_a = recall(lab_a, gt)
    log(f"[phase2] (a) speed mode, batch {BATCH}: recall@10 {rec_a:.4f} "
        f"(delta {rec_a - EXPECTED_RECALL:+.4f} from {EXPECTED_RECALL}), "
        f"{qps_a:.0f} qps, hop launches {c_a[0]}")
    if rec_a < 0.95:
        fail(f"(a) recall {rec_a} < 0.95")

    # (b) default descent at ef=200
    _, lab_b, qps_b, c_b = run_mode("b", q[:1024], 2, k=K, ef=200)
    rec_b = recall(lab_b, gt[:1024])
    rec_b512 = recall(lab_b[:512], gt[:512])
    _, lab_cpu, _ = idx.search_cpu(q[:512], k=K, ef=200)
    rec_cpu = recall(lab_cpu, gt[:512])
    log(f"[phase2] (b) default descent ef=200, 1024 queries: recall@10 {rec_b:.4f}, "
        f"{qps_b:.0f} qps, hop launches {c_b[0]}; first 512: device {rec_b512:.4f} "
        f"vs native CPU engine {rec_cpu:.4f}")
    if abs(rec_b512 - rec_cpu) > 0.01:
        fail(f"(b) recall {rec_b512} not within 0.01 of the CPU engine's {rec_cpu}")

    # (c) high-recall mode with exact rescore
    pc = SearchParams(k=K, ef=200, entry_seeds=4, stop_frontier=1.0, frontier_rank=200,
                      rescore=40)
    d_c, lab_c, qps_c, c_c = run_mode("c", q[:1024], 2, params=pc)
    rec_c = recall(lab_c, gt[:1024])
    log(f"[phase2] (c) high-recall + rescore 40, 1024 queries: recall@10 {rec_c:.4f}, "
        f"{qps_c:.0f} qps, hop launches {c_c[0]}, gather launches {c_c[1]}")
    if rec_c < 0.99:
        fail(f"(c) recall {rec_c} < 0.99")
    if c_c[1] == 0:
        fail("(c): the gather kernel was never launched")
    qsq = (q[:1024].astype(np.float64) ** 2).sum(-1)
    xsq = (x.astype(np.float64) ** 2).sum(-1)
    worst = 0.0
    for i in range(1024):
        ref = dict(zip(gt[i].tolist(), gt_d[i].tolist()))
        for lab, dv in zip(lab_c[i].tolist(), d_c[i].tolist()):
            if lab in ref:
                tol = 1e-5 * abs(ref[lab]) + 1e-5 * (qsq[i] + xsq[lab])
                worst = max(worst, abs(dv - ref[lab]) / tol)
    log(f"[phase2] (c) distances vs oracle: worst error {worst:.3f} of tolerance")
    if worst > 1.0:
        fail("(c) distances disagree with the oracle's")
    return {"launches": launches, "recall": {"a": rec_a, "b": rec_b, "c": rec_c},
            "qps": {"a": qps_a, "b": qps_b, "c": qps_c}}


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA GPU")
    import hnsw_tpu_torch  # noqa: F401  (fails outside the repository)

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = smi_name_power()
    log(f"[phase0] torch {torch.__version__} cuda {torch.version.cuda}, device {name}")
    log(f"[phase0] nvidia-smi: {smi}")

    k1 = phase1(dev)
    p2 = phase2(dev)
    log(json.dumps({"summary": {"recall@10": p2["recall"], "qps": p2["qps"],
                                "device": smi}}))
    log(json.dumps({"kernels": [
        {"name": "hop_dist_unified", "route": "cuda",
         "source": "hnsw_tpu_torch/csrc/hop_dist_unified.cu",
         "replaces": "hnsw_tpu/ops/pallas_gather.py:795",
         "launches": p2["launches"]["hop_dist_unified"],
         "max_abs_err": k1["hop"]["max_abs_err"],
         "ms": k1["hop"]["ms"], "plain_ms": k1["hop"]["plain_ms"]},
        {"name": "gather_dist_rows", "route": "cuda",
         "source": "hnsw_tpu_torch/csrc/gather_dist.cu",
         "replaces": "hnsw_tpu/ops/pallas_gather.py:1051",
         "launches": p2["launches"]["gather_dist_rows"],
         "max_abs_err": k1["gather"]["max_abs_err"],
         "ms": k1["gather"]["ms"], "plain_ms": k1["gather"]["plain_ms"]},
    ]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
