"""Drive the PyTorch/CUDA port (hnsw_tpu_torch) end to end on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 0  the device: name and power limit; CUDA is required (no CPU path).
Phase 1  builds the CUDA kernels from hnsw_tpu_torch/csrc and holds each
         against its plain PyTorch version on the card, at the main path's
         shapes and in sweeps over every shape the wrappers take (the four
         hops of the node-block ring, the split hop against the unified
         bf16 hop bit for bit, the two gathers), with times from CUDA
         events: warm, and cold (a fresh `chosen` or `ids` per launch on
         tables far past the L2) for every hop and gather row; the landmark
         seeds' top-s at the benchmark's shape, warm, beside its plain
         version and bruteforce_topk.
Phase 2  the main path at bench.py's operating point (N=100k clustered
         vectors, d=128, M=16, efC=200, k=10): host build, device sync, then
         (a) the seeded speed mode at batch 8192, (b) the default descent at
         ef=200 and (c) the high-recall mode with exact rescore, each gated on
         recall against the port's exact fp32 oracle, with the kernels'
         launch counts read around each mode.
Phase 3  the serving tiers below bf16 at N=2M (d=128, M=16, efC=200, the
         reference's clustered data with 4096 centers), each tier chosen with
         rebuild_device_tables(unified_max_bytes=...): (d) int8 with f32
         storage and the auto rescore, (e) int4 with bf16 storage (the
         reference's N=4M serving configuration, cut to 2M), and (f) the
         exact l2u8 space on 2M uint8 vectors (bin/sweep_u8.py's data),
         bulk-built and served over lossless int8 codes.
Phase 4  the device-wave bulk build (bulk_build, d=128, M=16, efC=200,
         defaults first_wave=4096 and select_c=64: waves of up to 16384 at
         expand=2, ef=200, on the split tier through the hop_dist_inline
         kernel with row-delta syncs): (g) phase 2's 100k dataset, held to
         the host-built graph's recall, the split hop launches of its first
         16,384-node wave kept by a WaveProbe and replayed cold; (i) the
         same data with the budgets
         (SPLIT_MAX_BYTES, UNIFIED_MAX_BYTES) set so that every wave runs on
         the int8 unified tier; (w) a wide graph, M=32 (m0=64), on 30k of the
         same data; (h) N=1M of the reference's 1M sweep data, then served
         after rebuild_device_tables(), then 1000 inserts that must sync as a
         delta.
Phase 5  the deployment path as users run it, at the reference builder's
         default deployment (N=100k gaussian vectors, d=128, M=16, efC=200,
         k=10, ef=200): hnsw_tpu_torch.service.builder_cli writes the vector
         store, the .npz index and its .adj; the storage service runs as its
         own process; (a) the normal-mode query service (a thread of this
         process, so the launch counters can be read) answers /search_batch
         in four modes and 256 single /search requests from 16 clients;
         (b) the optimized mode (.adj + one bulk fetch) runs as its own
         process; (c) the engine's int8 rung with --hbm_trim, in process.
         Gates: recall against the CPU engine, single answers against the
         batch at their bucket, (b)'s ids against (a)'s, (c)'s recall and
         tier, and the launches of rows 1, 2, 3 and 5.
Phase 6  hnswlib interop and the calibrated speed mode (run after phase 4,
         on its indexes and phase 2's, then freed before phase 5):
         (a) calibrate_speed_mode on phase 2's index, served at batch 8192
         behind phase 2 (a)'s recall gate; (b) that index through
         save_hnswlib and HNSWIndex.from_hnswlib onto the card, held to the
         original's graph, vectors and answers at ef=200 and in phase 2
         (c)'s rescore mode; (c) the same round trip for phase 4 (h)'s 1M
         index. The launches of rows 1 and 2 are read around each mode.
Phase 7  the stop-condition searches and the native frontends: (a)
         epsilon_search on phase 2's index (run after phase 6, before it is
         freed), epsilon the median exact 100th-nearest distance, up to 256
         points per query, the device beam against the native CPU engine;
         (b) a MultiVectorIndex of 3,125 documents x 32 vectors (N=100k,
         d=128) built with add_document, top-10 documents against the exact
         per-document min; (c) after phase 5, on its deployment: the
         port's copies of the C++ storage_main and query_main built by
         hnsw_tpu_torch.native.build_binary, normal mode (256 single
         /search one at a time) and optimized mode (64 from 8 clients at
         once), each answer's ids equal to the port's search_cpu's. Row
         1's launches are read around (a) and (b).
Phase 8  the sharded index in one process (run after phase 7 (b), before
         phase 2's index is freed): ShardedHNSWIndex over phase 2's N=100k
         in 8 shards, one HNSWIndex each, all on the card, built by `build`;
         phase 2's 1,024 queries: (a) the default descent at ef=200 on the
         default ladder's one rung, held to phase 2 (b)'s recall, with each
         returned distance its label's exact one and each shard's orphans
         logged; (b) the speed mode; (c) delete-marks and unmarks, and a
         shared filter of even labels; (d) every shard on the int8 rung with
         the shard-local rescore; (e) save() and load(), held to (a)'s
         answers; (f) add_items of 1,000 new vectors and 64 updates as row
         deltas, held to a rebuild; (g) int4 over bf16 storage and the split
         rung; (h) the trim configuration, whose add_items syncs in full;
         (i) epsilon_search and a MultiVectorIndex built by add_document
         over shards. Every row is launched.
Phase 9  phase 8's saved set under torch.distributed: 2 gloo ranks at dp=1,
         then 4 at dp=2 (the batch split in two), each its own process on
         the one card; every rank returns phase 8 (e)'s answers bit for bit
         at ef=200 (and in the speed mode at dp=1).

Prints a {"kernels": [...]} line, the card's name and power limit, and as
its last line {"ok": true, "device": {...}}. Exits non-zero on any failure.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np

N, DIM, M, EF_C, K = 100_000, 128, 16, 200, 10
BATCH = 8192
# the kernels' launch counters (ops/gather_kernels.COUNTS), summed over the phases
LAUNCHES = ("hop_dist_unified", "hop_dist_unified8", "hop_dist_unified4", "gather_dist_rows",
            "gather_dist_bf16", "hop_dist_inline", "seed_topk")
SEED = 123
EXPECTED_RECALL = 0.9945  # bench.py's operating point, for information only
N_TIERS, N_U8, NQ_TIERS = 2_000_000, 2_000_000, 1024
N_BULK = 1_000_000
N_WIDE = 30_000  # the M=32 bulk build of phase 4 (w)
# the H100 SXM's published peaks: HBM bytes/s and f32 (non-tensor) flop/s
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12


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
    """bench.py's clustered gaussian mixture (copied, not imported);
    bin/sweep2m.py's with n_clusters=4096."""
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


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    f32 operations over the f32 rate, whichever is larger."""
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return {"bound_ms": max(tb, tf), "bound_by": "bytes" if tb >= tf else "operations"}


# ---------------------------------------------------------------------------
# Phase 1: each kernel against its plain version.
# ---------------------------------------------------------------------------

# per tier: bytes of one neighbor row (codes or values, plus payload id and,
# when quantized, scale) and f32 operations per lane (dequant, sub, fma)
HOP_ROW_BYTES = {"bf16": lambda d: 2 * d + 4, "int8": lambda d: d + 8,
                 "int4": lambda d: d // 2 + 8}
HOP_OPS = {"bf16": 3, "int8": 4, "int4": 4}


def phase1(dev) -> dict:
    import torch

    from hnsw_tpu_torch.ops import gather_kernels as gk
    from hnsw_tpu_torch.ops.cuda_lib import LOG_PATH, load_kernels

    t0 = time.time()
    load_kernels()
    log(f"[phase1] kernels built and loaded in {time.time() - t0:.1f}s")
    with open(LOG_PATH) as fh:
        for line in fh:
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("[phase1] ptxas:", line.strip())

    rng = np.random.default_rng(7)
    out = {}

    def make_table(tier, rows, m0, d, exact=False):
        d_pad = -(-d // 8) * 8
        payload = torch.from_numpy(
            rng.integers(0, 1 << 30, size=(rows, m0)).astype(np.int32)).to(dev)
        if tier == "bf16":
            vecs = torch.from_numpy(
                rng.normal(size=(rows, m0, d_pad)).astype(np.float32)).to(dev).to(torch.bfloat16)
            vecs[:, :, d:] = 0
            return gk.UnifiedTable(vecs.contiguous(), payload)
        lo, hi = (-128, 127) if exact else (-127, 127) if tier == "int8" else (-7, 7)
        codes = torch.from_numpy(
            rng.integers(lo, hi + 1, size=(rows, m0, d_pad)).astype(np.int8)).to(dev)
        codes[:, :, d:] = 0
        scales = torch.from_numpy(
            rng.uniform(0.01, 0.1, size=(rows, m0)).astype(np.float32)).to(dev)
        if exact:  # l2u8's lossless codes
            scales = torch.ones_like(scales)
        if tier == "int8":
            return gk.Unified8Table(codes.contiguous(), scales, payload)
        return gk.Unified4Table(gk.pack_int4(codes).contiguous(), scales, payload)

    def hop_case(tier, b, e, m0, d, space, rows, timed, exact=False):
        table = make_table(tier, rows, m0, d, exact)
        if exact:  # integer queries, as l2u8 shifts uint8 data by -128
            q = torch.from_numpy(rng.integers(-128, 128, size=(b, d)).astype(np.float32)).to(dev)
        else:
            q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(dev)
        chosen = torch.from_numpy(rng.integers(0, rows, size=(b, e)).astype(np.int32)).to(dev)
        dk, ik = gk.hop_dist_unified(q, table, chosen, space)
        dp, ip_ = gk.hop_dist_unified_plain(q, table, chosen, space)
        torch.cuda.synchronize()
        tag = f"{tier} hop B={b} E={e} m0={m0} d={d} {space}" + (" scale-1 codes" if exact else "")
        if not torch.equal(ik, ip_):
            fail(f"{tag}: ids differ")
        if exact:
            # integer distances below 2^24 are exact in f32: equal to int64
            rows_i = table.codes[chosen.long()][..., :d].long()
            ref = ((rows_i - q.long()[:, None, None, :]) ** 2).sum(-1).reshape(b, e * m0)
            if not (torch.equal(dk, dp) and torch.equal(dk.long(), ref)):
                fail(f"{tag}: dists differ from the exact int64 distances")
        elif not torch.allclose(dk, dp, rtol=1e-5, atol=1e-4):
            fail(f"{tag}: dists differ, max {float((dk - dp).abs().max())}")
        err = float((dk - dp).abs().max())
        msg = f"[phase1] {tag}: ok, max_abs_err {err:.3e}"
        res = {"err": err}
        if timed:
            ms, pms = timed_pair(lambda: gk.hop_dist_unified(q, table, chosen, space),
                                 lambda: gk.hop_dist_unified_plain(q, table, chosen, space))
            # each distinct chosen block read once; q and chosen read, both
            # outputs written once
            blocks = int(torch.unique(chosen).numel())
            nbytes = (blocks * m0 * HOP_ROW_BYTES[tier](table.d_pad)
                      + b * table.d_pad * 4 + b * e * 4 + b * e * m0 * 8)
            flops = b * e * m0 * table.d_pad * HOP_OPS[tier]
            res.update(ms=ms, plain_ms=pms, library_ms=None, **bound(nbytes, flops))
            gb = b * e * m0 * HOP_ROW_BYTES[tier](table.d_pad) / 1e9
            msg += (f", kernel {ms:.4f} ms ({gb / ms * 1e3:.0f} GB/s of blocks read), "
                    f"plain {pms:.4f} ms, bound {res['bound_ms']:.4f} ms "
                    f"({res['bound_by']}, {blocks} distinct blocks)")
        log(msg)
        return res

    # 16384 node blocks: 134 MB (bf16), 71 MB (int8), 38 MB (int4) at
    # m0=32, d=128, past the 50 MB L2 like the real tables. The first case,
    # B=1024 and E=1, is the main path's usual launch (the default expand=1
    # of phase 2 (b), (c) and every phase-3 mode) and gives the kernels
    # line's times; E=2 at B=1024 and B=8192 is the speed mode's (a). These
    # times repeat one `chosen` 20 times, so a B=1024 launch (~8.5 MB of
    # bf16 blocks) is served from the L2 from its second repeat on: they are
    # warm times, kept to stand beside earlier runs'. cold_cases() times
    # rows 1, 3 and 4 the way the main path reads memory.
    for tier in ("bf16", "int8", "int4"):
        cases = [
            hop_case(tier, 1024, 1, 32, 128, "l2", 16384, True),
            hop_case(tier, 1024, 2, 32, 128, "l2", 16384, True),
            hop_case(tier, 1024, 2, 32, 128, "ip", 16384, False),
            hop_case(tier, 1024, 2, 32, 96, "l2", 16384, False),
            hop_case(tier, 8192, 2, 32, 128, "l2", 16384, True),
        ]
        if tier == "bf16":
            # the upper-level descent tables (M=16), and a bulk-build wave's
            # launch, for the split kernel's time to stand beside
            cases.append(hop_case(tier, 1024, 1, 16, 128, "l2", 4096, True))
            cases.append(hop_case(tier, 16384, 2, 32, 128, "l2", 16384, True))
            out["hop_bf16_b16384_ms"] = cases[-1]["ms"]
        if tier == "int8":  # l2u8's lossless codes, exact distances
            cases.append(hop_case(tier, 1024, 1, 32, 128, "l2", 16384, False, exact=True))
        out[f"hop_{tier}"] = dict(
            cases[0], max_abs_err=max(c["err"] for c in cases),
            **{f"{tag}_{key}": cases[i][key] for i, tag in ((1, "e2"), (4, "b8192"))
               for key in ("ms", "plain_ms", "bound_ms")})

    gen = torch.Generator(device=dev).manual_seed(7)
    for tier, err in ring_sweep(dev, gen).items():
        out[f"hop_{tier}"]["max_abs_err"] = max(out[f"hop_{tier}"]["max_abs_err"], err)
    cold = cold_cases(dev, gen)
    for tier in ("bf16", "int8", "int4"):
        out[f"hop_{tier}"].update(cold[tier])

    def inline_case(b, e, m0, d, space, rows, timed, beside_unified=False):
        """hop_dist_inline (the split tier) against its plain version; with
        `beside_unified` the unified bf16 hop is timed on the same tensors,
        in turns with it. The table is made on the card (the largest is
        2.1 GB)."""
        d_pad = -(-d // 8) * 8
        nbr = torch.randn((rows, m0, d_pad), generator=gen, device=dev, dtype=torch.bfloat16)
        nbr[:, :, d:] = 0
        level0 = torch.randint(0, 1 << 30, (rows, m0), generator=gen, device=dev,
                               dtype=torch.int32)
        q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(dev)
        chosen = torch.from_numpy(rng.integers(0, rows, size=(b, e)).astype(np.int32)).to(dev)
        dk, ik = gk.hop_dist_inline(q, nbr, level0, chosen, space)
        dp, ip_ = gk.hop_dist_inline_plain(q, nbr, level0, chosen, space)
        torch.cuda.synchronize()
        tag = f"split hop B={b} E={e} m0={m0} d={d} {space}"
        if not torch.equal(ik, ip_):
            fail(f"{tag}: ids differ")
        if not torch.allclose(dk, dp, rtol=1e-5, atol=1e-4):
            fail(f"{tag}: dists differ, max {float((dk - dp).abs().max())}")
        err = float((dk - dp).abs().max())
        msg = f"[phase1] {tag}: ok, max_abs_err {err:.3e}"
        res = {"err": err}
        if timed:
            ms, pms = timed_pair(lambda: gk.hop_dist_inline(q, nbr, level0, chosen, space),
                                 lambda: gk.hop_dist_inline_plain(q, nbr, level0, chosen, space))
            row_bytes = HOP_ROW_BYTES["bf16"](d_pad)
            blocks = int(torch.unique(chosen).numel())
            nbytes = blocks * m0 * row_bytes + b * d_pad * 4 + b * e * 4 + b * e * m0 * 8
            res.update(ms=ms, plain_ms=pms, library_ms=None,
                       read_bound_ms=b * e * m0 * row_bytes / PEAK_BYTES * 1e3,
                       **bound(nbytes, b * e * m0 * d_pad * HOP_OPS["bf16"]))
            gb = b * e * m0 * row_bytes / 1e9
            msg += (f", kernel {ms:.4f} ms ({gb / ms * 1e3:.0f} GB/s of blocks read), "
                    f"plain {pms:.4f} ms, bound as read {res['read_bound_ms']:.4f} ms, bound "
                    f"{res['bound_ms']:.4f} ms ({res['bound_by']}, {blocks} distinct blocks "
                    f"of {b * e} read), library: none")
            if beside_unified:
                table = gk.UnifiedTable(nbr, level0)
                du, iu = gk.hop_dist_unified(q, table, chosen, space)
                if not (torch.equal(iu, ik) and torch.allclose(du, dk, rtol=1e-5, atol=1e-4)):
                    fail(f"{tag}: the unified bf16 hop disagrees on the same tensors")
                ums, ims = timed_pair(lambda: gk.hop_dist_unified(q, table, chosen, space),
                                      lambda: gk.hop_dist_inline(q, nbr, level0, chosen, space))
                res.update(unified_ms=ums, beside_ms=ims)
                msg += (f"; in turns on the same tensors: unified bf16 hop {ums:.4f} ms, "
                        f"split hop {ims:.4f} ms")
        log(msg)
        return res

    # The split tier's hop. At B=16384 and E=2, a bulk-build wave's launch
    # (phase 4), a table of 16384 blocks is chosen from twice over: more than
    # half of its block reads repeat within the launch and may be served by
    # the L2. A wave of the 1M build chooses among a million blocks, so that
    # launch is timed again on a table of 262144 blocks (2.1 GB), where
    # repeats are rare and the blocks come from device memory; that case
    # gives the kernels line's times, with the unified bf16 hop beside it.
    cases = [
        inline_case(1024, 1, 32, 128, "l2", 16384, True),
        inline_case(1024, 2, 32, 128, "l2", 16384, True),
        inline_case(8192, 2, 32, 128, "l2", 16384, True),
        inline_case(16384, 2, 32, 128, "l2", 16384, True),
        inline_case(16384, 2, 32, 128, "l2", 262144, True, beside_unified=True),
        inline_case(1024, 2, 32, 128, "ip", 16384, False),
        inline_case(1024, 1, 32, 96, "l2", 16384, False),
        inline_case(1024, 2, 32, 96, "ip", 16384, False),
        inline_case(1024, 1, 16, 128, "l2", 4096, False),
        # M=32 graphs: m0=64, two steps of the row loop per chosen node
        inline_case(1024, 2, 64, 128, "l2", 8192, True),
        inline_case(1024, 1, 64, 96, "ip", 8192, False),
    ]
    out["hop_inline"] = dict(cases[4], max_abs_err=max(max(c["err"] for c in cases),
                                                       split_sweep(dev, gen)),
                             small_table_ms=cases[3]["ms"], **cold["inline"])
    log(f"[phase1] split hop vs unified bf16 hop at B=16384 E=2: table of 16384 blocks "
        f"(repeats in the L2) {cases[3]['ms']:.4f} ms vs {out['hop_bf16_b16384_ms']:.4f} ms; "
        f"table of 262144 blocks {cases[4]['beside_ms']:.4f} ms vs "
        f"{cases[4]['unified_ms']:.4f} ms")

    def gather_case(dtype, b, kk, d, space, rows, timed):
        table = torch.from_numpy(rng.normal(size=(rows, d)).astype(np.float32)).to(dev)
        table = table.to(dtype)
        q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(dev)
        ids = torch.from_numpy(rng.integers(0, rows, size=(b, kk)).astype(np.int32)).to(dev)
        dk = gk.gather_dist_rows(q, table, ids, space)
        dp = gk.gather_dist_rows_plain(q, table, ids, space)
        torch.cuda.synchronize()
        tag = f"gather {str(dtype)[6:]} B={b} K={kk} d={d} {space}"
        if bool(gather_bad(q, table, ids, dk, dp).any()):
            fail(f"{tag}: dists differ")
        err = float((dk - dp).abs().max())
        msg = f"[phase1] {tag}: ok, max_abs_err {err:.3e}"
        res = {"err": err}
        if timed:
            ms, pms = timed_pair(lambda: gk.gather_dist_rows(q, table, ids, space),
                                 lambda: gk.gather_dist_rows_plain(q, table, ids, space))
            esz = table.element_size()
            nbytes = (int(torch.unique(ids).numel()) * d * esz + b * d * 4
                      + b * kk * 4 + b * kk * 4)
            flops = b * kk * d * (4 if dtype == torch.float32 else 3)
            res.update(ms=ms, plain_ms=pms, library_ms=None, **bound(nbytes, flops))
            gb = b * kk * d * esz / 1e9
            msg += (f", kernel {ms:.4f} ms ({gb / ms * 1e3:.0f} GB/s of rows read), "
                    f"plain {pms:.4f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']})")
        log(msg)
        return res

    # warm, like the hop's cases above (one `ids` repeated over a 200,000-row
    # table that the L2 holds); gather_cold_cases() times rows 2 and 5 cold
    for name, dtype in (("gather_f32", torch.float32), ("gather_bf16", torch.bfloat16)):
        cases = [
            gather_case(dtype, 1024, 40, 128, "l2", 200_000, True),
            gather_case(dtype, 1024, 40, 128, "ip", 200_000, False),
        ]
        out[name] = dict(cases[0], max_abs_err=max(c["err"] for c in cases))
    for name, err in gather_sweep(dev, gen).items():
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
    for name, res in gather_cold_cases(dev, gen).items():
        out[name].update(res)
    out["seed_topk"] = seed_topk_case(dev)
    torch.cuda.empty_cache()  # phase 1's tables are gone: the card is free again
    return out


def seed_topk_case(dev) -> dict:
    """The landmark seeds' kernel (csrc/seed_topk.cu) at the benchmark
    cells' shape, B 8,192 x NL 62,500 x D 128, s 4 (L2): held to its plain
    version (distances within 1e-2 at |q|^2 + |x|^2 ~ 256, positions equal
    but for near ties), then timed warm in turns with it, and beside
    bruteforce_topk, the matmul and top_k it replaced on this path (the
    library yardstick), with each one's peak device memory above its
    inputs."""
    import torch

    from hnsw_tpu_torch.ops.gather_kernels import COUNTS
    from hnsw_tpu_torch.ops.topk import bruteforce_topk, seed_topk, seed_topk_plain

    b, nl, d, s = BATCH, 62_500, DIM, 4
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    q = torch.randn((b, d), generator=g, device=dev)
    x = torch.randn((nl, d), generator=g, device=dev)
    xsq = (x * x).sum(-1)
    kernel = lambda: seed_topk(q, x, s, "l2", x_sq_norms=xsq)  # noqa: E731
    plain = lambda: seed_topk_plain(q, x, s, "l2", x_sq_norms=xsq)  # noqa: E731
    library = lambda: bruteforce_topk(q, x, s, "l2", x_sq_norms=xsq)  # noqa: E731

    def peak_mb(fn) -> float:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 1e6

    COUNTS.reset()
    kd, ki = kernel()
    torch.cuda.synchronize()
    if COUNTS.seed_topk != 1 or COUNTS.plain_on_cuda:
        fail(f"seed_topk: {COUNTS.seed_topk} launches, {COUNTS.plain_on_cuda} plain")
    pd, pi = plain()
    err = float((kd - pd).abs().max())
    swapped = float((ki != pi).float().mean())
    if err > 1e-2 or swapped > 1e-3:
        fail(f"seed_topk: max_abs_err {err:.3e}, positions differ at {swapped:.2e}")
    ms, pms = timed_pair(kernel, plain)
    lms = cuda_ms(library)
    nbytes = (b * d + nl * d + nl) * 4 + b * s * 12
    res = {"max_abs_err": err, "swapped": swapped, "ms": ms, "plain_ms": pms,
           "library_ms": lms, "peak_mb": peak_mb(kernel), "library_peak_mb": peak_mb(library),
           **bound(nbytes, 2.0 * b * nl * d)}
    log(f"[phase1] seed_topk B={b} NL={nl} d={d} s={s}: ok, max_abs_err {err:.3e}, "
        f"positions differ at {swapped:.2e}; kernel {ms:.4f} ms, plain {pms:.4f} ms, "
        f"bruteforce_topk {lms:.4f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}); "
        f"peak above inputs {res['peak_mb']:.1f} MB (bruteforce_topk "
        f"{res['library_peak_mb']:.1f} MB)")
    return res


def dev_table(dev, gen, tier, rows, m0, d, exact=False):
    """A random unified table ("bf16", "int8" or "int4") made on the card:
    the largest is 8.6 GB, too large to draw on the host. `exact` gives
    l2u8's lossless scale-1 codes."""
    import torch

    from hnsw_tpu_torch.ops import gather_kernels as gk

    d_pad = -(-d // 8) * 8
    payload = torch.randint(0, 1 << 30, (rows, m0), generator=gen, device=dev,
                            dtype=torch.int32)
    if tier == "bf16":
        vecs = torch.randn((rows, m0, d_pad), generator=gen, device=dev, dtype=torch.bfloat16)
        vecs[:, :, d:] = 0
        return gk.UnifiedTable(vecs, payload)
    lo, hi = (-128, 127) if exact else (-127, 127) if tier == "int8" else (-7, 7)
    codes = torch.randint(lo, hi + 1, (rows, m0, d_pad), generator=gen, device=dev,
                          dtype=torch.int8)
    codes[:, :, d:] = 0
    if exact:
        scales = torch.ones((rows, m0), device=dev)
    else:
        scales = 0.01 + 0.09 * torch.rand((rows, m0), generator=gen, device=dev)
    if tier == "int8":
        return gk.Unified8Table(codes, scales, payload)
    return gk.Unified4Table(gk.pack_int4(codes), scales, payload)


def ring_sweep(dev, gen) -> dict:
    """Rows 1, 3 and 4 (the node-block ring) against their plain versions at
    every shape the wrapper takes: m0 16 to 128 (m0=128 at d=128 is cut into
    two pieces of rows), d 96 and 128 (and for int4 d=104, whose 52-byte row
    is no multiple of 8 bytes), E 1, 2 and 4, L2 and IP, chosen ids out of
    range (NaN, -1), B*E far below the persistent grid (B=48) and far above
    it (B=4096, E=4), a row as wide as the wrapper allows (d=12288, pieces
    of 2 rows, a ring past 48 KB; for int4 also d=12280, a 6,140-byte row cut
    into pieces of 4 rows), and l2u8's scale-1 codes, whose distances must
    equal the int64 ones. Ids exactly equal, distances within rtol 1e-5,
    atol 1e-4. Returns the largest error per tier."""
    import torch

    from hnsw_tpu_torch.ops import gather_kernels as gk

    errs = {"bf16": 0.0, "int8": 0.0, "int4": 0.0}
    nan = float("nan")

    def check(tier, table, b, e, space, exact=False, d=None):
        rows = table.rows
        if exact:
            q = torch.randint(-128, 128, (b, d), generator=gen, device=dev).float()
        else:
            q = torch.randn((b, d), generator=gen, device=dev)
        chosen = torch.randint(0, rows, (b, e), generator=gen, device=dev, dtype=torch.int32)
        chosen[0, 0], chosen[1, e - 1], chosen[2, 0] = -1, rows, rows - 1
        dk, ik = gk.hop_dist_unified(q, table, chosen, space)
        ok = (chosen >= 0) & (chosen < rows)
        dp, ip_ = gk.hop_dist_unified_plain(q, table, torch.where(ok, chosen, 0), space)
        bad = (~ok).repeat_interleave(table.m0, dim=1)
        dp, ip_ = dp.masked_fill(bad, nan), ip_.masked_fill(bad, -1)
        torch.cuda.synchronize()
        tag = (f"ring sweep {tier} B={b} E={e} m0={table.m0} d={d} {space}"
               + (" scale-1 codes" if exact else ""))
        if not torch.equal(ik, ip_):
            fail(f"{tag}: ids differ")
        if exact:
            codes = table.codes[torch.where(ok, chosen, 0).long()][..., :d].long()
            ref = ((codes - q.long()[:, None, None, :]) ** 2).sum(-1).reshape(b, -1)
            if not (torch.equal(dk[~bad], dp[~bad]) and torch.equal(dk[~bad].long(), ref[~bad])):
                fail(f"{tag}: dists differ from the exact int64 distances")
        if not (torch.isnan(dk) == bad).all():
            fail(f"{tag}: NaN where a chosen id was in range, or none where it was not")
        if not torch.allclose(dk[~bad], dp[~bad], rtol=1e-5, atol=1e-4):
            fail(f"{tag}: dists differ, max {float((dk[~bad] - dp[~bad]).abs().max())}")
        errs[tier] = max(errs[tier], float((dk[~bad] - dp[~bad]).abs().max()))
        return 1

    t0, n = time.time(), 0
    for tier in ("bf16", "int8", "int4"):
        for m0 in (16, 32, 64, 128):
            for d in (96, 104, 128) if tier == "int4" else (96, 128):
                table = dev_table(dev, gen, tier, 2048, m0, d)
                for e in (1, 2, 4):
                    n += check(tier, table, 48, e, "l2", d=d) + check(tier, table, 48, e, "ip", d=d)
                if d == 128:
                    n += check(tier, table, 4096, 4, "l2", d=d)
            if tier == "int8":
                table = dev_table(dev, gen, tier, 2048, m0, 128, exact=True)
                n += check(tier, table, 48, 2, "l2", exact=True, d=128)
                n += check(tier, table, 4096, 4, "l2", exact=True, d=128)
        for d in (12288, 12280) if tier == "int4" else (12288,):
            n += check(tier, dev_table(dev, gen, tier, 64, 16, d), 8, 2, "l2", d=d)
    log(f"[phase1] ring sweep: rows 1, 3 and 4 agree with their plain versions in {n} cases "
        f"({time.time() - t0:.1f}s); max_abs_err "
        + ", ".join(f"{t} {e:.3e}" for t, e in errs.items()))
    return errs


def split_sweep(dev, gen) -> float:
    """Row 6 (the split hop on the ring, level0 as the payload) against its
    plain version and against row 1 on the same tensors: m0 16, 32 and 64,
    d 96 and 128, E 1 and 2, L2 and IP, chosen ids out of range (NaN, -1)
    and the sentinel row n_pad - 1 chosen again and again, as finished beams
    choose it. Ids exactly equal and distances within rtol 1e-5, atol 1e-4
    of the plain version; ids and distance bits equal to row 1's. Returns
    the largest error."""
    import torch

    from hnsw_tpu_torch.ops import gather_kernels as gk

    err, n, t0 = 0.0, 0, time.time()
    for m0 in (16, 32, 64):
        for d in (96, 128):
            table = dev_table(dev, gen, "bf16", 2048, m0, d)
            nbr, level0, rows = table.vecs, table.payload, table.rows
            for e in (1, 2):
                for space in ("l2", "ip"):
                    b = 256
                    q = torch.randn((b, d), generator=gen, device=dev)
                    chosen = torch.randint(0, rows, (b, e), generator=gen, device=dev,
                                           dtype=torch.int32)
                    chosen[0, 0], chosen[1, e - 1], chosen[2:40, 0] = -1, rows, rows - 1
                    dk, ik = gk.hop_dist_inline(q, nbr, level0, chosen, space)
                    ok = (chosen >= 0) & (chosen < rows)
                    dp, ip_ = gk.hop_dist_inline_plain(q, nbr, level0,
                                                       torch.where(ok, chosen, 0), space)
                    bad = (~ok).repeat_interleave(m0, dim=1)
                    dp, ip_ = dp.masked_fill(bad, float("nan")), ip_.masked_fill(bad, -1)
                    du, iu = gk.hop_dist_unified(q, table, chosen, space)
                    torch.cuda.synchronize()
                    tag = f"split sweep B={b} E={e} m0={m0} d={d} {space}"
                    if not torch.equal(ik, ip_):
                        fail(f"{tag}: ids differ")
                    if not torch.equal(torch.isnan(dk), bad):
                        fail(f"{tag}: NaN where a chosen id was in range, or none where it was not")
                    if not torch.allclose(dk[~bad], dp[~bad], rtol=1e-5, atol=1e-4):
                        fail(f"{tag}: dists differ, max {float((dk[~bad] - dp[~bad]).abs().max())}")
                    if not (torch.equal(ik, iu) and torch.equal(dk.view(torch.int32),
                                                                du.view(torch.int32))):
                        fail(f"{tag}: not row 1's ids and distances bit for bit")
                    err = max(err, float((dk[~bad] - dp[~bad]).abs().max()))
                    n += 1
    log(f"[phase1] split sweep: row 6 agrees with its plain version, and with row 1 bit for "
        f"bit, in {n} cases ({time.time() - t0:.1f}s); max_abs_err {err:.3e}")
    return err


def cold_ms(fn, chosens) -> float:
    """cuda_ms of fn(chosen) with a fresh `chosen` for each of its 21 calls,
    so that a launch rarely finds its blocks in the L2, as a beam iteration
    of the main path does not."""
    it = iter(chosens)
    return cuda_ms(lambda: fn(next(it)))


def profiled_ms(fn, kernel: str) -> float:
    """Device ms that torch.profiler gives the kernels named `kernel` in one
    call of `fn`, summed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum((getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0))
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key) / 1e3


def cold_cases(dev, gen) -> dict:
    """Rows 1, 3 and 4 timed cold on tables of 262,144 node blocks (bf16 2.2
    GB, int8 1.1 GB, int4 0.6 GB; m0=32, d=128, L2) at the main path's
    launches, with row 6 (the split hop) and row 1 in turns on the same
    tensors at a bulk-build wave's launch, there and on a table of 1,048,576
    blocks (8.6 GB, a 1M build's split table), and int8 and bf16, int4 and
    int8, in turns at the speed mode's launch. Bound A: the blocks as read
    (every pair's block, its ids and scales) at 3.35 TB/s."""
    import torch

    from hnsw_tpu_torch.ops import gather_kernels as gk

    rows, m0, d = 262_144, 32, 128

    def chosen_sets(b, e, r):
        return [torch.randint(0, r, (b, e), generator=gen, device=dev, dtype=torch.int32)
                for _ in range(21)]

    def read_ms(tier, b, e):  # bound A
        return b * e * m0 * HOP_ROW_BYTES[tier](d) / PEAK_BYTES * 1e3

    tables = {t: dev_table(dev, gen, t, rows, m0, d) for t in ("bf16", "int8", "int4")}
    out = {t: {} for t in (*tables, "inline")}  # the kernels line's cold times
    sets = {}
    for (b, e), key in (((1024, 1), "cold_ms"), ((1024, 2), None),
                        ((8192, 2), "cold_b8192_ms"), ((16384, 2), None)):
        q = torch.randn((b, d), generator=gen, device=dev)
        ch = sets[b, e] = (q, chosen_sets(b, e, rows))
        for tier, table in tables.items():
            dk, ik = gk.hop_dist_unified(q, table, ch[1][0])
            dp, ip_ = gk.hop_dist_unified_plain(q, table, ch[1][0])
            if not (torch.equal(ik, ip_) and torch.allclose(dk, dp, rtol=1e-5, atol=1e-4)):
                fail(f"cold {tier} hop B={b} E={e}: differs from its plain version")
            ms = cold_ms(lambda c: gk.hop_dist_unified(q, table, c), ch[1])
            bound_a = read_ms(tier, b, e)
            # bound B of the first launch: each distinct block read once
            blocks = int(torch.unique(ch[1][0]).numel())
            bound_b = bound(blocks * m0 * HOP_ROW_BYTES[tier](d) + b * d * 4 + b * e * 4
                            + b * e * m0 * 8, 0)["bound_ms"]
            if key:
                out[tier][key] = ms
            log(f"[phase1] cold {tier} hop B={b} E={e} m0={m0} d={d} l2, {rows} blocks: "
                f"{ms:.4f} ms, bound A {bound_a * 1e3:.1f} us ({bound_a / ms:.0%} of bound), "
                f"bound B {bound_b * 1e3:.1f} us, "
                f"{b * e * m0 * HOP_ROW_BYTES[tier](d) / ms / 1e6:.0f} GB/s of blocks read")
        if key:  # row 6 on the bf16 table's tensors, its ids from the payload
            t16 = tables["bf16"]
            ms = cold_ms(lambda c: gk.hop_dist_inline(q, t16.vecs, t16.payload, c), ch[1])
            out["inline"][key] = ms
            blocks = int(torch.unique(ch[1][0]).numel())
            bound_b = bound(blocks * m0 * HOP_ROW_BYTES["bf16"](d) + b * d * 4 + b * e * 4
                            + b * e * m0 * 8, 0)["bound_ms"]
            log(f"[phase1] cold split hop B={b} E={e} m0={m0} d={d} l2, {rows} blocks: "
                f"{ms:.4f} ms, bound A {read_ms('bf16', b, e) * 1e3:.1f} us "
                f"({read_ms('bf16', b, e) / ms:.0%} of bound), bound B {bound_b * 1e3:.1f} us")

    # int8 against bf16 and int4 against int8 at the speed mode's launch, in
    # turns
    q, ch = sets[8192, 2]
    for lo, hi in (("int8", "bf16"), ("int4", "int8")):
        th_a, tl_a, tl_b, th_b = (cold_ms(lambda c: gk.hop_dist_unified(q, tables[t], c), ch)
                                  for t in (hi, lo, lo, hi))
        ratio = (tl_a + tl_b) / (th_a + th_b)
        log(f"[phase1] cold B=8192 E=2 in turns: {lo} {(tl_a + tl_b) / 2:.4f} ms, {hi} "
            f"{(th_a + th_b) / 2:.4f} ms: {lo} takes {ratio:.2f} of {hi}'s time for "
            f"{HOP_ROW_BYTES[lo](d) / HOP_ROW_BYTES[hi](d):.2f} of its bytes")
    b16 = tables.pop("bf16")
    del tables
    torch.cuda.empty_cache()

    # row 6 and row 1 in turns on the same tensors, cold, at a wave's launch
    b, e = 16384, 2
    q = torch.randn((b, d), generator=gen, device=dev)
    for r in (rows, 1 << 20):
        table = b16 if r == rows else dev_table(dev, gen, "bf16", r, m0, d)
        ch = chosen_sets(b, e, r)
        s_a, u_a, u_b, s_b = (
            cold_ms(lambda c: gk.hop_dist_inline(q, table.vecs, table.payload, c), ch),
            cold_ms(lambda c: gk.hop_dist_unified(q, table, c), ch),
            cold_ms(lambda c: gk.hop_dist_unified(q, table, c), ch),
            cold_ms(lambda c: gk.hop_dist_inline(q, table.vecs, table.payload, c), ch))
        split, unified = (s_a + s_b) / 2, (u_a + u_b) / 2
        log(f"[phase1] cold B={b} E={e} on {r} blocks ({table.nbytes / 1e9:.1f} GB), in "
            f"turns: split hop (row 6) {split:.4f} ms, unified bf16 hop (row 1) "
            f"{unified:.4f} ms, bound A {read_ms('bf16', b, e) * 1e3:.1f} us")
        if r > rows:  # the same 20 launches of row 6 as torch.profiler times them
            prof = profiled_ms(lambda: [gk.hop_dist_inline(q, table.vecs, table.payload, c)
                                        for c in ch[1:]], "hop_dist_ring") / 20
            log(f"[phase1] the same split hop launches under torch.profiler: {prof:.4f} ms "
                f"a launch (CUDA events: {split:.4f} ms)")
        del table
    del b16
    torch.cuda.empty_cache()
    return out


def gather_bad(q, table, ids, dk, dp):
    """Where a gather kernel's distances `dk` miss the plain version's `dp`:
    the f32 table's norm-expansion form cancels, so its atol scales with
    |q|^2 + |x|^2; the bf16 table's direct difference is held to rtol 1e-5,
    atol 1e-4."""
    import torch

    if table.dtype == torch.float32:
        scale = (q * q).sum(-1, keepdim=True) + (table * table).sum(-1)[ids.long()]
        return (dk - dp).abs() > 1e-5 * dp.abs() + 1e-5 * scale
    return ~torch.isclose(dk, dp, rtol=1e-5, atol=1e-4)


def gather_sweep(dev, gen) -> dict:
    """Rows 2 and 5 (the f32 and bf16 gathers) against their plain versions
    at K 1, 40 and 160, d 30, 96, 128 and 768 (d=30: the bf16 table's rows
    are 60 bytes, the second path of gather_dist_bf16.cu), L2 and IP, with
    ids out of range (NaN). Returns the largest error per table type."""
    import torch

    from hnsw_tpu_torch.ops import gather_kernels as gk

    errs, n, t0, rows, b = {}, 0, time.time(), 4096, 64
    for name, dtype in (("gather_f32", torch.float32), ("gather_bf16", torch.bfloat16)):
        errs[name] = 0.0
        for d in (30, 96, 128, 768):
            table = torch.randn((rows, d), generator=gen, device=dev).to(dtype)
            for kk in (1, 40, 160):
                for space in ("l2", "ip"):
                    q = torch.randn((b, d), generator=gen, device=dev)
                    ids = torch.randint(0, rows, (b, kk), generator=gen, device=dev,
                                        dtype=torch.int32)
                    ids[0, 0], ids[1, kk - 1], ids[2, 0] = -1, rows, rows - 1
                    ok = (ids >= 0) & (ids < rows)
                    dk = gk.gather_dist_rows(q, table, ids, space)
                    safe = torch.where(ok, ids, 0)
                    dp = gk.gather_dist_rows_plain(q, table, safe, space)
                    torch.cuda.synchronize()
                    tag = f"gather sweep {name[7:]} B={b} K={kk} d={d} {space}"
                    if not torch.equal(torch.isnan(dk), ~ok):
                        fail(f"{tag}: NaN where an id was in range, or none where it was not")
                    if bool(gather_bad(q, table, safe, dk, dp)[ok].any()):
                        fail(f"{tag}: dists differ")
                    errs[name] = max(errs[name], float((dk - dp)[ok].abs().max()))
                    n += 1
    log(f"[phase1] gather sweep: rows 2 and 5 agree with their plain versions in {n} cases "
        f"({time.time() - t0:.1f}s); max_abs_err "
        + ", ".join(f"{t[7:]} {e:.3e}" for t, e in errs.items()))
    return errs


def gather_cold_cases(dev, gen) -> dict:
    """Rows 2 and 5 timed cold: tables of 2,000,000 rows at d=128 (f32 1.02
    GB, bf16 512 MB), a fresh `ids` for each launch at B=1024 K=40 (the
    rescore of phase 2 (c) and of phase 3's auto rescore of 4*k). Bound A:
    B*K*D*elem bytes at 3.35 TB/s."""
    import torch

    from hnsw_tpu_torch.ops import gather_kernels as gk

    rows, b, kk, d = 2_000_000, 1024, 40, 128
    q = torch.randn((b, d), generator=gen, device=dev)
    sets = [torch.randint(0, rows, (b, kk), generator=gen, device=dev, dtype=torch.int32)
            for _ in range(21)]
    out = {}
    for name, dtype in (("gather_f32", torch.float32), ("gather_bf16", torch.bfloat16)):
        table = torch.randn((rows, d), generator=gen, device=dev).to(dtype)
        dk = gk.gather_dist_rows(q, table, sets[0])
        dp = gk.gather_dist_rows_plain(q, table, sets[0])
        if bool(gather_bad(q, table, sets[0], dk, dp).any()):
            fail(f"cold {name} B={b} K={kk}: differs from its plain version")
        ms = cold_ms(lambda i: gk.gather_dist_rows(q, table, i), sets)
        nbytes = b * kk * d * table.element_size()
        bound_a = nbytes / PEAK_BYTES * 1e3
        out[name] = {"cold_ms": ms}
        log(f"[phase1] cold {name[7:]} gather B={b} K={kk} d={d} l2, {rows} rows "
            f"({table.nbytes / 1e9:.2f} GB): {ms:.4f} ms, bound A {bound_a * 1e3:.1f} us "
            f"({bound_a / ms:.0%} of bound), {nbytes / ms / 1e6:.0f} GB/s of rows read")
        del table
    torch.cuda.empty_cache()
    return out


def recall(got: np.ndarray, gt: np.ndarray) -> float:
    return float(np.mean([len(set(got[i]) & set(gt[i])) / K for i in range(len(gt))]))


def counted(name, launches, fn):
    """Run `fn` with the kernels' counts set to 0 just before and read just
    after → (fn's result, seconds, counts); adds the counts to `launches`.
    Fails if a plain version ran on a CUDA tensor."""
    import torch

    from hnsw_tpu_torch.ops.gather_kernels import COUNTS

    torch.cuda.synchronize()
    COUNTS.reset()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    secs = time.time() - t0
    counts = {f: getattr(COUNTS, f) for f in launches}
    if COUNTS.plain_on_cuda:
        fail(f"({name}) a plain version ran on CUDA tensors {COUNTS.plain_on_cuda} times")
    for f, c in counts.items():
        launches[f] += c
    return out, secs, counts


def run_mode(idx, name, qs, reps, launches, warm=True, **kw):
    """Search `qs` `reps` times with the kernels' counts set to 0 just before
    and read just after; adds the counts to `launches`. Fails if a plain
    version ran on a CUDA tensor or the results are malformed. `warm`: one
    untimed search of 16 queries first, for an index whose device state an
    earlier call has not synced yet."""

    def searches():
        times = []
        for _ in range(reps):
            t = time.time()
            d, lab = idx.search(qs, **kw)
            times.append(time.time() - t)
        return d, lab, times

    if warm:
        idx.search(qs[:16], **kw)  # warm-up (device sync, allocator, kernel load)
    (d, lab, times), _, counts = counted(f"mode {name}", launches, searches)
    if d.shape != (len(qs), K) or not np.isfinite(d).all() or (lab < 0).any():
        fail(f"mode {name}: malformed results")
    qps = len(qs) / float(np.median(times))
    return d, lab, qps, counts


def need_launch(name, counts, *kernels):
    for kname in kernels:
        if counts[kname] == 0:
            fail(f"mode {name}: {kname} was never launched")


def phase2(dev, launches) -> dict:
    import torch

    from hnsw_tpu_torch import BruteforceIndex, HNSWIndex, L2Space, SearchParams

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
        f"{st.tier} table {st.unified.nbytes / 1e9:.3f} GB, "
        f"{len(st.upper_tables or ())} upper tables, max_level {st.graph.max_level}")
    if st.tier != "unified":
        fail(f"phase 2 serves the bf16 tier, got {st.tier}")
    del st

    # (a) speed mode, bench.py:233-261
    pa = SearchParams(k=K, ef=160, expand=2, stop_frontier=1.15, max_iters=14, entry_seeds=4)
    _, lab_a, qps_a, c_a = run_mode(idx, "a", q, 5, launches, params=pa)
    need_launch("a", c_a, "hop_dist_unified", "seed_topk")
    rec_a = recall(lab_a, gt)
    log(f"[phase2] (a) speed mode, batch {BATCH}: recall@10 {rec_a:.4f} "
        f"(delta {rec_a - EXPECTED_RECALL:+.4f} from {EXPECTED_RECALL}), "
        f"{qps_a:.0f} qps, hop launches {c_a['hop_dist_unified']}")
    if rec_a < 0.95:
        fail(f"(a) recall {rec_a} < 0.95")

    # (b) default descent at ef=200
    _, lab_b, qps_b, c_b = run_mode(idx, "b", q[:1024], 2, launches, k=K, ef=200)
    need_launch("b", c_b, "hop_dist_unified")
    rec_b = recall(lab_b, gt[:1024])
    rec_b512 = recall(lab_b[:512], gt[:512])
    _, lab_cpu, _ = idx.search_cpu(q[:512], k=K, ef=200)
    rec_cpu = recall(lab_cpu, gt[:512])
    log(f"[phase2] (b) default descent ef=200, 1024 queries: recall@10 {rec_b:.4f}, "
        f"{qps_b:.0f} qps, hop launches {c_b['hop_dist_unified']}; first 512: device "
        f"{rec_b512:.4f} vs native CPU engine {rec_cpu:.4f}")
    if abs(rec_b512 - rec_cpu) > 0.01:
        fail(f"(b) recall {rec_b512} not within 0.01 of the CPU engine's {rec_cpu}")

    # (c) high-recall mode with exact rescore
    pc = SearchParams(k=K, ef=200, entry_seeds=4, stop_frontier=1.0, frontier_rank=200,
                      rescore=40)
    d_c, lab_c, qps_c, c_c = run_mode(idx, "c", q[:1024], 2, launches, params=pc)
    need_launch("c", c_c, "hop_dist_unified", "gather_dist_rows")
    rec_c = recall(lab_c, gt[:1024])
    log(f"[phase2] (c) high-recall + rescore 40, 1024 queries: recall@10 {rec_c:.4f}, "
        f"{qps_c:.0f} qps, hop launches {c_c['hop_dist_unified']}, "
        f"gather launches {c_c['gather_dist_rows']}")
    if rec_c < 0.99:
        fail(f"(c) recall {rec_c} < 0.99")
    worst = oracle_error(d_c, lab_c, q[:1024], x, gt[:1024], gt_d[:1024])
    log(f"[phase2] (c) distances vs oracle: worst error {worst:.3f} of tolerance")
    if worst > 1.0:
        fail("(c) distances disagree with the oracle's")
    return {"recall": {"a": rec_a, "b": rec_b, "c": rec_c},
            "qps": {"a": qps_a, "b": qps_b, "c": qps_c},
            "data": (x, q[:1024], gt[:1024]),  # for phases 4 (g), 7 (a) and 8
            "gt_d": gt_d[:1024],  # for phase 8 (d)
            "serve": (idx, q, gt, pc)}  # for phase 6


def oracle_error(d, lab, q, x, gt, gt_d) -> float:
    """Worst |returned - oracle| distance over the oracle's tolerance
    1e-5*|ref| + 1e-5*(|q|^2 + |x|^2), for returned labels the oracle also
    returned (labels are row numbers)."""
    qsq = (q.astype(np.float64) ** 2).sum(-1)
    xsq = (x.astype(np.float64) ** 2).sum(-1)
    worst = 0.0
    for i in range(len(q)):
        ref = dict(zip(gt[i].tolist(), gt_d[i].tolist()))
        for lab_i, dv in zip(lab[i].tolist(), d[i].tolist()):
            if lab_i in ref:
                tol = 1e-5 * abs(ref[lab_i]) + 1e-5 * (qsq[i] + xsq[lab_i])
                worst = max(worst, abs(dv - ref[lab_i]) / tol)
    return worst


# ---------------------------------------------------------------------------
# Phase 3: the serving tiers below bf16.
# ---------------------------------------------------------------------------


def u8_dataset(n, nq, dim, rng):
    """bin/sweep_u8.py's SIFT-like uint8 data (copied, not imported)."""
    centers = rng.normal(size=(4096, dim))
    xf = centers[rng.integers(0, 4096, n)] + 0.5 * rng.normal(size=(n, dim))
    x = np.clip(np.rint(xf * 36.0 + 128.0), 0, 255).astype(np.uint8)
    qf = x[rng.integers(0, n, nq)].astype(np.float64) + 1.8 * rng.normal(size=(nq, dim))
    return x, np.clip(np.rint(qf), 0, 255).astype(np.uint8)


def tier_state(idx, budget, tier):
    """Rebuild the index's device tables under `budget` (None: keep the
    tables of the last sync) and check the tier."""
    import torch

    t0 = time.time()
    st = idx._sync_device() if budget is None else idx.rebuild_device_tables(budget)
    torch.cuda.synchronize()
    if st.tier != tier:
        fail(f"budget {budget} served tier {st.tier}, expected {tier}")
    nbytes = st.unified.nbytes
    cap = "the default budget" if budget is None else f"a budget of {budget / 1e9:.3f} GB"
    log(f"[phase3] {tier} tables under {cap}: level-0 table {nbytes / 1e9:.3f} GB, "
        f"vectors {str(st.vectors.dtype)[6:]}, sync {time.time() - t0:.1f}s")
    return st, nbytes


def phase3(dev, launches) -> dict:
    import torch

    from hnsw_tpu_torch import BruteforceIndex, HNSWIndex, L2Space, SearchParams, bulk_build
    from hnsw_tpu_torch.ops.gather_kernels import tier_bytes

    out = {}
    rng = np.random.default_rng(7)
    x = make_dataset(N_TIERS, DIM, rng, n_clusters=4096)
    q = x[rng.integers(0, N_TIERS, NQ_TIERS)] + 0.05 * rng.normal(
        size=(NQ_TIERS, DIM)).astype(np.float32)
    t0 = time.time()
    idx = HNSWIndex("l2", dim=DIM, m=M, ef_construction=EF_C, device=dev)
    idx.add_items(x)
    out["build_s"] = time.time() - t0
    log(f"[phase3] host build N={N_TIERS} d={DIM} M={M} efC={EF_C}: {out['build_s']:.1f}s")
    oracle = BruteforceIndex(L2Space(DIM), device=dev)
    oracle.add_items(x, np.arange(N_TIERS))
    gt_d, gt = oracle.search_knn(q, K)
    del oracle
    torch.cuda.empty_cache()

    st = idx._sync_device()
    need = tier_bytes(st.graph.n_pad, st.graph.level0.shape[1], DIM)
    log(f"[phase3] n_pad {st.graph.n_pad}, tier budgets (port tables + the JAX "
        "ladder's side tables, tier_bytes): "
        + ", ".join(f"{t} {b / 1e9:.3f} GB" for t, b in need.items()))
    del st
    params = SearchParams(k=K, ef=200, entry_seeds=4)

    def mode(name, tier, budget, qs, reps=2, **kw):
        st, nbytes = tier_state(idx, budget, tier)
        del st
        d, lab, qps, counts = run_mode(idx, name, qs, reps, launches, **kw)
        log(f"[phase3] ({name}) {tier}: {qps:.0f} qps, launches "
            + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
        out[name] = {"tier": tier, "qps": qps, "table_bytes": nbytes}
        return d, lab, counts

    # the bf16 tier (the ladder's pick on an 80 GB card) on the same graph
    # and params, for information
    _, lab_bf, _ = mode("bf16", "unified", None, q, params=params)
    out["bf16"]["recall"] = recall(lab_bf, gt)
    log(f"[phase3] (bf16) recall@10 {out['bf16']['recall']:.4f}")

    # (d) int8 tier, f32 storage, auto rescore of 4k
    d_d, lab_d, c_d = mode("d", "unified8", (need["unified8"] + need["unified"]) // 2, q,
                           params=params)
    need_launch("d", c_d, "hop_dist_unified8", "gather_dist_rows")
    out["d"]["recall"] = rec = recall(lab_d, gt)
    worst = oracle_error(d_d, lab_d, q, x, gt, gt_d)
    log(f"[phase3] (d) int8 + auto rescore: recall@10 {rec:.4f} (bf16 tier "
        f"{out['bf16']['recall']:.4f}), distances vs oracle: worst {worst:.3f} of tolerance")
    if rec < 0.95:
        fail(f"(d) recall {rec} < 0.95")
    if worst > 1.0:
        fail("(d) distances disagree with the oracle's")

    # (e) int4 tier with bf16 storage: res/sweep_4m.json's serving config
    idx.space = L2Space(DIM, storage_dtype=torch.bfloat16)
    d_e, lab_e, c_e = mode("e", "unified4", (need["unified4"] + need["unified8"]) // 2, q,
                           params=params)
    need_launch("e", c_e, "hop_dist_unified4", "gather_dist_bf16")
    xb = idx._device.vectors
    if xb.dtype != torch.bfloat16:
        fail(f"(e) vectors stored as {xb.dtype}")
    rows = xb[torch.from_numpy(lab_e).to(dev).long()].double().cpu().numpy()
    ref = ((rows - q.astype(np.float64)[:, None, :]) ** 2).sum(-1)
    out["e"]["recall"] = rec = recall(lab_e, gt)
    err = float(np.max(np.abs(d_e - ref) / (1e-4 + 1e-5 * np.abs(ref))))
    log(f"[phase3] (e) int4 + bf16 storage + auto rescore: recall@10 {rec:.4f}, "
        f"distances vs float64 of the bf16 vectors: worst {err:.3f} of tolerance")
    if rec < 0.90:
        fail(f"(e) recall {rec} < 0.90")
    if err > 1.0:
        fail("(e) distances disagree with float64 distances to the bf16 vectors")
    del idx, xb
    torch.cuda.empty_cache()

    # (f) l2u8 on lossless int8 codes, no rescore: bulk-built (the upper
    # hierarchy of ~125k nodes itself bulk-built, from the already shifted
    # data), then served on the int8 tier
    xu, qu = u8_dataset(N_U8, NQ_TIERS, DIM, np.random.default_rng(7))
    t0 = time.time()
    idx = bulk_build(xu, space="l2u8", m=M, ef_construction=EF_C, device=dev)
    out["f_build_s"] = time.time() - t0
    log(f"[phase3] bulk_build l2u8 N={N_U8} d={DIM} M={M} efC={EF_C}: "
        f"{out['f_build_s']:.1f}s, {len(idx.wave_log)} waves on "
        f"{sorted(set(w['tier'] for w in idx.wave_log))}")
    st = idx._sync_device()
    need_u8 = tier_bytes(st.graph.n_pad, st.graph.level0.shape[1], DIM)
    del st
    pf = SearchParams(k=K, ef=200, entry_seeds=4, stop_frontier=1.15)
    d_f, lab_f, c_f = mode("f", "unified8", (need_u8["unified8"] + need_u8["unified"]) // 2,
                           qu, params=pf)
    need_launch("f", c_f, "hop_dist_unified8")
    if c_f["gather_dist_rows"] or c_f["gather_dist_bf16"]:
        fail("(f) exact codes need no rescore, but a gather kernel ran")
    xi, qi = xu.astype(np.int64), qu.astype(np.int64)
    exact = ((xi[lab_f] - qi[:, None, :]) ** 2).sum(-1)
    if not np.array_equal(d_f.astype(np.float64), exact.astype(np.float64)):
        fail("(f) distances differ from the int64 distances")
    del idx
    torch.cuda.empty_cache()
    # the 10th exact distance per query, in float64 on the card (exact for
    # integers this small), 64 queries at a time, for a recall that counts ties
    xg = torch.from_numpy(xu).to(dev).double()
    xsq = (xg * xg).sum(-1)
    kth = []
    for s0 in range(0, len(qu), 64):
        qg = torch.from_numpy(qu[s0 : s0 + 64]).to(dev).double()
        dd = (qg * qg).sum(-1)[:, None] + xsq[None, :] - 2.0 * qg @ xg.T
        kth.append(torch.topk(dd, K, dim=-1, largest=False).values[:, -1].cpu().numpy())
    del xg, xsq, dd
    kth = np.concatenate(kth)
    out["f"]["recall"] = rec = float(np.mean(exact <= kth[:, None]))
    log(f"[phase3] (f) l2u8 exact int8: distances equal int64 numpy, tie-aware "
        f"recall@10 {rec:.4f}")
    if rec < 0.95:
        fail(f"(f) tie-aware recall {rec} < 0.95")
    return out

# ---------------------------------------------------------------------------
# Phase 4: the device-wave bulk build.
# ---------------------------------------------------------------------------


def check_waves(name, idx, n_pad, tier="split"):
    """The launch record of a bulk build: every wave on `tier`, on the split
    tier with the split kernel launched in it, and every sync after the
    first a delta unless more than n_pad // 2 rows were dirty (the rule for a
    full sync). Returns the per-stage seconds summed over the waves."""
    waves = idx.wave_log
    if not waves:
        fail(f"({name}) no wave ran")
    for i, w in enumerate(waves):
        if w["tier"] != tier:
            fail(f"({name}) wave {i} ran on tier {w['tier']}, expected {tier}")
        if tier == "split" and w["hop_dist_inline"] <= 0:
            fail(f"({name}) wave {i} never launched hop_dist_inline")
        want_full = i == 0 or w["sync_refusal"] == "more than n_pad // 2 dirty rows"
        if (w["sync_mode"] == "full") != want_full or w["sync_mode"] not in ("full", "delta"):
            fail(f"({name}) wave {i} synced as {w['sync_mode']} ({w['sync_refusal']})")
    stages = {s: sum(w[s] for w in waves) for s in ("sync_s", "search_s", "select_s", "link_s")}
    modes = [w["sync_mode"] for w in waves]
    log(f"[phase4] ({name}) {len(waves)} waves, n_pad {n_pad}: "
        + ", ".join(f"{s[:-2]} {v:.1f}s" for s, v in stages.items())
        + f"; syncs full {modes.count('full')} delta {modes.count('delta')}")
    return stages


def profile_wave(idx, x, dev) -> dict:
    """Where one full wave's device step spends its time: the step (search +
    select of 16384 nodes against the finished graph's split-tier state) is
    timed on the host clock, then run once under torch.profiler for the
    device time by kernel. The device-busy share is the kernels' summed
    device time over the unprofiled wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hnsw_tpu_torch.models.bulk_build import wave_device_step

    serve_budget = idx.unified_max_bytes
    st = idx.rebuild_device_tables(0)  # the waves' budget: the split tier
    idx.unified_max_bytes = serve_budget
    if st.tier != "split":
        fail(f"(h) a unified budget of 0 gave tier {st.tier}, expected split")
    q = torch.from_numpy(np.ascontiguousarray(x[-16384:])).to(dev)
    kw = dict(m=M, ef_construction=EF_C, k_sel=64, space="l2")
    wave_device_step(st, q, **kw)
    torch.cuda.synchronize()
    t0 = time.time()
    wave_device_step(st, q, **kw)
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wave_device_step(st, q, **kw)
        torch.cuda.synchronize()
    # device rows are kernels: their sum is the device time. For the list,
    # a PyTorch kernel is named by the operator that launched it (host rows
    # carry their own kernels' device time), this package's by its own name
    dev_ms, kernels, hop_launches = 0.0, {}, 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        on_device = e.device_type == torch.autograd.DeviceType.CUDA
        if on_device:
            dev_ms += us / 1e3
        if us and (not on_device or "hop_dist" in e.key):
            name = re.search(r"hop_dist\w*", e.key).group(0) if on_device else e.key
            kernels[name] = kernels.get(name, 0.0) + us / 1e3
            if on_device:
                hop_launches += e.count
    if dev_ms <= 0:
        log("[phase4] (h) wave profile: the profiler saw no device time: not measured")
        return {"wall_ms": wall_ms}
    log(f"[phase4] (h) one 16384-wave's device step: wall {wall_ms:.0f} ms unprofiled, device "
        f"time {dev_ms:.0f} ms (busy share {dev_ms / wall_ms:.2f}), by operator:")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:10]:
        log(f"[phase4]     {ms:8.1f} ms {ms / dev_ms:6.1%}  {name[:60]}")
    hop_ms = sum(ms for name, ms in kernels.items() if name.startswith("hop_dist"))
    log(f"[phase4] (h) the wave step's hop kernel: {hop_launches} launches, "
        f"{hop_ms / max(hop_launches, 1):.4f} ms a launch")
    return {"wall_ms": wall_ms, "device_ms": dev_ms, "hop_launches": hop_launches,
            "hop_ms_per_launch": hop_ms / max(hop_launches, 1)}


class WaveProbe:
    """Rebinds traversal.hop_dist_inline, the split hop as the beam loop
    calls it, for the length of a `with` block, and keeps the launches of
    the first wave of `keep_b` new nodes (a wave is a run of launches on one
    query tensor), each with a clone of its `chosen`, for wave_report() and
    replay_wave(). It reads nothing back from the card while the build runs
    and copies nothing after the kept wave."""

    def __init__(self, keep_b: int = 16384):
        self.keep_b = keep_b
        self.kept = []  # (q, nbr_vectors, level0, chosen, space) of the kept wave
        self._done = False

    def __enter__(self):
        from hnsw_tpu_torch.ops import traversal

        self._orig = orig = traversal.hop_dist_inline

        def probed(q, nbr_vectors, level0, chosen, space="l2"):
            if self.kept and q is not self.kept[0][0]:
                self._done = True  # the kept wave has ended
            if not self._done and chosen.shape[0] == self.keep_b:
                self.kept.append((q, nbr_vectors, level0, chosen.clone(), space))
            return orig(q, nbr_vectors, level0, chosen, space)

        traversal.hop_dist_inline = probed
        return self

    def __exit__(self, *exc):
        from hnsw_tpu_torch.ops import traversal

        traversal.hop_dist_inline = self._orig
        return False


def replay_wave(dev, kept) -> dict:
    """The kept wave's split-hop launches replayed cold, in order, on their
    own tensors: before each launch a 256 MB buffer is written (past the 50
    MB L2), and CUDA events around each launch give its device time. The
    card spins before every 32 launches so that they are queued before it
    runs them. Bound B per launch: each distinct block (its m0
    bf16 rows and ids) read once, q and chosen read, both outputs written
    once, at 3.35 TB/s."""
    import torch

    from hnsw_tpu_torch.ops import gather_kernels as gk

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    events = []
    for s in range(0, len(kept), 32):
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        for q, nbr, level0, chosen, space in kept[s:s + 32]:
            flush.fill_(s & 0xFF)
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            gk.hop_dist_inline(q, nbr, level0, chosen, space)
            t1.record()
            events.append((t0, t1))
    torch.cuda.synchronize()
    ms = sum(t0.elapsed_time(t1) for t0, t1 in events)
    bound_b = as_read = 0.0
    for q, nbr, level0, chosen, _ in kept:
        b, e = chosen.shape
        m0, d_pad = nbr.shape[1:]
        row = HOP_ROW_BYTES["bf16"](d_pad)
        blocks = int(torch.unique(chosen).numel())
        bound_b += (blocks * m0 * row + b * d_pad * 4 + b * e * 4 + b * e * m0 * 8) / PEAK_BYTES
        as_read += b * e * m0 * row / PEAK_BYTES
    del flush
    return {"launches": len(kept), "ms": ms, "bound_ms": bound_b * 1e3,
            "read_bound_ms": as_read * 1e3}


def wave_report(probe: WaveProbe, dev) -> dict:
    """The kept wave's launches after the build: B, E, the share of each
    launch's (query, chosen) pairs that name distinct node blocks
    (unique(chosen) / (B*E)) and the share on the sentinel row n_pad - 1 (a
    query whose beam has ended); its middle launch held to the plain
    version, and the wave replayed cold with row 6."""
    import torch

    from hnsw_tpu_torch.ops import gather_kernels as gk

    if not probe.kept:
        fail(f"(g) no wave of {probe.keep_b} new nodes ran")
    distinct = [torch.unique(c).numel() / c.numel() for *_, c, _ in probe.kept]
    sentinel = [float((c == lv.shape[0] - 1).float().mean()) for _, _, lv, c, _ in probe.kept]
    b, e = probe.kept[0][3].shape
    q, nbr, level0, chosen, space = probe.kept[len(probe.kept) // 2]
    dk, ik = gk.hop_dist_inline(q, nbr, level0, chosen, space)
    dp, ip_ = gk.hop_dist_inline_plain(q, nbr, level0, chosen, space)
    if not (torch.equal(ik, ip_) and torch.allclose(dk, dp, rtol=1e-5, atol=1e-4)):
        fail("(g) the replayed wave's split hop differs from its plain version")
    rep = replay_wave(dev, probe.kept)
    rep.update(distinct_median=float(np.median(distinct)),
               sentinel_median=float(np.median(sentinel)), sentinel_mean=float(np.mean(sentinel)))
    log(f"[phase4] (g) the first {probe.keep_b}-node wave: B={b} E={e}, {rep['launches']} "
        f"split-hop launches, distinct blocks {rep['distinct_median']:.3f} of B*E (median), on "
        f"the sentinel {rep['sentinel_median']:.3f} (median), {rep['sentinel_mean']:.3f} (mean); "
        f"replayed cold: {rep['ms']:.3f} ms summed, bound B {rep['bound_ms']:.3f} ms "
        f"({rep['bound_ms'] / rep['ms']:.0%}), bound as read {rep['read_bound_ms']:.3f} ms")
    return rep


def phase4(dev, launches, p2) -> tuple[dict, tuple]:
    import torch

    from hnsw_tpu_torch import BruteforceIndex, L2Space, SearchParams, bulk_build
    from hnsw_tpu_torch.core.graph import check_integrity, round_up
    from hnsw_tpu_torch.models import hnsw as thnsw
    from hnsw_tpu_torch.ops.gather_kernels import COUNTS, tier_bytes

    out = {}

    def build(name, x, m=M, tier="split", probe=None):
        """bulk_build with the counts set to 0 just before and read just
        after; the waves' hop kernel (the split hop, or the int8 hop on the
        int8 tier) and its launches go to the kernels line. A WaveProbe
        `probe` watches the split hop's launches."""
        kernel = "hop_dist_inline" if tier == "split" else "hop_dist_unified8"
        torch.cuda.synchronize()
        COUNTS.reset()
        t0 = time.time()
        with probe or contextlib.nullcontext():
            idx = bulk_build(x, space="l2", m=m, ef_construction=EF_C, verbose=True, device=dev)
        secs = time.time() - t0
        if COUNTS.plain_on_cuda:
            fail(f"({name}) a plain version ran on CUDA tensors {COUNTS.plain_on_cuda} times")
        if getattr(COUNTS, kernel) == 0:
            fail(f"({name}) {kernel} was never launched")
        launches[kernel] += getattr(COUNTS, kernel)
        stages = check_waves(name, idx, round_up(len(x) + 1, 128), tier)
        log(f"[phase4] ({name}) bulk_build N={len(x)} d={DIM} M={m} efC={EF_C}: {secs:.1f}s "
            f"({len(x) / secs:.0f} inserts/s), {kernel} launches {getattr(COUNTS, kernel)}")
        out[name] = {"build_s": secs, **stages, "waves": len(idx.wave_log)}
        return idx

    # (g) phase 2's dataset: the bulk-built graph against the host-built one
    x, q, gt = p2["data"]
    probe = WaveProbe()
    idx = build("g", x, probe=probe)
    out["g"]["wave_replay"] = wave_report(probe, dev)
    del probe
    check_integrity(idx.graph, require_inbound=False)
    if idx.rebuild_device_tables().tier != "unified":  # the waves' tier was split
        fail(f"(g) the finished index serves tier {idx._device.tier}, expected unified")
    _, lab_g, qps_g, c_g = run_mode(idx, "g", q, 2, launches, k=K, ef=200)
    need_launch("g", c_g, "hop_dist_unified")
    out["g"]["recall"] = rec = recall(lab_g, gt)
    host = p2["recall"]["b"]
    log(f"[phase4] (g) graph integrity ok; recall@10 at ef=200, 1024 queries: {rec:.4f} "
        f"(host-built graph {host:.4f}), {qps_g:.0f} qps on the {idx._device.tier} tier")
    if rec < 0.95 or rec < host - 0.02:
        fail(f"(g) recall {rec} below 0.95 or more than 0.02 under the host-built {host}")
    del idx

    # (i) the same data with the waves past the split budget: SPLIT_MAX_BYTES
    # below the split table and UNIFIED_MAX_BYTES at the int8 table's size
    # put every wave on the int8 unified tier, whose hop is then launched at
    # a wave's shape (B=16384, E=2); served afterwards on the default budgets
    n_pad = round_up(len(x) + 1, 128)
    saved = thnsw.UNIFIED_MAX_BYTES, thnsw.SPLIT_MAX_BYTES
    thnsw.SPLIT_MAX_BYTES = 0
    thnsw.UNIFIED_MAX_BYTES = tier_bytes(n_pad, max(16, round_up(2 * M, 16)), DIM)["unified8"]
    try:
        idx = build("i", x, tier="unified8")
    finally:
        thnsw.UNIFIED_MAX_BYTES, thnsw.SPLIT_MAX_BYTES = saved
    check_integrity(idx.graph, require_inbound=False)
    if idx.rebuild_device_tables().tier != "unified":
        fail(f"(i) the finished index serves tier {idx._device.tier}, expected unified")
    _, lab_i, _, c_i = run_mode(idx, "i", q, 2, launches, k=K, ef=200)
    need_launch("i", c_i, "hop_dist_unified")
    out["i"]["recall"] = rec_i = recall(lab_i, gt)
    log(f"[phase4] (i) graph integrity ok; recall@10 at ef=200, 1024 queries: {rec_i:.4f} "
        f"((g): {rec:.4f})")
    if rec_i < 0.95 or abs(rec_i - rec) > 0.02:
        fail(f"(i) recall {rec_i} below 0.95 or more than 0.02 from (g)'s {rec}")
    del idx

    # (w) a wide graph, M=32 (m0=64), on the first 30k of the same data: its
    # waves too run the split tier through hop_dist_inline
    xw = x[:N_WIDE]
    oracle = BruteforceIndex(L2Space(DIM), device=dev)
    oracle.add_items(xw, np.arange(N_WIDE))
    _, gt_w = oracle.search_knn(q, K)
    del oracle
    idx = build("w", xw, m=32)
    check_integrity(idx.graph, require_inbound=False)
    st = idx.rebuild_device_tables()  # the waves' tier was split
    if st.tier != "unified" or st.graph.level0.shape[1] != 64:
        fail(f"(w) serves tier {st.tier} at level-0 width {st.graph.level0.shape[1]}")
    del st
    _, lab_w, _, c_w = run_mode(idx, "w", q, 1, launches, k=K, ef=200)
    need_launch("w", c_w, "hop_dist_unified")
    out["w"]["recall"] = rec = recall(lab_w, gt_w)
    log(f"[phase4] (w) graph integrity ok; recall@10 at ef=200: {rec:.4f}")
    if rec < 0.95:
        fail(f"(w) recall {rec} < 0.95")
    del idx, x, xw
    torch.cuda.empty_cache()

    # (h) N=1M, the reference's 1M sweep data (seed 7, 4096 centers); 62k
    # upper nodes, so the upper hierarchy is itself bulk-built
    rng = np.random.default_rng(7)
    x = make_dataset(N_BULK, DIM, rng, n_clusters=4096)
    q = x[rng.integers(0, N_BULK, NQ_TIERS)] + 0.05 * rng.normal(
        size=(NQ_TIERS, DIM)).astype(np.float32)
    idx = build("h", x)
    out["h"]["wave_profile"] = profile_wave(idx, x, dev)
    oracle = BruteforceIndex(L2Space(DIM), device=dev)
    oracle.add_items(x, np.arange(N_BULK))
    _, gt = oracle.search_knn(q, K)
    del oracle
    torch.cuda.empty_cache()
    t0 = time.time()
    st = idx.rebuild_device_tables()
    torch.cuda.synchronize()
    log(f"[phase4] (h) rebuild_device_tables: {st.tier} table {st.unified.nbytes / 1e9:.3f} GB, "
        f"{time.time() - t0:.1f}s")
    if st.tier != "unified":
        fail(f"(h) the finished index serves tier {st.tier}, expected unified")
    del st
    params = SearchParams(k=K, ef=200, entry_seeds=4)
    _, lab_h, qps_h, c_h = run_mode(idx, "h", q, 2, launches, params=params)
    need_launch("h", c_h, "hop_dist_unified")
    out["h"]["recall"] = rec = recall(lab_h, gt)
    log(f"[phase4] (h) recall@10 at ef=200, 4 seeds, {NQ_TIERS} queries: {rec:.4f}, "
        f"{qps_h:.0f} qps")
    if rec < 0.95:
        fail(f"(h) recall {rec} < 0.95")

    # 1000 inserts into the finished index: a row delta, found at rank 1
    extra = x[rng.integers(0, N_BULK, 1000)] + 0.3 * rng.normal(
        size=(1000, DIM)).astype(np.float32)
    t0 = time.time()
    idx.add_items(extra, np.arange(N_BULK, N_BULK + 1000))
    t_add = time.time() - t0
    COUNTS.reset()
    t0 = time.time()
    _, lab_x = idx.search(extra, params=params)
    t_search = time.time() - t0
    found = float(np.mean(lab_x[:, 0] == np.arange(N_BULK, N_BULK + 1000)))
    log(f"[phase4] (h) 1000 inserts {t_add:.2f}s; sync {idx._last_sync_mode} + search "
        f"{t_search:.2f}s; found at rank 1: {found:.4f}")
    if idx._last_sync_mode != "delta":
        fail(f"(h) inserts synced as {idx._last_sync_mode}: {idx._last_sync_refusal}")
    if COUNTS.plain_on_cuda or found < 0.99:
        fail(f"(h) inserted vectors found at rank 1: {found}; plain_on_cuda "
             f"{COUNTS.plain_on_cuda}")
    out["h"]["inserts_found"] = found
    return out, (idx, q)  # (h)'s index for phase 6 (c)


# ---------------------------------------------------------------------------
# Phase 5: the deployment path (builder CLI, storage service, query service).
# ---------------------------------------------------------------------------

NQ_SERVE, N_SINGLE, N_CLIENTS = 1024, 256, 16
SERVE_MODES = {
    "speed": {"stop_frontier": 1.15, "max_iters": 14, "entry_seeds": 4, "ef": 160},
    "high_recall": {"rescore": 40, "entry_seeds": 4},
    "rank_only": {"frontier_rank": 200},
}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http(url: str, body: bytes | None = None, timeout: float = 600):
    """GET (no body) or POST a JSON body → the decoded JSON reply."""
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST" if body else "GET")
    req.add_header("Content-Type", "application/json")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def wait_ready(url: str, proc, log_path: str, timeout: float = 600):
    """Poll `url` until it answers; fail if the process `proc` (or None: a
    thread of this one) exits first or the time runs out."""
    t0 = time.time()
    while time.time() - t0 < timeout:
        if proc is not None and proc.poll() is not None:
            with open(log_path) as fh:
                fail(f"{url}: the service exited with {proc.returncode}:\n{fh.read()[-4000:]}")
        try:
            return http(url, timeout=10)
        except OSError:
            time.sleep(0.2)
    fail(f"{url}: no answer within {timeout} s")


def stop_all(procs) -> None:
    """Terminate every process in `procs` and wait for each (kill after
    30 s)."""
    for proc in procs:
        proc.terminate()
    for proc in procs:
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def result_ids(results, k=K) -> np.ndarray:
    """The ids of /search_batch's per-query result lists, -1 where a list is
    short."""
    out = np.full((len(results), k), -1, dtype=np.int64)
    for i, row in enumerate(results):
        ids = [r["id"] for r in row][:k]
        out[i, : len(ids)] = ids
    return out


def deployment_data() -> tuple[np.ndarray, np.ndarray]:
    """builder_cli's N=100k gaussian vectors (default_rng(123)) and the
    phase's 1,024 gaussian queries."""
    x = np.random.default_rng(123).normal(size=(N, DIM)).astype(np.float32)
    q = np.random.default_rng(SEED + 5).normal(size=(NQ_SERVE, DIM)).astype(np.float32)
    return x, q


def phase5(dev, launches, tmp: str) -> dict:
    """The deployment path as a user runs it, at the reference builder's
    default deployment (N=100k gaussian vectors, d=128, M=16, efC=200, k=10,
    ef=200): builder_cli writes the store and the index; the storage
    service runs as its own process; (a) the normal-mode query service in
    this process (so the launch counters can be read) over HTTP; (b) the
    optimized mode started as users start it; (c) the engine's int8 rung
    with --hbm_trim, in process. The deployment's files go to `tmp`, which
    the caller keeps for phase 7 (c) and removes."""
    import threading

    import torch

    from hnsw_tpu_torch import BruteforceIndex, HNSWIndex, L2Space
    from hnsw_tpu_torch.core.graph import round_up
    from hnsw_tpu_torch.models import hnsw as thnsw
    from hnsw_tpu_torch.ops.gather_kernels import COUNTS, tier_bytes
    from hnsw_tpu_torch.service import builder_cli
    from hnsw_tpu_torch.service import query_service as qs

    out: dict = {}
    db, ckpt = os.path.join(tmp, "vec_store.log"), os.path.join(tmp, "hnsw_index.npz")
    procs: list = []
    repo = os.path.dirname(os.path.abspath(__file__))
    unified_max = thnsw.UNIFIED_MAX_BYTES

    def start(name, args):
        path = os.path.join(tmp, f"{name}.log")
        fh = open(path, "w")
        proc = subprocess.Popen([sys.executable, "-m", *args], cwd=repo, stdout=fh,
                                stderr=subprocess.STDOUT)
        procs.append(proc)
        return proc, path

    try:
        t0 = time.time()
        builder_cli.main([str(N), str(DIM), db, ckpt, str(M), str(EF_C)])
        out["build_s"] = time.time() - t0
        log(f"[phase5] builder_cli N={N} d={DIM} M={M} efC={EF_C}: {out['build_s']:.1f}s "
            f"(store {os.path.getsize(db) / 1e6:.1f} MB, index "
            f"{os.path.getsize(ckpt) / 1e6:.1f} MB, adj {os.path.getsize(ckpt + '.adj') / 1e6:.1f} MB)")
        s_port = free_port()
        storage = f"http://127.0.0.1:{s_port}"
        s_proc, s_log = start("storage", ["hnsw_tpu_torch.service.storage_service", db,
                                          str(s_port)])
        if wait_ready(f"{storage}/info", s_proc, s_log)["count"] != N:
            fail("the storage service does not hold N vectors")

        x, q = deployment_data()
        oracle = BruteforceIndex(L2Space(DIM), device=dev)
        oracle.add_items(x, np.arange(N))
        _, gt = oracle.search_knn(q, K)
        del oracle
        cpu = HNSWIndex.load(ckpt, device=dev)
        _, lab_cpu, _ = cpu.search_cpu(q, k=K, ef=200)
        rec_cpu = recall(lab_cpu, gt)
        del cpu

        # (a) normal mode, served from a thread of this process
        t0 = time.time()
        eng = qs.build_engine(ckpt, False, storage, DIM, 200, K, modes=SERVE_MODES, device=dev)
        eng.warm_modes()
        start_a = time.time() - t0
        if eng.tier != "unified":
            fail(f"(a) the normal engine serves tier {eng.tier}, expected unified")
        a_port = free_port()
        url_a = f"http://127.0.0.1:{a_port}"
        threading.Thread(target=qs.serve, args=(eng, a_port), daemon=True).start()
        wait_ready(f"{url_a}/info", None, "")
        torch.cuda.synchronize()
        COUNTS.reset()
        labs, qps = {}, {}
        for mode in ("default", *SERVE_MODES):
            req = {"queries": q.tolist()}
            if mode != "default":
                req["mode"] = mode
            body = json.dumps(req).encode()
            times = []
            for _ in range(3):
                t = time.time()
                res = http(f"{url_a}/search_batch", body)
                times.append(time.time() - t)
            labs[mode] = result_ids(res["results"])
            qps[mode] = NQ_SERVE / float(np.median(times))
        # the same queries through the engine alone: what the HTTP front
        # end (JSON both ways) adds to a /search_batch
        times = []
        for _ in range(3):
            t = time.time()
            eng.search(q, K, 200)
            times.append(time.time() - t)
        qps["engine_default"] = NQ_SERVE / float(np.median(times))
        # single queries from 16 clients at once, coalesced by the
        # micro-batcher at the bucket of (k=10, ef=200)
        lat = []
        singles = [None] * N_SINGLE

        def client(rows):
            for i in rows:
                body = json.dumps({"query": q[i].tolist(), "k": K, "ef": 200}).encode()
                t = time.time()
                singles[i] = http(f"{url_a}/search", body)["results"]
                lat.append(time.time() - t)

        threads = [threading.Thread(target=client, args=(range(c, N_SINGLE, N_CLIENTS),))
                   for c in range(N_CLIENTS)]
        t0 = time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        single_s = time.time() - t0
        if any(t.is_alive() for t in threads):
            fail("(a) single /search clients still waiting after 600 s")
        kb, efb = qs._MicroBatcher._bucket(K, 200)
        at_bucket = http(f"{url_a}/search_batch", json.dumps(
            {"queries": q[:N_SINGLE].tolist(), "k": kb, "ef": efb}).encode())["results"]
        counts = {f: getattr(COUNTS, f) for f in launches}
        if COUNTS.plain_on_cuda:
            fail(f"(a) a plain version ran on CUDA tensors {COUNTS.plain_on_cuda} times")
        for f, c in counts.items():
            launches[f] += c
        need_launch("phase 5 (a)", counts, "hop_dist_unified", "gather_dist_rows")
        rec = {mode: recall(lab, gt) for mode, lab in labs.items()}
        bad = [i for i in range(N_SINGLE) if singles[i] is None or [
            (r["id"], r["distance"]) for r in singles[i]] != [
            (r["id"], r["distance"]) for r in at_bucket[i][:K]]]
        p50, p99 = (float(np.percentile(lat, p)) * 1e3 for p in (50, 99))
        mem_a = http(f"{url_a}/mem")["rss_kb"]
        log(f"[phase5] (a) normal mode: start-up {start_a:.1f}s (load + tables + warm), "
            f"tier {eng.tier}; /search_batch of {NQ_SERVE}: " + ", ".join(
                f"{m} recall@10 {rec[m]:.4f} at {qps[m]:.0f} qps" for m in rec)
            + f"; the engine alone {qps['engine_default']:.0f} qps (default mode)"
            + f"; native CPU engine (search_cpu, ef=200) {rec_cpu:.4f}")
        log(f"[phase5] (a) {N_SINGLE} single /search from {N_CLIENTS} clients: "
            f"{N_SINGLE / single_s:.0f} qps, latency p50 {p50:.2f} ms p99 {p99:.2f} ms; "
            f"{len(bad)} differ from /search_batch at the bucket (k={kb}, ef={efb}); "
            f"launches {counts}; /mem {mem_a} kB (this script's process)")
        if abs(rec["default"] - rec_cpu) > 0.01:
            fail(f"(a) default recall {rec['default']} not within 0.01 of the CPU engine's {rec_cpu}")
        if bad:
            fail(f"(a) {len(bad)} single answers differ from the batch answer at their bucket")
        if rec["high_recall"] < rec["default"]:
            fail(f"(a) high_recall {rec['high_recall']} below the default {rec['default']}")
        if not np.array_equal(labs["rank_only"], labs["default"]):
            fail("(a) rank_only does not serve the default mode's answers")

        # (b) the optimized mode, started as users start it
        b_port = free_port()
        url_b = f"http://127.0.0.1:{b_port}"
        t0 = time.time()
        b_proc, b_log = start("query_optimized", [
            "hnsw_tpu_torch.service.query_service", "--graph", ckpt, "--optimized", "1",
            "--storage", storage, "--port", str(b_port), "--dim", str(DIM)])
        info = wait_ready(f"{url_b}/info", b_proc, b_log)
        start_b = time.time() - t0
        if info["nodes"] != N or info["mode"] != "optimized":
            fail(f"(b) /info {info}")
        body = json.dumps({"queries": q.tolist()}).encode()
        times = []
        for _ in range(3):
            t = time.time()
            res = http(f"{url_b}/search_batch", body)
            times.append(time.time() - t)
        lab_b = result_ids(res["results"])
        same = float(np.mean((lab_b == labs["default"]).all(1)))
        mem_b = http(f"{url_b}/mem")["rss_kb"]
        # what any fresh process with torch and a CUDA context holds: the
        # floor under (b)'s RSS
        mem_floor = int(subprocess.run(
            [sys.executable, "-c", "import torch; torch.zeros(1, device='cuda'); "
             "from hnsw_tpu_torch.utils.rss import current_rss_kb; print(current_rss_kb())"],
            cwd=repo, capture_output=True, text=True, check=True, timeout=300,
        ).stdout.split()[-1])
        qps["optimized"] = NQ_SERVE / float(np.median(times))
        log(f"[phase5] (b) optimized mode (own process, .adj + one bulk fetch): start-up "
            f"{start_b:.1f}s to /info; {qps['optimized']:.0f} qps; {same:.4f} of the queries "
            f"return (a)'s ids; /mem {mem_b} kB against (a)'s {mem_a} kB; a fresh process "
            f"with torch and a CUDA context: {mem_floor} kB")
        if same < 0.999:
            fail(f"(b) only {same} of the queries return the normal mode's ids")

        # (c) the int8 rung with --hbm_trim, in process
        n_pad = round_up(N + 1, 128)
        thnsw.UNIFIED_MAX_BYTES = tier_bytes(n_pad, 2 * M, DIM)["unified8"]
        t0 = time.time()
        eng_c = qs.build_engine(ckpt, True, storage, DIM, 200, K, hbm_trim=True,
                                modes={"rescore40": {"rescore": 40}}, device=dev)
        eng_c.warm_modes()
        start_c = time.time() - t0
        if eng_c.tier != "unified8" or eng_c.x.dtype != torch.bfloat16:
            fail(f"(c) tier {eng_c.tier}, vectors {eng_c.x.dtype}: expected unified8 over bf16")
        (lab_c, lab_c40), _, counts_c = counted("5c", launches, lambda: (
            eng_c.search(q, K, 200)[1], eng_c.search(q, K, 200, mode="rescore40")[1]))
        need_launch("phase 5 (c)", counts_c, "hop_dist_unified8", "gather_dist_bf16")
        rec_c, rec_c40 = recall(lab_c, gt), recall(lab_c40, gt)
        log(f"[phase5] (c) optimized + hbm_trim on {eng_c.tier} (budget "
            f"{thnsw.UNIFIED_MAX_BYTES / 1e9:.3f} GB): start-up {start_c:.1f}s; recall@10 "
            f"auto rescore {rec_c:.4f}, rescore40 mode {rec_c40:.4f} ((a) {rec['default']:.4f}); "
            f"launches {counts_c}")
        if abs(rec_c - rec["default"]) > 0.02:
            fail(f"(c) recall {rec_c} not within 0.02 of (a)'s {rec['default']}")
        out.update(recall={**rec, "cpu_engine": rec_cpu, "c": rec_c, "c_rescore40": rec_c40},
                   qps=qps, single={"qps": N_SINGLE / single_s, "p50_ms": p50, "p99_ms": p99},
                   startup_s={"a": start_a, "b": start_b, "c": start_c},
                   rss_kb={"a": mem_a, "b": mem_b, "torch_cuda_floor": mem_floor},
                   optimized_same=same,
                   launches={"a": counts, "c": counts_c})
        del eng_c
        return out
    finally:
        thnsw.UNIFIED_MAX_BYTES = unified_max
        stop_all(procs)


# ---------------------------------------------------------------------------
# Phase 6: hnswlib interop and the calibrated speed mode.
# ---------------------------------------------------------------------------


def same_graph(a, b) -> bool:
    return (all(np.array_equal(getattr(a, f), getattr(b, f))
                for f in ("level0", "upper", "labels", "node_level"))
            and (a.entry_point, a.max_level) == (b.entry_point, b.max_level))


def round_trip(idx, path, dev) -> tuple:
    """save_hnswlib then from_hnswlib onto the card, with the seconds of the
    write, the import and the imported index's first (full) sync."""
    import torch

    from hnsw_tpu_torch import HNSWIndex

    t0 = time.time()
    idx.save_hnswlib(path)
    t_write = time.time() - t0
    t0 = time.time()
    imp = HNSWIndex.from_hnswlib(path, "l2", device=dev)
    t_import = time.time() - t0
    t0 = time.time()
    imp._sync_device()
    torch.cuda.synchronize()
    secs = {"bytes": os.path.getsize(path), "write_s": t_write, "import_s": t_import,
            "sync_s": time.time() - t0}
    return imp, secs


def same_answers(name, idx, imp, qs, launches, **kw) -> dict:
    """The imported index's labels equal the original's on every query, and
    its distances to 1e-5 relative."""
    d0, l0 = idx.search(qs, **kw)
    d1, l1, qps, counts = run_mode(imp, name, qs, 1, launches, **kw)
    same = float(np.mean((l1 == l0).all(1)))
    if same < 1.0 or not np.allclose(d1, d0, rtol=1e-5, atol=0):
        fail(f"({name}) the imported index returned the original's labels on {same:.4f} of "
             f"the queries; worst distance error {np.abs(d1 - d0).max()}")
    return {"qps": qps, "launches": counts}


def phase6(dev, launches, p2, big) -> dict:
    """(a) calibrate_speed_mode on phase 2's index (N=100k, d=128, M=16,
    efC=200), served at batch 8192 behind phase 2 (a)'s recall gate; (b) its
    .bin round trip, held to the original's answers at ef=200 and in phase 2
    (c)'s rescore mode; (c) the same for phase 4 (h)'s 1M bulk-built index."""
    import gc

    import torch

    idx, q, gt, pc = p2["serve"]
    out: dict = {}
    t_phase = time.time()

    # (a) the calibrated speed mode at the operating point
    sp, t_probe, probe = counted("6a", launches, lambda: idx.calibrate_speed_mode(
        k=K, ef=160, stop_frontier=1.15, entry_seeds=4))
    need_launch("6a probe", probe, "hop_dist_unified")
    _, lab, qps, counts = run_mode(idx, "6a", q, 5, launches, params=sp)
    need_launch("6a", counts, "hop_dist_unified")
    rec = recall(lab, gt)
    log(f"[phase6] (a) calibrate_speed_mode(k=10, ef=160, stop_frontier=1.15, entry_seeds=4): "
        f"max_iters {sp.max_iters} (bench.py's hand-set 14), probe of "
        f"{min(2048, idx.num_elements)} queries {t_probe:.2f}s; batch {len(q)}: recall@10 {rec:.4f}, {qps:.0f} qps (phase 2 (a) "
        f"{p2['recall']['a']:.4f}, {p2['qps']['a']:.0f} qps), hop launches "
        f"{counts['hop_dist_unified']} (probe {probe['hop_dist_unified']})")
    if rec < 0.95:
        fail(f"(6a) recall {rec} < 0.95")
    out["a"] = {"max_iters": sp.max_iters, "probe_s": t_probe, "recall": rec, "qps": qps,
                "launches": counts, "probe_launches": probe}

    tmp = tempfile.mkdtemp(prefix="hnsw_phase6_")
    try:
        # (b) the .bin round trip at 100k
        imp, secs = round_trip(idx, os.path.join(tmp, "n100k.bin"), dev)
        if not same_graph(imp.graph, idx.graph):
            fail("(6b) the imported graph differs from the original's")
        if not np.array_equal(imp._builder.export_vectors(), idx._builder.export_vectors()):
            fail("(6b) the imported vectors differ from the original's")
        qs = q[:1024]
        out["b"] = {**secs, "default": same_answers("6b", idx, imp, qs, launches, k=K, ef=200),
                    "rescore": same_answers("6b rescore", idx, imp, qs, launches, params=pc)}
        need_launch("6b", out["b"]["default"]["launches"], "hop_dist_unified")
        need_launch("6b rescore", out["b"]["rescore"]["launches"], "hop_dist_unified",
                    "gather_dist_rows")
        log(f"[phase6] (b) .bin round trip N={idx.num_elements}: {secs['bytes'] / 1e6:.1f} MB, write "
            f"{secs['write_s']:.2f}s, import {secs['import_s']:.2f}s, first sync "
            f"{secs['sync_s']:.2f}s; graph and vectors equal; labels equal on every one of "
            f"{len(qs)} queries at ef=200 ({out['b']['default']['qps']:.0f} qps) and with "
            f"rescore 40 ({out['b']['rescore']['qps']:.0f} qps)")
        del imp

        # (c) the .bin round trip of the 1M bulk-built index; the original is
        # synced afresh first, so both serve a full sync of the same graph
        bidx, bq = big
        bidx.rebuild_device_tables()
        imp, secs = round_trip(bidx, os.path.join(tmp, "n1m.bin"), dev)
        out["c"] = {**secs, "default": same_answers("6c", bidx, imp, bq, launches, k=K, ef=200)}
        need_launch("6c", out["c"]["default"]["launches"], "hop_dist_unified")
        log(f"[phase6] (c) .bin round trip N={bidx.num_elements}: {secs['bytes'] / 1e6:.1f} "
            f"MB, write {secs['write_s']:.2f}s, import {secs['import_s']:.2f}s, first sync "
            f"{secs['sync_s']:.2f}s; labels equal on every one of {len(bq)} queries at "
            f"ef=200 ({out['c']['default']['qps']:.0f} qps)")
        del imp
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.time() - t_phase
    log(f"[phase6] {out['seconds']:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 7: range search, multi-vector documents and the native frontends.
# ---------------------------------------------------------------------------

EPS_RANK, EPS_MAX = 100, 256  # epsilon: the median 100th-nearest distance
N_DOC, PER_DOC, DOC_SPREAD = 3125, 32, 0.5  # 100,000 token vectors
K_DOCS, OVERSAMPLE, EF_DOCS = 10, 4, 200
# absolute recall floors under the readings on the H100 (PERF.md section
# 2): (a) 0.9989 in-range recall on both engines, where a ladder that never
# widened past its first beam of 64 reads about 0.63; (b) 0.9926 device and
# 0.9949 CPU-engine document recall@10
RANGE_RECALL_MIN, DOC_RECALL_MIN = 0.99, 0.98
N_OPTIMIZED = 64  # the optimized native mode's requests (about 0.7 s each)
N_OPT_CLIENTS = 8  # sent at once: the port's query_main copies a hop's vectors under the lock


class LadderLog:
    """A pass-through index that records each widening step: (k, ef) and
    the step's (dists, labels)."""

    def __init__(self, index):
        self.index = index
        self.steps: list = []

    @property
    def num_elements(self) -> int:
        return self.index.num_elements

    @property
    def dim(self) -> int:
        return self.index.dim

    def search(self, queries, k, ef):
        out = self.index.search(queries, k=k, ef=ef)
        self.steps.append((k, ef, out))
        return out

    def search_cpu(self, queries, k, ef):
        out = self.index.search_cpu(queries, k=k, ef=ef)
        self.steps.append((k, ef, out[:2]))
        return out


def phase7_range(dev, launches, p2, smi) -> dict:
    """(a) epsilon_search on phase 2's index (N=100k clustered, d=128,
    M=16, efC=200, bf16 tier) over its first 1,024 queries, epsilon the
    median exact 100th-nearest squared distance, min_candidates=1,
    max_candidates=256, ef=0, through the device beam and the native CPU
    engine."""
    from hnsw_tpu_torch import BruteforceIndex, L2Space, epsilon_search

    idx, q_all, _, _ = p2["serve"]
    x, q = p2["data"][0], q_all[:NQ_TIERS]
    oracle = BruteforceIndex(L2Space(DIM), device=dev)
    oracle.add_items(x, np.arange(N))
    gt_d, gt = oracle.search_knn(q, EPS_MAX)
    del oracle
    eps = float(np.median(gt_d[:, EPS_RANK - 1]))
    # the exact within-epsilon set, capped at max_candidates
    truth = [set(gt[i][gt_d[i] <= eps].tolist()) for i in range(len(q))]
    n_true = sum(len(t) for t in truth)
    out: dict = {"epsilon": eps, "true_points": n_true}
    for engine in ("device", "cpu"):
        ladder = LadderLog(idx)
        (d, lab, valid), secs, counts = counted(
            f"7a {engine}", launches, lambda: epsilon_search(
                ladder, q, eps, min_candidates=1, max_candidates=EPS_MAX, ef=0,
                engine=engine))
        if d.shape != (len(q), EPS_MAX) or not valid[:, 0].all():
            fail(f"(7a {engine}) malformed results")
        exact, tol, err = read_distances(q, x, lab, d, bf16=engine == "device")
        if err > 1.0:
            fail(f"(7a {engine}) a returned distance is not its label's exact one "
                 f"({err:.3f} of tolerance)")
        if (valid[:, 1:] & ~(exact[:, 1:] <= eps + tol[:, 1:])).any():
            fail(f"(7a {engine}) a valid point past rank 1 lies beyond epsilon")
        if any(len(set(r[v].tolist())) != int(v.sum()) for r, v in zip(lab, valid)):
            fail(f"(7a {engine}) a label appears twice in a row")
        found = sum(len(set(lab[i][valid[i]].tolist()) & truth[i]) for i in range(len(q)))
        # queries whose beam was saturated with in-range points at each step
        sat = [int(np.all((sd[:, :k] <= eps) & (sl[:, :k] >= 0), axis=1).sum())
               for k, _, (sd, sl) in ladder.steps]
        out[engine] = {"recall": found / n_true, "seconds": secs, "steps": [s[0] for s in ladder.steps],
                       "saturated": sat, "valid": int(valid.sum()), "distance_error": err,
                       "launches": counts}
    dv, cp = out["device"], out["cpu"]
    need_launch("7a device", dv["launches"], "hop_dist_unified")
    log(f"[phase7] (a) epsilon_search, N={N} clustered, {len(q)} queries, epsilon {eps:.4f} "
        f"(median exact {EPS_RANK}th-nearest), max_candidates {EPS_MAX}: {n_true} points in "
        f"range; device: beams {dv['steps']}, saturated {dv['saturated']} (queries that "
        f"widened), recall {dv['recall']:.4f}, {dv['seconds']:.2f}s, hop launches "
        f"{dv['launches']['hop_dist_unified']}, distance error {dv['distance_error']:.3f} of "
        f"tolerance; CPU engine: beams {cp['steps']}, saturated {cp['saturated']}, recall "
        f"{cp['recall']:.4f}, {cp['seconds']:.2f}s, {cp['distance_error']:.3f} of tolerance "
        f"({smi})")
    for engine in ("device", "cpu"):
        if out[engine]["recall"] < RANGE_RECALL_MIN:
            fail(f"(7a {engine}) recall {out[engine]['recall']} under {RANGE_RECALL_MIN}")
    if dv["recall"] < cp["recall"] - 0.01:
        fail(f"(7a) device recall {dv['recall']} more than 0.01 under the CPU engine's {cp['recall']}")
    return out, (eps, truth)  # the exact in-range sets, for phase 8 (i)


def read_distances(q, x, lab, d, bf16) -> tuple[np.ndarray, np.ndarray, float]:
    """The exact float64 distance of each returned (query, label) to the row
    the search read, its tolerance, and the worst error of the returned `d`
    against it over that tolerance. The tolerance is 1e-5 of the distance
    plus 1e-6 of |q|^2 + |x|^2 (an f32 norm expansion's rounding). With
    `bf16` the row read is the f32 or the bf16 one, whichever lies nearer
    `d` (the bf16 tier's hops read bf16 rows, a descent entry its f32 row).
    Empty slots (label < 0 or `d` not finite) read inf, tolerance 1."""
    import torch

    exact, tol = np.full(lab.shape, np.inf), np.ones(lab.shape)
    worst = 0.0
    for lo in range(0, len(q), 64):
        sl = slice(lo, lo + 64)
        qq = q[sl].astype(np.float64)[:, None, :]
        dd = d[sl].astype(np.float64)
        ok = (lab[sl] >= 0) & np.isfinite(dd)
        rows = x[np.where(ok, lab[sl], 0)]
        r = ((qq - rows.astype(np.float64)) ** 2).sum(-1)
        if bf16:
            rb = ((qq - torch.from_numpy(rows).bfloat16().double().numpy()) ** 2).sum(-1)
            r = np.where(np.abs(dd - r) <= np.abs(dd - rb), r, rb)
        t = 1e-5 * r + 1e-6 * ((qq ** 2).sum(-1) + (rows.astype(np.float64) ** 2).sum(-1))
        worst = max(worst, float((np.abs(dd - r) / t)[ok].max(initial=0.0)))
        exact[sl], tol[sl] = np.where(ok, r, np.inf), np.where(ok, t, 1.0)
    return exact, tol, worst


def doc_distance_error(q, x, dd, docs, beam, doc_of, bf16) -> float:
    """Worst error, over the tolerance, of each final-beam vector's distance
    against its exact one (read_distances) and of a returned document's
    distance against the min over its vectors in that beam (wherever each
    was found) of their exact distances."""
    beam_d, beam_l = beam
    exact, tol, worst = read_distances(q, x, beam_l, beam_d, bf16)
    beam_doc = np.where(beam_l >= 0, doc_of[np.maximum(beam_l, 0)], -1)
    for i in range(len(q)):
        for dist, doc in zip(dd[i].tolist(), docs[i].tolist()):
            cand = np.flatnonzero((beam_doc[i] == doc) & np.isfinite(exact[i]))
            j = cand[np.argmin(exact[i, cand])]
            worst = max(worst, abs(dist - exact[i, j]) / tol[i, j])
    return worst


def phase7_docs(dev, launches, smi) -> dict:
    """(b) MultiVectorIndex on the card: 3,125 documents of 32 vectors
    (N=100k, d=128, late-interaction token embeddings' shape), built through
    add_document (the threaded host build), 1,024 queries near a random
    document's vector, k_docs=10, oversample=4, ef=200, through the device
    beam and the native CPU engine; held to the exact per-document min."""
    from hnsw_tpu_torch import BruteforceIndex, L2Space, MultiVectorIndex

    rng = np.random.default_rng(SEED + 7)
    centres = make_dataset(N_DOC, DIM, rng)
    x = (np.repeat(centres, PER_DOC, axis=0)
         + DOC_SPREAD * rng.normal(size=(N_DOC * PER_DOC, DIM))).astype(np.float32)
    q = x[rng.integers(0, len(x), NQ_TIERS)] + 0.05 * rng.normal(
        size=(NQ_TIERS, DIM)).astype(np.float32)
    doc_of = np.repeat(np.arange(N_DOC), PER_DOC)

    t0 = time.time()
    mv = MultiVectorIndex("l2", dim=DIM, m=M, ef_construction=EF_C, device=dev)
    for doc in range(N_DOC):
        mv.add_document(doc, x[doc * PER_DOC:(doc + 1) * PER_DOC])
    build_s = time.time() - t0
    if mv.num_docs != N_DOC or mv.index.num_elements != len(x):
        fail(f"(7b) {mv.num_docs} documents, {mv.index.num_elements} vectors")

    # the exact top documents: the first K_DOCS distinct documents of the
    # exact top K_DOCS * PER_DOC vectors (which hold at least K_DOCS)
    oracle = BruteforceIndex(L2Space(DIM), device=dev)
    oracle.add_items(x, np.arange(len(x)))
    _, gt = oracle.search_knn(q, K_DOCS * PER_DOC)
    del oracle
    true_docs = [list(dict.fromkeys(doc_of[r].tolist()))[:K_DOCS] for r in gt]

    index = mv.index
    mv.index.search(q[:16], k=K, ef=EF_DOCS)  # the first (full) device sync
    out: dict = {"build_s": build_s}
    for engine in ("device", "cpu"):
        mv.index = LadderLog(index)
        (dd, docs), secs, counts = counted(
            f"7b {engine}", launches, lambda: mv.search(
                q, k_docs=K_DOCS, ef=EF_DOCS, oversample=OVERSAMPLE, engine=engine))
        steps = mv.index.steps
        mv.index = index
        if docs.shape != (len(q), K_DOCS) or (docs < 0).any() or any(
                len(set(r)) != K_DOCS for r in docs.tolist()):
            fail(f"(7b {engine}) a query did not get {K_DOCS} distinct documents")
        err = doc_distance_error(q, x, dd, docs, steps[-1][2], doc_of, bf16=engine == "device")
        rec = float(np.mean([len(set(docs[i].tolist()) & set(true_docs[i])) / K_DOCS
                             for i in range(len(q))]))
        out[engine] = {"recall": rec, "seconds": secs, "qps": len(q) / secs,
                       "steps": [s[0] for s in steps], "distance_error": err,
                       "launches": counts}
        if err > 1.0:
            fail(f"(7b {engine}) a document's distance is not the min over its vectors' "
                 f"exact distances ({err:.3f} of tolerance)")
    dv, cp = out["device"], out["cpu"]
    need_launch("7b device", dv["launches"], "hop_dist_unified")
    log(f"[phase7] (b) MultiVectorIndex, {N_DOC} documents x {PER_DOC} vectors (N={len(x)}, "
        f"d={DIM}, M={M}, efC={EF_C}), add_document build {build_s:.1f}s; {len(q)} queries, "
        f"k_docs {K_DOCS}, oversample {OVERSAMPLE}, ef {EF_DOCS}: device beams {dv['steps']}, "
        f"recall@10 {dv['recall']:.4f}, {dv['qps']:.0f} qps, hop launches "
        f"{dv['launches']['hop_dist_unified']}, distance error {dv['distance_error']:.3f} of "
        f"tolerance; CPU engine beams {cp['steps']}, recall@10 {cp['recall']:.4f}, "
        f"{cp['qps']:.0f} qps, {cp['distance_error']:.3f} of tolerance ({smi})")
    for engine in ("device", "cpu"):
        if out[engine]["recall"] < DOC_RECALL_MIN:
            fail(f"(7b {engine}) recall@10 {out[engine]['recall']} under {DOC_RECALL_MIN}")
    if dv["recall"] < cp["recall"] - 0.01:
        fail(f"(7b) device recall {dv['recall']} more than 0.01 under the CPU engine's {cp['recall']}")
    return out, (x, q, doc_of, true_docs)  # for phase 8 (i)


def single_searches(url, q, clients: int = 1) -> tuple[list, list, float]:
    """POST one /search (k=K) per query from `clients` clients at once (query
    i from client i % clients) → (each query's results, latencies in
    seconds, wall seconds)."""
    import threading

    results, lat = [None] * len(q), []

    def client(rows):
        for i in rows:
            body = json.dumps({"query": q[i].tolist(), "k": K}).encode()
            t = time.time()
            results[i] = http(url, body)["results"]
            lat.append(time.time() - t)

    threads = [threading.Thread(target=client, args=(range(c, len(q), clients),))
               for c in range(clients)]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads) or any(r is None for r in results):
        fail(f"(7c) /search clients got no answer within 600 s ({url})")
    return results, lat, time.time() - t0


def phase7_native(dev, tmp, smi) -> dict:
    """(c) The native frontends on phase 5's deployment (N=100k gaussian,
    d=128, M=16, efC=200, its .adj): build_binary's storage_main, loaded
    through /vec/put_batch, and query_main in normal and optimized mode at
    --ef 200, single /search (k=10), 256 to the normal mode one at a time
    and the first N_OPTIMIZED of them to the optimized one from
    N_OPT_CLIENTS clients at once, each held to the port's search_cpu on the
    same graph at ef=200: the same ids on every query."""
    import urllib.request

    from hnsw_tpu_torch import BruteforceIndex, HNSWIndex, L2Space
    from hnsw_tpu_torch.native import build_binary

    ckpt = os.path.join(tmp, "hnsw_index.npz")
    t0 = time.time()
    bins = {name: build_binary(name) for name in ("storage_main", "query_main")}
    build_s = time.time() - t0
    x, q = deployment_data()
    q = q[:N_SINGLE]
    _, lab_cpu, _ = HNSWIndex.load(ckpt, device=dev).search_cpu(q, k=K, ef=200)
    oracle = BruteforceIndex(L2Space(DIM), device=dev)
    oracle.add_items(x, np.arange(N))
    _, gt = oracle.search_knn(q, K)
    del oracle
    rec_cpu = recall(lab_cpu, gt)
    ref_sets = [set(r.tolist()) for r in lab_cpu]
    procs: list = []
    out: dict = {"build_s": build_s, "cpu_engine_recall": rec_cpu}

    def start(name, args):
        path = os.path.join(tmp, f"native_{name}.log")
        with open(path, "w") as fh:
            procs.append(subprocess.Popen(args, stdout=fh, stderr=subprocess.STDOUT))
        return procs[-1], path

    try:
        s_port = free_port()
        storage = f"http://127.0.0.1:{s_port}"
        s_proc, s_log = start("storage", [bins["storage_main"], os.path.join(tmp, "native.log"),
                                          str(s_port)])
        wait_ready(f"{storage}/info", s_proc, s_log)
        t0 = time.time()
        for lo in range(0, N, 10_000):
            rec = np.zeros(min(10_000, N - lo), dtype=[("id", "<u4"), ("vec", "<f4", (DIM,))])
            rec["id"] = np.arange(lo, lo + len(rec))
            rec["vec"] = x[lo:lo + len(rec)]
            req = urllib.request.Request(
                f"{storage}/vec/put_batch", data=struct.pack("<II", len(rec), DIM) + rec.tobytes(),
                method="POST")
            with urllib.request.urlopen(req, timeout=600) as r:
                if r.read() != b"OK":
                    fail("(7c) /vec/put_batch did not answer OK")
        out["load_s"] = time.time() - t0
        if http(f"{storage}/info")["count"] != N:
            fail("(7c) the native storage does not hold N vectors")
        xsq = (x.astype(np.float64) ** 2).sum(-1)
        for mode, flag, nq, clients in (("normal", "0", N_SINGLE, 1),
                                        ("optimized", "1", N_OPTIMIZED, N_OPT_CLIENTS)):
            port = free_port()
            url = f"http://127.0.0.1:{port}"
            t0 = time.time()
            proc, path = start(mode, [bins["query_main"], "--graph", ckpt + ".adj", "--storage",
                                      storage, "--port", str(port), "--dim", str(DIM), "--ef",
                                      "200", "--optimized", flag])
            info = wait_ready(f"{url}/info", proc, path)
            start_s = time.time() - t0
            if (info["nodes"], info["dim"], info["ef"], info["mode"]) != (N, DIM, 200, mode):
                fail(f"(7c {mode}) /info {info}")
            results, lat, secs = single_searches(f"{url}/search", q[:nq], clients)
            ids = np.full((nq, K), -1, dtype=np.int64)
            worst = 0.0
            for i, res in enumerate(results):
                got = np.array([r["id"] for r in res], dtype=np.int64)
                dist = np.array([r["distance"] for r in res], dtype=np.float64)
                if len(got) != K or (np.diff(dist) < 0).any():
                    fail(f"(7c {mode}) query {i}: {len(got)} results, not ascending")
                ids[i] = got
                exact = ((q[i].astype(np.float64) - x[got].astype(np.float64)) ** 2).sum(-1)
                worst = max(worst, float((np.abs(dist - exact) / (
                    1e-5 * exact + 1e-6 * (xsq[got] + float(q[i].astype(np.float64) @ q[i])))).max()))
            same = sum(set(ids[i].tolist()) == ref_sets[i] for i in range(nq))
            rss = http(f"{url}/mem")["rss_kb"]
            p50 = float(np.median(lat)) * 1e3
            out[mode] = {"queries": nq, "same_as_search_cpu": same, "recall": recall(ids, gt[:nq]),
                         "search_cpu_recall": recall(lab_cpu[:nq], gt[:nq]), "p50_ms": p50,
                         "p99_ms": float(np.percentile(lat, 99)) * 1e3, "rss_kb": rss,
                         "start_s": start_s, "distance_error": worst, "qps": nq / secs,
                         "clients": clients}
            log(f"[phase7] (c) native query_main, {mode} mode, --ef 200: start-up {start_s:.2f}s, "
                f"{nq} single /search from {clients} client(s) at once, {nq / secs:.1f} qps: "
                f"{same} of {nq} return search_cpu's ids, recall@10 "
                f"{out[mode]['recall']:.4f} (search_cpu {out[mode]['search_cpu_recall']:.4f}), distances "
                f"{worst:.3f} of tolerance, p50 {p50:.2f} ms p99 {out[mode]['p99_ms']:.2f} ms, "
                f"RSS {rss} kB" + (" (PR 15, one request at a time: 43-47 MB)" if clients > 1 else "")
                + f" ({smi})")
            if worst > 1.0:
                fail(f"(7c {mode}) returned distances differ from the exact ones")
            proc.terminate()
            proc.wait(timeout=30)
        out["storage_rss_kb"] = http(f"{storage}/mem")["rss_kb"]
        log(f"[phase7] (c) build_binary {build_s:.1f}s, native storage loaded by /vec/put_batch "
            f"in {out['load_s']:.2f}s, RSS {out['storage_rss_kb']} kB ({smi})")
    finally:
        stop_all(procs)
    # both modes must return search_cpu's ids on every query: the normal mode
    # reads its own table, the optimized one a hop's own copies of the
    # fetched vectors, which another request's cache clear cannot touch
    for mode in ("normal", "optimized"):
        r = out[mode]
        if r["same_as_search_cpu"] != r["queries"]:
            fail(f"(7c {mode}) {r['queries'] - r['same_as_search_cpu']} of {r['queries']} answers "
                 f"differ from search_cpu's ids")
    return out


# ---------------------------------------------------------------------------
# Phase 8: the sharded index in one process.
# ---------------------------------------------------------------------------

N_SHARDS = 8
N_ADD, N_UPD = 1000, 64  # phase 8 (f)'s inserts and in-place updates
# phase 2 (a)'s speed mode, on the sharded index (phases 8 (b), (e) and 9)
SHARD_SPEED = dict(k=K, ef=160, expand=2, stop_frontier=1.15, max_iters=14, entry_seeds=4)


def orphans(g) -> np.ndarray:
    """Labels of a host graph's nodes that no level-0 edge points to."""
    hit = np.zeros(g.num_nodes, dtype=bool)
    hit[g.level0[g.level0 >= 0]] = True
    return g.labels[~hit]


def phase8(dev, launches, p2, ranged, docs, setdir, smi) -> dict:
    """ShardedHNSWIndex at phase 2's operating point: phase 2's N=100k
    clustered vectors in 8 shards (d=128, M=16, efC=200, k=10) on the card,
    built by `build` (threaded, as users build), phase 2's 1,024 queries:
    (a) the default descent at ef=200, held to phase 2 (b)'s single index,
    with each shard's orphans (nodes no level-0 edge reaches) logged beside
    the single index's; (b) the speed mode; (c) deletes, and a shared filter
    of even labels, which leaves four shards nothing eligible; (d) every
    shard on the int8 rung through the index's ladder, with the shard-local
    rescore (rows 3 and 2); (e) save() into `setdir` (phase 9 loads it) and
    load(), held to (a), whose answers at ef=200 and in the speed mode are
    phase 9's reference; (f) add_items of 1,000 new vectors and 64 in-place
    updates, synced as row deltas and held to a rebuild at the same rung;
    (g) the ladder at budgets between rungs: int4 over bf16 storage (rows 4
    and 5) and the split rung (row 6); (h) the trim configuration (bf16
    storage, int8 without side tables, no upper tables: rows 3 and 5),
    whose add_items syncs in full; (i) epsilon_search against phase 7 (a)'s
    exact in-range sets, and a MultiVectorIndex over a sharded index of
    phase 7 (b)'s documents, built by add_document."""
    import torch

    from hnsw_tpu_torch import BruteforceIndex, L2Space, MultiVectorIndex, epsilon_search
    from hnsw_tpu_torch.core.graph import round_up
    from hnsw_tpu_torch.ops.gather_kernels import tier_bytes
    from hnsw_tpu_torch.parallel.sharding import ShardedHNSWIndex

    x, q, gt = p2["data"]
    gt_d = p2["gt_d"]
    out: dict = {"step_s": {}}  # wall seconds of each step, build and sync in (a)
    prefix = os.path.join(setdir, "sharded")
    last = time.time()

    def step(name):
        nonlocal last
        out["step_s"][name], last = time.time() - last, time.time()

    def new_index(bf16=False):
        idx = ShardedHNSWIndex("l2", DIM, num_shards=N_SHARDS, m=M, ef_construction=EF_C,
                               device=dev)
        if bf16:
            idx.space = L2Space(DIM, storage_dtype=torch.bfloat16)
        return idx

    def tiers_of(name, idx, tier) -> list:
        """(tier, n_pad) of every shard after the index's sync; fails unless
        the index and every shard serve `tier`."""
        idx._sync()
        tiers = [(s._device.tier, s._device.graph.n_pad) for s in idx._shards]
        if idx._tier != tier or any(t != tier for t, _ in tiers):
            fail(f"({name}) the index serves {idx._tier}, its shards {[t for t, _ in tiers]}, "
                 f"expected {tier} on every one")
        return tiers

    def between(idx, lo, hi) -> int:
        """A per-shard budget between two rungs' bytes at the largest shard's
        n_pad."""
        n = max(len(labs) for labs in idx._shard_labels)
        need = tier_bytes(round_up(n + 1 + n // 16, 128), 2 * M, DIM)
        return (need[lo] + need[hi]) // 2

    t0 = time.time()
    idx = new_index()
    idx.build(x)
    out["build_s"] = time.time() - t0
    if idx.num_elements != N:
        fail(f"(8) the index holds {idx.num_elements} vectors")
    t0 = time.time()
    tiers = tiers_of("8a", idx, "unified")
    torch.cuda.synchronize()
    out["sync_s"], out["n_pad"] = time.time() - t0, [n for _, n in tiers]
    # orphans: nodes no level-0 edge reaches, which a beam finds only as its
    # entry; the exact top-10 slots they hold bound the recall they can cost
    orph = [orphans(s.graph) for s in idx._shards]
    orph_single = orphans(p2["serve"][0].graph)
    out["orphans"] = {"per_shard": [len(o) for o in orph], "single": len(orph_single),
                      "gt_slots": int(np.isin(gt, np.concatenate(orph)).sum()),
                      "gt_slots_single": int(np.isin(gt, orph_single).sum())}
    log(f"[phase8] ShardedHNSWIndex, N={N} in {N_SHARDS} shards (d={DIM}, M={M}, "
        f"efC={EF_C}), threaded build {out['build_s']:.1f}s, device sync "
        f"{out['sync_s']:.1f}s; the default ladder's one rung, per shard tier/n_pad: "
        + ", ".join(f"{t}/{n}" for t, n in tiers) + f"; nodes no level-0 edge reaches: "
        f"{out['orphans']['per_shard']} per shard ({sum(out['orphans']['per_shard'])} of {N}; "
        f"phase 2's single index {len(orph_single)}), holding {out['orphans']['gt_slots']} of "
        f"the {gt.size} exact top-10 slots (single index {out['orphans']['gt_slots_single']}) "
        f"({smi})")

    # (a) the default descent at ef=200
    d_a, lab_a, qps_a, c_a = run_mode(idx, "8a", q, 2, launches, warm=False, k=K, ef=200)
    need_launch("8a", c_a, "hop_dist_unified")
    rec_a = recall(lab_a, gt)
    worst = read_distances(q, x, lab_a, d_a, bf16=True)[2]
    residues = len(set((lab_a[:, 0] % N_SHARDS).tolist()))
    out["a"] = {"recall": rec_a, "qps": qps_a, "launches": c_a, "distance_error": worst,
                "top1_residues": residues}
    log(f"[phase8] (a) default descent ef=200, {len(q)} queries: recall@10 {rec_a:.4f} "
        f"(single index, phase 2 (b): {p2['recall']['b']:.4f}), {qps_a:.0f} qps, hop "
        f"launches {c_a['hop_dist_unified']}, distances {worst:.3f} of tolerance, top-1 "
        f"labels on {residues} residues mod {N_SHARDS} ({smi})")
    if rec_a < max(p2["recall"]["b"] - 0.01, 0.95):
        fail(f"(8a) recall {rec_a} under 0.95 or more than 0.01 under the single index's "
             f"{p2['recall']['b']}")
    if (np.diff(d_a, axis=1) < 0).any() or any(len(set(r)) != K for r in lab_a.tolist()):
        fail("(8a) rows not ascending, or a label twice in a row")
    if worst > 1.0:
        fail(f"(8a) returned distances differ from the exact ones ({worst:.3f} of tolerance)")
    if residues != N_SHARDS:
        fail(f"(8a) the top-1 labels span {residues} residues mod {N_SHARDS}")

    step("a")
    # (b) the speed mode
    _, lab_b, qps_b, c_b = run_mode(idx, "8b", q, 2, launches, warm=False, **SHARD_SPEED)
    need_launch("8b", c_b, "hop_dist_unified")
    rec_b = recall(lab_b, gt)
    out["b"] = {"recall": rec_b, "qps": qps_b, "launches": c_b}
    log(f"[phase8] (b) speed mode (ef 160, expand 2, frontier 1.15, max_iters 14, 4 seeds): "
        f"recall@10 {rec_b:.4f}, {qps_b:.0f} qps, hop launches {c_b['hop_dist_unified']} ({smi})")
    if rec_b < 0.95:
        fail(f"(8b) recall {rec_b} < 0.95")

    step("b")
    # (c) deletes, then a shared filter of even labels
    victims = np.unique(lab_a[:64, 0])
    for v in victims:
        idx.mark_deleted(int(v))
    _, lab_del, _, c_del = run_mode(idx, "8c deleted", q, 1, launches, warm=False, k=K, ef=200)
    back = int(np.isin(lab_del, victims).sum())
    for v in victims:
        idx.unmark_deleted(int(v))
    _, lab_un, _, c_un = run_mode(idx, "8c unmarked", q, 1, launches, warm=False, k=K, ef=200)
    same = int((lab_un == lab_a).all(axis=1).sum())
    even = np.arange(N) % 2 == 0
    _, lab_f, qps_f, c_f = run_mode(idx, "8c filter", q, 1, launches, warm=False, k=K, ef=200,
                                    filter_labels=even)
    oracle = BruteforceIndex(L2Space(DIM), device=dev)
    oracle.add_items(x[even], np.flatnonzero(even))
    _, gt_even = oracle.search_knn(q, K)
    del oracle
    rec_f = recall(lab_f, gt_even)
    out["c"] = {"victims": len(victims), "victims_returned": back, "unmarked_same": same,
                "filter_recall": rec_f, "filter_qps": qps_f,
                "launches": {f: c_del[f] + c_un[f] + c_f[f] for f in launches}}
    log(f"[phase8] (c) {len(victims)} top-1 labels of the first 64 queries delete-marked: "
        f"{back} come back; unmarked: {same} of {len(q)} queries return (a)'s labels; "
        f"even-label filter (shards 1, 3, 5, 7 hold nothing eligible): recall@10 {rec_f:.4f} "
        f"against the exact even-label oracle, {qps_f:.0f} qps ({smi})")
    if back:
        fail(f"(8c) {back} delete-marked labels returned")
    if not (lab_un[:64] == lab_a[:64]).all():
        fail("(8c) after unmark_deleted the first 64 queries do not return (a)'s labels")
    if (lab_f < 0).any() or (lab_f % 2).any():
        fail("(8c) the even-label filter returned an odd or missing label")
    if rec_f < 0.95:
        fail(f"(8c) filtered recall {rec_f} < 0.95")

    step("c")
    # (d) every shard on the int8 rung: f32 storage, auto rescore of 40
    t0 = time.time()
    idx.rebuild_device_tables(between(idx, "unified8", "unified"))
    tiers_of("8d", idx, "unified8")
    torch.cuda.synchronize()
    sync_d = time.time() - t0
    d_d, lab_d, qps_d, c_d = run_mode(idx, "8d", q, 2, launches, warm=False, k=K, ef=200)
    need_launch("8d", c_d, "hop_dist_unified8", "gather_dist_rows")
    rec_d = recall(lab_d, gt)
    worst_d = oracle_error(d_d, lab_d, q, x, gt, gt_d)
    out["d"] = {"recall": rec_d, "qps": qps_d, "launches": c_d, "oracle_error": worst_d,
                "sync_s": sync_d}
    log(f"[phase8] (d) int8 on every shard (sync {sync_d:.1f}s), auto rescore 40: recall@10 "
        f"{rec_d:.4f}, {qps_d:.0f} qps, launches "
        + ", ".join(f"{k} {v}" for k, v in c_d.items() if v)
        + f", distances vs oracle {worst_d:.3f} of tolerance ({smi})")
    if rec_d < rec_a - 0.01:
        fail(f"(8d) recall {rec_d} more than 0.01 under (a)'s {rec_a}")
    if worst_d > 1.0:
        fail("(8d) distances disagree with the oracle's")

    step("d")
    # (e) save() and load() into a fresh index on the card
    t0 = time.time()
    idx.save(prefix)
    save_s = time.time() - t0
    del idx
    torch.cuda.empty_cache()
    t0 = time.time()
    idx = new_index()
    idx.load(prefix)
    load_s = time.time() - t0
    tiers_of("8e", idx, "unified")
    d_e, lab_e, qps_e, c_e = run_mode(idx, "8e", q, 1, launches, warm=False, k=K, ef=200)
    d_es, lab_es, _, _ = run_mode(idx, "8e speed", q, 1, launches, warm=False, **SHARD_SPEED)
    same_e = int((lab_e == lab_a).all(axis=1).sum())
    out["e"] = {"save_s": save_s, "load_s": load_s, "same_labels": same_e, "qps": qps_e,
                "max_rel_diff": float(np.max(np.abs(d_e - d_a) / d_a))}
    out["reference"] = {"default": (d_e, lab_e), "speed": (d_es, lab_es)}  # for phase 9
    log(f"[phase8] (e) save {save_s:.1f}s, load {load_s:.1f}s: {same_e} of {len(q)} queries "
        f"return (a)'s labels, distances within {out['e']['max_rel_diff']:.2e} relative "
        f"({smi})")
    if same_e != len(q) or not np.allclose(d_e, d_a, rtol=1e-6, atol=0):
        fail("(8e) the loaded index does not answer as the saved one")

    step("e")
    # (f) add_items: new vectors from the same generator (another seed) and
    # in-place updates of existing labels, synced as row deltas
    rng = np.random.default_rng(SEED + 8)
    new = make_dataset(N_ADD + N_UPD, DIM, rng)
    new_labels = np.concatenate([np.arange(N, N + N_ADD),
                                 np.sort(rng.choice(N, N_UPD, replace=False))])
    t0 = time.time()
    idx.add_items(new[:N_ADD], new_labels[:N_ADD])
    idx.add_items(new[N_ADD:], new_labels[N_ADD:])
    add_s = time.time() - t0
    (_, lab_self), sync_f, c_fs = counted("8f", launches, lambda: idx.search(new, k=1, ef=200))
    mode_f = idx.last_sync_mode
    hit_f = float(np.mean(lab_self[:, 0] == new_labels))
    d_fd, lab_fd, _, _ = run_mode(idx, "8f delta", q, 1, launches, warm=False, k=K, ef=200)
    idx.rebuild_device_tables()
    tiers_of("8f", idx, "unified")
    d_fr, lab_fr, _, _ = run_mode(idx, "8f rebuilt", q, 1, launches, warm=False, k=K, ef=200)
    same_f = int((lab_fd == lab_fr).all(axis=1).sum())
    rel_f = float(np.max(np.abs(d_fd - d_fr) / d_fr))
    out["f"] = {"add_s": add_s, "sync_and_search_s": sync_f, "mode": mode_f, "self_hit": hit_f,
                "same_as_rebuild": same_f, "max_rel_diff": rel_f, "launches": c_fs}
    log(f"[phase8] (f) add_items of {N_ADD} new vectors and {N_UPD} in-place updates "
        f"{add_s:.2f}s; sync {mode_f} + search of the {N_ADD + N_UPD} {sync_f:.2f}s: "
        f"{hit_f:.4f} at rank 1; a rebuild at the same rung: {same_f} of {len(q)} queries "
        f"return the delta state's labels, distances within {rel_f:.2e} relative ({smi})")
    if mode_f != "delta":
        fail(f"(8f) the inserts synced as {mode_f}, not as row deltas")
    if hit_f < 0.99:
        fail(f"(8f) only {hit_f} of the new and updated vectors found at rank 1")
    if same_f != len(q) or rel_f > 1e-5:
        fail("(8f) the delta state does not answer as a rebuild at the same rung")
    del idx
    torch.cuda.empty_cache()

    step("f")
    # (g) budgets between rungs: the split rung, and int4 over bf16 storage
    idx = new_index()
    idx.load(prefix)
    idx.rebuild_device_tables(0)
    tiers_of("8g split", idx, "split")
    d_gs, lab_gs, qps_gs, c_gs = run_mode(idx, "8g split", q, 1, launches, warm=False, k=K, ef=200)
    need_launch("8g split", c_gs, "hop_dist_inline")
    rec_gs = recall(lab_gs, gt)
    worst_gs = read_distances(q, x, lab_gs, d_gs, bf16=True)[2]
    del idx
    torch.cuda.empty_cache()
    idx = new_index(bf16=True)
    idx.load(prefix)
    idx.rebuild_device_tables(between(idx, "unified4", "unified8"))
    tiers_of("8g int4", idx, "unified4")
    if idx._shards[0]._device.vectors.dtype != torch.bfloat16:
        fail("(8g int4) the vector table is not bf16")
    d_g4, lab_g4, qps_g4, c_g4 = run_mode(idx, "8g int4", q, 1, launches, warm=False, k=K, ef=200)
    need_launch("8g int4", c_g4, "hop_dist_unified4", "gather_dist_bf16")
    rec_g4 = recall(lab_g4, gt)
    worst_g4 = read_distances(q, x, lab_g4, d_g4, bf16=True)[2]
    out["g"] = {"split": {"recall": rec_gs, "qps": qps_gs, "launches": c_gs,
                          "distance_error": worst_gs},
                "int4_bf16": {"recall": rec_g4, "qps": qps_g4, "launches": c_g4,
                              "distance_error": worst_g4}}
    log(f"[phase8] (g) split on every shard: recall@10 {rec_gs:.4f} ((a) {rec_a:.4f}), "
        f"{qps_gs:.0f} qps, row 6 launches {c_gs['hop_dist_inline']}, distances {worst_gs:.3f} "
        f"of tolerance; int4 over bf16 storage on every shard, auto rescore 40: recall@10 "
        f"{rec_g4:.4f}, {qps_g4:.0f} qps, rows 4 / 5 launches {c_g4['hop_dist_unified4']} / "
        f"{c_g4['gather_dist_bf16']}, distances {worst_g4:.3f} of tolerance ({smi})")
    if rec_gs < 0.95 or abs(rec_gs - rec_a) > 0.01:
        fail(f"(8g split) recall {rec_gs} under 0.95 or not within 0.01 of (a)'s {rec_a}")
    if rec_g4 < 0.90:
        fail(f"(8g int4) recall {rec_g4} < 0.90")
    if max(worst_gs, worst_g4) > 1.0:
        fail("(8g) returned distances differ from the exact ones")

    step("g")
    # (h) the trim configuration on the bf16 index: int8 without its side
    # tables, no upper tables; a mutation syncs in full
    idx.upper_inline = False
    idx.keep_delta_tables = False
    idx.rebuild_device_tables(between(idx, "unified8", "unified"))
    tiers_of("8h", idx, "unified8")
    st = idx._shards[0]._device
    if st.codes is not None or st.upper_tables is not None:
        fail("(8h) the side tables or the upper tables were kept")
    del st
    d_h, lab_h, qps_h, c_h = run_mode(idx, "8h", q, 1, launches, warm=False, k=K, ef=200)
    need_launch("8h", c_h, "hop_dist_unified8", "gather_dist_bf16")
    rec_h = recall(lab_h, gt)
    worst_h = read_distances(q, x, lab_h, d_h, bf16=True)[2]
    idx.add_items(new[:N_ADD], new_labels[:N_ADD])
    (_, lab_hs), sync_h, _ = counted("8h add", launches,
                                     lambda: idx.search(new[:N_ADD], k=1, ef=200))
    mode_h = idx.last_sync_mode
    hit_h = float(np.mean(lab_hs[:, 0] == new_labels[:N_ADD]))
    d_h2, lab_h2, _, _ = run_mode(idx, "8h after", q, 1, launches, warm=False, k=K, ef=200)
    worst_h2 = read_distances(q, np.concatenate([x, new[:N_ADD]]), lab_h2, d_h2, bf16=True)[2]
    out["h"] = {"recall": rec_h, "qps": qps_h, "launches": c_h, "distance_error": worst_h,
                "mode": mode_h, "self_hit": hit_h, "sync_and_search_s": sync_h,
                "distance_error_after": worst_h2}
    log(f"[phase8] (h) trim (bf16 vectors, int8 without side tables, no upper tables): "
        f"recall@10 {rec_h:.4f}, {qps_h:.0f} qps, rows 3 / 5 launches "
        f"{c_h['hop_dist_unified8']} / {c_h['gather_dist_bf16']}; add_items of {N_ADD}: sync "
        f"{mode_h} + search {sync_h:.2f}s, {hit_h:.4f} at rank 1; distances {worst_h:.3f} / "
        f"{worst_h2:.3f} of tolerance before / after ({smi})")
    if rec_h < rec_a - 0.02:
        fail(f"(8h) recall {rec_h} more than 0.02 under (a)'s {rec_a}")
    if mode_h != "full" or hit_h < 0.99:
        fail(f"(8h) add_items synced as {mode_h}, {hit_h} found at rank 1")
    if max(worst_h, worst_h2) > 1.0:
        fail("(8h) returned distances differ from the exact ones")
    del idx
    torch.cuda.empty_cache()

    step("h")
    # (i) the stop-condition searches over the shards
    eps, truth = ranged
    qr = q[:len(truth)]  # phase 7 (a)'s queries
    idx = new_index()
    idx.load(prefix)
    idx.rebuild_device_tables()  # the first (full) device sync
    ladder = LadderLog(idx)
    (d_r, lab_r, valid), secs_r, c_r = counted("8i range", launches, lambda: epsilon_search(
        ladder, qr, eps, min_candidates=1, max_candidates=EPS_MAX, ef=0))
    need_launch("8i range", c_r, "hop_dist_unified")
    exact, tol, err_r = read_distances(qr, x, lab_r, d_r, bf16=True)
    n_true = sum(len(t) for t in truth)
    rec_r = sum(len(set(lab_r[i][valid[i]].tolist()) & truth[i]) for i in range(len(qr))) / n_true
    beyond = int((valid[:, 1:] & ~(exact[:, 1:] <= eps + tol[:, 1:])).sum())
    beams_r = [s[0] for s in ladder.steps]
    del idx, ladder
    torch.cuda.empty_cache()
    step("i range")
    xd, qd, doc_of, true_docs = docs
    t0 = time.time()
    mv = MultiVectorIndex("l2", DIM, index=new_index())
    for doc in range(N_DOC):
        mv.add_document(doc, xd[doc * PER_DOC:(doc + 1) * PER_DOC])
    build_docs = time.time() - t0
    if mv.num_docs != N_DOC or mv.index.num_elements != len(xd):
        fail(f"(8i) {mv.num_docs} documents, {mv.index.num_elements} vectors")
    index = mv.index
    index.rebuild_device_tables()  # the first (full) device sync
    mv.index = LadderLog(index)
    (dd, got_docs), secs_docs, c_docs = counted("8i docs", launches, lambda: mv.search(
        qd, k_docs=K_DOCS, ef=EF_DOCS, oversample=OVERSAMPLE))
    steps = mv.index.steps
    mv.index = index
    need_launch("8i docs", c_docs, "hop_dist_unified")
    err_docs = doc_distance_error(qd, xd, dd, got_docs, steps[-1][2], doc_of, bf16=True)
    rec_docs = float(np.mean([len(set(got_docs[i].tolist()) & set(true_docs[i])) / K_DOCS
                              for i in range(len(qd))]))
    out["i"] = {"range": {"recall": rec_r, "seconds": secs_r, "distance_error": err_r,
                          "beyond_epsilon": beyond, "beams": beams_r, "launches": c_r},
                "documents": {"recall": rec_docs, "seconds": secs_docs, "build_s": build_docs,
                              "steps": [s[0] for s in steps], "distance_error": err_docs,
                              "launches": c_docs}}
    log(f"[phase8] (i) epsilon_search over the shards, epsilon {eps:.4f}: beams {beams_r}, "
        f"in-range recall {rec_r:.4f} against phase 7 (a)'s exact sets, {secs_r:.2f}s, "
        f"distances {err_r:.3f} "
        f"of tolerance; MultiVectorIndex over a sharded index, {N_DOC} documents x {PER_DOC} "
        f"vectors by add_document {build_docs:.1f}s: beams {[s[0] for s in steps]}, document "
        f"recall@10 {rec_docs:.4f}, {len(qd) / secs_docs:.0f} qps, distances {err_docs:.3f} of "
        f"tolerance ({smi})")
    if rec_r < RANGE_RECALL_MIN or err_r > 1.0 or beyond:
        fail(f"(8i range) recall {rec_r}, distances {err_r} of tolerance, {beyond} valid "
             f"points past rank 1 beyond epsilon")
    if rec_docs < DOC_RECALL_MIN or err_docs > 1.0:
        fail(f"(8i documents) recall@10 {rec_docs}, distances {err_docs} of tolerance")
    del mv, index
    torch.cuda.empty_cache()
    step("i documents")
    log(f"[phase8] seconds by step: "
        + ", ".join(f"{k} {v:.1f}" for k, v in out["step_s"].items()) + f" ({smi})")
    return out


# ---------------------------------------------------------------------------
# Phase 9: the sharded index over torch.distributed ranks.
# ---------------------------------------------------------------------------

P9_RUNS = ((2, 1), (4, 2))  # (world size, dp)
NQ_RANKS = 512  # phase 9's queries: the first of phase 2's 1,024 (a cut for time)


def phase9_rank(rank, world, dp, init, prefix, qfile, out) -> None:
    """One rank of phase 9, run as its own process: a gloo group, its shards
    of phase 8's set on cuda:0, the queries of `qfile` at ef=200 and in the
    speed mode (each after a warm-up, with the kernels' counts set to 0 just
    before and read just after); writes its answers, counts and seconds to
    `out`.{rank}.npz and .json."""
    import torch
    import torch.distributed as dist

    from hnsw_tpu_torch.ops.gather_kernels import COUNTS
    from hnsw_tpu_torch.parallel.sharding import ShardedHNSWIndex

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))  # the host's cores
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    try:
        t0 = time.time()
        idx = ShardedHNSWIndex("l2", DIM, num_shards=N_SHARDS, m=M, ef_construction=EF_C,
                               device="cuda", process_group=dist.group.WORLD, dp=dp)
        idx.load(prefix)
        q = np.load(qfile)
        info = {"load_s": time.time() - t0, "shards": idx._own}
        res = {}
        for name, kw in (("default", {"k": K, "ef": 200}), ("speed", SHARD_SPEED)):
            idx.search(q[:16], **kw)
            dist.barrier()
            torch.cuda.synchronize()
            COUNTS.reset()
            t0 = time.time()
            res["d_" + name], res["l_" + name] = idx.search(q, **kw)
            torch.cuda.synchronize()
            info[name] = {"seconds": time.time() - t0, "plain_on_cuda": COUNTS.plain_on_cuda,
                          "counts": {f: getattr(COUNTS, f) for f in LAUNCHES}}
        np.savez(f"{out}.{rank}.npz", **res)
        with open(f"{out}.{rank}.json", "w") as f:
            json.dump(info, f)
    finally:
        dist.destroy_process_group()


def phase9(dev, launches, p2, p8, setdir, smi) -> dict:
    """Phase 8's saved set under torch.distributed, every rank a process on
    the one card with the gloo backend (two NCCL ranks cannot share a card):
    2 ranks at dp=1 (4 shards each), then 4 ranks at dp=2 (the batch split in
    two, 4 shards a rank). The first NQ_RANKS of phase 2's queries at ef=200
    and in the speed mode: every rank returns the whole answer; dp=1 equals
    phase 8 (e)'s one-process answers bit for bit, dp=2 at ef=200 too, and
    its speed mode (whose seed matmul changes shape with the batch) is held
    to phase 8 (b)'s recall on the same queries (the loaded set's) within
    0.002 and to exact distances."""
    import torch

    x, q, gt = (a[:NQ_RANKS] if i else a for i, a in enumerate(p2["data"]))
    ref = {mode: (d[:NQ_RANKS], lab[:NQ_RANKS]) for mode, (d, lab) in p8["reference"].items()}
    # phase 8 (b)'s speed mode, on these queries (the loaded set's answers)
    rec_speed = recall(ref["speed"][1], gt)
    qfile = os.path.join(setdir, "queries.npy")
    np.save(qfile, q)
    here = os.path.dirname(os.path.abspath(__file__))
    out: dict = {}
    for world, dp in P9_RUNS:
        name = f"W{world}_dp{dp}"
        stem = os.path.join(setdir, name)
        init = f"tcp://127.0.0.1:{free_port()}"
        t0 = time.time()
        procs = [subprocess.Popen([sys.executable, "-c", (
            f"import chip_smoke; chip_smoke.phase9_rank({r}, {world}, {dp}, {init!r}, "
            f"{os.path.join(setdir, 'sharded')!r}, {qfile!r}, {stem!r})")], cwd=here)
            for r in range(world)]
        try:
            codes = [p.wait(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.time() - t0
        if codes != [0] * world:
            fail(f"(9 {name}) rank exit codes {codes}")
        res = [dict(np.load(f"{stem}.{r}.npz")) for r in range(world)]
        info = []
        for r in range(world):
            with open(f"{stem}.{r}.json") as f:
                info.append(json.load(f))
        for r in range(1, world):
            if any(not np.array_equal(res[r][k], res[0][k]) for k in res[0]):
                fail(f"(9 {name}) rank {r} returned another answer than rank 0")
        run = {"wall_s": wall, "load_s": max(i["load_s"] for i in info)}
        for mode in ("default", "speed"):
            d, lab = res[0]["d_" + mode], res[0]["l_" + mode]
            rd, rl = ref[mode]
            bitwise = bool(np.array_equal(d, rd) and np.array_equal(lab, rl))
            counts = {f: sum(i[mode]["counts"][f] for i in info) for f in launches}
            if any(i[mode]["plain_on_cuda"] for i in info):
                fail(f"(9 {name} {mode}) a plain version ran on CUDA tensors")
            need_launch(f"9 {name} {mode}", counts, "hop_dist_unified")
            for f, c in counts.items():
                launches[f] += c
            secs = max(i[mode]["seconds"] for i in info)
            run[mode] = {"bitwise": bitwise, "recall": recall(lab, gt), "qps": len(q) / secs,
                         "distance_error": read_distances(q, x, lab, d, bf16=True)[2],
                         "launches": counts}
        out[name] = run
        log(f"[phase9] {world} gloo ranks on one card, dp={dp}: wall {wall:.1f}s (start, load "
            f"{run['load_s']:.1f}s, searches); ef=200: bit for bit with phase 8 (e) "
            f"{run['default']['bitwise']}, recall@10 {run['default']['recall']:.4f}, "
            f"{run['default']['qps']:.0f} qps; speed mode: bit for bit "
            f"{run['speed']['bitwise']}, recall@10 {run['speed']['recall']:.4f} (one process "
            f"{rec_speed:.4f}), {run['speed']['qps']:.0f} qps, distances "
            f"{run['speed']['distance_error']:.3f} of tolerance; hop launches "
            f"{run['default']['launches']['hop_dist_unified']} / "
            f"{run['speed']['launches']['hop_dist_unified']} ({smi})")
        if not run["default"]["bitwise"]:
            fail(f"(9 {name}) the ef=200 answers differ from the one-process index's")
        if dp == 1 and not run["speed"]["bitwise"]:
            fail(f"(9 {name}) the speed-mode answers differ from the one-process index's")
        if abs(run["speed"]["recall"] - rec_speed) > 0.002 or (
                run["speed"]["distance_error"] > 1.0):
            fail(f"(9 {name}) speed mode: recall {run['speed']['recall']} not within 0.002 of "
                 f"the one-process {rec_speed}, or distances not exact")
    return out


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

    t_start = last = time.time()
    phase_s: dict = {}  # wall seconds of each phase, in the order they ran

    def mark(name):
        nonlocal last
        phase_s[name], last = time.time() - last, time.time()

    k1 = phase1(dev)
    mark("1")
    launches = dict.fromkeys(LAUNCHES, 0)
    p2 = phase2(dev, launches)
    mark("2")
    p3 = phase3(dev, launches)
    torch.cuda.empty_cache()  # phase 3's index is gone: phase 4 gets the card
    mark("3")
    p4, big = phase4(dev, launches, p2)
    rep = p4["g"]["wave_replay"]
    k1["hop_inline"].update(wave_ms=rep["ms"], wave_bound_ms=rep["bound_ms"],
                            wave_launches=rep["launches"])
    mark("4")
    p6 = phase6(dev, launches, p2, big)
    mark("6")
    p7, ranged, docs = {}, None, None
    p7["range"], ranged = phase7_range(dev, launches, p2, smi)
    p7["documents"], docs = phase7_docs(dev, launches, smi)
    mark("7ab")
    setdir = tempfile.mkdtemp(prefix="hnsw_phase8_")  # phase 8's saved set, for phase 9
    try:
        p8 = phase8(dev, launches, p2, ranged, docs, setdir, smi)
        mark("8")
        del big, p2["serve"], ranged, docs  # phase 9 and phase 5 get the card
        torch.cuda.empty_cache()
        p9 = phase9(dev, launches, p2, p8, setdir, smi)
        mark("9")
    finally:
        shutil.rmtree(setdir, ignore_errors=True)
    del p8["reference"]
    tmp = tempfile.mkdtemp(prefix="hnsw_phase5_")  # phase 5's deployment, kept for 7 (c)
    try:
        p5 = phase5(dev, launches, tmp)
        mark("5")
        p7["native"] = phase7_native(dev, tmp, smi)
        mark("7c")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(json.dumps({"summary": {"recall@10": p2["recall"], "qps": p2["qps"], "tiers": p3,
                                "bulk_build": p4, "deployment": p5, "interop": p6,
                                "stop_conditions": p7, "sharded": p8, "distributed": p9,
                                "phase_s": phase_s, "seconds": time.time() - t_start,
                                "device": smi}}))
    rows = [  # (counter, phase-1 key, source, TPU pallas_call it replaces)
        ("hop_dist_unified", "hop_bf16", "hop_ring.cuh", "pallas_gather.py:795"),
        ("gather_dist_rows", "gather_f32", "gather_dist.cu", "pallas_gather.py:1051"),
        ("hop_dist_unified8", "hop_int8", "hop_ring.cuh", "pallas_gather.py:795"),
        ("hop_dist_unified4", "hop_int4", "hop_ring.cuh", "pallas_gather.py:795"),
        ("gather_dist_bf16", "gather_bf16", "gather_dist_bf16.cu", "pallas_gather.py:1026"),
        ("hop_dist_inline", "hop_inline", "hop_ring.cuh", "pallas_gather.py:214"),
        ("seed_topk", "seed_topk", "seed_topk.cu", "topk.py bruteforce_topk (XLA, no Pallas)"),
    ]
    kernels = []
    for counter, key, src, tpu in rows:
        r = k1[key]
        kernels.append({
            "name": counter, "route": "cuda", "source": f"hnsw_tpu_torch/csrc/{src}",
            "replaces": f"hnsw_tpu/ops/{tpu}", "launches": launches[counter],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            # timed cold (fresh blocks or rows per launch): rows 1, 3, 4 and 6
            # at B=1024 E=1 and B=8192 E=2, rows 2 and 5 at B=1024 K=40; row
            # 6 also over phase 4 (g)'s first 16384-node wave, replayed cold
            # (summed ms and bound B of its launches)
            **{k: r[k] for k in ("cold_ms", "cold_b8192_ms", "wave_ms", "wave_bound_ms",
                                 "wave_launches") if k in r},
        })
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
