"""Rows 6 and 2 of the port's kernels (the split-tier hop and the f32 row
gather) and the node-block ring's rows 1, 3 and 4, timed beside a parent
tree's kernels in turns on one NVIDIA GPU.

    python3 chip_kernel_ab.py PARENT_DIR

PARENT_DIR is an unpacked checkout of an earlier commit (`git archive`);
its hnsw_tpu_torch/csrc is built with this tree's build
(hnsw_tpu_torch/ops/cuda_lib.py) into _build/libhnsw_kernels_parent.so and
called through its own C entries. Every comparison runs the versions in
turns (a, b, ..., b, a) with CUDA events, on the same tensors: warm (one
`chosen` or `ids` repeated), cold (a fresh one per launch on tables far
past the 50 MB L2), and row 6 over the launches of one 16,384-node wave of
chip_smoke.py phase 4 (g)'s bulk build, replayed cold (chip_smoke.WaveProbe
and replay_wave). Prints one line per measurement, the card's name and
power limit, and a JSON summary as the last line. Needs CUDA.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys
import time

import numpy as np

import chip_smoke as cs


# the C entries this tool times on the parent's library (an older library
# lacks the seed kernel's)
PARENT_ENTRIES = ("hop_dist_unified_bf16", "hop_dist_unified_int8", "hop_dist_unified_int4",
                  "hop_dist_inline", "gather_dist_f32", "gather_dist_bf16")


def build_parent(parent_dir: str) -> ctypes.CDLL:
    """The parent's kernels, compiled from its csrc by this tree's build and
    bound with this tree's signatures (the C entries keep PR 2's)."""
    from hnsw_tpu_torch.buildutil import BUILD_DIR
    from hnsw_tpu_torch.ops import cuda_lib

    path = os.path.join(BUILD_DIR, "libhnsw_kernels_parent.so")
    os.makedirs(BUILD_DIR, exist_ok=True)
    saved = cuda_lib.CSRC_DIR, cuda_lib.LOG_PATH
    cuda_lib.CSRC_DIR = os.path.join(parent_dir, "hnsw_tpu_torch", "csrc")
    cuda_lib.LOG_PATH = path + ".log"
    try:
        cuda_lib._compile(path)
    finally:
        cuda_lib.CSRC_DIR, cuda_lib.LOG_PATH = saved
    lib = ctypes.CDLL(path)
    for name in PARENT_ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = cuda_lib.ENTRIES[name]
        fn.restype = ctypes.c_int
    return lib


class Using:
    """Within the block, the wrappers of gather_kernels launch `lib`'s
    entries (the six C entries have the same signatures in both trees)."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        from hnsw_tpu_torch.ops import cuda_lib

        cuda_lib.load_kernels()
        self.saved = cuda_lib._LIB[0]
        cuda_lib._LIB[0] = self.lib

    def __exit__(self, *exc):
        from hnsw_tpu_torch.ops import cuda_lib

        cuda_lib._LIB[0] = self.saved
        return False


def in_turns(fns: dict, timer) -> dict:
    """timer(fn) for each version, in the order a, b, ..., b, a; the mean of
    each version's two readings."""
    names = list(fns)
    got = {n: [] for n in names}
    for n in names + names[::-1]:
        got[n].append(timer(fns[n]))
    return {n: float(np.mean(v)) for n, v in got.items()}


def fmt(res: dict) -> str:
    return ", ".join(f"{n} {ms:.4f} ms" for n, ms in res.items())


def main(argv) -> int:
    import torch

    from hnsw_tpu_torch import bulk_build
    from hnsw_tpu_torch.ops import gather_kernels as gk
    from hnsw_tpu_torch.ops.cuda_lib import load_kernels

    if len(argv) != 1:
        cs.fail("usage: python3 chip_kernel_ab.py PARENT_DIR")
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this script needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    smi = cs.smi_name_power()
    cs.log(f"[ab] device {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    t0 = time.time()
    libs = {"parent": build_parent(argv[0]), "tree": load_kernels()}
    cs.log(f"[ab] both trees' kernels built in {time.time() - t0:.1f}s")
    gen = torch.Generator(device=dev).manual_seed(11)
    out: dict = {"device": smi}

    def turns(timer) -> dict:
        """timer() under each tree's kernels, in turns."""

        def run(lib):
            with Using(lib):
                return timer()

        return in_turns({n: (lambda lib=lib: run(lib)) for n, lib in libs.items()},
                        lambda g: g())

    def sets_of(b, e, rows):
        return [torch.randint(0, rows, (b, e), generator=gen, device=dev, dtype=torch.int32)
                for _ in range(21)]

    # ---- row 6 warm and cold, rows 1, 3 and 4 cold; m0=32, d=128, l2 ----
    m0, d = 32, 128
    for rows in (16384, 262_144):
        t = cs.dev_table(dev, gen, "bf16", rows, m0, d)
        nbr, level0 = t.vecs, t.payload
        shapes = ((1024, 1), (1024, 2), (8192, 2), (16384, 2)) if rows == 16384 else (
            (1024, 1), (8192, 2), (16384, 2))
        for b, e in shapes:
            q = torch.randn((b, d), generator=gen, device=dev)
            sets = sets_of(b, e, rows)
            with Using(libs["parent"]):
                ref_d, ref_i = gk.hop_dist_inline(q, nbr, level0, sets[0])
            dk, ik = gk.hop_dist_inline(q, nbr, level0, sets[0])
            du, iu = gk.hop_dist_unified(q, t, sets[0])
            if not (torch.equal(ik, ref_i) and torch.allclose(dk, ref_d, rtol=1e-5, atol=1e-4)):
                cs.fail(f"row 6 B={b} E={e} differs from the parent's kernel")
            if not (torch.equal(ik, iu) and torch.equal(dk.view(torch.int32),
                                                        du.view(torch.int32))):
                cs.fail(f"row 6 B={b} E={e} is not row 1 bit for bit")
            key = f"row6_b{b}_e{e}_{rows}"
            out[key + "_warm"] = warm = turns(
                lambda: cs.cuda_ms(lambda: gk.hop_dist_inline(q, nbr, level0, sets[0])))
            cs.log(f"[ab] row 6 warm B={b} E={e} on {rows} blocks: {fmt(warm)}")
            if rows > 16384:
                out[key + "_cold"] = cold = turns(
                    lambda: cs.cold_ms(lambda c: gk.hop_dist_inline(q, nbr, level0, c), sets))
                cs.log(f"[ab] row 6 cold B={b} E={e} on {rows} blocks: {fmt(cold)}")
        if rows > 16384:
            tables = {"bf16": t, "int8": cs.dev_table(dev, gen, "int8", rows, m0, d),
                      "int4": cs.dev_table(dev, gen, "int4", rows, m0, d)}
            for tier, table in tables.items():
                for b, e in ((1024, 1), (8192, 2)):
                    q = torch.randn((b, d), generator=gen, device=dev)
                    sets = sets_of(b, e, rows)
                    out[f"{tier}_b{b}_e{e}_cold"] = res = turns(
                        lambda: cs.cold_ms(lambda c: gk.hop_dist_unified(q, table, c), sets))
                    cs.log(f"[ab] {tier} hop cold B={b} E={e} on {rows} blocks: {fmt(res)}")
            del tables
        del t, nbr, level0
        torch.cuda.empty_cache()

    # ---- row 2: warm (200,000 rows) and cold (2,000,000 rows), B=1024 K=40 ----
    b, kk = 1024, 40
    q = torch.randn((b, d), generator=gen, device=dev)
    for rows, mode in ((200_000, "warm"), (2_000_000, "cold")):
        table = torch.randn((rows, d), generator=gen, device=dev)
        sets = sets_of(b, kk, rows)
        dk = gk.gather_dist_rows(q, table, sets[0])
        dp = gk.gather_dist_rows_plain(q, table, sets[0])
        if bool(cs.gather_bad(q, table, sets[0], dk, dp).any()):
            cs.fail(f"row 2 ({mode}) differs from its plain version")
        if mode == "warm":
            res = turns(lambda: cs.cuda_ms(lambda: gk.gather_dist_rows(q, table, sets[0])))
        else:
            res = turns(lambda: cs.cold_ms(lambda i: gk.gather_dist_rows(q, table, i), sets))
        out[f"row2_{mode}"] = res
        cs.log(f"[ab] row 2 {mode} B={b} K={kk} d={d} on {rows} rows: {fmt(res)}")
        del table
    torch.cuda.empty_cache()

    # ---- row 6 over one wave of phase 4 (g)'s bulk build, replayed cold ----
    x = cs.make_dataset(cs.N, cs.DIM, np.random.default_rng(cs.SEED))
    probe = cs.WaveProbe()
    with probe:
        bulk_build(x, space="l2", m=cs.M, ef_construction=cs.EF_C, device=dev)
    shares = [c.unique().numel() / c.numel() for *_, c, _ in probe.kept]
    rep = cs.replay_wave(dev, probe.kept)
    res = turns(lambda: cs.replay_wave(dev, probe.kept)["ms"])
    out["wave"] = {"ms": res, "launches": rep["launches"], "bound_ms": rep["bound_ms"],
                   "read_bound_ms": rep["read_bound_ms"],
                   "distinct_median": float(np.median(shares))}
    cs.log(f"[ab] row 6 over the first 16384-node wave of the 100k bulk build, replayed cold "
           f"({rep['launches']} launches, summed): {fmt(res)}; bound B {rep['bound_ms']:.3f} ms, "
           f"as read {rep['read_bound_ms']:.3f} ms, distinct blocks {np.median(shares):.3f} "
           f"of B*E (median)")
    cs.log(smi)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
