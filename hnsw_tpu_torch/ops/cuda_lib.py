"""Build and bind the port's CUDA kernels (``hnsw_tpu_torch/csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a``; the objects are linked into one shared library with a plain
C interface, ``hnsw_tpu_torch/_build/libhnsw_kernels.so``, loaded with
ctypes. The build runs at first use (never at import: the CPU tests import
every module) and again when a source or a header (``csrc/*.cuh``) is newer
than the library. The
compiler's output, including ``-Xptxas -v`` register and spill counts, is
kept in ``_build/libhnsw_kernels.log``.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

from hnsw_tpu_torch.buildutil import BUILD_DIR, PKG_DIR, build_if_stale

CSRC_DIR = os.path.join(PKG_DIR, "csrc")
LIB_PATH = os.path.join(BUILD_DIR, "libhnsw_kernels.so")
LOG_PATH = os.path.join(BUILD_DIR, "libhnsw_kernels.log")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_LOCK = threading.Lock()
_LIB: list[ctypes.CDLL] = []


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _sources() -> list[str]:
    """The sources and the headers they include: a change to either rebuilds."""
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _compile(tmp: str) -> None:
    nvcc = _nvcc()
    objs, procs = [], []
    for src in _sources():
        if not src.endswith(".cu"):
            continue
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [nvcc, *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-c", src, "-o", obj]
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
        objs.append(obj)
    logs, failed = [], []
    for cmd, p in procs:
        out, _ = p.communicate()
        logs.append(" ".join(cmd) + "\n" + out)
        if p.returncode != 0:
            failed.append(out)
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        link = [nvcc, *ARCH, "-shared", "-o", tmp, *objs]
        res = subprocess.run(link, capture_output=True, text=True)
        logs.append(" ".join(link) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + res.stderr)
    finally:
        with open(LOG_PATH, "w") as fh:
            fh.write("\n".join(logs))
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)


def load_kernels() -> ctypes.CDLL:
    """The kernel library, built first if it is missing or stale."""
    with _LOCK:
        if _LIB:
            return _LIB[0]
        so = build_if_stale(LIB_PATH, _sources(), _compile)
        _LIB.append(declare(ctypes.CDLL(so)))
        return _LIB[0]


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_HOP = [_I, _I, _I, _I, _L, _I, _P]  # B, E, m0, d_pad, R, ip, stream
_GATHER = [_P, _P, _P, _P, _I, _I, _I, _L, _I, _P]
# the argument types of each C entry of the kernel library
ENTRIES = {
    "hop_dist_unified_bf16": [_P] * 6 + _HOP,
    "hop_dist_unified_int8": [_P] * 7 + _HOP,
    "hop_dist_unified_int4": [_P] * 7 + _HOP,
    "hop_dist_inline": [_P] * 6 + _HOP,
    "gather_dist_f32": _GATHER,
    "gather_dist_bf16": _GATHER,
    "seed_topk_slices": [_I, _I, _I],  # B, NL, s
    "seed_topk": [_P] * 7 + [_I] * 6 + [_P],  # ..., B, NL, D, s, slices, ip, stream
}


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of the C entries on `lib`."""
    for name, args in ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = _I
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
