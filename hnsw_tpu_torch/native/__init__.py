"""ctypes bindings for the native C++ graph builder and vector store, and
the native service frontends.

The port does not import the reference package (every module of it imports
jax). It compiles the reference's unchanged sources
``hnsw_tpu/native/builder.cpp`` and ``hnsw_tpu/native/vecstore.cpp``, read
by path, with the reference's flags (``g++ -O3 -march=native -std=c++20
-shared -fPIC``) into ``hnsw_tpu_torch/_build/libbuilder.so`` and
``libvecstore.so``, and binds the same C ABIs. ``build_binary`` compiles
the host-only HTTP frontends ``storage_main.cpp`` and ``query_main.cpp``
the same way into executables ``_build/bin_<name>``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

from hnsw_tpu_torch.buildutil import BUILD_DIR, PKG_DIR, build_if_stale

_NATIVE_DIR = os.path.join(os.path.dirname(PKG_DIR), "hnsw_tpu", "native")
BUILDER_SRC = os.path.join(_NATIVE_DIR, "builder.cpp")
VECSTORE_SRC = os.path.join(_NATIVE_DIR, "vecstore.cpp")
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _load(name: str, src: str, declare) -> ctypes.CDLL:
    """Compile `src` into _build/lib<name>.so (if stale) and dlopen it."""

    def compile_to(tmp: str) -> None:
        cmd = [
            "g++", "-O3", "-march=native", "-std=c++20", "-shared", "-fPIC",
            "-o", tmp, src,
        ]
        subprocess.run(cmd, check=True, capture_output=True, text=True)

    with _LOCK:
        if name not in _LIBS:
            so = build_if_stale(
                os.path.join(BUILD_DIR, f"lib{name}.so"), [src], compile_to
            )
            lib = ctypes.CDLL(so)
            declare(lib)
            _LIBS[name] = lib
        return _LIBS[name]


def build_binary(name: str) -> str:
    """Compile the reference's ``hnsw_tpu/native/<name>.cpp`` (a service
    frontend: ``storage_main`` or ``query_main``) into the executable
    ``_build/bin_<name>`` if stale, and return its path. The sources
    include ``httpkit.h`` and ``vecstore.cpp``, so a newer one of either
    rebuilds too. Nothing is written under ``hnsw_tpu/``."""
    src = os.path.join(_NATIVE_DIR, f"{name}.cpp")
    deps = [src, os.path.join(_NATIVE_DIR, "httpkit.h"), VECSTORE_SRC]

    def compile_to(tmp: str) -> None:
        cmd = [
            "g++", "-O3", "-march=native", "-std=c++20", "-pthread",
            "-o", tmp, src,
        ]
        subprocess.run(cmd, check=True, capture_output=True, text=True)

    return build_if_stale(os.path.join(BUILD_DIR, f"bin_{name}"), deps, compile_to)


def load_builder_lib() -> ctypes.CDLL:
    return _load("builder", BUILDER_SRC, _declare)


def load_vecstore_lib() -> ctypes.CDLL:
    return _load("vecstore", VECSTORE_SRC, _declare_vecstore)


def _declare_vecstore(lib: ctypes.CDLL) -> None:
    """Signature table, the same as hnsw_tpu/native/__init__.py's
    load_vecstore_lib."""
    c = ctypes
    P = c.POINTER
    lib.vs_open.restype = c.c_void_p
    lib.vs_open.argtypes = [c.c_char_p]
    lib.vs_close.argtypes = [c.c_void_p]
    lib.vs_put.restype = c.c_int
    lib.vs_put.argtypes = [c.c_void_p, c.c_uint32, c.c_uint32, P(c.c_float)]
    lib.vs_flush.restype = c.c_int
    lib.vs_flush.argtypes = [c.c_void_p]
    lib.vs_get.restype = c.c_int64
    lib.vs_get.argtypes = [c.c_void_p, c.c_uint32, P(c.c_float), c.c_int64]
    lib.vs_batch_get.restype = c.c_int
    lib.vs_batch_get.argtypes = [
        c.c_void_p, P(c.c_uint32), c.c_int64, c.c_uint32, P(c.c_float), P(c.c_uint8),
    ]
    lib.vs_count.restype = c.c_int64
    lib.vs_count.argtypes = [c.c_void_p]
    lib.vs_ids.argtypes = [c.c_void_p, P(c.c_uint32)]


def _declare(lib: ctypes.CDLL) -> None:
    """Signature table, the same as hnsw_tpu/native/__init__.py's
    load_builder_lib."""
    c = ctypes
    P = c.POINTER
    lib.hnsw_create.restype = c.c_void_p
    lib.hnsw_create.argtypes = [c.c_int, c.c_int, c.c_int, c.c_int, c.c_uint64]
    lib.hnsw_free.argtypes = [c.c_void_p]
    lib.hnsw_add.argtypes = [c.c_void_p, P(c.c_float), c.c_int64]
    lib.hnsw_add_batch.argtypes = [
        c.c_void_p, P(c.c_float), P(c.c_int64), c.c_int64, c.c_int,
    ]
    lib.hnsw_add_with_level.argtypes = [c.c_void_p, P(c.c_float), c.c_int64, c.c_int]
    lib.hnsw_register_level0_batch.restype = c.c_int64
    lib.hnsw_register_level0_batch.argtypes = [
        c.c_void_p, P(c.c_float), P(c.c_int64), c.c_int64,
    ]
    lib.hnsw_connect_batch.argtypes = [
        c.c_void_p, P(c.c_uint32), c.c_int64, P(c.c_int32), c.c_int,
    ]
    lib.hnsw_mark_deleted.argtypes = [c.c_void_p, c.c_int64]
    lib.hnsw_mark_deleted.restype = c.c_int
    lib.hnsw_unmark_deleted.argtypes = [c.c_void_p, c.c_int64]
    lib.hnsw_unmark_deleted.restype = c.c_int
    for fn, res in [
        ("hnsw_size", c.c_int64),
        ("hnsw_max_level", c.c_int),
        ("hnsw_entry_point", c.c_int),
        ("hnsw_dim", c.c_int),
        ("hnsw_m", c.c_int),
        ("hnsw_max_m0", c.c_int),
        ("hnsw_num_deleted", c.c_int64),
        ("hnsw_capacity", c.c_int64),
        ("hnsw_index_file_size", c.c_int64),
    ]:
        getattr(lib, fn).argtypes = [c.c_void_p]
        getattr(lib, fn).restype = res
    lib.hnsw_clear.argtypes = [c.c_void_p]
    lib.hnsw_get_data_by_label.argtypes = [c.c_void_p, c.c_int64, P(c.c_float)]
    lib.hnsw_get_data_by_label.restype = c.c_int
    lib.hnsw_export_level0.argtypes = [c.c_void_p, P(c.c_int32)]
    lib.hnsw_export_levels.argtypes = [c.c_void_p, P(c.c_int32)]
    lib.hnsw_export_labels.argtypes = [c.c_void_p, P(c.c_int64)]
    lib.hnsw_export_deleted.argtypes = [c.c_void_p, P(c.c_uint8)]
    lib.hnsw_export_vectors.argtypes = [c.c_void_p, P(c.c_float)]
    lib.hnsw_upper_count.argtypes = [c.c_void_p, c.c_int]
    lib.hnsw_upper_count.restype = c.c_int64
    lib.hnsw_export_upper.argtypes = [c.c_void_p, c.c_int, P(c.c_int32), P(c.c_int32)]
    lib.hnsw_import.restype = c.c_void_p
    lib.hnsw_import.argtypes = [
        c.c_int, c.c_int, c.c_int, c.c_int, c.c_uint64, c.c_int64,
        P(c.c_float), P(c.c_int64), P(c.c_int32), P(c.c_uint8),
        P(c.c_int32), P(c.c_int32), c.c_int, c.c_int,
    ]
    lib.hnsw_search.argtypes = [
        c.c_void_p, P(c.c_float), c.c_int, c.c_int, P(c.c_int64), P(c.c_float),
    ]
    lib.hnsw_search.restype = c.c_int
    lib.hnsw_search_batch.argtypes = [
        c.c_void_p, P(c.c_float), c.c_int64, c.c_int, c.c_int,
        P(c.c_int64), P(c.c_float), P(c.c_int32),
    ]
    lib.hnsw_add_replace.argtypes = [c.c_void_p, P(c.c_float), c.c_int64]
    lib.hnsw_add_replace.restype = c.c_int
    lib.hnsw_dirty_count.argtypes = [c.c_void_p]
    lib.hnsw_dirty_count.restype = c.c_int64
    lib.hnsw_dirty_flags.argtypes = [c.c_void_p]
    lib.hnsw_dirty_flags.restype = c.c_int
    lib.hnsw_take_dirty.argtypes = [c.c_void_p, P(c.c_int32)]
    lib.hnsw_clear_dirty.argtypes = [c.c_void_p]
    lib.hnsw_export_level0_rows.argtypes = [
        c.c_void_p, P(c.c_int32), c.c_int64, P(c.c_int32)
    ]
    lib.hnsw_export_vectors_range.argtypes = [
        c.c_void_p, c.c_int64, c.c_int64, P(c.c_float)
    ]
    lib.hnsw_export_labels_range.argtypes = [
        c.c_void_p, c.c_int64, c.c_int64, P(c.c_int64)
    ]
    lib.hnsw_export_adj.argtypes = [c.c_void_p, c.c_char_p]
    lib.hnsw_export_adj.restype = c.c_int
    lib.hnsw_flush_updates.argtypes = [c.c_void_p]
    lib.hnsw_flush_updates.restype = c.c_int64
    lib.hnsw_take_vec_dirty.argtypes = [c.c_void_p, P(c.c_int32)]
    lib.hnsw_export_vectors_rows.argtypes = [
        c.c_void_p, P(c.c_int32), c.c_int64, P(c.c_float)
    ]
    lib.hnsw_search_filtered.argtypes = [
        c.c_void_p, P(c.c_float), c.c_int, c.c_int, P(c.c_uint8),
        P(c.c_int64), P(c.c_float),
    ]
    lib.hnsw_search_filtered.restype = c.c_int
    lib.hnsw_search_batch_filtered.argtypes = [
        c.c_void_p, P(c.c_float), c.c_int64, c.c_int, c.c_int, P(c.c_uint8),
        P(c.c_int64), P(c.c_float), P(c.c_int32),
    ]
