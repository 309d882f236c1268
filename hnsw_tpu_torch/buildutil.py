"""Build directory and locked, atomic rebuilds of the port's shared objects.

Everything the port compiles (the host builder from the reference's
unchanged C++ source, the CUDA kernels from ``csrc/``) lands in
``hnsw_tpu_torch/_build/``, which git ignores. A build runs at first use
and again when a source is newer than its output; an ``fcntl`` lock keeps
two processes (e.g. pytest-xdist workers) from compiling at once, and the
output is written to a temporary name and moved into place with
``os.replace``, so a reader never sees a half-written library.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
from typing import Callable, Iterator

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG_DIR, "_build")


@contextlib.contextmanager
def _file_lock(path: str) -> Iterator[None]:
    with open(path, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def _stale(target: str, sources: list[str]) -> bool:
    if not os.path.exists(target):
        return True
    built = os.path.getmtime(target)
    return any(os.path.getmtime(s) > built for s in sources)


def build_if_stale(
    target: str, sources: list[str], build: Callable[[str], None]
) -> str:
    """Ensure `target` (a file in BUILD_DIR) is newer than every source.
    `build(tmp_path)` writes the output to `tmp_path`; it is then moved
    onto `target` atomically. Returns `target`."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    if not _stale(target, sources):
        return target
    with _file_lock(target + ".lock"):
        if _stale(target, sources):  # another process may have built it
            tmp = f"{target}.tmp.{os.getpid()}"
            try:
                build(tmp)
                os.replace(tmp, target)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
    return target
