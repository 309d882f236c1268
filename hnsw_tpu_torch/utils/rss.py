"""Process RSS measurement and the address-space cap (port of
hnsw_tpu/utils/rss.py; reference: get_current_rss_kb,
hnsw_service/main.cpp:10-22, parsed from /proc/self/statm)."""

import os


def current_rss_kb() -> int:
    try:
        with open("/proc/self/statm") as f:
            parts = f.read().split()
        rss_pages = int(parts[1])
        return rss_pages * os.sysconf("SC_PAGE_SIZE") // 1024
    except (OSError, IndexError, ValueError):
        return 0


def apply_mem_cap(mem_cap_mb: int) -> bool:
    """RLIMIT_AS self-cap (reference parity with hnsw_service/main.cpp:19-22):
    with a hard address-space ceiling, exceeding the cap kills the process
    instead of paging. Returns True when the cap was applied; <= 0 disables
    it, which is the query service's default: the CUDA context alone maps
    a large virtual address space, so a blanket cap would kill the engine."""
    if mem_cap_mb <= 0:
        return False
    try:
        import resource

        cap = mem_cap_mb << 20
        resource.setrlimit(resource.RLIMIT_AS, (cap, cap))
        return True
    except (ImportError, ValueError, OSError):
        return False


def release_host_memory() -> None:
    """gc + glibc malloc_trim: freed Python and NumPy buffers otherwise stay
    in the allocator's arena and keep RSS at its transient peak (the
    reference's RSS methodology, bin/experiment.py:237-290, measures the
    steady state)."""
    import ctypes
    import gc

    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except Exception:
        pass
