"""Index builder CLI (port of hnsw_tpu/service/builder_cli.py) — parity with
the reference index_builder (index_builder/build.cpp:110-154): seeded
gaussian data generation, vectors written to the store, HNSW build, index
save, adjacency-only export.

Usage (positional, like the reference argv at build.cpp:117-122):
    python -m hnsw_tpu_torch.service.builder_cli [N] [dim] [dbpath] \\
        [graph_out] [M] [ef_construction]

Outputs: graph_out (native .npz checkpoint, loadable by both packages) and
graph_out + ".adj" (reference-compatible adjacency file). The build runs on
the host's native engine and touches no device.
"""

from __future__ import annotations

import sys
import time

import numpy as np


def main(argv=None, n_threads: int = 0):
    """`n_threads`: host build threads, 0 = all cores (what
    HNSWIndex.add_items uses); 1 builds serially, deterministically."""
    argv = list(sys.argv[1:] if argv is None else argv)
    n = int(argv[0]) if len(argv) > 0 else 100_000
    dim = int(argv[1]) if len(argv) > 1 else 128
    dbpath = argv[2] if len(argv) > 2 else "./vec_store.log"
    graph_out = argv[3] if len(argv) > 3 else "./hnsw_index.npz"
    m = int(argv[4]) if len(argv) > 4 else 16
    ef_construction = int(argv[5]) if len(argv) > 5 else 200

    from hnsw_tpu_torch.models.hnsw import HNSWIndex
    from hnsw_tpu_torch.native.vecstore import VectorStore

    rng = np.random.default_rng(123)  # seeded like build.cpp:124
    print(f"Generating {n} random vectors of dim {dim}", flush=True)
    data = rng.normal(size=(n, dim)).astype(np.float32)

    store = VectorStore(dbpath)
    t0 = time.time()
    # the builder never searches, so its index holds no device state: a
    # CPU index here never opens the card (and never collides with a query
    # service already serving from it)
    idx = HNSWIndex(
        "l2", dim=dim, m=m, ef_construction=ef_construction,
        inline_neighbors=False, device="cpu",
    )
    for start in range(0, n, 10_000):
        chunk = data[start : start + 10_000]
        for i, v in enumerate(chunk):
            store.put(start + i, v)
        idx._builder.add_batch(
            chunk, np.arange(start, start + len(chunk)), n_threads=n_threads
        )
        print(f"  inserted {start + len(chunk)}/{n}", flush=True)
    store.flush()
    store.close()
    build_s = time.time() - t0

    idx.save(graph_out)
    idx.export_adj(graph_out + ".adj")
    print(
        f"Built N={n} in {build_s:.1f}s ({n / build_s:.0f} inserts/s); "
        f"saved {graph_out} and {graph_out}.adj",
        flush=True,
    )


if __name__ == "__main__":
    main()
