"""Closed loop: one client sends a batch of `batch` queries, drawn without
replacement from the query pool, and sends the next when the answer is on
the host. Every batch of a seed has the same size; the seed picks the rows.
"""

from __future__ import annotations

import time

import numpy as np


def _rows(rng: np.random.Generator, pool_size: int, batch: int) -> np.ndarray:
    return rng.permutation(pool_size)[:batch]


def warm_up(search, pool: np.ndarray, spec: dict, seed: int) -> None:
    """`warmup_batches` batches of the window's shape, from a stream of
    their own (the window's rows do not depend on the warm-up)."""
    rng = np.random.default_rng([seed, 0])
    for _ in range(spec["warmup_batches"]):
        search(pool[_rows(rng, len(pool), spec["batch"])])


def run(search, pool: np.ndarray, spec: dict, seed: int, seconds: float,
        on_batch=None) -> dict:
    """Send batches back to back while the window is open. The window runs
    from the first submission to the answer of the last batch sent before
    `seconds` had passed. `on_batch(i)` is called before batch i is formed
    and once more after the last. Returns the rows asked, the answers and
    each batch's submission time in the window and latency, from
    submission to the answer on the host."""
    rng = np.random.default_rng([seed, 1])
    rows, dists, labels, lat, sent = [], [], [], [], []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    end = t0
    while not rows or end < deadline:
        if on_batch is not None:
            on_batch(len(rows))
        r = _rows(rng, len(pool), spec["batch"])
        qs = pool[r]
        ts = time.perf_counter()
        sent.append(ts - t0)
        d, lab = search(qs)
        end = time.perf_counter()
        rows.append(r)
        dists.append(d)
        labels.append(lab)
        lat.append(end - ts)
    if on_batch is not None:
        on_batch(len(rows))
    return {
        "qid": np.concatenate(rows),
        "dists": np.concatenate(dists),
        "labels": np.concatenate(labels),
        "latency_s": np.asarray(lat),
        "sent_s": np.asarray(sent),
        "window_s": end - t0,
        "batches": len(rows),
    }
