"""The comparison that decides ``correct``.

It judges the labels and distances that the timed path returned for every
query it answered in the window, against the plain reference:

- ``recall_at_10``: the share of returned labels whose exact distance is no
  more than the query's exact k-th distance (tie-aware: on integer data a
  tie at the k-th distance counts as found), over every answered query. The
  configuration states its least recall.
- ``dist_gap``: the widest gap between a returned distance and the exact
  distance of its label, |d - ref| / (|q|^2 + |x|^2), where ref is the
  exact distance to the row in the form closest to d among the forms the
  configuration stores rows in (a bf16 node-block tier returns distances to
  bf16-rounded rows; the landmark seeds return them to f32 rows).
- ``bad_rows``: answered rows with a label out of range, a label twice, a
  distance that is not finite, or distances out of ascending order.

Each number has the limit the cell file states; ``correct`` is true when
every number is within its limit.
"""

from __future__ import annotations

import numpy as np

from benchmark import reference

# a returned distance counts as within the k-th when it is no farther than
# the k-th exact distance plus this share of |q|^2 + |x|^2: float64 rounding
# of two summation orders, far below any gap between real neighbors
_TIE_SLACK = 1e-12


def bad_rows(labels: np.ndarray, dists: np.ndarray, n: int) -> np.ndarray:
    """[R] bool: rows that are no valid answer."""
    out_of_range = ((labels < 0) | (labels >= n)).any(-1)
    srt = np.sort(labels, axis=-1)
    twice = (srt[:, 1:] == srt[:, :-1]).any(-1)
    not_finite = ~np.isfinite(dists).all(-1)
    with np.errstate(invalid="ignore"):  # inf - inf in a row already not finite
        unordered = (np.diff(dists, axis=-1) < 0).any(-1)
    return out_of_range | twice | not_finite | unordered


def judge(cfg: dict, check: dict, x: np.ndarray, pool: np.ndarray, qid: np.ndarray,
          labels: np.ndarray, dists: np.ndarray, device) -> dict:
    """The numbers compared, each with its limit, and the verdict. `qid`
    [R] names each answered row's query in `pool`; `labels`, `dists`
    [R, k] are what the timed path returned."""
    k = cfg["k"]
    labels = labels[:, :k]
    dists = dists[:, :k].astype(np.float64)
    bad = bad_rows(labels, dists, len(x))
    kth_d, _ = reference.exact_knn(x, pool, k, device)
    ref = reference.pair_dists(x, pool, qid, labels, tuple(cfg["stored_as"]), device)
    valid = (labels >= 0) & (labels < len(x))
    # (a row holding a label twice is a bad row, so the run is not correct
    # whatever this counts)
    found = valid & (ref[cfg["stored_as"][0]]
                     <= kth_d[qid, -1][:, None] + _TIE_SLACK * ref["scale"])
    recall = float(found.sum() / (len(labels) * k)) if len(labels) else 0.0
    gaps = np.min([np.abs(dists - ref[f]) for f in cfg["stored_as"]], axis=0)
    gaps = np.where(valid & np.isfinite(dists), gaps / np.maximum(ref["scale"], 1e-30), 0.0)
    worst_gap = float(gaps.max()) if gaps.size else 0.0
    if (valid & ~np.isfinite(dists)).any():
        worst_gap = float("inf")
    numbers = {
        "recall_at_10": {"value": recall, "min": check["recall_min"]},
        "dist_gap": {"value": worst_gap, "max": check["dist_gap_max"]},
        "bad_rows": {"value": int(bad.sum()), "max": 0},
    }
    ok = all(
        ("min" not in v or v["value"] >= v["min"]) and ("max" not in v or v["value"] <= v["max"])
        for v in numbers.values()
    )
    return {"correct": bool(ok and len(labels) > 0), "numbers": numbers,
            "recall": recall, "bad": int(bad.sum())}
