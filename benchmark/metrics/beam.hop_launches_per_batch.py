"""Beam loop layer: the node-block hop kernel's launches per batch over the
whole window, from the program's launch counts (one launch per beam
iteration at level 0)."""

from benchmark.program import HOP_COUNTERS

UNIT = "launches"
MOVES = "qps"


def read(ctx):
    before, after = ctx["counts_before"], ctx["counts_after"]
    n = sum(after[f] - before[f] for f in HOP_COUNTERS)
    if not n or not ctx["window"]["batches"]:
        return None
    return n / ctx["window"]["batches"]
