"""Kernels layer: the hop kernel's share of its roofline over the traced
batches: the least time the launches' inputs need (benchmark/roofline.py:
each launch's distinct node blocks, query rows and ids read, distances and
ids written, at the published HBM rate) over the kernel's device time in
the profiler for the same launches."""

from benchmark import roofline

UNIT = "%"
MOVES = "qps"


def read(ctx):
    tr, launches = ctx.get("trace"), ctx.get("hop_launches")
    if not tr or not launches or tr["hop_launches"] != len(launches) or tr["hop_s"] <= 0:
        return None
    least = sum(roofline.hop_least_seconds(tier, [(b, e, n)], m0, d)
                for tier, m0, d, b, e, n in launches)
    return 100.0 * least / tr["hop_s"]
