"""Device layer: the share of a batch's wall time in which no operation runs
on the card: one less the device's busy seconds per batch (the union of the
profiler's kernels, copies and fills over the traced batches) over the wall
seconds per batch of the window's untraced batches, which run without the
profiler's own host work."""

UNIT = "%"
MOVES = "qps"


def read(ctx):
    tr, n, win = ctx.get("trace"), ctx.get("trace_batches"), ctx["window"]
    if not tr or not n or win["batches"] <= n:
        return None
    wall = (win["window_s"] - win["sent_s"][n]) / (win["batches"] - n)
    return 100.0 * (1.0 - tr["busy_s"] / n / wall)
