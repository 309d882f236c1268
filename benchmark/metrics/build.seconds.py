"""Bulk build layer: wall seconds of the bulk_build call in set-up (a span
the benchmark takes around the call)."""

UNIT = "s"
MOVES = "setup_s"


def read(ctx):
    return ctx.get("build_s")
