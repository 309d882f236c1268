"""Bulk build layer: the waves' search stage seconds over the sum of their
sync, search, select and link seconds, from the built index's wave_log."""

UNIT = "%"
MOVES = "setup_s"
_STAGES = ("sync_s", "search_s", "select_s", "link_s")


def read(ctx):
    waves = ctx.get("wave_log") or []
    total = sum(w.get(s, 0.0) for w in waves for s in _STAGES)
    if total <= 0:
        return None
    return 100.0 * sum(w.get("search_s", 0.0) for w in waves) / total
