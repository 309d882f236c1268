"""Beam loop layer: device milliseconds per traced batch in every operation
that is not one of the program's own CUDA kernels: the beam's dedup
compares, bitonic merges and selects, the landmark seeds' matmul and top-k,
and the copies of queries and answers."""

from benchmark.tracing import PORT_KERNELS

UNIT = "ms"
MOVES = "qps"


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not ctx.get("trace_batches"):
        return None
    secs = sum(v for name, v in tr["device_s_by_op"].items()
               if not any(k in name for k in PORT_KERNELS))
    return 1e3 * secs / ctx["trace_batches"]
