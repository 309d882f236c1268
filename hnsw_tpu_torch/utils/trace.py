"""Named spans on the torch profiler's clock.

`span(name)` opens a host range that a running `torch.profiler` records
beside its aten ops, CUDA runtime calls and device kernels, on the same
clock; with no profiler running it returns one shared do-nothing context,
so a span costs a flag check and a `with`. There is no switch: spans exist
exactly while a profiler runs.

The range is a FUNCTION-scope record (`_RecordFunctionFast`), not a user
annotation (`record_function`): under CUDA activity the profiler mirrors
user annotations as events of CUDA device type, which would count as
device work in any reading of busy time, and `record_function` costs ~13 µs
a span even with no profiler running.
"""

from __future__ import annotations

import torch


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


def span(name: str):
    """A context that records `name` as a host range while a torch profiler
    runs, else the shared no-op `NO_SPAN`."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return NO_SPAN
