"""The port's spans: host ranges on ``torch.profiler``'s clock.

``span(name)`` opens a range in the running profiler, so the span lands in
the same trace and on the same clock as the card's kernels, beside them.  It
records through ``_RecordFunctionFast``, the profiler's range that skips the
dispatcher (``torch.profiler.record_function`` is an operator call of its
own, about eight times the cost, and a span's cost lands inside what the
spans around it measure).  When no profiler records it returns one shared
null context: a span then costs a function call and a flag test.  Any
``torch.profiler`` session records the spans; nothing here keeps timestamps,
buffers or writes anything.  Every name starts with ``rm::`` (the names,
where each opens and what reads it: ``docs/spans_torch.md``).

The collector's pauses are spans too: a ``gc.callbacks`` hook opens
``rm::gc`` when a collection starts and closes it when it stops, only while
a profiler records.
"""

from __future__ import annotations

import contextlib
import gc

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

WAIT = "rm::wait"  # the host blocked on the card
GC = "rm::gc"

_OFF = contextlib.nullcontext()


def span(name: str):
    """A range named ``name`` in the running profiler's trace, or the shared
    null context when none records."""
    if _profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _OFF


class _GcSpans:
    """``rm::gc`` around each collection that starts while a profiler
    records (a collection never nests in another)."""

    def __init__(self):
        self.open = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            if _profiler._is_profiler_enabled:
                self.open = _RecordFunctionFast(GC)
                self.open.__enter__()
        elif self.open is not None:
            rec, self.open = self.open, None
            rec.__exit__(None, None, None)


if not any(isinstance(cb, _GcSpans) for cb in gc.callbacks):
    gc.callbacks.append(_GcSpans())
