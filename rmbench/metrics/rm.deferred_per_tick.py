"""rm.deferred_per_tick: express reads a tick that ``begin_tick`` left to
``finish_tick`` because their answer was still on its way from the card
(``rm::serve.settle``, one a deferred read), over the count of
``rm::serve.tick`` in the profiled stretch.  A program without the span
reads nothing."""

from rmbench import spans

SETTLE = "rm::serve.settle"


def read(run):
    trace = run.get("trace")
    if trace is None:
        return None
    ticks, settles = spans.count(trace, spans.TICK), spans.count(trace, SETTLE)
    if not ticks or not settles:
        return None
    return settles / ticks
