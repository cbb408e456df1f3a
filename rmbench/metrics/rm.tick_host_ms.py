"""rm.tick_host_ms: host milliseconds a tick that the QueryServer spent in
its own tick work, read from the program's spans in the profiled stretch:
``rm::serve.tick`` (``begin_tick``: writes, compile, launch, the express
finalize) and ``rm::serve.finish`` (``finish_tick``'s bulk finalize), less
the ``rm::wait`` inside them (the host blocked on the card) and the
collector's pauses (``rm::gc``: one can take a fifth of a second, which a
2-second stretch holds or not), over the count of ``rm::serve.tick``."""

from rmbench import spans


def read(run):
    trace = run.get("trace")
    ticks = spans.count(trace, spans.TICK) if trace is not None else 0
    if not ticks:
        return None
    server = spans.named(trace, spans.TICK, spans.FINISH)
    aside = spans.overlap(server, spans.named(trace, spans.WAIT, spans.GC))
    return (spans.length(server) - aside) * 1e-3 / ticks
