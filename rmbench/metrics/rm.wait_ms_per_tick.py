"""rm.wait_ms_per_tick: host milliseconds a tick in which the program was
blocked on the card (``rm::wait``: the express sums' pull of their scalar
pair, a copy from pageable memory, a pass handle's sync), over the count of
``rm::serve.tick`` in the profiled stretch."""

from rmbench import spans


def read(run):
    trace = run.get("trace")
    ticks = spans.count(trace, spans.TICK) if trace is not None else 0
    if not ticks:
        return None
    return spans.length(spans.named(trace, spans.WAIT)) * 1e-3 / ticks
