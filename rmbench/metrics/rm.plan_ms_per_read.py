"""rm.plan_ms_per_read: host milliseconds of the QueryServer's compile step
(``rm::serve.compile``) over the reads it compiled (one
``rm::planner.compile_plan`` each) in the profiled stretch, less the
collector's pauses inside it (``rm::gc``): the program's own reading of what
``rm.compile_ms_per_read`` times from outside over the window, where a
pause is spread over many more reads."""

from rmbench import spans


def read(run):
    trace = run.get("trace")
    reads = spans.count(trace, spans.PLAN) if trace is not None else 0
    if not reads:
        return None
    planning = spans.named(trace, spans.COMPILE)
    aside = spans.overlap(planning, spans.named(trace, spans.GC))
    return (spans.length(planning) - aside) * 1e-3 / reads
