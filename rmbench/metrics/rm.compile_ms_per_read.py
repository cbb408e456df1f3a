"""rm.compile_ms_per_read: host milliseconds the QueryServer spent in its
compile step (``_compile_reads``, the planner's ``compile_plan`` for every
read of a tick) a read, from the benchmark's span around the call over the
traced window."""


def read(run):
    span = run.get("compile_span")
    if not span or not span["reads"]:
        return None
    return span["seconds"] * 1e3 / span["reads"]
