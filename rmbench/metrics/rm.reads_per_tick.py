"""rm.reads_per_tick: reads the QueryServer served a tick over the traced
window (its ServerStats deltas): how many reads share a tick's pass."""


def read(run):
    c = run.get("counters")
    if not c or not c["ticks"]:
        return None
    return c["reads"] / c["ticks"]
