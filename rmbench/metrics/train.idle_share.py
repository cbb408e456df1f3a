"""train.idle_share: the share of the profiled train steps in which no
operation ran on the card."""


def read(run):
    trace = run.get("trace")
    if trace is None or trace.window_s <= 0 or not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
