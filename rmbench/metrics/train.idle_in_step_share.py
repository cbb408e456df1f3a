"""train.idle_in_step_share: the share of the profiled steps in which no
operation ran on the card while the host was inside the step's own spans
(``rm::data.batch``, ``rm::train.forward``, ``rm::train.backward``,
``rm::train.update``): the program's part of ``train.idle_share``, apart from
the harness's sync a step and the profiler's buffer requests."""

from rmbench import spans


def read(run):
    trace = run.get("trace")
    if trace is None:
        return None
    return spans.idle_share_in(trace, spans.named(trace, *spans.STEP))
