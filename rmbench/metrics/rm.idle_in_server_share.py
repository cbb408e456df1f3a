"""rm.idle_in_server_share: the share of the profiled stretch in which no
operation ran on the card while the host was inside the QueryServer's tick
(``rm::serve.tick`` or ``rm::serve.finish``): the server's part of
``rm.idle_share``; the rest falls in the client loop or in nothing."""

from rmbench import spans


def read(run):
    trace = run.get("trace")
    if trace is None:
        return None
    return spans.idle_share_in(trace, spans.named(trace, spans.TICK, spans.FINISH))
