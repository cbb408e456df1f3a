"""train.batch_ms: host milliseconds a profiled step in the data layer
(``rm::data.batch``: ``TrainPipeline``'s permutation, the rows' pick and
their gather from the record store's packed view)."""

from rmbench import spans


def read(run):
    trace = run.get("trace")
    batches = spans.named(trace, "rm::data.batch") if trace is not None else []
    if not batches:
        return None
    return spans.length(batches) * 1e-3 / run["profile_steps"]
