"""Per-layer metric readers, one file a metric, named as the metric: each
``read(run) -> float | None`` takes what a traced run gathered (the
driver's ``Outcome.layer``: counters, spans, recorded passes, the device
trace) and returns nothing where it finds nothing to read."""
