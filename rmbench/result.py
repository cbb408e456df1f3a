"""What a run hands back, the statistics its metrics use, and the last line
it prints."""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class Check:
    """One number compared against the reference, beside its limit: the
    run is correct only where ``value <= limit`` for every check."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return not math.isnan(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """A driver's run: its end-to-end values (all it measured; the cell
    reports those the manifest gives it), what the per-layer readers read
    (``layer``: counters, spans, the device trace), the checks, and the
    device's readings."""

    end_to_end: dict[str, float]
    layer: dict
    checks: list[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int

    @property
    def trace(self):
        """The traced stretch's ``trace.DeviceTrace``, where there is one."""
        return self.layer.get("trace")

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(c.ok for c in self.checks)


def percentile(values, q: float) -> float:
    """Nearest-rank ``q``-th percentile over every value (no sampling)."""
    if not values:
        raise ValueError("percentile of no values")
    s = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(s)))
    return s[min(rank, len(s)) - 1]


def rate(count: float, seconds: float) -> float:
    """Work over the whole window's seconds."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return count / seconds


def checks_line(checks: list[Check]) -> dict:
    return {c.name: {"value": c.value, "limit": c.limit} for c in checks}


def result_line(cell, outcome: Outcome, trace: bool, device: dict, layer_values: dict) -> dict:
    """The contract's last line: ``correct``, ``attempted``, ``failed``,
    ``metrics`` (end-to-end with ``--trace 0``, per-layer with ``--trace
    1``), ``device``, with a trace ``breakdown``, and the checks last."""
    if trace:
        units = {m.name: m.unit for m in cell.per_layer}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in layer_values.items()
                   if v is not None}
    else:
        metrics = {m.name: {"value": outcome.end_to_end[m.name], "unit": m.unit}
                   for m in cell.end_to_end}
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": device}
    if trace and outcome.trace is not None:
        line["breakdown"] = outcome.trace.breakdown()
    line["checks"] = checks_line(outcome.checks)
    return line
