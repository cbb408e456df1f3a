"""The program's own spans in a traced stretch: ``repro_torch``'s ``rm::``
ranges, which ``torch.profiler`` keeps among the host events of
:class:`~rmbench.trace.DeviceTrace` on the same clock as the card's
operations.  Intervals are ``(start_us, end_us)``; a program without the
spans gives empty lists and zero counts, and the readers then return
``None``."""

from __future__ import annotations

TICK = "rm::serve.tick"
FINISH = "rm::serve.finish"
COMPILE = "rm::serve.compile"
PLAN = "rm::planner.compile_plan"
WAIT = "rm::wait"
GC = "rm::gc"
STEP = ("rm::data.batch", "rm::train.forward", "rm::train.backward", "rm::train.update")


def named(trace, *names: str) -> list[tuple[float, float]]:
    """The intervals of the host events called one of ``names``."""
    return [(s, e) for n, s, e in trace.host if n in names]


def count(trace, name: str) -> int:
    return sum(1 for n, _, _ in trace.host if n == name)


def merged(intervals) -> list[tuple[float, float]]:
    """The union of ``intervals`` as disjoint intervals in order."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def length(intervals) -> float:
    """Microseconds covered by ``intervals`` (overlaps counted once)."""
    return sum(e - s for s, e in merged(intervals))


def overlap(a, b) -> float:
    """Microseconds covered by both ``a`` and ``b``."""
    a, b = merged(a), merged(b)
    total, j = 0.0, 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            total += min(e, b[k][1]) - max(s, b[k][0])
            k += 1
    return total


def idle(trace) -> list[tuple[float, float]]:
    """The stretch's intervals in which no operation ran on the device (the
    whole stretch where the trace holds none)."""
    gaps, t = [], trace.start_us
    busy = merged((max(s, trace.start_us), min(e, trace.end_us)) for _, s, e in trace.ops)
    for s, e in busy + [(trace.end_us, trace.end_us)]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    return gaps


def idle_share_in(trace, spans) -> float | None:
    """Percent of the stretch in which the device was idle while the host
    was inside ``spans``; ``None`` without spans or a stretch."""
    window = trace.end_us - trace.start_us
    if not spans or window <= 0:
        return None
    return 100.0 * overlap(idle(trace), spans) / window
