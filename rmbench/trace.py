"""The traced stretch of a run: ``torch.profiler`` over a short stretch after
the measured window, reduced to the device's kernels, its busy time, the
idle gaps between kernels and what the host was doing in each.  The
benchmark names its own host spans ``rmbench.<what>`` (``record``); the
program's spans and counters are read elsewhere.  Nothing is written to
disk."""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

SPAN_PREFIX = "rmbench."
TOP = 10


def record(what: str):
    """A host span of the benchmark's own, visible in the trace."""
    return torch.profiler.record_function(SPAN_PREFIX + what)


@dataclasses.dataclass
class DeviceTrace:
    """Device operations ``(name, start_us, end_us)`` in start order, host
    events likewise, and the stretch's bounds in the same time base."""

    ops: list[tuple[str, float, float]]
    host: list[tuple[str, float, float]]
    start_us: float
    end_us: float

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) * 1e-6

    def _intervals(self) -> list[tuple[float, float]]:
        spans = sorted((max(s, self.start_us), min(e, self.end_us)) for _, s, e in self.ops)
        merged: list[list[float]] = []
        for s, e in spans:
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(e - s for s, e in self._intervals()) * 1e-6

    def seconds(self, match) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(e - s for name, s, e in self.ops if match(name)) * 1e-6

    def count(self, match) -> int:
        return sum(1 for name, _, _ in self.ops if match(name))

    def seconds_with_followers(self, match, follower: str) -> float:
        """Like :meth:`seconds`, plus each op named ``follower`` that comes
        right after one ``match`` accepts (a launch's reduction of its
        partials belongs to the launch)."""
        total, owned = 0.0, False
        for name, s, e in self.ops:
            if follower in name:
                if owned:
                    total += e - s
                continue
            owned = bool(match(name))
            if owned:
                total += e - s
        return total * 1e-6

    def _host_at(self, t: float) -> str:
        """What the host was doing at ``t``: the innermost of the
        benchmark's spans and the innermost other host event around it."""
        best: dict[bool, tuple[float, str]] = {}
        for name, s, e in self.host:
            if s > t:
                break
            if e < t or name == SPAN_PREFIX + "stretch":
                continue
            ours = name.startswith(SPAN_PREFIX)
            if ours not in best or e - s < best[ours][0]:
                best[ours] = (e - s, name)
        names = [best[k][1] for k in (True, False) if k in best]
        return " > ".join(names) or "no host event"

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest idle
        gaps by what the host was doing (``[name, seconds]`` each)."""
        by_name: dict[str, float] = {}
        for name, s, e in self.ops:
            by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:TOP]
        gaps, t = [], self.start_us
        for s, e in self._intervals() + [(self.end_us, self.end_us)]:
            if s > t:
                gaps.append((s - t, t))
            t = max(t, e)
        gaps.sort(reverse=True)
        idle = [[self._host_at(t0 + g / 2), g * 1e-6] for g, t0 in gaps[:TOP]]
        return {"device_ops": [[k[:120], v] for k, v in ops],
                "idle_gaps": [[k[:120], v] for k, v in idle]}


@contextlib.contextmanager
def profiled(device: torch.device):
    """Profile the body; yields a holder whose ``trace`` is the
    :class:`DeviceTrace` once the body has ended (in a device sync)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    holder = type("Holder", (), {"trace": None})()
    with profile(activities=acts) as prof:
        with record("stretch"):
            yield holder
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    ops, host, bounds = [], [], None
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            # a host span's copy on the device timeline is no operation
            if not (getattr(e, "is_user_annotation", False) or e.name.startswith(SPAN_PREFIX)):
                ops.append(span)
        else:
            host.append(span)
            if e.name == SPAN_PREFIX + "stretch":
                bounds = span[1:]
    ops.sort(key=lambda x: x[1])
    host.sort(key=lambda x: x[1])
    if bounds is None:
        bounds = (host[0][1], host[-1][2]) if host else (0.0, 0.0)
    holder.trace = DeviceTrace(ops, host, *bounds)


class HostClock:
    """Seconds since the process began, by the host's clock."""

    def __init__(self, t0: float):
        self.t0 = t0
        self.marks: dict[str, float] = {}  # named points of the start, in seconds

    def mark(self, name: str) -> None:
        self.marks[name] = self.now()

    def now(self) -> float:
        return time.perf_counter() - self.t0
