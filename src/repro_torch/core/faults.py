"""Deterministic fault injection + the lowering circuit breaker — a copy of
``repro.core.faults``.

In the port every site is wired as in the reference: the engine calls
:func:`maybe_fault` at ``upload``, ``stream_chunk``, ``scan_launch``,
``lowering`` and ``join_build``, the sharded backend at ``shard_pass`` and
``collective_combine``, the engine holds a :class:`CircuitBreaker`, and the
``QueryServer`` retries :class:`TransientFault`.  Three deliberate
differences.  The sharded backend retries and fails over on an injected
fault only (a real kernel error propagates), and its failover re-runs the
shard through the fused scan kernel on the root device rather than an XLA
fallback.  And where the text below says
a lowering *failure* reroutes to the XLA fallback, the port reroutes only on
a CPU engine, and only an injected ``lowering`` fault (or an open route), to
the plain PyTorch version there.  On the card the breaker is not consulted:
an injected ``lowering`` fault propagates like the other sites' faults, and
a real error of a CUDA kernel propagates everywhere.  The text below
describes the reference package.

A real deployment of Relational Memory sits *between* the CPU and memory:
the accelerator path can fail — a lowering error on a new target, a device
dropping mid-pass, an interconnect hiccup during a cross-shard combine —
and the serving stack has to recover without losing writes, hanging
clients, or silently returning wrong answers.  None of those failures
occur naturally in a CPU interpret-mode test run, so this module makes
them *schedulable*: a :class:`FaultPlan` scripts exactly which named
**injection site** raises what, on which hit, and the hot paths consult
:func:`maybe_fault` at every site.  Every failure path in the engine,
the sharded backend, and the serving loop is thereby reproducible in
tests and CI — not just theorized.

Injection sites (each named call is threaded through the corresponding
hot path):

==================== =====================================================
``upload``           host→device row-store transfer (full or delta sync)
``scan_launch``      a tick's fused scan entering the backend scan hook
``shard_pass``       one shard's fused pass (``ShardedEngine``)
``collective_combine`` the cross-shard combine of reduced partials
``join_build``       build-side hash partitioning for the device join
``stream_chunk``     one chunk of a streamed projection
``lowering``         Pallas kernel dispatch (scan or join probe)
==================== =====================================================

Faults are **typed**: a :class:`TransientFault` models a failure that a
bounded retry can outlast (the plan stops firing after ``times`` hits);
a :class:`PermanentFault` models a failure that will never succeed on
retry (device loss, an unlowerable kernel).  The recovery layers key off
the type — transients are retried, permanents skip straight to failover
or a typed client error.

Plans are scriptable (``inject(site, at=N)`` fires on the Nth hit) and
seeded (``inject_random(site, p=...)`` draws from the plan's own
``random.Random(seed)``), so a chaos run is reproducible bit-for-bit.
Install a plan globally with :func:`install`/:func:`clear` or the
:func:`fault_plan` context manager; with no plan installed,
:func:`maybe_fault` is a single ``None`` check — the fault-free hot path
stays unmeasurably close to uninstrumented (gated ≤5% by
``benchmarks/fig_fault_recovery.py``).

:class:`CircuitBreaker` lives here too: the engine wraps every Pallas
kernel dispatch with it, counting lowering failures per (table,
request-shape) route and flipping a repeatedly-failing route to the XLA
fallback (``scan_multi_xla`` / ``hash_join_xla``) for a cooldown, with
half-open probes to recover — the classic pattern, counter-based so it
is deterministic under test.  See ``docs/reliability.md``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
from typing import Iterator

SITES = (
    "upload",
    "scan_launch",
    "shard_pass",
    "collective_combine",
    "join_build",
    "stream_chunk",
    "lowering",
)


class FaultError(RuntimeError):
    """Base of every injected fault; carries its site and hit index."""

    kind = "fault"

    def __init__(self, site: str, hit: int):
        super().__init__(f"injected {self.kind} fault at site {site!r} "
                         f"(hit {hit})")
        self.site = site
        self.hit = hit


class TransientFault(FaultError):
    """A failure a bounded retry can outlast (spurious device error)."""

    kind = "transient"


class PermanentFault(FaultError):
    """A failure that never succeeds on retry (device loss, unlowerable
    kernel) — recovery means failover or a typed client error, not
    persistence."""

    kind = "permanent"


_KINDS = {"transient": TransientFault, "permanent": PermanentFault}


@dataclasses.dataclass
class FaultSpec:
    """One scripted fault: fire ``times`` consecutive hits starting at the
    ``at``-th matching hit of ``site`` (1-based).  ``times=None`` fires on
    every hit from ``at`` on — a deterministically failing route.
    ``match`` restricts which hits count: a hit matches iff every key the
    spec names equals the context the site passed (e.g. ``shard=1``).
    ``p`` (random mode) fires each matching hit with probability ``p``
    from the plan's seeded RNG instead of by position."""

    site: str
    at: int = 1
    times: int | None = 1
    kind: str = "transient"
    match: dict = dataclasses.field(default_factory=dict)
    p: float | None = None
    hits: int = 0
    fired: int = 0

    def _matches(self, ctx: dict) -> bool:
        return all(ctx.get(k) == v for k, v in self.match.items())


class FaultPlan:
    """A seeded, scriptable registry of faults to inject.

    Build one, script it (chainable), install it::

        plan = FaultPlan().inject("shard_pass", at=1, shard=1)
        with fault_plan(plan):
            server.drain()
        assert plan.fired("shard_pass") == 1

    The plan is pure bookkeeping — it never touches engine state — so the
    same plan object can be inspected after the run to assert exactly
    which faults fired.
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.specs: list[FaultSpec] = []
        self._rng = random.Random(seed)

    # ------------------------------------------------------------ scripting
    def inject(self, site: str, at: int = 1, kind: str = "transient",
               times: int | None = 1, **match) -> "FaultPlan":
        """Script a fault: raise ``kind`` on hits ``[at, at + times)`` of
        ``site`` (restricted to hits whose context matches ``match``)."""
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r}; want one of {SITES}")
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; "
                             "want 'transient' or 'permanent'")
        if at < 1:
            raise ValueError(f"at must be >= 1, got {at}")
        self.specs.append(FaultSpec(site, at=at, times=times, kind=kind,
                                    match=dict(match)))
        return self

    def inject_random(self, site: str, p: float, kind: str = "transient",
                      **match) -> "FaultPlan":
        """Script a seeded random fault: each matching hit of ``site`` fires
        with probability ``p`` (drawn from the plan's own RNG, so a fixed
        seed reproduces the exact same fault schedule)."""
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r}; want one of {SITES}")
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"p must be in [0, 1], got {p}")
        self.specs.append(FaultSpec(site, kind=kind, match=dict(match), p=p))
        return self

    # -------------------------------------------------------------- firing
    def hit(self, site: str, **ctx) -> None:
        """Record one hit of ``site``; raises the first spec due to fire."""
        due: FaultSpec | None = None
        for spec in self.specs:
            if spec.site != site or not spec._matches(ctx):
                continue
            spec.hits += 1
            if due is not None:
                continue  # one fault per hit; later specs still count hits
            if spec.p is not None:
                if self._rng.random() < spec.p:
                    due = spec
            elif spec.hits >= spec.at and (
                spec.times is None or spec.hits < spec.at + spec.times
            ):
                due = spec
        if due is not None:
            due.fired += 1
            raise _KINDS[due.kind](site, due.hits)

    # ----------------------------------------------------------- reporting
    def fired(self, site: str | None = None) -> int:
        """Total faults raised (optionally for one site)."""
        return sum(s.fired for s in self.specs
                   if site is None or s.site == site)

    def hits_at(self, site: str) -> int:
        """Times the site was reached (max over specs watching it; 0 when
        nothing watches it)."""
        return max((s.hits for s in self.specs if s.site == site), default=0)


# ------------------------------------------------------- global installation
_ACTIVE: FaultPlan | None = None


def install(plan: FaultPlan) -> FaultPlan:
    """Make ``plan`` the process-wide active plan (returns it)."""
    global _ACTIVE
    _ACTIVE = plan
    return plan


def clear() -> None:
    """Deactivate fault injection (the production state)."""
    global _ACTIVE
    _ACTIVE = None


def active_plan() -> FaultPlan | None:
    return _ACTIVE


@contextlib.contextmanager
def fault_plan(plan: FaultPlan | None = None) -> Iterator[FaultPlan]:
    """Scope a plan's installation: ``with fault_plan(plan): ...`` — always
    cleared on exit, so a failing chaos test never leaks faults into the
    next one."""
    global _ACTIVE
    plan = plan if plan is not None else FaultPlan()
    prev = _ACTIVE
    install(plan)
    try:
        yield plan
    finally:
        _ACTIVE = prev


def maybe_fault(site: str, **ctx) -> None:
    """The hot-path hook: a no-op unless a plan is installed.

    Sites pass identifying context (``shard=``, ``table=``, ...) so plans
    can target, e.g., shard 1's second pass specifically.  Keep this call
    cheap — it sits on every upload, scan, and stream chunk."""
    if _ACTIVE is not None:
        _ACTIVE.hit(site, **ctx)


# ========================================================== circuit breaker
@dataclasses.dataclass
class _Route:
    """Breaker state for one (table, request-shape) route."""

    state: str = "closed"  # "closed" | "open" | "half_open"
    streak: int = 0  # consecutive failures while closed
    cooldown_left: int = 0  # fallback serves remaining while open


class CircuitBreaker:
    """Counter-based circuit breaker over kernel-lowering routes.

    ``closed`` routes attempt the Pallas kernel; ``threshold`` consecutive
    failures **trip** the route ``open``, and the next ``cooldown`` serves
    go straight to the XLA fallback without attempting (no repeated
    lowering cost, no repeated exception).  After the cooldown the route is
    ``half_open``: one probe attempt is allowed — success closes it,
    failure re-trips a fresh cooldown.  Everything is counted in *serves*,
    not wall time, so tests and CI are deterministic.
    """

    def __init__(self, threshold: int = 3, cooldown: int = 4):
        if threshold < 1 or cooldown < 1:
            raise ValueError("threshold and cooldown must be >= 1")
        self.threshold = threshold
        self.cooldown = cooldown
        self._routes: dict = {}
        self.trips = 0  # closed/half_open -> open transitions
        self.fallbacks = 0  # serves routed to the fallback while open
        self.probes = 0  # half-open probe attempts

    def _route(self, key) -> _Route:
        route = self._routes.get(key)
        if route is None:
            route = self._routes[key] = _Route()
        return route

    def allow(self, key) -> bool:
        """Should this serve attempt the Pallas kernel?  ``False`` routes it
        to the fallback (and burns one cooldown serve)."""
        route = self._route(key)
        if route.state == "open":
            route.cooldown_left -= 1
            if route.cooldown_left <= 0:
                route.state = "half_open"
            self.fallbacks += 1
            return False
        if route.state == "half_open":
            self.probes += 1
        return True

    def record_failure(self, key) -> None:
        route = self._route(key)
        if route.state == "half_open":
            route.state = "open"
            route.cooldown_left = self.cooldown
            self.trips += 1
            return
        route.streak += 1
        if route.streak >= self.threshold:
            route.state = "open"
            route.cooldown_left = self.cooldown
            route.streak = 0
            self.trips += 1

    def record_success(self, key) -> None:
        route = self._route(key)
        route.streak = 0
        if route.state == "half_open":
            route.state = "closed"  # the probe succeeded: recovered

    # ----------------------------------------------------------- reporting
    def state(self, key) -> str:
        route = self._routes.get(key)
        return route.state if route is not None else "closed"

    @property
    def open_routes(self) -> int:
        return sum(1 for r in self._routes.values() if r.state != "closed")

    def snapshot(self) -> dict:
        """Flat counters for the serving layer's ``snapshot()`` export."""
        return {
            "breaker_trips": self.trips,
            "breaker_fallbacks": self.fallbacks,
            "breaker_probes": self.probes,
            "breaker_open": self.open_routes,
        }
