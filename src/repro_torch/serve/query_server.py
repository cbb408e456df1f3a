"""Concurrent query serving: many clients, one engine, shared scans per tick —
with live HTAP writes, pipelined ticks, priority lanes, and streaming results.
The port of ``repro.serve.query_server``.

What the port leaves out, each raising ``NotImplementedError`` that names
its ROADMAP item: the mesh-sharded backend (``mesh=`` / ``num_shards=``,
queue 1 item 6) and the write-ahead log (a non-``None`` ``wal=``, item 4).
``snapshot()`` has no circuit-breaker fields, because the port's engine has
no breaker yet (item 4).

The paper's closing argument (§8) is that native column access "can vastly
simplify the software logic" of an analytics engine.  This module is the
multi-tenant half of that story: a :class:`QueryServer` owns one
:class:`~repro_torch.core.engine.RelationalMemoryEngine` and admits *logical plans* (:mod:`repro_torch.core.plan`) from
any number of concurrent clients.  Requests are not executed as they arrive
— they queue, and each serving **tick** drains a batch, compiles every plan
(:func:`repro_torch.core.planner.compile_plan`), and coalesces the tick's scan ops
into **one** ``execute_many`` call: same-table work from different clients —
projections, fused filters, fused aggregates, and group-bys alike,
regardless of lane — rides a single shared Fetch-Unit stream (the
heterogeneous one-pass kernel ``rme_scan_multi``), so a mixed-kind
same-table tick performs exactly one row-store pass instead of one per op
kind.  Nothing in the tick syncs with the host until finalize.

The pipelined tick (double buffering)
-------------------------------------
A tick splits into :meth:`QueryServer.begin_tick` — drain, apply writes,
serve the express lane, compile the bulk lane, and *enqueue* its device pass
(:meth:`~repro_torch.core.engine.RelationalMemoryEngine.execute_many_async` +
per-query ``launch``, no host syncs) — and :meth:`QueryServer.finish_tick`,
the only blocking half, which finalizes the bulk results and resolves their
tickets.  ``drain()`` and the background loop interleave them double-
buffered: tick N+1's admission drain, write application, and ``compile_plan``
run while tick N's device pass is still in flight (``begin_tick(N+1)`` →
``finish_tick(N)``), so compile and device time overlap instead of adding.
This is safe because a launched pass holds immutable device arrays — tick
N+1's writes patch the *host* row store and upload fresh delta chunks; they
cannot retroactively change work already enqueued — and because each read
was compiled against its own tick's post-write snapshot.  Serial semantics
are a flag away (``pipeline=False``) and ``run_tick()`` is still
begin+finish in one call.

Priority lanes, deadlines, backpressure
---------------------------------------
Tickets ride one of two **lanes**.  The *express* lane is for point work —
writes, fused aggregates, small group-bys (estimated result ≤
``express_result_bytes``) — drained ahead of any bulk backlog and served to
completion inside ``begin_tick``: its scalar-sized results are finalized
immediately, while the tick's bulk results (and their O(rows) host
transfers) stay in flight until ``finish_tick``.  An express ticket
therefore never waits behind a queued 50k-row packed projection — though
co-tick scans of the same table still fuse into one shared pass, lanes and
all.  The *bulk* lane carries everything else through the pipelined pass
above.  Lanes are
auto-classified from the plan shape; ``submit(..., lane=...)`` overrides.
Per-ticket ``deadline_s`` bounds queue wait + service: an expired ticket
fails with :class:`DeadlineExceeded` (a ``TimeoutError``) at drain or
finalize time instead of hanging, and is counted per lane.  Admission is
bounded by ``max_queue``: beyond it the server **sheds**
(:class:`ServerOverloaded` at submit) or **degrades** (admits demoted to the
bulk lane, deadline stripped) per the ``overload`` policy — and hard-sheds
at twice the bound so memory stays bounded either way.

Streaming results
-----------------
``submit(..., stream=True)`` (projection-shaped rme plans) returns a
:class:`StreamingTicket` whose result arrives **incrementally**: the engine
streams the packed projection one resident row-store chunk at a time
(:meth:`~repro_torch.core.engine.RelationalMemoryEngine.stream_project`;
``stream_chunk_rows`` re-slices large base chunks), the serving loop pushes
each chunk into the ticket as its scan lands, and ``chunks()`` yields them
while the pass is still running.  ``result()`` still returns the full block
— byte-identical to the blocking route.

The write path (HTAP)
---------------------
Clients also submit **write tickets** — :meth:`QueryServer.submit_insert` /
``submit_update`` / ``submit_delete`` — which always ride the express lane.
A tick applies its writes *first*, in admission order, then serves every
read of the tick from the resulting state: one consistent post-write
snapshot per tick, so readers never block on writers and writers never wait
for readers (MVCC gives pinned readers their own view regardless).  Once a
server has admitted any write (or always, with ``snapshot_reads=True``), the
snapshot is explicit — each read is compiled with ``snapshot_ts`` set to its
table's post-write clock, fusing the MVCC visibility test in-scan (see
:func:`repro_torch.core.planner.compile_plan`; note this changes project-shaped
results to the ``(packed, mask)`` filter contract).  Because the engine's
row store is delta-chunked, a tick's writes cost O(delta) host→device bytes:
appended rows ship as tail chunks, deletes and updates ship only patched
timestamp words, and hot views survive appends via incremental tail scans
instead of cold rebuilds.

Fault tolerance (``docs/reliability.md``)
-----------------------------------------
The tick executor degrades gracefully instead of failing wholesale.  A
transient fault (:class:`repro_torch.core.faults.TransientFault` — an injected
or real spurious failure of an upload, scan, or stream) retries the
affected ticket up to ``max_retries`` times on its individual fallback
path; a ticket that *keeps* failing resolves typed and its plan signature
enters **poison quarantine** — re-submissions of the same shape fail
immediately with :class:`PoisonedPlanError` for ``poison_cooldown_ticks``
ticks instead of burning retry budget, and the rest of the tick is never
poisoned (a failing shared step falls back to per-query execution).  The
reference's circuit breaker and write-ahead log are not ported.

Threading model: ``submit*`` is thread-safe and non-blocking (clients get a
:class:`QueryTicket` and block on ``result()`` — or iterate ``chunks()`` —
at their leisure); all engine *and table* work happens on whichever single
thread calls ``begin_tick``/``finish_tick``/``run_tick`` — either the
caller's (deterministic, what the tests drive) or the background serving
thread started by ``start()``/the ``serving()`` context manager.  Kernel
launches, device buffers, and the host row stores are therefore never
touched from two threads at once (every launch names the engine's device,
so the serving thread needs no current-device setup).

Accounting: the server reports engine-level :class:`~repro_torch.core.engine.
EngineStats` plus its own :class:`ServerStats` — queue depth, shared-scan
ratio, ``bytes_saved``, write counters, and per-lane :class:`LaneStats`:
served/failed/deadline-miss counts, result bytes, and bounded
:class:`LatencyReservoir` samples of total latency, queue wait, and service
time, from which ``snapshot()`` exports p50/p95/p99 per lane.  See
``docs/metrics.md`` for every counter's charging rule and
``docs/serving.md`` for operating the loop under load.
"""

from __future__ import annotations

import dataclasses
import math
import random
import threading
import time
from collections import deque
from typing import Any, Iterator, Mapping

import numpy as np
import torch

from repro_torch.core import faults
from repro_torch.core.engine import RelationalMemoryEngine
from repro_torch.core.plan import PlanBuilder, PlanNode, Scan, decompose
from repro_torch.core.planner import (
    CompileOptions,
    PhysicalQuery,
    _device_join_expressible,
    compile_plan,
)
from repro_torch.core.requests import ProjectOp
from repro_torch.core.table import RelationalTable

LANES = ("express", "bulk")


class DeadlineExceeded(TimeoutError):
    """The ticket's ``deadline_s`` elapsed before the server could serve it.

    Raised *through the ticket* (``result()`` re-raises it): the serving loop
    resolves an expired ticket with this error at drain or finalize time, so
    a missed deadline is a prompt, typed failure — never a hang."""


class ServerOverloaded(RuntimeError):
    """Admission refused: the queue is at ``max_queue`` under the ``"shed"``
    policy (or at twice the bound under ``"degrade"`` — the hard limit that
    keeps a degrading server memory-bounded).  The message names the lane
    that shed and both lanes' queue depths; per-lane shed counts live in
    ``LaneStats.shed``."""


class PoisonedPlanError(RuntimeError):
    """The plan's signature is in poison quarantine: an identically-shaped
    query exhausted its transient-fault retries within the last
    ``poison_cooldown_ticks`` ticks, so the server fails this one
    immediately — typed, at compile time — instead of burning another
    tick's retry budget on a deterministically failing plan."""


class LatencyReservoir:
    """Bounded latency sample: exact percentiles up to ``cap`` samples, then
    uniform reservoir sampling (Vitter's Algorithm R) — every observation
    ever added has equal probability ``cap/count`` of being in the sample,
    so the percentile estimate stays unbiased while memory stays O(cap) for
    millions of tickets.  ``count``/``sum``/``max`` are exact regardless.
    The RNG is seeded, so a deterministic workload reports deterministic
    percentiles."""

    __slots__ = ("cap", "count", "sum", "max", "_samples", "_rng")

    def __init__(self, cap: int = 4096, seed: int = 0x5EED):
        if cap <= 0:
            raise ValueError("reservoir cap must be positive")
        self.cap = cap
        self.count = 0
        self.sum = 0.0
        self.max = 0.0
        self._samples: list[float] = []
        self._rng = random.Random(seed)

    def add(self, x: float) -> None:
        self.count += 1
        self.sum += x
        if x > self.max:
            self.max = x
        if len(self._samples) < self.cap:
            self._samples.append(x)
        else:
            j = self._rng.randrange(self.count)
            if j < self.cap:
                self._samples[j] = x

    @property
    def mean(self) -> float:
        return self.sum / max(self.count, 1)

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over the retained sample (exact while
        ``count <= cap``); 0.0 when empty."""
        if not self._samples:
            return 0.0
        s = sorted(self._samples)
        rank = max(1, math.ceil(q / 100.0 * len(s)))
        return s[min(rank, len(s)) - 1]


def _reservoir() -> LatencyReservoir:
    return LatencyReservoir()


class QueryTicket:
    """A client's handle on one admitted request; resolved at end of its tick.

    Read tickets resolve to their query result; write tickets resolve to the
    new physical row indices (insert/update) or ``None`` (delete).  A ticket
    whose ``deadline_s`` expires resolves with :class:`DeadlineExceeded`.
    """

    __slots__ = ("client", "lane", "deadline_s", "submitted_at", "admitted_at",
                 "queue_wait_s", "latency_s", "route",
                 "_event", "_result", "_error")

    def __init__(self, client: str, lane: str = "bulk",
                 deadline_s: float | None = None):
        self.client = client
        self.lane = lane
        self.deadline_s = deadline_s
        self.submitted_at = time.perf_counter()
        self.admitted_at: float | None = None  # set when a tick drains it
        self.queue_wait_s: float | None = None
        self.latency_s: float | None = None
        self.route: str | None = None
        self._event = threading.Event()
        self._result: Any = None
        self._error: BaseException | None = None

    def done(self) -> bool:
        return self._event.is_set()

    def expired(self, now: float | None = None) -> bool:
        if self.deadline_s is None:
            return False
        now = time.perf_counter() if now is None else now
        return now > self.submitted_at + self.deadline_s

    def result(self, timeout: float | None = None) -> Any:
        """Block until served; re-raises compile/execution/deadline errors."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"query for client {self.client!r} not served")
        if self._error is not None:
            raise self._error
        return self._result

    def _resolve(self, result: Any = None, error: BaseException | None = None,
                 route: str | None = None) -> None:
        self.latency_s = time.perf_counter() - self.submitted_at
        self.route = route
        self._result, self._error = result, error
        self._event.set()


class StreamingTicket(QueryTicket):
    """A ticket whose result arrives incrementally, one packed chunk per
    resident row-store chunk.

    ``chunks()`` yields each chunk as the serving loop pushes it — while the
    stream's remaining scans are still running — and ``result()`` blocks for
    the whole thing and returns the chunks' concatenation, byte-identical to
    the blocking (non-streamed) route.  Both re-raise the ticket's error.
    """

    __slots__ = ("_cond", "_chunks")

    def __init__(self, client: str, lane: str = "bulk",
                 deadline_s: float | None = None):
        super().__init__(client, lane, deadline_s)
        self._cond = threading.Condition()
        self._chunks: list[Any] = []

    def _push(self, chunk: Any) -> None:
        with self._cond:
            self._chunks.append(chunk)
            self._cond.notify_all()

    def _resolve(self, result: Any = None, error: BaseException | None = None,
                 route: str | None = None) -> None:
        with self._cond:
            super()._resolve(result, error, route)
            self._cond.notify_all()

    def chunks(self, timeout: float | None = None) -> Iterator[Any]:
        """Yield result chunks as they land; returns when the ticket
        resolves.  Raises the ticket's error (chunks already yielded were
        still byte-exact — a prefix of the result)."""
        i = 0
        while True:
            with self._cond:
                while len(self._chunks) <= i and not self._event.is_set():
                    if not self._cond.wait(timeout):
                        raise TimeoutError(
                            f"stream for client {self.client!r} stalled")
                have = len(self._chunks) > i
                chunk = self._chunks[i] if have else None
            if have:
                i += 1
                yield chunk
                continue
            if self._error is not None:
                raise self._error
            return

    def result(self, timeout: float | None = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError(f"query for client {self.client!r} not served")
        if self._error is not None:
            raise self._error
        if self._result is None and self._chunks:
            self._result = (self._chunks[0] if len(self._chunks) == 1
                            else torch.cat(self._chunks, dim=0))
        return self._result


@dataclasses.dataclass
class LaneStats:
    """Per-lane serving counters + bounded latency reservoirs.

    ``latency`` samples submit→resolve seconds; ``queue_wait`` the
    submit→drain share of it; ``service`` the remainder (compile + device +
    finalize).  ``result_bytes`` sums each served op's own output size
    (:meth:`~repro_torch.core.requests.ProjectOp.result_bytes` and siblings; for
    streams, the bytes actually pushed) — the lane's *output* volume,
    distinct from the engine's bus-beat scan charges."""

    served: int = 0
    failed: int = 0
    deadline_misses: int = 0
    shed: int = 0  # admissions this lane refused with ServerOverloaded
    result_bytes: int = 0
    latency: LatencyReservoir = dataclasses.field(default_factory=_reservoir)
    queue_wait: LatencyReservoir = dataclasses.field(default_factory=_reservoir)
    service: LatencyReservoir = dataclasses.field(default_factory=_reservoir)


@dataclasses.dataclass
class ServerStats:
    """Serving-layer counters (the engine's own PMU counts the bytes).

    Totals here; the per-lane split (including every latency reservoir)
    lives in ``lanes["express"]`` / ``lanes["bulk"]``.  ``latency`` is the
    all-lanes reservoir — ``mean_latency_s``/``latency_max_s`` read from it,
    keeping the historical fields as exact properties."""

    submitted: int = 0
    served: int = 0
    failed: int = 0
    ticks: int = 0
    ticks_overlapped: int = 0  # begin_tick entered with a pass still in flight
    max_queue_depth: int = 0
    table_groups: int = 0  # cold same-table view groups across all ticks
    table_groups_shared: int = 0  # of those, served by a multi-view shared scan
    bytes_saved: int = 0  # row-store bytes avoided vs per-query cold execution
    # SLO / admission-control counters
    deadline_misses: int = 0  # tickets resolved with DeadlineExceeded
    shed: int = 0  # admissions refused with ServerOverloaded
    degraded: int = 0  # admissions demoted to the bulk lane at the bound
    # fault-tolerance counters (docs/reliability.md)
    retries: int = 0  # per-ticket transient-fault retry attempts
    poisoned: int = 0  # tickets that exhausted retries -> quarantined plans
    streams: int = 0  # streaming tickets served
    stream_chunks: int = 0  # chunks pushed across all streams
    # write-path counters
    writes_submitted: int = 0
    writes_applied: int = 0
    inserts: int = 0
    updates: int = 0
    deletes: int = 0
    rows_written: int = 0  # rows inserted + replacement rows + rows deleted
    latency: LatencyReservoir = dataclasses.field(default_factory=_reservoir)
    lanes: dict[str, LaneStats] = dataclasses.field(
        default_factory=lambda: {lane: LaneStats() for lane in LANES})

    @property
    def shared_scan_ratio(self) -> float:
        """Fraction of cold table-groups that coalesced into a shared scan."""
        return self.table_groups_shared / max(self.table_groups, 1)

    @property
    def latency_sum_s(self) -> float:
        return self.latency.sum

    @property
    def latency_max_s(self) -> float:
        return self.latency.max

    @property
    def mean_latency_s(self) -> float:
        return self.latency.sum / max(self.served, 1)


@dataclasses.dataclass
class _WritePayload:
    """One admitted write: insert (columns), update (rows+values), delete (rows)."""

    kind: str  # "insert" | "update" | "delete"
    table: RelationalTable
    columns: Mapping[str, np.ndarray] | None = None
    rows: np.ndarray | None = None
    values: Mapping[str, np.ndarray] | None = None


@dataclasses.dataclass
class _Admitted:
    ticket: QueryTicket
    node: PlanNode | None
    path: str
    colstore: Mapping[str, np.ndarray] | None
    right_colstore: Mapping[str, np.ndarray] | None
    write: _WritePayload | None = None
    lane: str = "bulk"
    stream: bool = False
    stream_chunk_rows: int | None = None
    options: CompileOptions | None = None


@dataclasses.dataclass
class _InflightTick:
    """begin_tick's handle on a tick whose bulk pass is still on the device.

    ``processed`` counts everything the tick already settled (writes, express
    tickets, expired/failed admissions); ``reads``/``compiled``/``tokens``
    are the launched bulk queries awaiting ``finish_tick``."""

    processed: int
    reads: list[_Admitted] = dataclasses.field(default_factory=list)
    compiled: list[PhysicalQuery | None] = dataclasses.field(default_factory=list)
    tokens: list[Any] = dataclasses.field(default_factory=list)
    finished: bool = False


class QueryServer:
    """Admission queues + pipelined tick executor over one relational engine.

    ``snapshot_reads`` controls whether reads are compiled with the tick's
    post-write snapshot timestamp (fused MVCC visibility; project-shaped
    plans then return ``(packed, mask)``).  The default, ``None``, is
    **auto, per table**: reads of tables this server has never written keep
    the historical unpinned contract (nothing about their results changes,
    regardless of unrelated write traffic), while a table's first applied
    write pins every subsequent read of *that table* — without pinning, a
    read after an update/delete would count old *and* replacement row
    versions, because unpinned scans have no MVCC test.  Pass
    ``True``/``False`` to force either mode globally; plans that cannot
    carry a snapshot (joins, row/col host paths) always compile unpinned.

    ``mesh`` / ``num_shards`` select the reference's mesh-sharded backend,
    which the port does not have yet: either raises
    ``NotImplementedError``.

    Serving-loop knobs (see ``docs/serving.md`` for tuning guidance):

    * ``lanes`` — auto-classify tickets into express/bulk priority lanes
      (``False``: single-lane FIFO, the pre-pipelining behavior).
    * ``pipeline`` — double-buffer ticks in ``drain()``/the background loop
      (``False``: strictly serial ticks; ``run_tick()`` is always serial).
    * ``express_result_bytes`` — auto-classification threshold: a read whose
      estimated result is at most this rides the express lane.
    * ``max_queue`` — admission bound across both lanes (``None``:
      unbounded); ``overload`` — ``"shed"`` (refuse with
      :class:`ServerOverloaded`) or ``"degrade"`` (demote to bulk, strip the
      deadline; hard-sheds at ``2 * max_queue``).

    Reliability knobs (see ``docs/reliability.md``):

    * ``wal`` — must be ``None``: the write-ahead log is not ported.
    * ``max_retries`` — per-ticket bound on transient-fault retries.
    * ``poison_cooldown_ticks`` — how many ticks a retry-exhausted plan
      signature stays quarantined (:class:`PoisonedPlanError`).
    """

    def __init__(
        self,
        engine: RelationalMemoryEngine | None = None,
        max_batch: int = 64,
        snapshot_reads: bool | None = None,
        mesh=None,
        num_shards: int | None = None,
        lanes: bool = True,
        pipeline: bool = True,
        express_result_bytes: int = 4096,
        max_queue: int | None = None,
        overload: str = "shed",
        wal=None,
        max_retries: int = 2,
        poison_cooldown_ticks: int = 8,
    ):
        if engine is not None and (mesh is not None or num_shards is not None):
            raise ValueError(
                "pass either a pre-built engine or mesh/num_shards, not both"
            )
        if mesh is not None or num_shards is not None:
            raise NotImplementedError(
                "the mesh-sharded backend is not ported yet (ROADMAP queue 1 "
                "item 6: sharded QueryServer)"
            )
        if wal is not None:
            raise NotImplementedError(
                "the write-ahead log is not ported yet (ROADMAP queue 1 item "
                "4: fault sites, breaker and WAL)"
            )
        if overload not in ("shed", "degrade"):
            raise ValueError(f"unknown overload policy {overload!r}; "
                             "want 'shed' or 'degrade'")
        # no engine given: one on the card (raises without a card)
        self.engine = engine if engine is not None else RelationalMemoryEngine()
        self.max_batch = max_batch
        self.snapshot_reads = snapshot_reads
        self.lanes = lanes
        self.pipeline = pipeline
        self.express_result_bytes = express_result_bytes
        self.max_queue = max_queue
        self.overload = overload
        self.wal = wal  # always None: the WAL is not ported
        self.max_retries = max_retries
        self.poison_cooldown_ticks = poison_cooldown_ticks
        # poison quarantine: plan signature -> remaining cooldown ticks
        self._poisoned: dict[Any, int] = {}
        self.stats = ServerStats()
        self._lock = threading.Lock()
        self._express: deque[_Admitted] = deque()
        self._bulk: deque[_Admitted] = deque()
        # consecutive express-saturated ticks with bulk work waiting — the
        # anti-starvation trigger in _drain_batch
        self._express_streak = 0
        # ticks begun but not yet finished — touched only on the tick thread
        self._open_ticks = 0
        # tables that have taken a write through this server (auto snapshot
        # pinning is per-table: reads of never-written tables keep their
        # historical result shapes); touched only on the tick thread
        self._written_uids: set[int] = set()
        # per-client running (count, sum_s, max_s) — scalars, not a sample
        # list: a long-running server must not grow per served query
        self._client_latency: dict[str, list[float]] = {}
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # ------------------------------------------------------------ admission
    def submit(
        self,
        query: PlanNode | PlanBuilder,
        client: str = "anon",
        path: str = "rme",
        colstore: Mapping[str, np.ndarray] | None = None,
        right_colstore: Mapping[str, np.ndarray] | None = None,
        lane: str | None = None,
        deadline_s: float | None = None,
        stream: bool = False,
        stream_chunk_rows: int | None = None,
        options: CompileOptions | None = None,
        optimize: bool | None = None,
    ) -> QueryTicket:
        """Admit a logical plan; returns immediately with a ticket.

        ``lane`` overrides the automatic express/bulk classification;
        ``deadline_s`` bounds submit→resolve (expired tickets fail with
        :class:`DeadlineExceeded`); ``stream=True`` returns a
        :class:`StreamingTicket` whose packed result arrives chunk-by-chunk
        (projection-shaped rme plans only; always bulk lane).  May raise
        :class:`ServerOverloaded` when ``max_queue`` is set.

        ``options`` is the full :class:`~repro_torch.core.planner.CompileOptions`
        passthrough — when given it wins over the individual ``path`` /
        ``colstore`` / ``right_colstore`` / ``stream`` / ``stream_chunk_rows``
        parameters (``snapshot_ts`` inside it is still overridden by the
        tick's own pin).  ``optimize=False`` skips the logical rewrite
        passes for this query regardless of where the options came from.
        """
        if lane is not None and lane not in LANES:
            raise ValueError(f"unknown lane {lane!r}; want one of {LANES}")
        node = query.build() if isinstance(query, PlanBuilder) else query
        if options is not None:
            path = options.path
            colstore = options.colstore
            right_colstore = options.right_colstore
            stream = options.stream
            stream_chunk_rows = options.stream_chunk_rows
        else:
            options = CompileOptions(
                path=path, colstore=colstore, right_colstore=right_colstore,
                stream=stream, stream_chunk_rows=stream_chunk_rows,
            )
        if optimize is not None:
            options = dataclasses.replace(options, optimize=optimize)
        if stream:
            lane = "bulk"  # a chunked large output is bulk by definition
        elif lane is None:
            lane = self._classify(node)
        if not self.lanes:
            lane = "bulk"
        ticket_cls = StreamingTicket if stream else QueryTicket
        return self._admit(_Admitted(
            ticket_cls(client, lane, deadline_s), node, path,
            colstore, right_colstore, lane=lane, stream=stream,
            stream_chunk_rows=stream_chunk_rows, options=options,
        ))

    def submit_insert(
        self,
        table: RelationalTable,
        columns: Mapping[str, np.ndarray],
        client: str = "anon",
    ) -> QueryTicket:
        """Admit an insert; the ticket resolves to the new physical row indices.

        The rows become visible to every read admitted into (or after) the
        tick that applies the write — and cost O(rows) upload bytes, since
        the device row store ships them as a tail chunk.
        """
        return self._admit_write(_WritePayload("insert", table,
                                               columns=dict(columns)), client)

    def submit_update(
        self,
        table: RelationalTable,
        rows: np.ndarray,
        values: Mapping[str, np.ndarray],
        client: str = "anon",
    ) -> QueryTicket:
        """Admit an MVCC update of the given physical rows; resolves to the
        replacement rows' indices.  Old versions stay readable at earlier
        snapshots."""
        return self._admit_write(_WritePayload("update", table,
                                               rows=np.asarray(rows),
                                               values=dict(values)), client)

    def submit_delete(
        self,
        table: RelationalTable,
        rows: np.ndarray,
        client: str = "anon",
    ) -> QueryTicket:
        """Admit an MVCC delete of the given physical rows; resolves to ``None``.
        Costs O(rows) timestamp words of upload, never a table re-ship."""
        return self._admit_write(_WritePayload("delete", table,
                                               rows=np.asarray(rows)), client)

    def _admit_write(self, w: _WritePayload, client: str) -> QueryTicket:
        # writes always ride the express lane: applying them first is what
        # defines the tick snapshot, and they carry no deadline — a write
        # must apply or be refused at admission, never be silently dropped
        lane = "express" if self.lanes else "bulk"
        return self._admit(_Admitted(
            QueryTicket(client, lane), None, "write", None, None,
            write=w, lane=lane,
        ))

    def _classify(self, node: PlanNode) -> str:
        """Express iff the result is point-sized: a fused aggregate's 8-byte
        scalar pair, or a group-by whose ``(G, 2)`` partials fit
        ``express_result_bytes``.  Projections, filters, and joins move
        O(rows) and ride bulk.  (An unroutable plan classifies bulk and
        fails with its real compile error in its tick.)"""
        if not self.lanes:
            return "bulk"
        try:
            shape = decompose(node)
        except Exception:
            return "bulk"
        if shape.kind == "aggregate":
            return "express"
        if (shape.kind == "groupby"
                and shape.group.num_groups * 8 <= self.express_result_bytes):
            return "express"
        return "bulk"

    def _admit(self, adm: _Admitted) -> QueryTicket:
        with self._lock:
            if self.max_queue is not None:
                depth = len(self._express) + len(self._bulk)
                if depth >= self.max_queue:
                    # writes cannot be degraded (a demoted write would still
                    # have to apply) and a degrading server still hard-sheds
                    # at twice the bound, or queue memory would be unbounded
                    if (self.overload == "shed" or adm.write is not None
                            or depth >= 2 * self.max_queue):
                        self.stats.shed += 1
                        self.stats.lanes[adm.lane].shed += 1
                        raise ServerOverloaded(
                            f"admission queue at {depth} >= bound "
                            f"{self.max_queue} (policy: {self.overload}; "
                            f"shed lane: {adm.lane}; depths: "
                            f"express={len(self._express)} "
                            f"bulk={len(self._bulk)})"
                        )
                    adm.lane = "bulk"
                    adm.ticket.lane = "bulk"
                    adm.ticket.deadline_s = None
                    self.stats.degraded += 1
            queue = self._express if adm.lane == "express" else self._bulk
            queue.append(adm)
            self.stats.submitted += 1
            if adm.write is not None:
                self.stats.writes_submitted += 1
            self.stats.max_queue_depth = max(
                self.stats.max_queue_depth,
                len(self._express) + len(self._bulk),
            )
        return adm.ticket

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._express) + len(self._bulk)

    # --------------------------------------------------------------- writes
    def _apply_write(self, w: _WritePayload) -> Any:
        if w.kind == "insert":
            rows = w.table.append(w.columns)
            self.stats.inserts += 1
            self.stats.rows_written += len(rows)
            return rows
        if w.kind == "update":
            rows = w.table.update(w.rows, w.values)
            self.stats.updates += 1
            self.stats.rows_written += len(rows)
            return rows
        if w.kind == "delete":
            n_deleted = w.table.delete(w.rows)
            self.stats.deletes += 1
            self.stats.rows_written += n_deleted  # live rows only, not ids
            return None
        raise ValueError(f"unknown write kind {w.kind!r}")

    def _run_writes(self, batch: list[_Admitted]) -> None:
        """Apply the tick's writes in admission order, resolving their tickets.

        Runs before any read compiles, so the tick's reads all observe one
        consistent post-write state — the tick's snapshot.  A failing write
        resolves its own ticket with the error and never blocks the reads.
        """
        for req in batch:
            if req.write is None:
                continue
            try:
                result = self._apply_write(req.write)
            except Exception as e:
                self._fail(req, e)
                continue
            self._written_uids.add(req.write.table.uid)
            self.stats.writes_applied += 1
            self._serve(req, result, route=f"write-{req.write.kind}")

    # ------------------------------------------------------------ execution
    def _account_cold_groups(self, ops) -> None:
        """Shared-scan ratio + bytes-saved credit for this tick's op batch.

        Cold ops (projections not served by the reorg cache, plus every
        filter/aggregate/group-by) are grouped per table, the way
        ``execute_many`` will coalesce them; a group of ≥2 distinct lowered
        requests becomes one shared scan whose cost is the union geometry
        over all enabled words, while a per-query execution would have paid
        every request's own pass.
        """
        by_table: dict[int, tuple[Any, dict]] = {}
        for op in ops:
            if isinstance(op, ProjectOp):
                # served from the cache — a full hot hit or a tail-only delta
                # serve — means the op never joins the shared pass, so it
                # must not be priced as a full cold scan here
                if self.engine.projection_is_cached(op.table, op.view.geometry):
                    continue
            entry = by_table.setdefault(op.table.uid, (op.table, {}))
            entry[1].setdefault(op.lower())
        for table, reqs in by_table.values():
            self.stats.table_groups += 1
            if len(reqs) >= 2:
                self.stats.table_groups_shared += 1
                independent = sum(
                    self.engine.scan_bytes(table, (r,)) for r in reqs
                )
                union = self.engine.scan_bytes(table, tuple(reqs))
                self.stats.bytes_saved += independent - union
            # a lone cold request is priced identically either way

    def _serve(self, req: _Admitted, result: Any, route: str | None) -> None:
        req.ticket._resolve(result=result, route=route)
        self.stats.served += 1
        self.stats.lanes[req.lane].served += 1
        self._record_latency(req.ticket)

    def _fail(self, req: _Admitted, error: BaseException) -> None:
        self.stats.failed += 1
        self.stats.lanes[req.lane].failed += 1
        req.ticket._resolve(error=error)

    def _expire(self, req: _Admitted, when: str) -> bool:
        """Resolve an expired ticket with :class:`DeadlineExceeded`; the
        caller skips whatever work remained for it."""
        if not req.ticket.expired():
            return False
        lane = self.stats.lanes[req.lane]
        lane.deadline_misses += 1
        self.stats.deadline_misses += 1
        self._fail(req, DeadlineExceeded(
            f"client {req.ticket.client!r}: deadline {req.ticket.deadline_s}s "
            f"exceeded at {when}"
        ))
        return True

    def _drain_batch(self) -> list[_Admitted]:
        """Pop one tick's batch: the express lane first (up to ``max_batch``),
        bulk filling only the *remainder* — a saturated express tick admits
        no bulk work, so a point read's tick never carries an O(rows) scan
        in its fused pass.  Sustained saturation still can't starve
        analytics: after 3 consecutive express-only ticks with bulk waiting,
        one bulk slot is forced through."""
        now = time.perf_counter()
        with self._lock:
            n_exp = min(self.max_batch, len(self._express))
            batch = [self._express.popleft() for _ in range(n_exp)]
            n_bulk = min(max(self.max_batch - n_exp, 0), len(self._bulk))
            if n_bulk == 0 and self._bulk and self._express_streak >= 3:
                n_bulk = 1
            if n_exp and not n_bulk and self._bulk:
                self._express_streak += 1
            else:
                self._express_streak = 0
            batch += [self._bulk.popleft() for _ in range(n_bulk)]
        for req in batch:
            req.ticket.admitted_at = now
            req.ticket.queue_wait_s = now - req.ticket.submitted_at
        return batch

    # ------------------------------------------------- fault recovery layer
    @staticmethod
    def _plan_sig(req: _Admitted, pq: PhysicalQuery | None):
        """A stable signature of the plan's physical shape — what poison
        quarantine keys on.  Lowered requests hash structurally (frozen
        dataclasses), so two submissions of the same query shape collide
        here even from different clients.  ``None`` (unkeyable) disables
        quarantine for this plan."""
        if pq is None:
            return None
        try:
            return (req.path, tuple(
                (op.table.uid, op.lower()) for op in pq.ops
            ))
        except Exception:
            return None

    def _poison(self, req: _Admitted, pq: PhysicalQuery | None) -> None:
        """Quarantine a retry-exhausted plan signature for the cooldown."""
        self.stats.poisoned += 1
        sig = self._plan_sig(req, pq)
        if sig is not None:
            self._poisoned[sig] = self.poison_cooldown_ticks

    def _retry_read(self, req: _Admitted, pq: PhysicalQuery,
                    err: BaseException) -> tuple[bool, Any]:
        """Bounded retry of one query's individual execution after a
        transient fault.  Success returns ``(True, result)``; a permanent
        or persistent failure resolves the ticket typed (quarantining the
        plan when retries were exhausted) and returns ``(False, None)``."""
        for _ in range(self.max_retries):
            self.stats.retries += 1
            try:
                return True, pq.run()
            except faults.TransientFault as e:
                err = e
            except Exception as e:
                self._fail(req, e)
                return False, None
        self._poison(req, pq)
        self._fail(req, err)
        return False, None

    def _retry_stream(self, req: _Admitted, pq: PhysicalQuery,
                      err: BaseException) -> tuple[bool, Any]:
        """Stream retry: only safe while *no* chunk reached the client —
        each attempt drains a fresh ``pq.stream()`` iterator.  Once a
        prefix is out, a restart would duplicate it, so the ticket resolves
        typed instead (``chunks()`` documents yielded chunks as a byte-
        exact prefix of the result)."""
        for _ in range(self.max_retries):
            if req.ticket._chunks:
                # a prefix reached the client: fail typed, don't poison —
                # the fault was positional, not necessarily deterministic
                self._fail(req, err)
                return False, None
            self.stats.retries += 1
            try:
                return True, self._serve_stream(req, pq.stream())
            except faults.TransientFault as e:
                err = e
            except Exception as e:
                self._fail(req, e)
                return False, None
        if not req.ticket._chunks:
            self._poison(req, pq)
        self._fail(req, err)
        return False, None

    def _compile_reads(self, reads: list[_Admitted]) -> list[PhysicalQuery | None]:
        compiled: list[PhysicalQuery | None] = []
        for req in reads:
            try:
                snapshot_ts = None
                if (self._pin_read(req.node)
                        and _snapshot_capable(req.node, req.path)):
                    # the tick's snapshot: the post-write clock of the plan's
                    # tables (per-table clocks; writes already applied) — for
                    # a join, the max over both sides, so every row live in
                    # either table right now is visible.  Plans that cannot
                    # carry a snapshot — host-path baselines, joins whose
                    # columns the device route cannot express — compile
                    # unpinned; they still observe the tick-consistent
                    # post-write state (writes ran first).  A *streamed* read
                    # of a written table fails its ticket instead: the
                    # per-chunk contract has no visibility channel.
                    snapshot_ts = max(
                        t.now() for t in _plan_tables(req.node)
                    )
                base = req.options or CompileOptions(
                    path=req.path, colstore=req.colstore,
                    right_colstore=req.right_colstore, stream=req.stream,
                    stream_chunk_rows=req.stream_chunk_rows,
                )
                if snapshot_ts is not None:
                    base = dataclasses.replace(base, snapshot_ts=snapshot_ts)
                pq = compile_plan(req.node, self.engine, options=base)
                sig = self._plan_sig(req, pq)
                if sig is not None and sig in self._poisoned:
                    compiled.append(None)
                    self._fail(req, PoisonedPlanError(
                        f"plan shape quarantined for "
                        f"{self._poisoned[sig]} more tick(s) after "
                        f"exhausting {self.max_retries} retries"
                    ))
                    continue
                compiled.append(pq)
            except Exception as e:  # compile errors belong to the client
                compiled.append(None)
                self._fail(req, e)
        return compiled

    def _launch_reads(
        self, reads: list[_Admitted], compiled: list[PhysicalQuery | None],
    ) -> list[Any] | None:
        """Enqueue one lane's device pass: coalesce every scan op into one
        ``execute_many_async`` batch, then ``launch`` each query on its
        slice.  No host syncs.  Returns the per-query finalize tokens — or
        ``None`` when the shared step failed and every ticket was already
        settled by the per-query fallback."""
        ops, spans = [], []
        for pq in compiled:
            if pq is None:
                spans.append((0, 0))
                continue
            spans.append((len(ops), len(pq.ops)))
            ops.extend(pq.ops)
        self._account_cold_groups(ops)
        try:
            handle = (self.engine.execute_many_async(ops) if ops else None)
        except Exception:
            # the shared step failed (one op's lowering error, OOM on the
            # union geometry, ...).  One bad client must not poison the
            # tick: fall back to executing each query individually, so every
            # healthy ticket still resolves with its result and only the
            # offender carries the error.  (PMU counters may over-charge the
            # aborted shared attempt — accounting noise, not a result bug.)
            for req, pq in zip(reads, compiled):
                if pq is None:
                    continue
                try:
                    result = pq.run()
                except faults.TransientFault as e:
                    ok, result = self._retry_read(req, pq, e)
                    if not ok:
                        continue
                except Exception as e:
                    self._fail(req, e)
                    continue
                self._note_result_bytes(req, pq)
                self._serve(req, result, route=pq.route)
            return None

        packed = handle.results if handle is not None else []
        tokens: list[Any] = []
        for i, (req, pq) in enumerate(zip(reads, compiled)):
            if pq is None:
                tokens.append(None)
                continue
            off, k = spans[i]
            try:
                if pq.stream is not None:
                    # eager call: snapshots the chunk list against THIS
                    # tick's state, so a pipelined next tick's writes can't
                    # leak into the stream drained at finish_tick
                    tokens.append(pq.stream())
                else:
                    tokens.append(pq.launch(packed[off: off + k]))
            except faults.TransientFault as e:
                # a launch-time transient (e.g. a faulted upload): retry the
                # query individually; either way it is settled here, so
                # finalize must skip it
                tokens.append(None)
                compiled[i] = None
                if pq.stream is not None:
                    ok, result = self._retry_stream(req, pq, e)
                else:
                    ok, result = self._retry_read(req, pq, e)
                if ok:
                    self._note_result_bytes(req, pq)
                    self._serve(req, result, route=pq.route)
            except Exception as e:
                tokens.append(None)
                compiled[i] = None
                self._fail(req, e)
        return tokens

    def _finalize_reads(
        self, reads: list[_Admitted], compiled: list[PhysicalQuery | None],
        tokens: list[Any],
    ) -> None:
        """The blocking half: pull each query's result (or iterate its chunk
        stream), resolve tickets, and charge per-lane accounting.  A ticket
        whose deadline lapsed while its pass was in flight resolves with
        :class:`DeadlineExceeded` — its device work completed, but the SLO
        answer is a typed miss, not a stale success."""
        for req, pq, token in zip(reads, compiled, tokens):
            if pq is None:
                continue
            if self._expire(req, "finalize"):
                continue
            try:
                if pq.stream is not None:
                    result = self._serve_stream(req, token)
                else:
                    result = pq.finalize(token)
            except faults.TransientFault as e:
                if pq.stream is not None:
                    ok, result = self._retry_stream(req, pq, e)
                else:
                    # re-run the whole query individually: the launched
                    # pass's tokens are tainted by the fault, a fresh
                    # pq.run() is the clean per-query fallback path
                    ok, result = self._retry_read(req, pq, e)
                if not ok:
                    continue
            except Exception as e:
                self._fail(req, e)
                continue
            self._note_result_bytes(req, pq)
            self._serve(req, result, route=pq.route)

    def _serve_stream(self, req: _Admitted, chunk_iter) -> None:
        """Drain the query's chunk iterator (created at launch) into its
        StreamingTicket: each chunk is visible to ``chunks()`` the moment
        its scan lands, while the remaining chunks are still being
        produced."""
        ticket = req.ticket
        lane = self.stats.lanes[req.lane]
        for chunk in chunk_iter:
            ticket._push(chunk)
            self.stats.stream_chunks += 1
            lane.result_bytes += int(chunk.nbytes)
        self.stats.streams += 1
        return None  # StreamingTicket.result() concatenates its chunks

    def _note_result_bytes(self, req: _Admitted, pq: PhysicalQuery) -> None:
        if pq.stream is None:  # streams charge per pushed chunk instead
            self.stats.lanes[req.lane].result_bytes += sum(
                op.result_bytes() for op in pq.ops
            )

    def begin_tick(self) -> _InflightTick | None:
        """The non-blocking half of a tick: drain one batch, apply its
        writes, *enqueue* the tick's shared pass (compile +
        ``execute_many_async`` + per-query launch — no host syncs for the
        bulk lane), and serve the express lane to completion.  Returns the
        in-flight handle for :meth:`finish_tick`, or ``None`` if nothing
        was queued.

        Express reads are finalized here: their results are scalar-sized,
        so pulling them is O(1) host work, and serving them ahead of the
        bulk lane's O(rows) transfers is what keeps a point read's latency
        independent of how much analytics traffic shares the tick.
        """
        batch = self._drain_batch()
        if not batch:
            return None
        self.stats.ticks += 1
        if self._open_ticks > 0:
            self.stats.ticks_overlapped += 1
        if self._poisoned:  # quarantine cooldowns tick down per served tick
            self._poisoned = {sig: left - 1
                              for sig, left in self._poisoned.items()
                              if left > 1}

        self._run_writes(batch)
        live = [req for req in batch
                if req.write is None and not self._expire(req, "admission")]
        express = [req for req in live if req.lane == "express"]
        bulk = [req for req in live if req.lane == "bulk"]

        # Both lanes compile into ONE op batch: same-table work still fuses
        # into a single shared pass per table regardless of lane (the
        # one-pass invariant the engine tests pin down).  Lanes differ in
        # *finalize order*, not in scan count — express results are pulled
        # here, bulk's (typically much larger) host transfers wait for
        # finish_tick.
        reads = express + bulk
        compiled = self._compile_reads(reads)
        tokens = self._launch_reads(reads, compiled)
        tick = _InflightTick(processed=len(batch))
        if tokens is not None:
            n = len(express)
            self._finalize_reads(reads[:n], compiled[:n], tokens[:n])
            if bulk:
                tick.reads = reads[n:]
                tick.compiled = compiled[n:]
                tick.tokens = tokens[n:]
        self._open_ticks += 1
        return tick

    def finish_tick(self, tick: _InflightTick | None) -> int:
        """The blocking half: finalize the tick's bulk pass and resolve its
        tickets (streamed queries push their chunks here).  Returns the
        number of requests the tick processed; idempotent per tick."""
        if tick is None:
            return 0
        if tick.finished:
            return 0
        tick.finished = True
        self._open_ticks -= 1
        if tick.reads:
            # sweep deadlines BEFORE any O(rows) bulk transfer: a ticket
            # that expired while its pass was in flight is resolved typed
            # here and its finalize/transfer work is skipped entirely —
            # the result is dropped, not pulled then discarded
            for i, req in enumerate(tick.reads):
                if (tick.compiled[i] is not None
                        and self._expire(req, "finish_tick")):
                    tick.compiled[i] = None
            self._finalize_reads(tick.reads, tick.compiled, tick.tokens)
        return tick.processed

    def run_tick(self) -> int:
        """Serve one batch start-to-finish: drain ≤ ``max_batch`` requests,
        apply writes, serve the express lane, execute and finalize the bulk
        lane.  Returns the number of requests processed (served + failed).
        The serial spelling of ``begin_tick()`` + ``finish_tick()`` — same
        results, no overlap."""
        return self.finish_tick(self.begin_tick())

    def _pin_read(self, node: PlanNode) -> bool:
        """Should this read carry the tick snapshot?  Auto mode pins exactly
        the tables this server has written — a mutated table must not
        double-count row versions, while reads of never-written tables keep
        their historical (unpinned) result shapes no matter what unrelated
        traffic does.  A join pins when *either* side has been written."""
        if self.snapshot_reads is not None:
            return self.snapshot_reads
        return any(t.uid in self._written_uids
                   for t in _plan_tables(node))

    def _record_latency(self, ticket: QueryTicket) -> None:
        lat = ticket.latency_s
        self.stats.latency.add(lat)
        lane = self.stats.lanes[ticket.lane]
        lane.latency.add(lat)
        if ticket.queue_wait_s is not None:
            lane.queue_wait.add(ticket.queue_wait_s)
            lane.service.add(max(lat - ticket.queue_wait_s, 0.0))
        with self._lock:  # client_latencies() iterates under the lock
            ent = self._client_latency.setdefault(ticket.client, [0, 0.0, 0.0])
            ent[0] += 1
            ent[1] += lat
            ent[2] = max(ent[2], lat)

    def drain(self) -> int:
        """Run ticks until the admission queues are empty; returns total
        processed.  With ``pipeline=True`` ticks are double-buffered: tick
        N+1's drain/writes/compile/launch run before tick N's finalize
        blocks, so host-side tick work overlaps the in-flight device pass.
        """
        total = 0
        if not self.pipeline:
            while True:
                n = self.run_tick()
                if n == 0:
                    return total
                total += n
        inflight: _InflightTick | None = None
        while True:
            nxt = self.begin_tick()
            total += self.finish_tick(inflight)
            if nxt is None:
                return total
            inflight = nxt

    # ------------------------------------------------------ background loop
    def start(self, idle_wait_s: float = 0.001) -> None:
        """Serve ticks on a background thread until :meth:`stop` (pipelined
        per the ``pipeline`` flag, like :meth:`drain`)."""
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._stop.clear()

        def loop() -> None:
            inflight: _InflightTick | None = None
            while not self._stop.is_set():
                nxt = self.begin_tick() if self.pipeline else self.run_tick()
                if self.pipeline:
                    self.finish_tick(inflight)
                    inflight = nxt
                if not nxt:
                    self._stop.wait(idle_wait_s)
            self.finish_tick(inflight)  # settle the last in-flight tick

        self._thread = threading.Thread(target=loop, name="query-server", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None

    def __enter__(self) -> "QueryServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------ reporting
    def client_latencies(self) -> dict[str, dict[str, float]]:
        """Per-client latency summary: count / mean / max seconds."""
        with self._lock:
            return {
                client: {
                    "count": count,
                    "mean_s": total / count,
                    "max_s": max_s,
                }
                for client, (count, total, max_s) in self._client_latency.items()
            }

    def snapshot(self) -> dict[str, Any]:
        """One flat dict of serving + engine counters (for logs/benchmarks).

        Per-lane keys are prefixed ``express_``/``bulk_``; the ``*_ms``
        percentiles read the lane's bounded reservoirs (exact until the cap,
        unbiased beyond).  ``docs/metrics.md`` documents every key."""
        e = self.engine.stats
        out = {
            "queue_depth": self.queue_depth,
            "submitted": self.stats.submitted,
            "served": self.stats.served,
            "failed": self.stats.failed,
            "ticks": self.stats.ticks,
            "ticks_overlapped": self.stats.ticks_overlapped,
            "max_queue_depth": self.stats.max_queue_depth,
            "shared_scan_ratio": self.stats.shared_scan_ratio,
            "bytes_saved": self.stats.bytes_saved,
            "mean_latency_s": self.stats.mean_latency_s,
            "max_latency_s": self.stats.latency_max_s,
            "deadline_misses": self.stats.deadline_misses,
            "shed": self.stats.shed,
            "degraded": self.stats.degraded,
            "retries": self.stats.retries,
            "poisoned": self.stats.poisoned,
            "poison_quarantined": len(self._poisoned),
            "streams": self.stats.streams,
            "stream_chunks": self.stats.stream_chunks,
            "writes_applied": self.stats.writes_applied,
            "rows_written": self.stats.rows_written,
        }
        for name, lane in self.stats.lanes.items():
            out[f"{name}_served"] = lane.served
            out[f"{name}_failed"] = lane.failed
            out[f"{name}_deadline_misses"] = lane.deadline_misses
            out[f"{name}_shed"] = lane.shed
            out[f"{name}_result_bytes"] = lane.result_bytes
            out[f"{name}_p50_ms"] = lane.latency.percentile(50) * 1e3
            out[f"{name}_p95_ms"] = lane.latency.percentile(95) * 1e3
            out[f"{name}_p99_ms"] = lane.latency.percentile(99) * 1e3
            out[f"{name}_queue_wait_p95_ms"] = lane.queue_wait.percentile(95) * 1e3
            out[f"{name}_service_p95_ms"] = lane.service.percentile(95) * 1e3
        out.update({
            "engine_shared_scans": e.shared_scans,
            "engine_hot_hits": e.hot_hits,
            "engine_delta_hits": e.delta_hits,
            "engine_cold_misses": e.cold_misses,
            "engine_bytes_from_dram": e.bytes_from_dram,
            "engine_bytes_uploaded": e.bytes_uploaded,
            "engine_uploads": e.uploads,
            "engine_bytes_uploaded_delta": e.bytes_uploaded_delta,
            "engine_delta_uploads": e.delta_uploads,
            "engine_bytes_collective": e.bytes_collective,
            "engine_collective_ops": e.collective_ops,
            "engine_retries": e.retries,
            "engine_failovers": e.failovers,
            "engine_bytes_failover": e.bytes_failover,
            "engine_bytes_saved_compression": e.bytes_saved_compression,
            "engine_decodes": e.decodes,
            "engine_decode_cache_hits": e.decode_cache_hits,
        })
        # the reference adds its circuit breaker's fields here; the port's
        # engine has no breaker yet (ROADMAP queue 1 item 4)
        return out


def _plan_tables(node: PlanNode) -> list[RelationalTable]:
    """Every base table a plan reads (both sides of a join)."""
    tables, stack = [], [node]
    while stack:
        n = stack.pop()
        if isinstance(n, Scan):
            tables.append(n.table)
        stack.extend(n.children())
    return tables


def _snapshot_capable(node: PlanNode, path: str) -> bool:
    """Whether ``compile_plan`` accepts a ``snapshot_ts`` for this request:
    rme-path plans only (the row/col host baselines have no MVCC visibility
    channel — see planner._check_snapshot_path).  Joins pin through the
    device hash route when its column constraints hold (int32 keys, 4-byte
    payloads); an inexpressible join compiles unpinned rather than failing
    its ticket."""
    if path != "rme":
        return False
    try:
        shape = decompose(node)
    except Exception:
        return False
    if shape.kind == "join":
        return _device_join_expressible(shape)
    return True
