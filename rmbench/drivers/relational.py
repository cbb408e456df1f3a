"""The relational driver: one table in one ``RelationalMemoryEngine`` on the
card behind a ``QueryServer`` (the paper's HTAP main path), served to a
closed loop of clients.

Set-up draws the table's columns on the card from ``--seed``
(``inputs.table_columns``), hands them to the program as its row store, uploads
it, deletes the configuration's ``setup_deletes`` rows through the server
(so every read's snapshot hides them) and runs ``warmup_rounds`` queries a
client of the mix from a stream of its own.  In the window each of the mix's
``clients`` clients keeps one query out, served by the server's own
pipelined tick (:class:`Loop`), and sends its next as soon as that one is
complete, until ``--seconds`` have passed and the last queries are in.  A
query's latency runs from its submit to its answer's completion: on the
host when its ticket resolves, on the card when the card has passed the
pass that wrote it.  The memory peak is the window's alone.

``correct``: every answer of a query the stream drew for the check (a
seeded share of each size class and the first of each blocked template, up
to ``check.max_blocked`` blocked and ``check.max_small`` other answers),
copied to the host as it is kept (:class:`HostCopies`), is compared once
the window has closed and the program's engine is freed with
``reference.relational.Oracle`` over the columns drawn again.

The traced run adds the server's and engine's counter deltas over the
window, a span around the server's compile step, and then a stretch of
``profile_seconds`` under ``torch.profiler`` in which every scan pass's
requests are recorded for the roofline readers.
"""

from __future__ import annotations

import gc
import time

import torch

from rmbench import inputs, traffic
from rmbench.reference.relational import Oracle, gaps
from rmbench.result import Check, Outcome, percentile, rate
from rmbench.trace import profiled, record


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_table(cfg: dict, columns: dict):
    """The program's table holding ``columns``, as ``from_columns`` would
    build it (every row appended at tick 1, live), its row-major words made
    on the columns' device in one pass and handed over through
    ``RelationalTable.from_state``."""
    from repro_torch.core import RelationalTable, benchmark_schema
    from repro_torch.core.table import TS_INF

    schema = benchmark_schema(cfg["row_bytes"], cfg["column_bytes"])
    block = torch.stack([columns[c.name] for c in schema.columns], dim=1)
    words = torch.empty((block.shape[0], schema.row_words + 2), dtype=torch.int32,
                        device=block.device)
    words[:, :schema.row_words] = block
    del block
    words[:, schema.row_words] = 1
    words[:, schema.row_words + 1] = TS_INF
    host = words.cpu().numpy()
    del words
    return RelationalTable.from_state({
        "columns": [(c.name, c.dtype, c.width, c.codec) for c in schema.columns],
        "words": host, "clock": 1})


def build_plan(table, q):
    """``q`` as the program's logical plan over ``table``."""
    from repro_torch.core.plan import plan

    p = plan(table)
    if q.pred is not None:
        p = p.filter(*q.pred)
    if q.kind in ("sum", "select_sum"):
        return p.sum(q.agg)
    if q.kind == "groupby_avg":
        return p.groupby(q.group, q.agg, "avg", q.groups)
    return p.project(*q.columns)


def _on_card(result) -> bool:
    if isinstance(result, torch.Tensor):
        return result.is_cuda
    if isinstance(result, (tuple, list)):
        return any(_on_card(r) for r in result)
    return False


def _nbytes(result) -> int:
    """Bytes ``result``'s tensors take in a :class:`HostCopies` arena."""
    if isinstance(result, torch.Tensor):
        return -(-result.numel() * result.element_size() // 64) * 64
    if isinstance(result, (tuple, list)):
        return sum(_nbytes(r) for r in result)
    return 0


class HostCopies:
    """The answers kept for the check, copied to the host as they are kept:
    on a stream of their own into page-locked memory set aside in set-up,
    so that neither the host nor the card's passes wait for the copy and
    the window's device memory holds only what the program holds.  An
    answer that does not fit the arena is copied synchronously
    (``sync_copies`` counts them)."""

    def __init__(self, device, nbytes: int):
        self.device, self.used, self.sync_copies = device, 0, 0
        self.arena = self.stream = None
        if device.type == "cuda" and nbytes:
            self.arena = torch.empty(nbytes, dtype=torch.uint8)
            self.arena.fill_(0)  # the pages in, before they are locked
            err = int(torch.cuda.cudart().cudaHostRegister(self.arena.data_ptr(), nbytes, 0))
            if err:
                raise RuntimeError(f"cudaHostRegister of {nbytes} bytes failed: error {err}")
            self.stream = torch.cuda.Stream(device)

    def take(self, result):
        """``result`` with each of its tensors on the card replaced by its
        host copy (under way until :meth:`release`)."""
        if isinstance(result, (tuple, list)):
            return type(result)(self.take(r) for r in result)
        if not (isinstance(result, torch.Tensor) and result.is_cuda):
            return result
        n = _nbytes(result)
        if self.arena is None or self.used + n > self.arena.numel():
            self.sync_copies += 1
            return result.cpu()
        size = result.numel() * result.element_size()
        host = self.arena[self.used:self.used + size].view(result.dtype).view(result.shape)
        self.used += n
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            host.copy_(result, non_blocking=True)
        result.record_stream(self.stream)  # its memory is not reused before the copy
        return host

    def release(self) -> None:
        """Wait for every copy and unlock the arena's pages (the copies
        stay where they are)."""
        if self.arena is not None:
            self.stream.synchronize()
            torch.cuda.cudart().cudaHostUnregister(self.arena.data_ptr())
            self.arena = None


class Loop:
    """A closed loop of ``clients`` clients against ``server``, which serves
    them by its own loop body (``start()``'s): ``begin_tick`` of the next
    tick, then ``finish_tick`` of the one in flight, so a tick's host work
    overlaps the pass before it.  Each client keeps one query out and sends
    its next once that one is complete: a host answer (a sum) when its
    ticket resolves, an answer on the card once its ticket has resolved and
    the card has passed an event recorded after the ``begin_tick`` that
    enqueued its pass.  A query's latency runs from its submit to then.  (A
    finalize that enqueues device work of its own, as a multi-join's does,
    would finish after that event; no mix sends one.)"""

    def __init__(self, server, table, queries, clients: int, device):
        self.server, self.table, self.queries = server, table, queries
        self.clients, self.device = clients, device
        self.latencies: list[float] = []
        self.attempted = 0
        self.failed = 0

    def _submit(self, out: dict, c: int) -> None:
        q = next(self.queries)
        with record("submit"):
            out[c] = (q, self.server.submit(build_plan(self.table, q), client=f"c{c}"))
        self.attempted += 1

    def _mark(self):
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def run(self, seconds: float | None = None, count: int | None = None,
            done=None) -> tuple[float, float]:
        """Until ``seconds`` have passed or ``count`` queries were sent; then
        the outstanding ones complete.  ``done(query, result)`` sees each
        answer once it is complete.  Returns the window's start and end
        (host clock)."""
        out: dict = {}      # client -> (query, ticket): sent, not complete
        marks: dict = {}    # id(ticket) -> the event after its tick's begin_tick
        waiting: list = []  # (client, query, ticket, result, event): resolved on the card
        first = self.attempted
        _sync(self.device)
        start = time.perf_counter()

        def complete(c, q, ticket, result, latency):
            self.latencies.append(latency)
            if result is not None and done is not None:
                done(q, result)
            more = (time.perf_counter() - start < seconds if seconds is not None
                    else self.attempted - first < count)
            if more:
                self._submit(out, c)

        for c in range(self.clients):
            self._submit(out, c)
        inflight = None
        while out or waiting or inflight is not None:
            with record("tick"):
                nxt = self.server.begin_tick()
                mark = self._mark() if nxt is not None else None
                self.server.finish_tick(inflight)
            progressed = nxt is not None or inflight is not None
            inflight = nxt
            if nxt is not None:
                for req in nxt.reads:
                    marks[id(req.ticket)] = mark
            for c in sorted(out):
                q, ticket = out[c]
                if not ticket.done():
                    continue
                del out[c]
                ev = marks.pop(id(ticket), mark)  # express answers resolve in begin_tick
                try:
                    result = ticket.result(timeout=0)
                except Exception:  # the ticket's error is the client's answer
                    self.failed += 1
                    complete(c, q, ticket, None, ticket.latency_s)
                    continue
                if _on_card(result):
                    waiting.append((c, q, ticket, result, ev or self._mark()))
                else:
                    complete(c, q, ticket, result, ticket.latency_s)
            if waiting and inflight is None and not out:
                with record("wait"):
                    waiting[0][4].synchronize()  # nothing else to do
                progressed = True
            still = []
            for w in waiting:
                if w[4].query():
                    c, q, ticket, result, _ = w
                    complete(c, q, ticket, result, time.perf_counter() - ticket.submitted_at)
                else:
                    still.append(w)
            waiting = still
            if not progressed and out and not self.server.queue_depth:
                raise RuntimeError("queries outstanding, none queued or in flight")
        return start, time.perf_counter()


def _counters(server) -> dict:
    return {"ticks": server.stats.ticks, "reads": server.stats.served,
            "bytes_from_dram": server.engine.stats.bytes_from_dram}


def _timed(fn, span: dict):
    def wrapper(reads):
        t0 = time.perf_counter()
        try:
            return fn(reads)
        finally:
            span["seconds"] += time.perf_counter() - t0
            span["reads"] += len(reads)
    return wrapper


def _record_passes(engine, passes: list):
    """Record each scan pass's requests, rows and row bytes: the fused pass
    (``rme_scan_multi.scan_multi``) and the single-request kernels
    (``engine._solo_kernel``).  Returns the undo."""
    from repro_torch.kernels import rme_scan_multi as KR

    fused, solo = KR.scan_multi, engine._solo_kernel

    def scan_multi(words, requests):
        passes.append(("fused", tuple(requests), words.shape[0], words.shape[1] * 4))
        return fused(words, requests)

    def solo_kernel(words, req):
        passes.append(("solo", (req,), words.shape[0], words.shape[1] * 4))
        return solo(words, req)

    KR.scan_multi = scan_multi
    engine._solo_kernel = solo_kernel

    def undo():
        KR.scan_multi = fused
        del engine._solo_kernel
    return undo


def run(cell, seed: int, seconds: float, trace: bool, device, clock) -> Outcome:
    s = serve(cell, seed, seconds, trace, device, clock)
    t0 = time.perf_counter()
    checks = judge(cell.config, s["answers"], seed, device)
    s["layer"]["timings"]["reference_s"] = time.perf_counter() - t0
    return Outcome(s["e2e"], s["layer"], checks, s["attempted"], s["failed"], s["peak"])


def arena_bytes(sizes: dict, check: dict) -> int:
    """Room for the answers a window keeps: the first of every blocked
    template, as many more as ``max_blocked`` leaves room for where the
    mix draws a share of them, and ``max_small`` of the largest other."""
    blocked = [n for v, n in sizes.items() if v[0] in traffic.BLOCKED]
    small = [n for v, n in sizes.items() if v[0] not in traffic.BLOCKED]
    extra = max(check["max_blocked"] - len(blocked), 0) if check["blocked_share"] else 0
    return (sum(blocked) + extra * max(blocked, default=0)
            + check["max_small"] * max(small, default=0))


def serve(cell, seed: int, seconds: float, trace: bool, device, clock) -> dict:
    """Set up, warm up and serve the window (and, traced, the profiled
    stretch); the program's state is freed on return, the answers drawn for
    the check kept."""
    from repro_torch.core import RelationalMemoryEngine
    from repro_torch.serve import QueryServer

    cfg, mix = cell.config, cell.mix
    phases = {**clock.marks, "start_s": clock.now()}
    t0 = time.perf_counter()
    table = build_table(cfg, inputs.table_columns(cfg, seed, device))
    deleted = inputs.deleted_rows(cfg, seed)
    engine = RelationalMemoryEngine(revision=cfg["revision"], device=device)
    server = QueryServer(engine, **cfg["server"])
    t1 = time.perf_counter()
    engine.device_words(table)  # the upload
    _sync(device)
    t2 = time.perf_counter()
    server.submit_delete(table, deleted)
    if server.drain() != 1:
        raise RuntimeError("set-up's delete did not run")
    sizes: dict = {}  # a template's answer bytes, for the arena of kept answers

    def size(q, result) -> None:
        sizes[q.variant] = max(sizes.get(q.variant, 0), _nbytes(result))

    warm = Loop(server, table, traffic.stream(cfg, mix, seed, salt=1), mix["clients"], device)
    warm.run(count=mix["warmup_rounds"] * mix["clients"], done=size)
    if warm.failed:
        raise RuntimeError(f"{warm.failed} warm-up queries failed")
    del warm
    t3 = time.perf_counter()
    check, kept, answers = mix["check"], {True: 0, False: 0}, []
    copies = HostCopies(device, arena_bytes(sizes, check))
    setup_s = clock.now()
    phases.update(table_s=t1 - t0, upload_s=t2 - t1, delete_warm_s=t3 - t2,
                  arena_s=time.perf_counter() - t3)

    def keep(q, result) -> None:
        cap = check["max_blocked"] if q.blocked else check["max_small"]
        if q.keep and kept[q.blocked] < cap:
            kept[q.blocked] += 1
            answers.append((q, copies.take(result)))

    loop = Loop(server, table, traffic.stream(cfg, mix, seed), mix["clients"], device)
    gc.collect()
    layer: dict = {"config": cfg, "mix": mix, "trace": None, "passes": [],
                   "device": device.type}
    if trace:
        span = {"seconds": 0.0, "reads": 0}
        server._compile_reads = _timed(server._compile_reads, span)
        before = _counters(server)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)  # the window's peak, not set-up's
    start, end = loop.run(seconds=seconds, done=keep)
    if trace:
        after = _counters(server)
        layer["counters"] = {k: after[k] - before[k] for k in after}
        layer["compile_span"] = dict(span)
        del server._compile_reads
        undo = _record_passes(engine, layer["passes"])
        stretch = Loop(server, table, loop.queries, mix["clients"], device)
        with profiled(device) as prof:
            stretch.run(seconds=mix["profile_seconds"])
        undo()
        layer["trace"] = prof.trace
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    copies.release()  # every copy in; the answers stay readable on the host
    completed = len(loop.latencies) - loop.failed
    e2e = {"query_p95_ms": percentile(loop.latencies, 95) * 1e3,
           "queries_per_s": rate(completed, end - start), "setup_s": setup_s}
    layer["timings"] = {"setup_s": setup_s, **phases, "window_s": end - start,
                        "queries": completed, "answers_kept": len(answers),
                        "kept_bytes": copies.used, "kept_sync_copies": copies.sync_copies}

    out = {"e2e": e2e, "layer": layer, "answers": answers, "attempted": loop.attempted,
           "failed": loop.attempted - completed,  # raised, or never answered
           "peak": peak}
    del loop, server, engine, table
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def oracle(cfg: dict, seed: int, device, precision: str = "exact") -> Oracle:
    """The reference over the seed's columns, drawn again, at the snapshot."""
    return Oracle(inputs.table_columns(cfg, seed, device), inputs.deleted_rows(cfg, seed),
                  device, precision)


def judge(cfg, answers, seed: int, device, precision: str = "exact",
          want: Oracle | None = None) -> list[Check]:
    """The checks over the answers drawn for them: the widest sum gap, the
    widest group-average gap and the mismatched words and mask bits, each
    beside the configuration's limit.  ``precision="bfloat16"`` judges the
    control in the program's place instead (its answers replace ``answers``'
    results)."""
    want = want or oracle(cfg, seed, device)
    control = oracle(cfg, seed, device, precision) if precision != "exact" else None
    worst = {"sum_err": 0.0, "avg_err": 0.0, "mismatches": 0.0}
    for q, got in answers:
        if control is not None:
            got = control.answer(q)
            got = got[0] if not q.blocked else got
        for k, v in gaps(q, got, want.answer(q)).items():
            worst[k] = worst[k] + v if k == "mismatches" else max(worst[k], v)
    limits = cfg["limits"]
    return [Check(k, worst[k], limits[k]) for k in ("sum_err", "avg_err", "mismatches")]
