#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's engine batch path and its QueryServer on
one NVIDIA GPU.

    python3 chip_smoke.py [--rows N] [--build-rows M] [--seed S] [--reps R]

Builds the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a), then,
on a fact table S of ``benchmark_schema(64, 4)`` (16 int32 columns, the
paper's Fig. 13 upper end: 2 GiB of user data, 33,554,432 rows, 72 bytes a
row stored with the two MVCC words; ``--rows`` cuts it) whose key column
``A2`` is uniform in ``[0, 2 * M)``, and a dimension table R of the same
schema with M = 1,048,576 rows (``--build-rows``) and ``A2 = arange(M)`` as
its primary key — the setup of ``benchmarks/fig12_join.py``, about half the
probe rows matching — all made from ``--seed``:

1. prints the card (``nvidia-smi`` name and power limit, torch and CUDA);
2. times the kernel build;
3. runs the tick script below at 5,000 rows on a card server and a CPU
   server and holds their results equal;
4. holds every kernel against its plain PyTorch version on the card at the
   path's shapes, and times both (CUDA events, median of ``--reps`` after a
   warm-up), beside the least time the card could take and one library
   call where one computes the same (or, footnoted, less) work;
5. drives the engine through ``BatchExecutor`` / ``execute_many`` on the
   card — solo project, filter, aggregate and group-by, a mixed batch of 7
   ops, then 4,096 appends, 64 updates and 64 deletes and the same batch
   under a snapshot over base plus tail chunks — checks every result
   against a numpy oracle from the host table, and checks that each of the
   five scan kernels was launched by that run;
6. drives a ``QueryServer`` on the card through three ticks: A, the join
   ``S.A2 = R.A2`` alone on S (the probe streams the row store, cold build)
   beside a streamed projection; B, the same join (build cache hit); C,
   4,096 inserts, 64 updates and 64 deletes on S, then a filtered sum, a
   group-by average, a projection, the join and a two-join chain in one
   tick, all pinned to the tick's snapshot and riding one shared scan (the
   joins probe its packed block).  Every ticket is held against a numpy
   oracle, and the hash-join probe must have launched in ticks A and C;
7. prints the ``{"kernels": [...]}`` line, then ``{"ok": true, ...}`` last.

Every phase prints one JSON line.  Any failure ends the run with a
traceback and a non-zero exit; without a CUDA device it exits non-zero
before printing any result.
"""

from __future__ import annotations

import argparse
import cProfile
import gc
import json
import math
import pstats
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROWS = 33_554_432  # 2 GiB of 64-byte rows
BUILD_ROWS = 1_048_576  # the dimension table: 18 MiB of hash buckets
STREAM_CHUNK_ROWS = 4_194_304
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
SECTOR = 32
# per request and row: the predicate and two MVCC compares, an add, a count
OPS_PER_ROW = 5
SUM_RTOL = 1e-5  # |a - b| <= 1e-5 * sum(|v|) over the summed rows

REPLACES = {
    "project": "src/repro/kernels/rme_project.py:47",
    "filter_project": "src/repro/kernels/rme_filter.py:26",
    "aggregate": "src/repro/kernels/rme_aggregate.py:30",
    "groupby_sum": "src/repro/kernels/rme_aggregate.py:120",
    "scan_multi": "src/repro/kernels/rme_scan_multi.py:217",
    "hash_join": "src/repro/kernels/rme_join.py:219",
}
SOURCES = {"hash_join": "src/repro_torch/csrc/rm_join.cu"}  # else rm_scan.cu


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--build-rows", type=int, default=BUILD_ROWS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    return ap.parse_args(argv)


# ------------------------------------------------------------------ timing
def time_ms(torch, fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sector_bytes(words: set[int], rows: int, row_bytes: int) -> int:
    """Bytes of the distinct 32-byte sectors holding ``words`` of every row
    (the buffer starts sector-aligned).  The pattern repeats every
    ``SECTOR / gcd(row_bytes, SECTOR)`` rows, each period sector-aligned."""
    period = SECTOR // math.gcd(row_bytes, SECTOR)

    def count(n: int) -> int:
        return len({(r * row_bytes + 4 * w) // SECTOR for r in range(n) for w in words})

    full, rem = divmod(rows, period)
    return (full * count(period) + count(rem)) * SECTOR


def bound(read_words: set[int], out_bytes: int, rows: int, row_bytes: int,
          ops_per_row: int) -> tuple[float, str]:
    """The least time of the work on the card, in ms, and what bounds it."""
    t_bytes = (sector_bytes(read_words, rows, row_bytes) + out_bytes) / HBM_BYTES_PER_S
    t_ops = rows * ops_per_row / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------ comparisons
def sum_err(torch, got, want, absval) -> float:
    """|got - want|, asserted within SUM_RTOL * absval."""
    err = (got.double() - want.double()).abs()
    assert torch.all(err <= SUM_RTOL * absval.double() + 1e-3), (got, want, absval)
    return float(err.max())


def compare(torch, kind: str, got, want, words, req) -> float:
    """Hold a kernel result against the plain version's; returns max |diff|."""
    if kind in ("project",):
        assert torch.equal(got, want)
        return 0.0
    if kind == "filter":
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        return 0.0
    from repro_torch.kernels import common

    mask = common.row_mask(words, req.pred_word, req.pred_dtype, req.pred_op,
                           common.pred_k_bits(req.pred_k, req.pred_dtype),
                           req.ts_word, req.ts)
    absvals = common.masked_values(words[:, req.agg_word], req.agg_dtype, mask).abs()
    if kind == "aggregate":
        assert got[1].item() == want[1].item(), (got, want)
        return sum_err(torch, got[0], want[0], absvals.sum())
    assert torch.equal(got[1], want[1]), (got[1], want[1])
    g = common.group_ids(words[:, req.group_word], req.num_groups).long()
    per_group = torch.zeros(req.num_groups, dtype=torch.float64, device=words.device)
    per_group.index_add_(0, g, absvals.double())
    return sum_err(torch, got[0], want[0], per_group)


def count_ok(got: float, true: int, chunks: int = 1) -> bool:
    """A float32 count against the exact one.  Counts travel as float32 (the
    reference's ``[sum, count]`` contract): above 2^24 each chunk's count is
    rounded once and each cross-chunk add once more, half an ulp each."""
    return abs(float(got) - true) <= (2 * chunks - 1) * 2.0 ** -24 * true


def kind_of(req, KR) -> str:
    return {KR.ProjectRequest: "project", KR.FilterRequest: "filter",
            KR.AggregateRequest: "aggregate", KR.GroupByRequest: "groupby"}[type(req)]


# ------------------------------------------------------------------ phases
def card(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = {"phase": "card", "nvidia_smi": smi,
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def build_table(rows: int, seed: int, build_rows: int):
    """The fact table S: columns uniform in [-1000, 1000), the join key A2
    uniform in [0, 2 * build_rows) so about half the rows match R."""
    from repro_torch.core import RelationalTable, benchmark_schema

    schema = benchmark_schema(64, 4)
    rng = np.random.default_rng(seed)
    cols = {c.name: rng.integers(-1000, 1000, rows, dtype=np.int32)
            for c in schema.columns}
    cols["A2"] = rng.integers(0, 2 * build_rows, rows, dtype=np.int32)
    return RelationalTable.from_columns(schema, cols)


def build_dimension(rows: int, seed: int):
    """The dimension table R: primary key A2 = arange(rows), the other
    columns uniform in [-1000, 1000)."""
    from repro_torch.core import RelationalTable, benchmark_schema

    schema = benchmark_schema(64, 4)
    rng = np.random.default_rng(seed + 7)
    cols = {c.name: rng.integers(-1000, 1000, rows, dtype=np.int32)
            for c in schema.columns}
    cols["A2"] = np.arange(rows, dtype=np.int32)
    return RelationalTable.from_columns(schema, cols)


def path_requests(table, ts: int | None):
    """The kernel requests the engine's batches lower to."""
    from repro_torch.core import AggregateOp, GroupByOp, RelationalMemoryEngine
    from repro_torch.core.requests import FilterOp, ProjectOp

    eng = RelationalMemoryEngine(device="cpu")  # only to register views
    return {
        "project": ProjectOp(eng.register(table, ["A1", "A5", "A9", "A13"])).lower(),
        "filter": FilterOp(eng.register(table, ["A2", "A3"]), "A4", "gt", 0,
                           ts).lower(),
        "aggregate": AggregateOp(table, "A6", "A7", "lt", 100, ts).lower(),
        "groupby": GroupByOp(table, "A16", "A8", 16, snapshot_ts=ts).lower(),
        "aggregate2": AggregateOp(table, "A9", "A10", "gt", -500, ts).lower(),
    }


def kernels_phase(torch, table, dim, reps: int) -> dict:
    """Each kernel against its plain version at the path's shapes."""
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import rme_scan_multi as KR
    from repro_torch.kernels.common import geometry_words

    words = torch.from_numpy(table.words()).cuda()
    n, row_words = words.shape
    row_bytes = row_words * 4
    reqs = path_requests(table, table.now())
    p, f, a, g = reqs["project"], reqs["filter"], reqs["aggregate"], reqs["groupby"]
    fused = [p, f, a, g, reqs["aggregate2"]]

    def solo(name, req):
        if name == "project":
            return lambda w: K.project(w, req.geom), lambda w: K.project_torch(w, req.geom)
        if name == "filter_project":
            kw = dict(pred_word=req.pred_word, pred_dtype=req.pred_dtype,
                      pred_op=req.pred_op, pred_k=req.pred_k, ts=req.ts,
                      ts_word=req.ts_word)
            return (lambda w: K.filter_project(w, req.geom, **kw),
                    lambda w: K.filter_project_torch(w, req.geom, **kw))
        kw = dict(agg_word=req.agg_word, agg_dtype=req.agg_dtype,
                  pred_word=req.pred_word, pred_dtype=req.pred_dtype,
                  pred_op=req.pred_op, pred_k=req.pred_k, ts=req.ts,
                  ts_word=req.ts_word)
        if name == "aggregate":
            return lambda w: K.aggregate(w, **kw), lambda w: K.aggregate_torch(w, **kw)
        kw.update(group_word=req.group_word, num_groups=req.num_groups)
        return lambda w: K.groupby_sum(w, **kw), lambda w: K.groupby_sum_torch(w, **kw)

    def touched(req) -> set[int]:
        return {o // 4 + j for o, w in KR.request_intervals(req) for j in range(w // 4)}

    def out_bytes(req) -> int:
        if isinstance(req, KR.ProjectRequest):
            return n * req.geom.out_bytes_per_row
        if isinstance(req, KR.FilterRequest):
            return n * (req.geom.out_bytes_per_row + 1)
        return KR.reduced_result_bytes(req)

    # library yardsticks: one PyTorch call each, on inputs prepared beforehand
    idx = torch.tensor(geometry_words(p.geom), dtype=torch.long, device="cuda")
    from repro_torch.kernels import common
    a_vals = common.masked_values(
        words[:, a.agg_word], a.agg_dtype,
        common.row_mask(words, a.pred_word, a.pred_dtype, a.pred_op,
                        common.pred_k_bits(a.pred_k, a.pred_dtype), a.ts_word, a.ts))
    g_ids = common.group_ids(words[:, g.group_word], g.num_groups).long()
    g_vals = common.masked_values(
        words[:, g.agg_word], g.agg_dtype,
        common.row_mask(words, g.pred_word, g.pred_dtype, g.pred_op,
                        common.pred_k_bits(g.pred_k, g.pred_dtype), g.ts_word, g.ts))
    library = {
        "project": lambda: torch.index_select(words, 1, idx),
        "aggregate": lambda: torch.sum(a_vals),
        "groupby_sum": lambda: torch.zeros(g.num_groups, device="cuda").index_add_(
            0, g_ids, g_vals),
    }

    results = {}
    cases = [("project", p), ("filter_project", f), ("aggregate", a),
             ("groupby_sum", g), ("scan_multi", fused)]
    for name, req in cases:
        if name == "scan_multi":
            run = lambda w: K.scan_multi(w, fused)  # noqa: E731
            plain = lambda w: K.scan_multi_torch(w, fused)  # noqa: E731
            got, want = run(words), plain(words)
            torch.cuda.synchronize()
            err = max(compare(torch, kind_of(r, KR), x, y, words, r)
                      for r, x, y in zip(fused, got, want))
            read = set().union(*(touched(r) for r in fused))
            outb = sum(out_bytes(r) for r in fused)
            ops = OPS_PER_ROW * len(fused)
        else:
            run, plain = solo(name, req)
            got, want = run(words), plain(words)
            torch.cuda.synchronize()
            err = compare(torch, kind_of(req, KR), got, want, words, req)
            read, outb, ops = touched(req), out_bytes(req), OPS_PER_ROW
        bound_ms, bound_by = bound(read, outb, n, row_bytes, ops)
        line = {
            "phase": "kernel", "name": name,
            "kernel_ms": time_ms(torch, lambda: run(words), reps),
            "plain_ms": time_ms(torch, lambda: plain(words), max(3, reps // 3)),
            "library_ms": (time_ms(torch, library[name], reps)
                           if name in library else None),
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
            "rows": n, "row_bytes": row_bytes,
        }
        emit(line)
        results[name] = line
    results.update(join_kernel_phase(torch, words, dim, table.now(), reps))
    del words
    torch.cuda.empty_cache()
    return results


def join_bound(torch, words, parts, key_word, val_word, ts_word,
               build_ts, key_matches: int) -> tuple[float, str]:
    """The probe's least time: the sectors of the key, payload and (when
    tested) timestamp words of every row, each bucket array once, 9 output
    bytes a row; operations: the hash (2), the C key compares and the probe
    row's two MVCC compares a row, and per key match the build row's two
    MVCC compares and an add."""
    n, row_words = words.shape
    read = {key_word, val_word} | ({ts_word, ts_word + 1} if ts_word >= 0 else set())
    t_bytes = (sector_bytes(read, n, row_words * 4) + parts.nbytes + 9 * n) / HBM_BYTES_PER_S
    ops = n * (2 + parts.capacity + (2 if ts_word >= 0 else 0))
    ops += key_matches * (3 if build_ts else 1)
    t_ops = ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def join_kernel_phase(torch, words, dim, ts: int, reps: int) -> dict:
    """The hash-join probe against its plain version in both forms the
    server path gives it: the row store (S's words, snapshot tests on both
    sides) and a packed {A1, A2} block (the shared scan's output)."""
    from repro_torch.kernels import ops as K

    dw = dim.words()
    parts = K.build_partitions(dw[:, 1], dw[:, 2], dw[:, dim.ts_begin_word],
                               dw[:, dim.ts_end_word], device="cuda")
    sorted_keys = torch.sort(torch.from_numpy(dw[:, 1].copy()).cuda()).values
    packed = words[:, :2].contiguous()
    out = {}
    forms = [("hash_join", words, 1, 0, 16, True),
             ("hash_join_packed", packed, 1, 0, -1, True)]
    for name, w, key_word, val_word, ts_word, build_ts in forms:
        args = (key_word, val_word, ts_word, ts, build_ts)
        got = K.hash_join(w, parts, *args)
        want = K.hash_join_torch(w, parts, *args)
        torch.cuda.synchronize()
        for g, x in zip(got, want):
            assert g.dtype == x.dtype and torch.equal(g, x), name
        err = max(float((g.long() - x.long()).abs().max()) if g.numel() else 0.0
                  for g, x in zip(got[:2], want[:2]))
        probe_keys = w[:, key_word].contiguous()  # prepared beforehand
        pos = torch.searchsorted(sorted_keys, probe_keys).clamp_(0, sorted_keys.numel() - 1)
        key_matches = int((sorted_keys[pos] == probe_keys).sum())
        del got, want, pos
        bound_ms, bound_by = join_bound(torch, w, parts, key_word, val_word,
                                        ts_word, build_ts, key_matches)
        line = {
            "phase": "kernel", "name": name,
            "kernel_ms": time_ms(torch, lambda: K.hash_join(w, parts, *args), reps),
            "plain_ms": time_ms(torch, lambda: K.hash_join_torch(w, parts, *args),
                                max(3, reps // 3)),
            # the sort-probe route's one call: a binary search of the probe
            # keys in the sorted build keys — less work than the probe (no
            # payload, no MVCC tests, no match mask)
            "library_ms": time_ms(torch, lambda: torch.searchsorted(sorted_keys, probe_keys),
                                  reps),
            "library_call": "torch.searchsorted (does less work)",
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
            "rows": w.shape[0], "row_bytes": w.shape[1] * 4,
            "buckets": parts.num_buckets, "capacity": parts.capacity,
            "bucket_bytes": parts.nbytes, "key_matches": key_matches,
        }
        emit(line)
        out[name] = line
    del packed
    return out


def oracle_batch(table, results, ts: int | None, chunks: int) -> None:
    """The mixed batch's results against numpy over the host table."""
    w = table.words()
    vis = (np.ones(len(w), bool) if ts is None
           else (w[:, 16] <= ts) & (ts < w[:, 17]))
    packed, sub, (fp, fm), (fp2, fm2), agg, (gs, gc), agg2 = results
    proj = w[:, [0, 4, 8, 12]]
    assert np.array_equal(packed.cpu().numpy(), proj)
    assert np.array_equal(sub.cpu().numpy(), w[:, [0, 4]])
    m = (w[:, 3] > 0) & vis
    want = np.where(m[:, None], w[:, [1, 2]], 0)
    for p_, m_ in ((fp, fm), (fp2, fm2)):
        assert np.array_equal(m_.cpu().numpy(), m)
        assert np.array_equal(p_.cpu().numpy(), want)
    for got, col, pred in ((agg, 5, w[:, 6] < 100), (agg2, 8, w[:, 9] > -500)):
        m = pred & vis
        v = w[m, col].astype(np.float64)
        host = got.cpu().numpy()
        assert count_ok(host[1], int(m.sum()), chunks), (host, m.sum())
        assert abs(host[0] - v.sum()) <= SUM_RTOL * np.abs(v).sum() + 1e-3
    gid = np.mod(w[:, 15].astype(np.int64), 16)
    m = vis
    want_c = np.bincount(gid[m], minlength=16)
    want_s = np.bincount(gid[m], weights=w[m, 7].astype(np.float64), minlength=16)
    abs_s = np.bincount(gid[m], weights=np.abs(w[m, 7]).astype(np.float64), minlength=16)
    # per-group counts stay below 2^24 at the smoke size: exact
    assert np.array_equal(gc.cpu().numpy(), want_c.astype(np.float32))
    assert np.all(np.abs(gs.cpu().numpy() - want_s) <= SUM_RTOL * abs_s + 1e-3)


def mixed_ops(eng, table, ts):
    from repro_torch.core import AggregateOp, GroupByOp
    from repro_torch.core.requests import FilterOp, ProjectOp

    big = eng.register(table, ["A1", "A5", "A9", "A13"])
    return [
        ProjectOp(big),
        ProjectOp(eng.register(table, ["A1", "A5"])),  # subsumed by `big`
        FilterOp(eng.register(table, ["A2", "A3"]), "A4", "gt", 0, ts),
        FilterOp(eng.register(table, ["A2", "A3"]), "A4", "gt", 0, ts),  # duplicate
        AggregateOp(table, "A6", "A7", "lt", 100, ts),
        GroupByOp(table, "A16", "A8", 16, snapshot_ts=ts),
        AggregateOp(table, "A9", "A10", "gt", -500, ts),
    ]


def engine_phase(torch, table, seed: int) -> dict:
    """The engine batch path on the card, every result against numpy."""
    import dataclasses

    from repro_torch.core import BatchExecutor, RelationalMemoryEngine
    from repro_torch.kernels import _cuda

    eng = RelationalMemoryEngine()  # on the card
    rng = np.random.default_rng(seed + 1)
    steps = []

    def step(name, fn, rows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps.append({"step": name, "seconds": dt, "rows": rows,
                      "rows_per_s": rows / dt if dt > 0 else None})
        return out

    _cuda.reset_launches()
    n = table.row_count
    step("upload", lambda: eng.device_chunks(table), n)

    def solo_project():
        b = BatchExecutor(eng)
        b.add_columns(table, ["A1", "A5", "A9", "A13"])
        return b.submit()[0]

    packed = step("solo_project", solo_project, n)
    assert np.array_equal(packed.cpu().numpy(), table.words()[:, [0, 4, 8, 12]])
    del packed

    def solo_filter():
        b = BatchExecutor(eng)
        b.add_filter(table, ["A2", "A3"], "A4", "gt", 0)
        return b.submit()[0]

    fp, fm = step("solo_filter", solo_filter, n)
    w = table.words()
    m = w[:, 3] > 0
    assert np.array_equal(fm.cpu().numpy(), m)
    assert np.array_equal(fp.cpu().numpy(), np.where(m[:, None], w[:, [1, 2]], 0))
    del fp, fm

    s, c = step("solo_aggregate", lambda: eng.aggregate(table, "A6", "A7", "lt", 100), n)
    m = w[:, 6] < 100
    v = w[m, 5].astype(np.float64)
    assert count_ok(c, int(m.sum())) and abs(s - v.sum()) <= SUM_RTOL * np.abs(v).sum() + 1e-3

    def solo_groupby():
        b = BatchExecutor(eng)
        b.add_groupby(table, "A16", "A8", 16)
        return b.submit()[0]

    gs, gc = step("solo_groupby", solo_groupby, n)
    gid = np.mod(w[:, 15].astype(np.int64), 16)
    assert np.array_equal(gc.cpu().numpy(), np.bincount(gid, minlength=16).astype(np.float32))
    want = np.bincount(gid, weights=w[:, 7].astype(np.float64), minlength=16)
    absw = np.bincount(gid, weights=np.abs(w[:, 7]).astype(np.float64), minlength=16)
    assert np.all(np.abs(gs.cpu().numpy() - want) <= SUM_RTOL * absw + 1e-3)

    res = step("mixed_batch", lambda: eng.execute_many(mixed_ops(eng, table, None)), n)
    oracle_batch(table, res, None, 1)
    del res

    def writes():
        cols = {c.name: rng.integers(-1000, 1000, 4096, dtype=np.int32)
                for c in table.schema.columns}
        table.append(cols)
        upd = rng.choice(n, 64, replace=False)
        table.update(upd, {"A1": rng.integers(-1000, 1000, 64, dtype=np.int32)})
        table.delete(rng.choice(n, 64, replace=False))

    writes()  # host-side OLTP; the next batch ships only the delta
    ts = table.now()
    res = step("mixed_batch_snapshot",
               lambda: eng.execute_many(mixed_ops(eng, table, ts)), table.row_count)
    chunks = len(eng.device_chunks(table))
    assert chunks == 2, chunks  # the base and one tail of the written rows
    oracle_batch(table, res, ts, chunks)
    del res
    launches = {k: _cuda.LAUNCHES[k] for k in _cuda.SCAN_KERNELS}
    idle = [k for k, v in launches.items() if v == 0]
    assert not idle, f"kernels never launched on the engine path: {idle}"
    out = {"phase": "engine", "rows": table.row_count, "chunks": chunks,
           "launches": launches, "steps": steps,
           "stats": dataclasses.asdict(eng.stats)}
    emit(out)
    return out


def host_top(prof: cProfile.Profile, k: int = 8) -> list:
    """The ``k`` functions with the most host self-time in a profile, as
    ``[function, self seconds, cumulative seconds]``."""
    rows = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])[:k]
    return [[f"{Path(f).name}:{line}({fn})", tt, ct]
            for (f, line, fn), (_, _, tt, ct, _) in rows]


def server_ticks(torch, server, S, R, seed: int, stream_chunk_rows: int):
    """The serving tick script; yields ``(tick, results, seconds, host_top)``
    after each tick (host clock around submit + drain, synced on both
    sides; the tick runs under ``cProfile``, whose top functions by host
    self-time say where a host-bound tick spends it).

    A: the join alone on S (the probe streams S's row store) and a streamed
       projection; B: the same join again; C: writes on S, then five reads
       of S in one tick, pinned to its snapshot."""
    from repro_torch.core import plan

    rng = np.random.default_rng(seed + 3)

    def join(proj="A3"):
        return plan(S).join(R, key="A2", left_proj="A1", right_proj=proj)

    def tick(submit):
        prof = cProfile.Profile()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prof.enable()
        tickets = submit()
        server.drain()
        results = [tk.result(timeout=900) for tk in tickets]
        torch.cuda.synchronize()
        prof.disable()
        return results, time.perf_counter() - t0, host_top(prof)

    yield ("A", *tick(lambda: [
        server.submit(join()),
        server.submit(plan(S).project("A1", "A4"), stream=True,
                      stream_chunk_rows=stream_chunk_rows)]))
    yield ("B", *tick(lambda: [server.submit(join())]))

    def tick_c():
        n = S.row_count
        cols = {c.name: rng.integers(-1000, 1000, 4096, dtype=np.int32)
                for c in S.schema.columns}
        cols["A2"] = rng.integers(0, 2 * R.row_count, 4096, dtype=np.int32)
        server.submit_insert(S, cols)
        server.submit_update(S, rng.choice(n, 64, replace=False),
                             {"A1": rng.integers(-1000, 1000, 64, dtype=np.int32)})
        server.submit_delete(S, rng.choice(n, 64, replace=False))
        return [server.submit(plan(S).filter("A3", "gt", 100).sum("A1")),
                server.submit(plan(S).groupby("A4", "A1", "avg", 16)),
                server.submit(plan(S).project("A1", "A5")),
                server.submit(join()),
                server.submit(join().join(R, key="A2", left_proj="A1",
                                          right_proj="A5"))]

    yield ("C", *tick(tick_c))


def join_oracle(w, R, ts: int | None, proj_word: int):
    """(s_proj, r_proj, matched) of ``S.A2 = R.A2`` over S's words ``w``:
    R's key is its row number, so a probe key in range matches row key."""
    key = w[:, 1].astype(np.int64)
    vis = np.ones(len(w), bool) if ts is None else (w[:, 16] <= ts) & (ts < w[:, 17])
    matched = vis & (key >= 0) & (key < R.row_count)
    r_vals = R.words()[:, proj_word]
    r = np.where(matched, r_vals[np.clip(key, 0, R.row_count - 1)], 0)
    return np.where(vis, w[:, 0], 0), r, matched


def check_join(res, want) -> None:
    for got, exp in zip((res.s_proj, res.r_proj, res.matched), want):
        assert np.array_equal(got.cpu().numpy(), exp)


def server_oracle(torch, tick: str, results, S, R, ts: int | None) -> None:
    """Every ticket of a tick against numpy over the host tables."""
    w = S.words()
    if tick in ("A", "B"):
        check_join(results[0], join_oracle(w, R, None, 2))
        if tick == "A":
            assert np.array_equal(results[1].cpu().numpy(), w[:, [0, 3]])
        return
    total, avg, (packed, mask), one, chain = results
    vis = (w[:, 16] <= ts) & (ts < w[:, 17])
    m = vis & (w[:, 2] > 100)
    v = w[m, 0].astype(np.float64)
    assert abs(total - v.sum()) <= SUM_RTOL * np.abs(v).sum() + 1e-3, (total, v.sum())
    gid = np.mod(w[:, 3].astype(np.int64), 16)[vis]
    cnt = np.bincount(gid, minlength=16)
    sums = np.bincount(gid, weights=w[vis, 0].astype(np.float64), minlength=16)
    abs_s = np.bincount(gid, weights=np.abs(w[vis, 0]).astype(np.float64), minlength=16)
    got = avg.cpu().numpy().astype(np.float64)
    assert np.all(np.abs(got - sums / np.maximum(cnt, 1))
                  <= (SUM_RTOL * abs_s + 1e-3) / np.maximum(cnt, 1)), (got, sums / cnt)
    assert np.array_equal(mask.cpu().numpy(), vis)
    assert np.array_equal(packed.cpu().numpy(), np.where(vis[:, None], w[:, [0, 4]], 0))
    want = join_oracle(w, R, ts, 2)
    check_join(one, want)
    s_want, r3, matched = want
    r5 = join_oracle(w, R, ts, 4)[1]
    assert np.array_equal(chain.matched.cpu().numpy(), matched)
    assert np.array_equal(chain.s_proj.cpu().numpy(), np.where(matched, s_want, 0))
    assert np.array_equal(chain.r_projs[0].cpu().numpy(), r3)
    assert np.array_equal(chain.r_projs[1].cpu().numpy(), r5)


def server_phase(torch, S, R, seed: int) -> dict:
    """A QueryServer on the card, three ticks, every ticket against numpy."""
    import dataclasses

    from repro_torch.core import RelationalMemoryEngine, planner
    from repro_torch.kernels import _cuda
    from repro_torch.serve import QueryServer

    planner.clear_join_build_cache()
    eng = RelationalMemoryEngine()  # on the card
    server = QueryServer(eng)
    _cuda.reset_launches()
    ticks = []
    for name, results, dt, top in server_ticks(torch, server, S, R, seed,
                                               STREAM_CHUNK_ROWS):
        launches = dict(_cuda.LAUNCHES)
        delta = {k: v - sum(t["launches"][k] for t in ticks) for k, v in launches.items()}
        before = ticks[-1]["stats"] if ticks else {}
        stats = dataclasses.asdict(eng.stats)
        ts = max(S.now(), R.now()) if name == "C" else None
        server_oracle(torch, name, results, S, R, ts)
        if name in ("A", "C"):
            assert delta["hash_join"] >= 1, (name, delta)
        if name in ("A", "B"):
            assert stats["join_builds"] == 1, stats  # built in A, cached for B
        if name == "B":
            assert planner.JOIN_BUILD_STATS["hits"] >= 1, planner.JOIN_BUILD_STATS
        if name == "C":
            # all five reads rode one shared pass, not the per-query fallback
            assert stats["shared_scans"] - before["shared_scans"] == 1, stats
        line = {"phase": "server_tick", "tick": name, "seconds": dt,
                "launches": delta, "stats": stats, "host_top": top}
        emit(line)
        ticks.append(line)
        del results
    out = {"phase": "server", "rows": S.row_count, "build_rows": R.row_count,
           "launches": dict(_cuda.LAUNCHES),
           "join_build_stats": dict(planner.JOIN_BUILD_STATS),
           "tick_seconds": {t["tick"]: t["seconds"] for t in ticks},
           "snapshot": server.snapshot()}
    emit(out)
    return out


def small_reference_check(torch, seed: int) -> None:
    """The card against the CPU on small tables: the engine batch and the
    server's tick script."""
    from repro_torch.core import RelationalMemoryEngine, planner
    from repro_torch.serve import QueryServer

    results = []
    for device in ("cuda", "cpu"):
        table = build_table(5000, seed, 1024)
        eng = RelationalMemoryEngine(device=device)
        out = eng.execute_many(mixed_ops(eng, table, None))
        table.append({c.name: np.arange(300, dtype=np.int32) - 150
                      for c in table.schema.columns})
        table.delete(np.arange(0, 5000, 9))
        out += eng.execute_many(mixed_ops(eng, table, table.now()))
        planner.clear_join_build_cache()
        S, R = build_table(5000, seed, 1024), build_dimension(1024, seed)
        server = QueryServer(RelationalMemoryEngine(device=device))
        for name, res, _, _ in server_ticks(torch, server, S, R, seed, 1000):
            server_oracle(torch, name, res, S, R,
                          max(S.now(), R.now()) if name == "C" else None)
            out += flatten(res)
        results.append(out)
    assert len(results[0]) == len(results[1])
    for a, b in zip(*results):
        if isinstance(b, float):
            assert a == b, (a, b)
            continue
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x.cpu(), y), (x, y)
            assert torch.isfinite(y.float()).all()
    emit({"phase": "small_reference", "rows": 5000, "ok": True})


def flatten(results) -> list:
    """Server results as a flat list of tensors, tuples and floats."""
    out = []
    for r in results:
        if hasattr(r, "r_projs"):
            out += [r.s_proj, *r.r_projs, r.matched]
        elif hasattr(r, "r_proj"):
            out += [r.s_proj, r.r_proj, r.matched]
        else:
            out.append(r)
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import _cuda

    card(torch)
    t0 = time.perf_counter()
    _cuda.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(_cuda.library_path().name)})

    small_reference_check(torch, args.seed)
    t0 = time.perf_counter()
    table = build_table(args.rows, args.seed, args.build_rows)
    dim = build_dimension(args.build_rows, args.seed)
    emit({"phase": "data", "rows": table.row_count,
          "row_bytes_stored": table.row_bytes,
          "bytes_stored": table.row_count * table.row_bytes,
          "build_rows": dim.row_count,
          "seconds": time.perf_counter() - t0})
    kernels = kernels_phase(torch, table, dim, args.reps)
    engine = engine_phase(torch, table, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    server = server_phase(torch, table, dim, args.seed)
    launches = {**engine["launches"], "hash_join": server["launches"]["hash_join"]}

    emit({"kernels": [{
        "name": name, "route": "cuda",
        "source": SOURCES.get(name, "src/repro_torch/csrc/rm_scan.cu"),
        "replaces": REPLACES[name], "launches": launches[name],
        "max_abs_err": k["max_abs_err"], "ms": k["kernel_ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k["library_ms"],
    } for name, k in kernels.items() if name in REPLACES]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
