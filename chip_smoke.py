#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's engine batch path on one NVIDIA GPU.

    python3 chip_smoke.py [--rows N] [--seed S] [--reps R]

Builds the CUDA scan kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a),
then, on a ``benchmark_schema(64, 4)`` table of 16 int32 columns (the paper's
Fig. 13 upper end: 2 GiB of user data, 33,554,432 rows, 72 bytes a row
stored with the two MVCC words; ``--rows`` cuts it), made from ``--seed``:

1. prints the card (``nvidia-smi`` name and power limit, torch and CUDA);
2. times the kernel build;
3. holds every kernel against its plain PyTorch version on the card at the
   path's shapes, and times both (CUDA events, median of ``--reps`` after a
   warm-up), beside the least time the card could take and one library
   call where one computes the same function;
4. drives the engine through ``BatchExecutor`` / ``execute_many`` on the
   card — solo project, filter, aggregate and group-by, a mixed batch of 7
   ops, then 4,096 appends, 64 updates and 64 deletes and the same batch
   under a snapshot over base plus tail chunks — checks every result
   against a numpy oracle from the host table, and checks that each of the
   five kernels was launched by that run;
5. prints the ``{"kernels": [...]}`` line, then ``{"ok": true, ...}`` last.

Every phase prints one JSON line.  Any failure ends the run with a
traceback and a non-zero exit; without a CUDA device it exits non-zero
before printing any result.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROWS = 33_554_432  # 2 GiB of 64-byte rows
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
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=ROWS)
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


def build_table(rows: int, seed: int):
    from repro_torch.core import RelationalTable, benchmark_schema

    schema = benchmark_schema(64, 4)
    rng = np.random.default_rng(seed)
    cols = {c.name: rng.integers(-1000, 1000, rows, dtype=np.int32)
            for c in schema.columns}
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


def kernels_phase(torch, table, reps: int) -> dict:
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
    del words
    torch.cuda.empty_cache()
    return results


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
    launches = dict(_cuda.LAUNCHES)
    idle = [k for k, v in launches.items() if v == 0]
    assert not idle, f"kernels never launched on the main path: {idle}"
    out = {"phase": "engine", "rows": table.row_count, "chunks": chunks,
           "launches": launches, "steps": steps,
           "stats": dataclasses.asdict(eng.stats)}
    emit(out)
    return out


def small_reference_check(torch, seed: int) -> None:
    """The card engine against the CPU engine on a small table."""
    from repro_torch.core import RelationalMemoryEngine

    results = []
    for device in ("cuda", "cpu"):
        table = build_table(5000, seed)
        eng = RelationalMemoryEngine(device=device)
        out = eng.execute_many(mixed_ops(eng, table, None))
        table.append({c.name: np.arange(300, dtype=np.int32) - 150
                      for c in table.schema.columns})
        table.delete(np.arange(0, 5000, 9))
        out += eng.execute_many(mixed_ops(eng, table, table.now()))
        results.append(out)
    for a, b in zip(*results):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x.cpu(), y), (x, y)
            assert torch.isfinite(y.float()).all()
    emit({"phase": "small_reference", "rows": 5000, "ok": True})


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
    table = build_table(args.rows, args.seed)
    emit({"phase": "data", "rows": table.row_count,
          "row_bytes_stored": table.row_bytes,
          "bytes_stored": table.row_count * table.row_bytes,
          "seconds": time.perf_counter() - t0})
    kernels = kernels_phase(torch, table, args.reps)
    engine = engine_phase(torch, table, args.seed)

    emit({"kernels": [{
        "name": name, "route": "cuda", "source": "src/repro_torch/csrc/rm_scan.cu",
        "replaces": REPLACES[name], "launches": engine["launches"][name],
        "max_abs_err": k["max_abs_err"], "ms": k["kernel_ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k["library_ms"],
    } for name, k in kernels.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
