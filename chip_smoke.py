#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's engine batch path, its QueryServer, the
sharded backend, the paper's three projection revisions, the selection
entry points and the LM serving path (``qwen3-8b`` at full width, bf16 and
int8) on one NVIDIA GPU.

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
2. times the kernel build (one ``nvcc`` a source, all at once) and prints
   the ``-Xptxas -v`` reports of ``rm_flash.cu``, ``rm_join.cu`` and
   ``rm_scan.cu``: each kernel's registers, shared memory and spills;
3. at 5,000 rows, for each revision (``bsl``, ``pck``, ``mlp``), runs the
   engine batch and the tick script below on a card engine and server and a
   CPU one and holds their results equal; then a WAL round: a card server
   with a ``WriteAheadLog`` through tick C's writes, the table recovered
   from the log, and tick C's reads served again from it on a fresh server,
   with equal results;
4. holds every kernel against its plain PyTorch version on the card at the
   path's shapes, and times both (CUDA events around the call, host work
   included, median of ``--reps`` after a warm-up; for the kernel and the
   library call also ``device_ms``, their kernels' device time alone from
   ``torch.profiler``, or ``device_ms_estimated`` where the trace lost
   launches), beside the least time the card could take and one library
   call where one computes the same (or, footnoted, less) work — the
   selection at four selectivities (90/50/10/1 %), one line each;
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
   Then the sharded phase, on S as ``--seed`` built it and the same R: a
   ``ShardedEngine(num_shards=4)`` beside a single-device engine, step for
   step and timed apart — the upload (the same bytes; each shard its
   ``shard_ranges`` rows), the 7-op batch, a lone aggregate, 4,096 appends
   (exactly one shard gains a chunk), 64 updates and 64 deletes and the
   batch under a snapshot, the solo join (one broadcast of the build
   partitions: ``3 * parts.nbytes`` collective bytes, one collective op; a
   warm repeat adds nothing) — packed blocks, masks and join outputs
   bit-equal to the single engine's, everything against numpy; a permanent
   ``shard_pass`` fault on shard 1 (one failover, shard 1's bytes, the
   fused scan kernel launched for its chunks, equal results) and a
   malformed request that raises without a failover; the path's kernels
   against their plain versions on shard 0's rows; ``QueryServer(
   num_shards=4)`` through ticks A/B/C; the free ``dist_project``,
   ``dist_aggregate``, ``dist_groupby`` and ``dist_join`` over 4 shards,
   against numpy, and at 5,003 rows (one padding row) card against CPU;
7. the paper's Fig. 6 revision study on the card: for each revision an
   engine serves a solo projection of S for 1, 4 and 11 columns (11 is the
   configuration port's cap, ``MAX_ENABLED_COLUMNS``), each held bit-equal
   to numpy and to the ``mlp`` result, checks that the revision's kernel
   launched, and times the engine call and the kernel alone;
8. the selection entry points on S's device words: ``project_multi`` of
   three views and ``select_compact`` + ``densify`` at the four
   selectivities, every result against numpy;
9. releases S, R and the engines, then the LM phases:
   a. card against CPU: the smokes of ``qwen3-8b`` and of the two QKV-bias
      decoders, ``qwen1.5-110b`` and ``internlm2-20b``, each served by a
      ``ServeSession`` on the card (decode steps replayed from a CUDA
      graph) and one on the CPU with the same weights (drawn from
      ``--seed``), 5 requests over 2 slots: at float32 compute the token
      lists are equal and every prefill's and decode step's logits agree
      within 1e-4; at bfloat16 compute every prefill's logits agree within
      5e-2 (the card's kernel scales q in float32, the CPU's blockwise path
      in bf16, and the two frameworks round bf16 matmuls apart); then
      ``qwen3-8b-smoke`` int8-quantized at float32 compute (the W8 kernel
      in its decode steps), tokens equal and logits within 1e-4;
   b. the flash-attention kernel against its plain version on the card
      (bf16 within 2^-7 of each value plus 2e-3) at the serving path's
      prefill shape (B 8, S 2,048, 32 query / 8 KV heads, D 128, causal),
      there also its float32 build (within 1e-4), and at a ``gemma3-27b``
      local layer's (32 / 16 heads, window 1,024), timed beside its bound
      and one ``scaled_dot_product_attention`` call (a yardstick the port
      never calls);
   c. the W8 kernel (``csrc/rm_w8.cu``) against its plain version (the
      dequant, then ``torch.matmul``) and against the exact product at a
      qwen3-8b layer's four decode shapes (M 8; K x N 4,096 x 4,096,
      4,096 x 1,024, 4,096 x 12,288, 12,288 x 4,096), bf16 and float32
      (``W8_SUM_RTOL``), timed beside its bound and one ``torch.matmul`` of
      x against the weight dequantized beforehand, all three as a decode
      step runs them: weights cold, launches replayed from a CUDA graph;
   d. ``qwen3-8b`` at full width and depth (36 layers, d_model 4,096,
      8,190,735,360 weights in bf16) initialised on the card from
      ``--seed``, a ``ServeSession`` of 8 slots and ``max_len`` 2,112
      serving 16 requests with prompts of 1,024–2,048 tokens and 16 new
      tokens each, its decode steps replayed from a CUDA graph: every
      request gets 16 tokens inside the vocab, every logit row is finite,
      the flash kernel launched once per layer and prefill, and its output
      on the q, k, v of layers 0 and 35 (taken with a forward hook in the
      first prefill) is the path's and matches the plain version as in b;
      one replayed decode step is bit-equal to an eager ``decode_step`` on
      a copy of the same cache; then one more prefill, one replayed and one
      eager decode step are warmed, timed and traced (``torch.profiler``:
      device-busy time, launches, the profiled step's idle share, top
      kernels); then the 16 requests are served once more under
      ``torch.profiler``, to the same tokens, and the kernels the trace
      holds are counted (at least one of each the run ran, and no more:
      a trace of about 100,000 kernels can lose records);
   e. the same model int8-quantized in place (``quantize_for_serving``,
      timed, its peak memory) and the same 16 requests served and checked
      as in d, 252 W8 products (7 of 36 layers) launched by the wrapper in
      the warm-up step and recorded by the capture, so 252 × (ticks + 1)
      in the run, 252 W8 kernels in the trace of a replayed step (taken
      once more if it lost records), some in the traced serving run, and
      the dequant's device time in an int8 prefill;
10. checks that no engine the script built ever tripped its circuit breaker
    or rerouted a dispatch to a plain version (no fault plan is installed);
11. prints the ``{"kernels": [...]}`` line, then ``{"ok": true, ...}`` last.

Every kernel's ``launches`` is counted on its path alone (counts set to 0
just before the path, read just after): the engine phase for the five scan
kernels, the server phase for the probe, the revision phase for BSL and
PCK, the selection phase for ``project_multi`` and ``select_compact``, the
LM serve phase's two runs for ``flash_attention`` and its int8 run for
``w8_matmul`` — its wrapper launches in the warm-up step before the graph's
capture; the graph's replays launch it without the wrapper, and the
line's ``w8_kernels_run`` adds them from the capture's records and the
replay count —; the sharded phase's own path (its
sharded engine's and server's runs and the free operators, not the single
engine beside them) adds its launches of the fused scan, the projection,
aggregate and group-by kernels and the probe.

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
import resource
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROWS = 33_554_432  # 2 GiB of 64-byte rows
BUILD_ROWS = 1_048_576  # the dimension table: 18 MiB of hash buckets
STREAM_CHUNK_ROWS = 4_194_304
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
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
    "project_pck": "src/repro/kernels/rme_project.py:53",
    "project_bsl": "src/repro/kernels/rme_project.py:68",
    "project_multi": "src/repro/kernels/rme_project_multi.py:36",
    "select_compact": "src/repro/kernels/rme_select.py:35",
    "flash_attention": "src/repro/kernels/flash_attention.py:36",
}
# kernels with no Pallas counterpart: what of the reference each replaces
FUSIONS = {"w8_matmul": "src/repro/models/layers.py:51"}
SOURCES = {"hash_join": "src/repro_torch/csrc/rm_join.cu",
           "flash_attention": "src/repro_torch/csrc/rm_flash.cu",
           "w8_matmul": "src/repro_torch/csrc/rm_w8.cu",
           "project_pck": "src/repro_torch/csrc/rm_project.cu",
           "project_bsl": "src/repro_torch/csrc/rm_project.cu",
           "select_compact": "src/repro_torch/csrc/rm_project.cu"}  # else rm_scan.cu
ENGINE_KERNELS = ("project", "filter_project", "aggregate", "groupby_sum",
                  "scan_multi")
REVISIONS = ("mlp", "bsl", "pck")  # mlp first: the others are held to it
# the revision study's views of S: 1, 4 and 11 columns (the port's cap)
REVISION_VIEWS = {1: ["A1"], 4: ["A1", "A5", "A9", "A13"],
                  11: [f"A{i}" for i in range(1, 12)]}
MULTI_VIEWS = (["A1"], ["A2", "A3"], ["A1", "A5", "A9", "A13"])
# benchmarks/fig_selectivity.py: A1, A9 where A3 > k, A3 uniform in
# [-1000, 1000), 512-row blocks
SELECTIVITIES = ((90, -800), (50, 0), (10, 800), (1, 980))
SELECT_BLOCK_ROWS = 512
# the LM serving path: qwen3-8b, 8 slots of 2,112 positions, prompts of
# 1,024-2,048 tokens, 16 new tokens each
LM_ARCH = "qwen3-8b"
LM_SLOTS = 8
LM_MAX_LEN = 2112
LM_PROMPT = (1024, 2048)
LM_MAX_NEW = 16
LM_REQUESTS = 16
LM_CHECK_LAYERS = (0, 35)
# the card-against-CPU smokes: qwen3-8b's, then the two QKV-bias decoders'
LM_REFERENCE_ARCHS = ("qwen3-8b", "qwen1.5-110b", "internlm2-20b")
# (K, N) of a qwen3-8b layer's decode products at M = 8 rows, and how many
# of each a layer runs: wq and wo, wk and wv, w_gate and w_up, w_down
W8_SHAPES = (((4096, 4096), 2), ((4096, 1024), 2), ((4096, 12288), 2),
             ((12288, 4096), 1))
W8_ROWS = LM_SLOTS
# the W8 lines' timing: the copies of a shape's int8 weight launched in turn
# (8: more bytes than the 50 MB L2 for every shape but 4,096 x 1,024), one
# graph of them replayed W8_GRAPH_REPS times
W8_COPIES = 8
W8_GRAPH_REPS = 20
# (name, B, S, H, KH, D, causal, window): the prefill of a qwen3-8b layer
# and of a gemma3-27b local layer on the path's batch
FLASH_SHAPES = (("flash_attention", 8, 2048, 32, 8, 128, True, None),
                ("flash_attention_window", 8, 2048, 32, 16, 128, True, 1024))
# the kernel against its plain version, |got - want| <= atol + rtol·|want|:
# bf16 output, one rounding step of the output (2^-7 of its value) plus the
# rounding of p to bf16 before PV, which the two take at other running maxima
# (the bf16 kernel's 128-key tiles against the plain version's 256), on
# outputs near 0; float32 output: summation order alone
FLASH_TOL = {"bfloat16": (2.0 ** -7, 2e-3), "float32": (0.0, 1e-4)}
# the W8 kernel against the exact product of x and the dequantized weight:
# the float32 sum within W8_SUM_RTOL of sum(|x| |w|) (its order), and in bf16
# also half a bf16 step of the value (the output's one rounding); against
# the plain version (cuBLAS, reduced-precision bf16 reductions off) the same
# sum term twice and one whole bf16 step (two roundings)
W8_SUM_RTOL = 1e-5


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


def device_ms(torch, fn, reps: int) -> tuple[float | None, list, float | None]:
    """Device time per call of ``fn`` without its host work: the kernels it
    launches (one stream, so they do not overlap), from ``torch.profiler``
    over ``reps`` calls after a warm-up; ``[kernel, ms per call, launches
    per call]`` for each; and an estimate.  A trace that holds no device
    time, or lost launches (a kernel counted other than a multiple of
    ``reps`` times), is taken once more; if the second loses launches too,
    the time is ``None`` and the estimate is each kernel's mean time a
    launch times its traced launches a call, rounded (at least one) — which
    misses a kernel whose launches were all lost.  The estimate is ``None``
    where the time was measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA and dev_us(e) > 0]
        split = [[e.key[:60], dev_us(e) / 1e3 / reps, e.count / reps] for e in kernels]
        if kernels and not any(e.count % reps for e in kernels):
            return sum(dev_us(e) for e in kernels) / 1e3 / reps, split, None
    if not kernels:
        return None, split, None
    per_call = [dev_us(e) / e.count * max(1, round(e.count / reps)) for e in kernels]
    return None, split, sum(per_call) / 1e3


def device_fields(torch, fn, reps: int, prefix: str = "") -> dict:
    """A kernel line's ``device_ms``, ``device_ms_estimated`` and split,
    ``device_kernels`` (each key after ``prefix``)."""
    ms, split, estimate = device_ms(torch, fn, reps)
    return {f"{prefix}device_ms": ms, f"{prefix}device_ms_estimated": estimate,
            f"{prefix}device_kernels": split}


_SIDE_STREAM: list = []  # graph_ms's one side stream, made at its first call


def graph_ms(torch, fns, reps: int) -> float:
    """Milliseconds a launch of ``fns`` (a list of calls): run once on a side
    stream, captured in one CUDA graph on that stream, and ``reps`` replays
    of it timed by CUDA events, over the calls.  Every call uses the same
    side stream: cuBLAS keeps a workspace allocated for each stream it ran
    on, which a new stream a call would add to the memory in use."""
    if not _SIDE_STREAM:
        _SIDE_STREAM.append(torch.cuda.Stream())
    side = _SIDE_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps / len(fns)


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
            **device_fields(torch, lambda: run(words), reps),
            "plain_ms": time_ms(torch, lambda: plain(words), max(3, reps // 3)),
            "library_ms": (time_ms(torch, library[name], reps)
                           if name in library else None),
            **(device_fields(torch, library[name], reps, "library_")
               if name in library else {"library_device_ms": None}),
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
            "rows": n, "row_bytes": row_bytes,
        }
        emit(line)
        results[name] = line
    results.update(join_kernel_phase(torch, words, dim, table.now(), reps))
    results.update(slice3_kernel_phase(torch, words, table, p, reps))
    del words
    torch.cuda.empty_cache()
    return results


def slice3_kernel_phase(torch, words, table, p, reps: int) -> dict:
    """The BSL and PCK projections at the path's projection, the multi-view
    projection of three views, and the selection at four selectivities,
    each against its plain version."""
    from repro_torch.core import TableGeometry
    from repro_torch.kernels import ops as K
    from repro_torch.kernels.common import geometry_words

    n, row_words = words.shape
    row_bytes = row_words * 4
    idx = torch.tensor(geometry_words(p.geom), dtype=torch.long, device="cuda")
    proj_words = set(geometry_words(p.geom))
    out = {}

    def line(name, run, plain, same, read, outb, library, **extra):
        got, want = run(), plain()
        torch.cuda.synchronize()
        assert same(got, want), name
        del got, want
        bound_ms, bound_by = bound(read, outb, n, row_bytes, OPS_PER_ROW)
        row = {"phase": "kernel", "name": name,
               "kernel_ms": time_ms(torch, run, reps),
               **device_fields(torch, run, reps),
               "plain_ms": time_ms(torch, plain, max(3, reps // 3)),
               "library_ms": time_ms(torch, library, reps) if library else None,
               **(device_fields(torch, library, reps, "library_")
                  if library else {"library_device_ms": None}),
               "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": 0.0,
               "rows": n, "row_bytes": row_bytes, **extra}
        emit(row)
        return row

    for rev in ("bsl", "pck"):
        out[f"project_{rev}"] = line(
            f"project_{rev}", lambda: K.project(words, p.geom, rev),
            lambda: K.project_torch(words, p.geom), torch.equal, proj_words,
            n * p.geom.out_bytes_per_row, lambda: torch.index_select(words, 1, idx))
    geoms = [TableGeometry.from_schema(table.schema, v, n) for v in MULTI_VIEWS]
    out["project_multi"] = line(
        "project_multi", lambda: K.project_multi(words, geoms),
        lambda: K.project_multi_torch(words, geoms),
        lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b)),
        {w for g in geoms for w in geometry_words(g)},
        n * sum(g.out_bytes_per_row for g in geoms), None,
        library_call="none: no one call writes several packed views")
    sel = TableGeometry.from_schema(table.schema, ["A1", "A9"], n)
    n_blocks = -(-n // SELECT_BLOCK_ROWS)
    for pct, k in SELECTIVITIES:
        kw = dict(pred_word=table.schema.word_offset("A3"), pred_op="gt", pred_k=k,
                  block_rows=SELECT_BLOCK_ROWS)
        counts = K.select_compact(words, sel, **kw)[1]
        kept = int(counts.sum())
        del counts
        row = line(
            "select_compact", lambda: K.select_compact(words, sel, **kw),
            lambda: K.select_compact_torch(words, sel, **kw),
            lambda a, b: torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
            set(geometry_words(sel)) | {kw["pred_word"]},
            n_blocks * (SELECT_BLOCK_ROWS * sel.out_bytes_per_row + 4), None,
            selectivity_pct=pct, pred_k=k, kept_rows=kept,
            library_call="none: no one call compacts per block")
        if pct == 50:
            out["select_compact"] = row
    return out


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
            **device_fields(torch, lambda: K.hash_join(w, parts, *args), reps),
            "plain_ms": time_ms(torch, lambda: K.hash_join_torch(w, parts, *args),
                                max(3, reps // 3)),
            # the sort-probe route's one call: a binary search of the probe
            # keys in the sorted build keys — less work than the probe (no
            # payload, no MVCC tests, no match mask)
            "library_ms": time_ms(torch, lambda: torch.searchsorted(sorted_keys, probe_keys),
                                  reps),
            **device_fields(torch, lambda: torch.searchsorted(sorted_keys, probe_keys),
                            reps, "library_"),
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


def revision_phase(torch, table, reps: int, breakers: list) -> dict:
    """The paper's Fig. 6 study on the card: a solo projection of S for 1, 4
    and 11 columns through an engine of each revision.  The ``mlp`` result
    is held against numpy and the others against it on the card; each
    revision's kernel must have launched.  Then each is timed: the engine
    call (CUDA events around ``execute_many``, host work included) and the
    kernel alone."""
    from repro_torch.core import ProjectOp, RelationalMemoryEngine
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import ops as K

    w = table.words()
    want: dict = {}
    ops: dict = {}
    _cuda.reset_launches()
    for rev in REVISIONS:
        eng = RelationalMemoryEngine(revision=rev)  # on the card
        breakers.append(eng.breaker)
        for q, cols in REVISION_VIEWS.items():
            op = ProjectOp(eng.register(table, cols))
            got = eng.execute_many([op])[0]
            if rev == "mlp":
                idx = [table.schema.word_offset(c) for c in cols]
                assert np.array_equal(got.cpu().numpy(), w[:, idx]), (rev, q)
                want[q] = got
            else:
                assert torch.equal(got, want[q]), (rev, q)
            ops[rev, q] = (eng, op)
    torch.cuda.synchronize()
    launches = {k: _cuda.LAUNCHES[k] for k in ("project", "project_bsl", "project_pck")}
    assert launches == {"project": 3, "project_bsl": 3, "project_pck": 3}, launches
    del want
    table_ms = []
    for (rev, q), (eng, op) in ops.items():
        words = eng.device_words(table)
        geom = op.view.geometry
        table_ms.append({
            "revision": rev, "q": q,
            "engine_ms": time_ms(torch, lambda: eng.execute_many([op]), reps),
            "kernel_ms": time_ms(torch, lambda: K.project(words, geom, rev), reps),
        })
    out = {"phase": "revisions", "rows": table.row_count, "launches": launches,
           "fig6": table_ms}
    emit(out)
    del ops
    gc.collect()
    torch.cuda.empty_cache()
    return out


def selection_phase(torch, table, breakers: list) -> dict:
    """The selection entry points on S's device words: three views in one
    ``project_multi`` pass, then ``select_compact`` and ``densify`` at the
    four selectivities — every result against numpy."""
    from repro_torch.core import RelationalMemoryEngine, TableGeometry
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import ops as K

    eng = RelationalMemoryEngine()  # on the card
    breakers.append(eng.breaker)
    words = eng.device_words(table)
    w = table.words()
    n = table.row_count
    word = table.schema.word_offset
    _cuda.reset_launches()
    geoms = [TableGeometry.from_schema(table.schema, v, n) for v in MULTI_VIEWS]
    for v, got in zip(MULTI_VIEWS, K.project_multi(words, geoms)):
        assert np.array_equal(got.cpu().numpy(), w[:, [word(c) for c in v]]), v
    sel = TableGeometry.from_schema(table.schema, ["A1", "A9"], n)
    kept = {}
    for pct, k in SELECTIVITIES:
        blocks, counts = K.select_compact(words, sel, pred_word=word("A3"),
                                          pred_op="gt", pred_k=k,
                                          block_rows=SELECT_BLOCK_ROWS)
        m = w[:, word("A3")] > k
        want_counts = np.add.reduceat(m, np.arange(0, n, SELECT_BLOCK_ROWS))
        assert np.array_equal(counts.cpu().numpy(), want_counts), pct
        dense = K.densify(blocks, counts, int(m.sum()))
        assert np.array_equal(dense.cpu().numpy(), w[m][:, [word("A1"), word("A9")]]), pct
        kept[pct] = int(m.sum())
        del blocks, counts, dense
    torch.cuda.synchronize()
    launches = {k: _cuda.LAUNCHES[k] for k in ("project_multi", "select_compact")}
    assert launches == {"project_multi": 1, "select_compact": len(SELECTIVITIES)}, launches
    out = {"phase": "selection", "rows": n, "launches": launches,
           "kept_rows": kept}
    emit(out)
    del words
    return out


# --------------------------------------------------------------- LM phases
def lm_prompts(rng, n: int, lo: int, hi: int, vocab: int) -> list:
    return [rng.integers(0, vocab, int(n_tok)).astype(np.int32)
            for n_tok in rng.integers(lo, hi + 1, n)]


def host_usage() -> dict:
    """This process's host counters (all its threads): CPU seconds in user
    and kernel mode, and the times a thread gave up its core to wait."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return {"user_s": r.ru_utime, "sys_s": r.ru_stime, "voluntary_switches": r.ru_nvcsw}


def recorded(torch, fn, log: list, sync: bool, usage: list):
    """``fn`` (a session's prefill or decode step) timed on the host clock,
    synced on both sides when ``sync``; appends ``(seconds, logits)`` to
    ``log`` and, to ``usage``, what :func:`host_usage` counted in the call
    (a wall time far above its CPU seconds waited: on the device, a lock or
    the scheduler)."""
    def run(*args):
        if sync:
            torch.cuda.synchronize()
        before = host_usage()
        t0 = time.perf_counter()
        logits, cache = fn(*args)
        if sync:
            torch.cuda.synchronize()
        log.append((time.perf_counter() - t0, logits))
        usage.append({k: v - before[k] for k, v in host_usage().items()})
        return logits, cache
    return run


def serve_session(torch, model, prompts, slots: int, max_len: int, max_new: int,
                  sync: bool):
    """Serve ``prompts`` on a fresh session; returns the requests, the
    recorded prefills and decode steps, the session's decode step, and the
    host counters of each prefill and of the first decode step."""
    from repro_torch.serve import Request, ServeSession

    sess = ServeSession(model, batch_slots=slots, max_len=max_len)
    prefills, decodes, usage = [], [], {"prefills": [], "ticks": []}
    step = sess.decode_fn
    sess.prefill_fn = recorded(torch, sess.prefill_fn, prefills, sync, usage["prefills"])
    sess.decode_fn = recorded(torch, sess.decode_fn, decodes, sync, usage["ticks"])
    reqs = [Request(rid=i, prompt=p, max_new=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        sess.submit(r)
    sess.run_to_completion()
    usage["first_tick"] = usage.pop("ticks")[0]
    return reqs, prefills, decodes, step, usage


def lm_reference_phase(torch, seed: int) -> dict:
    """Each smoke of ``LM_REFERENCE_ARCHS`` served on the card (graphed
    decode steps) and on the CPU (eager) with the same weights: float32
    compute token lists equal and logits within 1e-4; bfloat16 compute
    prefill logits within 5e-2.  Then qwen3-8b-smoke int8-quantized at
    float32 compute (the W8 kernel in every decode step and the prefill of
    rows <= 64): tokens equal and logits within 1e-4."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import _cuda
    from repro_torch.models.layers import W8_DECODE_ROWS, quantize_for_serving
    from repro_torch.models.lm import DecoderLM

    out = {"phase": "lm_reference"}
    runs = [(arch, dtype, tol, False) for arch in LM_REFERENCE_ARCHS
            for dtype, tol in (("float32", 1e-4), ("bfloat16", 5e-2))]
    runs.append((LM_ARCH, "float32", 1e-4, True))
    for arch, dtype, tol, int8 in runs:
        cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype=dtype)
        cpu = DecoderLM(cfg, device="cpu", seed=seed)
        card = DecoderLM(cfg, device="cuda", seed=None)
        if int8:
            quantize_for_serving(cpu)
            quantize_for_serving(card)
        card.load_state_dict(cpu.state_dict())
        prompts = lm_prompts(np.random.default_rng(seed + 5), 5, 3, 24, cfg.vocab)
        _cuda.reset_launches()
        got = serve_session(torch, card, prompts, 2, 64, 6, True)
        launches = dict(_cuda.LAUNCHES)
        want = serve_session(torch, cpu, prompts, 2, 64, 6, False)
        assert launches["flash_attention"] == cfg.n_layers * len(got[1]), (
            launches, len(got[1]))
        # the wrapper's launches: each prefill of at most W8_DECODE_ROWS rows
        # (2 slots x its longest prompt) and the warm-up step before the
        # capture; the replays launch without it
        rows = [2 * max(len(p) for p in prompts[i:i + 2]) for i in range(0, len(prompts), 2)]
        want_w8 = 7 * cfg.n_layers * (1 + sum(r <= W8_DECODE_ROWS for r in rows))
        assert launches["w8_matmul"] == (want_w8 if int8 else 0), (launches, rows)
        tokens_equal = [r.out for r in got[0]] == [r.out for r in want[0]]
        pairs = list(zip(got[1], want[1]))
        if dtype == "float32":
            assert tokens_equal, ([r.out for r in got[0]], [r.out for r in want[0]])
            pairs += list(zip(got[2], want[2]))
        assert len(got[1]) == len(want[1]) == 3  # three admissions of <= 2
        err = 0.0
        for (_, a), (_, b) in pairs:
            torch.testing.assert_close(a.cpu(), b, rtol=tol, atol=tol)
            err = max(err, float((a.cpu() - b).abs().max()))
        out[f"{cfg.name}{'-int8' if int8 else ''}-{dtype}"] = {
            "tokens_equal": tokens_equal, "max_abs_err": err,
            "logit_sets": len(pairs), "tolerance": tol,
            "flash_launches": launches["flash_attention"],
            "w8_launches": launches["w8_matmul"]}
        del cpu, card
    emit(out)
    return out


def flash_check(got, want, dtype: str) -> dict:
    """``got`` within ``FLASH_TOL[dtype]`` of ``want`` everywhere: the
    largest error, and the largest share of its element's limit."""
    rtol, atol = FLASH_TOL[dtype]
    diff = (got.float() - want.float()).abs()
    share = float((diff / (atol + rtol * want.float().abs())).max())
    out = {"max_abs_err": float(diff.max()), "limit_share": share,
           "rtol": rtol, "atol": atol}
    assert share <= 1.0, out
    return out


def flash_pairs(s: int, causal: bool, window: int | None) -> int:
    """Unmasked (query, key) pairs of one head."""
    w = s if window is None else window
    i = np.arange(s, dtype=np.int64)
    if causal:
        return int(np.minimum(i + 1, w).sum())
    return int((np.minimum(i + w - 1, s - 1) - np.maximum(i - w + 1, 0) + 1).sum())


def flash_bound(b, s, h, kh, d, causal, window, elem_bytes) -> tuple[float, str]:
    """The least time of the attention forward: 4·B·H·D operations per
    unmasked pair (QK and PV, a multiply and an add each) over the bf16
    tensor-core rate, against Q, K, V and O moved once."""
    ops = 4 * b * h * d * flash_pairs(s, causal, window)
    t_ops = ops / BF16_OPS_PER_S
    t_bytes = (2 * b * s * h * d + 2 * b * s * kh * d) * elem_bytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def flash_phase(torch, seed: int, reps: int) -> dict:
    """The kernel against its plain version at the path's shapes, timed
    beside its bound and one ``scaled_dot_product_attention`` call."""
    import torch.nn.functional as Fn

    from repro_torch.kernels import flash_attention as FA

    out = {}
    g = torch.Generator(device="cuda").manual_seed(seed + 9)
    for name, b, s, h, kh, d, causal, window in FLASH_SHAPES:
        q, k, v = (torch.randn((b, s, n, d), generator=g, device="cuda",
                               dtype=torch.bfloat16) for n in (h, kh, kh))
        run = lambda: FA.flash_attention(q, k, v, causal=causal, window=window)  # noqa: E731
        plain = lambda: FA.flash_attention_torch(q, k, v, causal=causal, window=window)  # noqa: E731
        got, want = run(), plain()
        torch.cuda.synchronize()
        check = flash_check(got, want, "bfloat16")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # (B, heads, S, D) views
        if window is None:
            library = lambda: Fn.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True, enable_gqa=True)
        else:
            i = torch.arange(s, device="cuda")
            dist = i[:, None] - i[None, :]
            mask = (dist >= 0) & (dist < window)
            library = lambda: Fn.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask, enable_gqa=True)
        lib_err = float((library().transpose(1, 2).float() - want.float()).abs().max())
        del got, want
        if window is None:  # the float32 build at the path's shape too
            q32, k32, v32 = (x.float() for x in (q, k, v))
            f32 = flash_check(FA.flash_attention(q32, k32, v32, causal=causal),
                              FA.flash_attention_torch(q32, k32, v32, causal=causal),
                              "float32")
            f32["kernel_ms"] = time_ms(torch, lambda: FA.flash_attention(
                q32, k32, v32, causal=causal), max(3, reps // 3))
            del q32, k32, v32
        bound_ms, bound_by = flash_bound(b, s, h, kh, d, causal, window, 2)
        line = {"phase": "kernel", "name": name,
                "kernel_ms": time_ms(torch, run, reps),
                **device_fields(torch, run, reps),
                "plain_ms": time_ms(torch, plain, max(3, reps // 3)),
                "library_ms": time_ms(torch, library, reps),
                **device_fields(torch, library, reps, "library_"),
                "library_call": "torch.nn.functional.scaled_dot_product_attention"
                                + (" (is_causal)" if window is None else " (bool window mask)"),
                "library_max_abs_err": lib_err,
                "bound_ms": bound_ms, "bound_by": bound_by, **check,
                "shape": {"B": b, "S": s, "H": h, "KH": kh, "D": d, "causal": causal,
                          "window": window, "dtype": "bfloat16"},
                "pairs_per_head": flash_pairs(s, causal, window)}
        if window is None:
            line["float32"] = f32
        emit(line)
        out[name] = line
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return out


def w8_bound(m: int, k: int, n: int, elem_bytes: int) -> tuple[float, str]:
    """The least time of ``x (m, k) @ dequant(q (k, n), s)``: the int8
    weight, the bf16 scales, x and y moved once over the memory rate,
    against 2·m·k·n operations over the inputs' rate (bf16 on the tensor
    cores, float32 on the CUDA cores)."""
    t_bytes = (k * n + 2 * n + (m * k + m * n) * elem_bytes) / HBM_BYTES_PER_S
    t_ops = 2 * m * k * n / (BF16_OPS_PER_S if elem_bytes == 2 else FP32_OPS_PER_S)
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes")


def w8_check(torch, got, x, q, s, want) -> dict:
    """``got`` against the exact product (float64) and against ``want``, the
    plain version, with the limits of ``W8_SUM_RTOL``; raises on a miss."""
    from repro_torch.kernels.w8_matmul import dequantize

    w = dequantize(q, s, x.dtype).double()
    exact = x.double() @ w
    sums = x.double().abs() @ w.abs()
    half_step = 2.0 ** -8 if x.dtype == torch.bfloat16 else 0.0
    err = (got.double() - exact).abs()
    share = float((err / (W8_SUM_RTOL * sums + half_step * exact.abs() + 1e-30)).max())
    plain_err = (got.double() - want.double()).abs()
    plain_share = float((plain_err / (2 * W8_SUM_RTOL * sums + 2 * half_step
                                      * want.double().abs() + 1e-30)).max())
    out = {"max_abs_err": float(plain_err.max()), "max_abs_err_exact": float(err.max()),
           "limit_share": share, "plain_limit_share": plain_share}
    assert share <= 1.0 and plain_share <= 1.0, out
    return out


def w8_phase(torch, seed: int) -> dict:
    """The W8 kernel against its plain version at a qwen3-8b layer's four
    decode shapes, in bf16 and float32, timed beside its bound and one
    ``torch.matmul`` of the same x against the weight dequantized
    beforehand (it reads twice the bytes of a bf16 weight and does no
    dequant).  All three are timed as a decode step meets them: over
    ``W8_COPIES`` copies of the weight in turn (weights cold in L2), the
    launches captured in one CUDA graph (no host work between them),
    ``W8_GRAPH_REPS`` replays between CUDA events.  Returns the bf16 lines
    and, as ``w8_matmul``, a layer's seven products summed (the shapes
    times their count)."""
    from repro_torch.kernels import w8_matmul as W8
    from repro_torch.models.layers import quantize_weight

    g = torch.Generator(device="cuda").manual_seed(seed + 13)
    lines = {}
    for (k, n), count in W8_SHAPES:
        rec = quantize_weight(torch.randn((k, n), generator=g, device="cuda") * k ** -0.5)
        q, s = rec.q, rec.s
        qs = [q] + [q.clone() for _ in range(W8_COPIES - 1)]
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((W8_ROWS, k), generator=g, device="cuda").to(dtype)
            ws = [W8.dequantize(qc, s, dtype) for qc in qs]  # the library call's weights
            got = W8.w8_matmul(x, q, s)
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
            want = W8.w8_matmul_torch(x, q, s)
            torch.cuda.synchronize()
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
            assert torch.equal(got, W8.w8_matmul(x, q, s))  # a fixed order of the split-K sums
            bound_ms, bound_by = w8_bound(W8_ROWS, k, n, x.element_size())
            name = f"w8_matmul_{k}x{n}_{str(dtype).split('.')[1]}"
            line = {"phase": "kernel", "name": name,
                    "kernel_ms": graph_ms(torch, [lambda qc=qc: W8.w8_matmul(x, qc, s)
                                                  for qc in qs], W8_GRAPH_REPS),
                    "plain_ms": graph_ms(torch, [lambda qc=qc: W8.w8_matmul_torch(x, qc, s)
                                                 for qc in qs], W8_GRAPH_REPS),
                    "library_ms": graph_ms(torch, [lambda w=w: torch.matmul(x, w)
                                                   for w in ws], W8_GRAPH_REPS),
                    "library_call": "torch.matmul (weight dequantized beforehand)",
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    **w8_check(torch, got, x, q, s, want),
                    "shape": {"M": W8_ROWS, "K": k, "N": n, "dtype": str(dtype),
                              "per_layer": count}}
            emit(line)
            lines[name] = line
            del x, ws, got, want
        del rec, q, s, qs
        torch.cuda.empty_cache()
    bf16 = [(lines[f"w8_matmul_{k}x{n}_bfloat16"], c) for (k, n), c in W8_SHAPES]
    layer = {"phase": "kernel", "name": "w8_matmul", "per": "a qwen3-8b layer's 7 decode "
             "products, bf16, M 8",
             **{key: sum(ln[key] * c for ln, c in bf16)
                for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")},
             "bound_by": "bytes" if all(ln["bound_by"] == "bytes" for ln, _ in bf16)
             else "operations",
             "max_abs_err": max(ln["max_abs_err"] for ln in lines.values())}
    emit(layer)
    return {"w8_matmul": layer}


def profile_step(torch, fn, count=("rm_w8_matmul", "rm_w8_reduce")) -> dict:
    """One step's time: ``fn`` once to warm up, once on the host clock
    (synced), then once more under ``torch.profiler`` — the sum of its
    kernels' device times (one stream, so they do not overlap), its
    launches, the top five kernels, the launches of the kernels whose names
    hold one of ``count``, and the idle share of that profiled step against
    its own wall time (the profiler's host cost included).  ``None`` where
    the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    unprofiled_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:5]
    return {"profiled_wall_ms": wall_ms, "unprofiled_ms": unprofiled_ms,
            "device_busy_ms": busy_ms or None,
            "idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
            "kernel_launches": sum(e.count for e in kernels),
            "counted": {c: sum(e.count for e in kernels if c in e.key) for c in count},
            "top_kernels": [[e.key[:90], dev_us(e) / 1e3, e.count] for e in top]}


def serve_cell(torch, model, cfg, prompts, int8: bool) -> dict:
    """Serve ``prompts`` through ``ServeSession`` (graphed decode steps) on
    ``model`` and check what came out; then, on the first admission's
    prompts again, one replayed step against an eager ``decode_step`` on a
    copy of the same cache (bit-equal logits and caches), and one prefill,
    one replayed and one eager decode step timed and profiled; then the
    requests served again under the profiler (:func:`traced_serve`).  The
    wrappers' flash and W8 launches are counted on the first serving run
    alone; its host counters (:func:`host_usage`) are kept for each prefill
    and the first tick (warm-up, capture, replay)."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.serve.engine import make_decode_step

    captured: dict = {}

    def capture(idx):
        def hook(module, args, result):
            if idx not in captured:  # the first prefill's q, k, v and output
                captured[idx] = (args, result)
        return hook

    hooks = [model.layers[i].mixer.attend.register_forward_hook(capture(i))
             for i in LM_CHECK_LAYERS]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs, prefills, decodes, session_step, usage = serve_session(
        torch, model, prompts, LM_SLOTS, LM_MAX_LEN, LM_MAX_NEW, True)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {k: _cuda.LAUNCHES[k] for k in ("flash_attention", "w8_matmul")}
    capture_s = session_step.capture_seconds
    replays, recorded = session_step.replays, session_step.captured
    del session_step
    for hk in hooks:
        hk.remove()
    peak = torch.cuda.max_memory_allocated()
    assert launches["flash_attention"] == cfg.n_layers * len(prefills), (launches, len(prefills))
    # the W8 wrapper launches in the warm-up step before the capture alone
    # (every prefill has more than W8_DECODE_ROWS rows); the capture records
    # as many, which each replay launches without the wrapper
    assert launches["w8_matmul"] == (7 * cfg.n_layers if int8 else 0), launches
    assert replays == len(decodes), (replays, len(decodes))  # every tick a replay
    assert recorded["w8_matmul"] == launches["w8_matmul"], recorded  # as the warm-up
    assert all(len(r.out) == LM_MAX_NEW for r in reqs), [len(r.out) for r in reqs]
    assert all(0 <= t < cfg.vocab for r in reqs for t in r.out)
    for _, logits in prefills + decodes:
        assert logits.shape == (LM_SLOTS, cfg.padded_vocab)
        assert bool(torch.isfinite(logits).all())
    checked = {}
    for idx in LM_CHECK_LAYERS:
        (q, k, v), result = captured[idx]
        again = FA.flash_attention(q, k, v)  # a compare launch, not counted above
        want = FA.flash_attention_torch(q, k, v)
        torch.cuda.synchronize()
        assert torch.equal(again, result), idx  # the path's output is the kernel's
        checked[idx] = {"shape": list(q.shape),
                        **flash_check(result, want, cfg.compute_dtype)}
    del captured
    tokens = sum(len(r.out) for r in reqs)
    decode_ms = [1e3 * t for t, _ in decodes]
    # where a step's time goes: the first admission's prefill and one decode
    # step again, after the counts were read
    first = prompts[:LM_SLOTS]
    toks = np.zeros((LM_SLOTS, max(len(p) for p in first)), np.int32)
    for slot, p in enumerate(first):
        toks[slot, -len(p):] = p
    toks = torch.from_numpy(toks).to(model.device)
    nxt, pos = toks[:, -1:].contiguous(), toks.shape[1]
    _, cache = model.prefill({"tokens": toks}, LM_MAX_LEN)
    twin = [{n: t.clone() for n, t in c.items()} for c in cache]
    step = make_decode_step(model)
    replayed, _ = step(cache, nxt, pos)
    eager, _ = model.decode_step(twin, nxt, pos)
    torch.cuda.synchronize()
    replay_equal = torch.equal(replayed, eager) and all(
        torch.equal(a[n], b[n]) for a, b in zip(cache, twin) for n in a)
    assert replay_equal, float((replayed - eager).abs().max())
    del twin, replayed, eager
    profiles = {
        "prefill": profile_step(torch, lambda: model.prefill({"tokens": toks}, LM_MAX_LEN)),
        "decode_replayed": profile_step(torch, lambda: step(cache, nxt, pos)),
        "decode_eager": profile_step(torch, lambda: model.decode_step(cache, nxt, pos)),
    }
    # the W8 products the serving run ran: the wrapper's (the warm-up step)
    # and, in each replay, those its capture recorded, which the trace of a
    # replayed step holds (taken once more if it lost records)
    w8_run = launches["w8_matmul"] + replays * recorded["w8_matmul"]
    if profiles["decode_replayed"]["counted"]["rm_w8_matmul"] != recorded["w8_matmul"]:
        profiles["decode_replayed"] = profile_step(torch, lambda: step(cache, nxt, pos))
    counted = profiles["decode_replayed"]["counted"]
    assert counted["rm_w8_matmul"] == recorded["w8_matmul"], (counted, recorded)
    del cache, step
    traced = traced_serve(torch, model, prompts, [r.out for r in reqs],
                          {"rm_flash_attention": launches["flash_attention"],
                           "rm_w8_matmul": w8_run})
    out = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "weights": "int8" if int8 else cfg.compute_dtype, "dtype": cfg.compute_dtype,
           "slots": LM_SLOTS, "max_len": LM_MAX_LEN, "requests": len(reqs),
           "prompt_tokens": int(sum(len(p) for p in prompts)),
           "prefill_seconds": [t for t, _ in prefills],
           "prefill_lengths": [max(len(p) for p in prompts[i:i + LM_SLOTS])
                               for i in range(0, len(prompts), LM_SLOTS)],
           "decode_steps": len(decodes),
           "decode_tick_ms_median": statistics.median(decode_ms),
           "decode_tick_ms": decode_ms,
           "serve_seconds": serve_s, "generated_tokens": tokens,
           "generated_tokens_per_s": tokens / serve_s,
           # the session's serve time outside its timed prefills and ticks
           "untimed_seconds": serve_s - sum(t for t, _ in prefills + decodes),
           "capture_seconds": capture_s, "host_usage": usage,
           "max_memory_allocated": peak, "launches": launches,
           "replays": replays, "captured": recorded, "w8_kernels_run": w8_run,
           "replayed_step_bit_equal_to_eager": replay_equal,
           "kernel_check": checked, "profiles": profiles, "traced_run": traced}
    del prefills, decodes
    return out


def traced_serve(torch, model, prompts, tokens: list, ran: dict) -> dict:
    """The same requests served again on a fresh session under
    ``torch.profiler``: the flash and W8 kernels the trace holds — the
    graph's replays included, which no wrapper counts — beside ``ran``,
    what the timed run ran of each; the tokens, which must equal ``tokens``
    (the timed run's); and the session's first tick and capture seconds
    (the profiler's host cost included).  A trace of a whole serving run
    (about 100,000 kernels) can lose records: on an H100 one held 7,677 of
    the 7,812 W8 kernels, with equal tokens.  So it must hold some of each
    kernel the run ran and no more, and ``lost`` says how many it missed;
    the exact counts are the wrappers' launches, the capture's records and
    the replays (:func:`serve_cell`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gc.collect()
    torch.cuda.empty_cache()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        reqs, prefills, decodes, step, _ = serve_session(
            torch, model, prompts, LM_SLOTS, LM_MAX_LEN, LM_MAX_NEW, True)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    traced = {name: sum(e.count for e in kernels if name in e.key) for name in ran}
    out = {"launches": traced, "ran": ran,
           "lost": {name: ran[name] - traced[name] for name in ran},
           "prefills": len(prefills), "decode_steps": len(decodes),
           "replays": step.replays,
           "tokens_equal": [r.out for r in reqs] == tokens,
           "first_tick_seconds": decodes[0][0], "capture_seconds": step.capture_seconds}
    assert out["tokens_equal"], out
    assert step.replays == len(decodes), out
    for name, n in ran.items():
        assert (0 < traced[name] <= n) if n else traced[name] == 0, (name, out)
    del step, prefills, decodes, prof
    return out


def lm_serve_phase(torch, seed: int) -> dict:
    """qwen3-8b at full width on the card through ``ServeSession``, in bf16
    and then, on the same model quantized in place by
    ``quantize_for_serving``, int8; the flash kernel's and the W8 kernel's
    launches are counted on these runs alone."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.w8_matmul import dequantize
    from repro_torch.models.layers import QuantizedWeight, quantize_for_serving
    from repro_torch.models.lm import DecoderLM

    cfg = get_config(LM_ARCH)
    baseline = torch.cuda.memory_allocated()  # held before the model: not the cells'
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = DecoderLM(cfg, seed=seed)  # on the card
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = sum(p.numel() for p in model.parameters())
    assert weights == cfg.param_count() and len(model.layers) == cfg.n_layers == 36
    rng = np.random.default_rng(seed + 11)
    prompts = lm_prompts(rng, LM_REQUESTS, *LM_PROMPT, cfg.vocab)
    bf16 = serve_cell(torch, model, cfg, prompts, int8=False)
    out = {"phase": "lm_serve", "weights": weights, "init_seconds": init_s,
           "baseline_memory_allocated": baseline, **bf16}
    emit(out)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quantize_for_serving(model)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    quantize_peak = torch.cuda.max_memory_allocated()
    records = [m for m in model.modules() if isinstance(m, QuantizedWeight)]
    assert len(records) == 7 * cfg.n_layers, len(records)
    int8 = serve_cell(torch, model, cfg, prompts, int8=True)
    # the dequant's share of an int8 prefill: the casts a prefill runs (one
    # for each of the 252 weights: its rows exceed W8_DECODE_ROWS), timed
    # alone by CUDA events (a device-bound loop), against the profiled
    # prefill's device-busy time
    dtype = model.compute_dtype
    def dequant_all():
        for r in records:
            dequantize(r.q, r.s, dtype)

    dequant_ms = time_ms(torch, dequant_all, 3)
    busy = int8["profiles"]["prefill"]["device_busy_ms"]
    int8_line = {"phase": "lm_serve_int8", "quantize_seconds": quantize_s,
                 "quantize_peak_memory": quantize_peak,
                 "int8_weight_bytes": sum(r.q.numel() + 2 * r.s.numel() for r in records),
                 "prefill_dequant_ms": dequant_ms,
                 "prefill_dequant_share": (dequant_ms / busy) if dequant_ms and busy else None,
                 **int8,
                 "bf16": {k: bf16[k] for k in (
                     "prefill_seconds", "decode_tick_ms_median", "generated_tokens_per_s",
                     "max_memory_allocated")}}
    emit(int8_line)
    del model, records
    gc.collect()
    torch.cuda.empty_cache()
    return {"bf16": out, "int8": int8_line}


# the words the mixed batch (and the engine's solo steps) read
BATCH_WORDS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 15)
# table uid -> (version, {word: contiguous column}) for the numpy oracles
_HOST_COLUMNS: dict = {}


def host_columns(table, *words) -> list:
    """Contiguous copies of ``table``'s word columns for the numpy oracles.

    A column of the row-major host buffer is a strided read of all of it, so
    each is taken once, a thread a column, and kept while the table's
    version (row count, mutation count) stands: equal versions mean
    byte-identical storage.  A write drops the table's columns.
    """
    ver, cols = _HOST_COLUMNS.get(table.uid, (None, {}))
    if ver != table.version:
        ver, cols = table.version, {}
        _HOST_COLUMNS[table.uid] = (ver, cols)
    w = table.words()
    missing = [i for i in dict.fromkeys(words) if i not in cols]
    if missing:
        with ThreadPoolExecutor(min(8, len(missing))) as pool:
            cols.update(zip(missing, pool.map(
                lambda i: np.ascontiguousarray(w[:, i]), missing)))
    return [cols[i] for i in words]


def same_block(block, cols, mask=None) -> bool:
    """A ``(N, k)`` result block equals ``k`` numpy columns (zero where
    ``mask`` is false), compared a thread a column."""
    b = block.cpu().numpy()
    if b.shape != (len(cols[0]), len(cols)):
        return False

    def eq(i):
        want = cols[i] if mask is None else np.where(mask, cols[i], 0)
        return np.array_equal(b[:, i], want)

    with ThreadPoolExecutor(len(cols)) as pool:
        return all(pool.map(eq, range(len(cols))))


def visible(table, ts: int | None):
    """The rows a snapshot at ``ts`` sees (every row without one)."""
    if ts is None:
        return np.ones(table.row_count, bool)
    begin, end = host_columns(table, 16, 17)
    return (begin <= ts) & (ts < end)


# (table uid, version, ts) -> the mixed batch's expected results; one entry
_BATCH_WANT: dict = {}


def batch_expectation(table, ts: int | None) -> dict:
    """What the mixed batch must return at ``ts``, from numpy over the host
    columns.  Kept for the table's version and ``ts``, so a second engine's
    batch over the same state is only compared."""
    key = (table.uid, table.version, ts)
    if key in _BATCH_WANT:
        return _BATCH_WANT[key]
    w = dict(zip(BATCH_WORDS, host_columns(table, *BATCH_WORDS)))
    vis = None if ts is None else visible(table, ts)

    def seen(m):
        return m if vis is None else m & vis

    def total(col, pred):
        m = seen(pred(w))
        v = np.where(m, w[col], 0)
        return (int(v.sum(dtype=np.int64)), int(np.abs(v, dtype=np.int64).sum()),
                int(m.sum()))

    def filtered():
        m = seen(w[3] > 0)
        return m, [np.where(m, w[1], 0), np.where(m, w[2], 0)]

    def groups():
        gid = np.mod(w[15], 16)
        g = w[7] if vis is None else np.where(vis, w[7], 0)
        return [np.bincount(gid, weights=vis, minlength=16),
                np.bincount(gid, weights=g, minlength=16),
                np.bincount(gid, weights=np.abs(g), minlength=16)]

    # independent pieces, a thread each (numpy lets go of the GIL)
    with ThreadPoolExecutor(4) as pool:
        parts = [pool.submit(total, 5, lambda w: w[6] < 100),
                 pool.submit(total, 8, lambda w: w[9] > -500),
                 pool.submit(filtered), pool.submit(groups)]
        agg, agg2, (fmask, fcols), (count, sums, absval) = [f.result() for f in parts]
    want = {"w": w, "fmask": fmask, "fcols": fcols, "aggs": [agg, agg2],
            "count": count, "sum": sums, "abs": absval}
    _BATCH_WANT.clear()
    _BATCH_WANT[key] = want
    return want


def oracle_batch(table, results, ts: int | None, chunks: int,
                 blocks: bool = True) -> None:
    """The mixed batch's results against numpy over the host table;
    ``blocks=False`` checks the sums and counts alone (for an engine whose
    blocks were already held bit-equal to a checked engine's)."""
    want = batch_expectation(table, ts)
    w = want["w"]
    packed, sub, (fp, fm), (fp2, fm2), agg, (gs, gc), agg2 = results
    if blocks:
        assert same_block(packed, [w[0], w[4], w[8], w[12]])
        assert same_block(sub, [w[0], w[4]])
        same = fp2 is fp and fm2 is fm  # the duplicate filter, deduplicated
        for p_, m_ in [(fp, fm)] + ([] if same else [(fp2, fm2)]):
            assert np.array_equal(m_.cpu().numpy(), want["fmask"])
            assert same_block(p_, want["fcols"])
    for got, (total, absval, count) in zip((agg, agg2), want["aggs"]):
        host = got.cpu().numpy()
        assert count_ok(host[1], count, chunks), (host, count)
        assert abs(host[0] - total) <= SUM_RTOL * absval + 1e-3
    # per-group counts stay below 2^24 at the smoke size: exact
    assert np.array_equal(gc.cpu().numpy(), want["count"].astype(np.float32))
    assert np.all(np.abs(gs.cpu().numpy() - want["sum"]) <= SUM_RTOL * want["abs"] + 1e-3)


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


def engine_phase(torch, table, seed: int, breakers: list) -> dict:
    """The engine batch path on the card, every result against numpy."""
    import dataclasses

    from repro_torch.core import BatchExecutor, RelationalMemoryEngine
    from repro_torch.kernels import _cuda

    eng = RelationalMemoryEngine()  # on the card
    breakers.append(eng.breaker)
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
    w = dict(zip(BATCH_WORDS, host_columns(table, *BATCH_WORDS)))
    assert same_block(packed, [w[0], w[4], w[8], w[12]])
    del packed

    def solo_filter():
        b = BatchExecutor(eng)
        b.add_filter(table, ["A2", "A3"], "A4", "gt", 0)
        return b.submit()[0]

    fp, fm = step("solo_filter", solo_filter, n)
    m = w[3] > 0
    assert np.array_equal(fm.cpu().numpy(), m)
    assert same_block(fp, [w[1], w[2]], m)
    del fp, fm

    s, c = step("solo_aggregate", lambda: eng.aggregate(table, "A6", "A7", "lt", 100), n)
    m = w[6] < 100
    v = w[5][m].astype(np.float64)
    assert count_ok(c, int(m.sum())) and abs(s - v.sum()) <= SUM_RTOL * np.abs(v).sum() + 1e-3

    def solo_groupby():
        b = BatchExecutor(eng)
        b.add_groupby(table, "A16", "A8", 16)
        return b.submit()[0]

    gs, gc = step("solo_groupby", solo_groupby, n)
    gid = np.mod(w[15].astype(np.int64), 16)
    assert np.array_equal(gc.cpu().numpy(), np.bincount(gid, minlength=16).astype(np.float32))
    want = np.bincount(gid, weights=w[7].astype(np.float64), minlength=16)
    absw = np.bincount(gid, weights=np.abs(w[7]).astype(np.float64), minlength=16)
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
    launches = {k: _cuda.LAUNCHES[k] for k in ENGINE_KERNELS}
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
        return [server.submit(q) for q in tick_c_reads(S, R)]

    yield ("C", *tick(tick_c))


def tick_c_reads(S, R) -> list:
    """Tick C's five reads of S: a filtered sum, a group-by average, a
    projection, the join and a two-join chain."""
    from repro_torch.core import plan

    def join():
        return plan(S).join(R, key="A2", left_proj="A1", right_proj="A3")

    return [plan(S).filter("A3", "gt", 100).sum("A1"),
            plan(S).groupby("A4", "A1", "avg", 16),
            plan(S).project("A1", "A5"),
            join(),
            join().join(R, key="A2", left_proj="A1", right_proj="A5")]


def join_oracle(S, R, ts: int | None, proj_word: int):
    """(s_proj, r_proj, matched) of ``S.A2 = R.A2`` over S's host words:
    R's key is its row number, so a probe key in range matches row key."""
    s_val, key = host_columns(S, 0, 1)
    vis = visible(S, ts)
    matched = vis & (key >= 0) & (key < R.row_count)
    r_vals, = host_columns(R, proj_word)
    r = np.where(matched, r_vals[np.clip(key, 0, R.row_count - 1)], 0)
    return np.where(vis, s_val, 0), r, matched


def check_join(res, want) -> None:
    for got, exp in zip((res.s_proj, res.r_proj, res.matched), want):
        assert np.array_equal(got.cpu().numpy(), exp)


def server_oracle(torch, tick: str, results, S, R, ts: int | None) -> None:
    """Every ticket of a tick against numpy over the host tables."""
    w = dict(zip((0, 2, 3, 4), host_columns(S, 0, 2, 3, 4)))
    if tick in ("A", "B"):
        check_join(results[0], join_oracle(S, R, None, 2))
        if tick == "A":
            assert same_block(results[1], [w[0], w[3]])
        return
    total, avg, (packed, mask), one, chain = results
    vis = visible(S, ts)
    m = vis & (w[2] > 100)
    v = w[0][m].astype(np.float64)
    assert abs(total - v.sum()) <= SUM_RTOL * np.abs(v).sum() + 1e-3, (total, v.sum())
    gid = np.mod(w[3].astype(np.int64), 16)[vis]
    cnt = np.bincount(gid, minlength=16)
    sums = np.bincount(gid, weights=w[0][vis].astype(np.float64), minlength=16)
    abs_s = np.bincount(gid, weights=np.abs(w[0][vis]).astype(np.float64), minlength=16)
    got = avg.cpu().numpy().astype(np.float64)
    assert np.all(np.abs(got - sums / np.maximum(cnt, 1))
                  <= (SUM_RTOL * abs_s + 1e-3) / np.maximum(cnt, 1)), (got, sums / cnt)
    assert np.array_equal(mask.cpu().numpy(), vis)
    assert same_block(packed, [w[0], w[4]], vis)
    want = join_oracle(S, R, ts, 2)
    check_join(one, want)
    s_want, r3, matched = want
    r5 = join_oracle(S, R, ts, 4)[1]
    assert np.array_equal(chain.matched.cpu().numpy(), matched)
    assert np.array_equal(chain.s_proj.cpu().numpy(), np.where(matched, s_want, 0))
    assert np.array_equal(chain.r_projs[0].cpu().numpy(), r3)
    assert np.array_equal(chain.r_projs[1].cpu().numpy(), r5)


def server_phase(torch, S, R, seed: int, breakers: list) -> dict:
    """A QueryServer on the card, three ticks, every ticket against numpy."""
    import dataclasses

    from repro_torch.core import RelationalMemoryEngine, planner
    from repro_torch.kernels import _cuda
    from repro_torch.serve import QueryServer

    planner.clear_join_build_cache()
    eng = RelationalMemoryEngine()  # on the card
    breakers.append(eng.breaker)
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


SHARDS = 4
# the sharded phase's path kernels: rows 1, 2, 4, 5 and 6 of PERF.md's table
SHARDED_KERNELS = ("scan_multi", "project", "aggregate", "groupby_sum", "hash_join")


class PairClock:
    """Times each step on the single engine and then on the sharded one
    (host clock, synced on both sides), and counts the launches of the
    sharded engine's runs alone: the phase's path."""

    def __init__(self, torch):
        from repro_torch.kernels import _cuda

        self.torch, self.cuda = torch, _cuda
        self.steps: list = []
        self.launches = dict.fromkeys(SHARDED_KERNELS, 0)

    def _run(self, fn, count: bool):
        self.torch.cuda.synchronize()
        before = dict(self.cuda.LAUNCHES)
        t0 = time.perf_counter()
        out = fn()
        self.torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if count:
            for k in self.launches:
                self.launches[k] += self.cuda.LAUNCHES[k] - before[k]
        return out, dt

    def pair(self, name: str, single, sharded, rows: int, profile: bool = False):
        """``(single result, sharded result)`` of one step; ``profile`` runs
        the sharded side under cProfile and keeps its top host functions."""
        a, t_single = self._run(single, False)
        prof = cProfile.Profile() if profile else None
        if prof:
            prof.enable()
        b, t_sharded = self._run(sharded, True)
        step = {"step": name, "rows": rows, "single_s": t_single,
                "sharded_s": t_sharded}
        if prof:
            prof.disable()
            step["sharded_host_top"] = host_top(prof)
        self.steps.append(step)
        return a, b

    def solo(self, name: str, fn, rows: int, single_s=None):
        out, dt = self._run(fn, True)
        self.steps.append({"step": name, "rows": rows, "single_s": single_s,
                           "sharded_s": dt})
        return out


def assert_same_blocks(torch, single, sharded) -> None:
    """Packed blocks, masks and join outputs bit-equal on the card."""
    for a, b in zip(flatten(single), flatten(sharded)):
        if isinstance(a, float):
            continue
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            if x.dtype != torch.float32:
                assert torch.equal(x, y), (x, y)


def sharded_holds(torch, eng, table, dim_parts) -> dict:
    """The path's kernels against their plain versions at the shard shapes:
    the fused scan and the probe over shard 0's chunk, the projection,
    aggregate and group-by over shard 0's rows."""
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import rme_scan_multi as KR

    words = eng.rowstore.shard_parts(table)[0][0].words
    reqs = path_requests(table, table.now())
    fused = [reqs[k] for k in ("project", "filter", "aggregate", "groupby", "aggregate2")]
    errs = {"rows": words.shape[0]}
    got, want = K.scan_multi(words, fused), K.scan_multi_torch(words, fused)
    errs["scan_multi"] = max(compare(torch, kind_of(r, KR), x, y, words, r)
                             for r, x, y in zip(fused, got, want))
    del got, want
    p, a, g = reqs["project"], reqs["aggregate"], reqs["groupby"]
    errs["project"] = compare(torch, "project", K.project(words, p.geom),
                              K.project_torch(words, p.geom), words, p)
    akw = dict(agg_word=a.agg_word, pred_word=a.pred_word, pred_op=a.pred_op,
               pred_k=a.pred_k, ts=a.ts, ts_word=a.ts_word)
    errs["aggregate"] = compare(torch, "aggregate", K.aggregate(words, **akw),
                                K.aggregate_torch(words, **akw), words, a)
    gkw = dict(group_word=g.group_word, agg_word=g.agg_word, num_groups=g.num_groups,
               ts=g.ts, ts_word=g.ts_word)
    errs["groupby_sum"] = compare(torch, "groupby", K.groupby_sum(words, **gkw),
                                  K.groupby_sum_torch(words, **gkw), words, g)
    args = (words, dim_parts, 1, 0, table.ts_begin_word, table.now(), True)
    for x, y in zip(K.hash_join(*args), K.hash_join_torch(*args)):
        assert torch.equal(x, y)
    errs["hash_join"] = 0.0
    return errs


def sharded_phase(torch, S, R, seed: int, breakers: list, single_ticks: dict) -> dict:
    """The sharded backend on the card: ``ShardedEngine(num_shards=4)`` beside
    a single-device engine on the same table, step for step; the solo join
    with its broadcast; a sharded ``QueryServer`` through ticks A/B/C; a
    failover that runs the kernel; a real kernel error that propagates; the
    free ``dist_*`` operators; every result against numpy."""
    import dataclasses

    from repro_torch.core import (RelationalMemoryEngine, ShardedEngine, TableGeometry,
                                  compile_plan, faults, plan, planner, shard_ranges)
    from repro_torch.core import distributed as D
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.rme_scan_multi import AggregateRequest
    from repro_torch.serve import QueryServer

    started = time.perf_counter()
    planner.clear_join_build_cache()
    single, eng = RelationalMemoryEngine(), ShardedEngine(num_shards=SHARDS)
    breakers += [single.breaker, eng.breaker]
    clock = PairClock(torch)
    rng = np.random.default_rng(seed + 5)
    n = S.row_count

    # upload: the same bytes as one engine, each shard its shard_ranges rows
    clock.pair("upload", lambda: single.device_chunks(S),
               lambda: eng.rowstore.shard_parts(S), n)
    assert eng.stats.bytes_uploaded == single.stats.bytes_uploaded == n * S.row_bytes
    parts = eng.rowstore.shard_parts(S)
    assert [[c.segments for c in p] for p in parts] == [
        [((start, rows),)] for start, rows in shard_ranges(n, SHARDS)]

    a, b = clock.pair("mixed_batch", lambda: single.execute_many(mixed_ops(single, S, None)),
                      lambda: eng.execute_many(mixed_ops(eng, S, None)), n, profile=True)
    assert_same_blocks(torch, a, b)
    oracle_batch(S, b, None, SHARDS)
    del a, b
    a, b = clock.pair("lone_aggregate", lambda: single.aggregate(S, "A6", "A7", "lt", 100),
                      lambda: eng.aggregate(S, "A6", "A7", "lt", 100), n)
    agg, pred = host_columns(S, 5, 6)
    m = pred < 100
    v = agg[m].astype(np.float64)
    for s_, c_ in (a, b):
        assert count_ok(c_, int(m.sum()), SHARDS)
        assert abs(s_ - v.sum()) <= SUM_RTOL * np.abs(v).sum() + 1e-3

    # writes: 4,096 appends land on one owning shard; then updates, deletes
    before = [len(p) for p in eng.rowstore.shard_parts(S)]
    S.append({c.name: rng.integers(-1000, 1000, 4096, dtype=np.int32)
              for c in S.schema.columns})
    after = [len(p) for p in eng.rowstore.shard_parts(S)]
    assert [x - y for x, y in zip(after, before)] == [1, 0, 0, 0], (before, after)
    S.update(rng.choice(n, 64, replace=False),
             {"A1": rng.integers(-1000, 1000, 64, dtype=np.int32)})
    S.delete(rng.choice(n, 64, replace=False))
    ts = S.now()
    a, b = clock.pair("mixed_batch_snapshot",
                      lambda: single.execute_many(mixed_ops(single, S, ts)),
                      lambda: eng.execute_many(mixed_ops(eng, S, ts)), S.row_count)
    assert_same_blocks(torch, a, b)
    oracle_batch(S, b, ts, SHARDS + 1)
    # the single engine (base + one tail): its blocks equal the sharded ones
    oracle_batch(S, a, ts, 2, blocks=False)
    del a, b

    # the solo join S.A2 = R.A2: one build, one broadcast, every shard probes
    def join(e):
        return compile_plan(plan(S).join(R, key="A2", left_proj="A1", right_proj="A3"), e).run()

    def cold_join(e):
        # both engines share the planner's build cache (keyed by device):
        # each cold side pays the key check and R's build itself
        planner.clear_join_build_cache()
        return join(e)

    coll = (eng.stats.bytes_collective, eng.stats.collective_ops)
    a, b = clock.pair("solo_join", lambda: cold_join(single), lambda: cold_join(eng),
                      S.row_count)
    (bparts, _), = eng._bcast_parts.values()
    assert (eng.stats.bytes_collective - coll[0],
            eng.stats.collective_ops - coll[1]) == ((SHARDS - 1) * bparts.nbytes, 1)
    want = join_oracle(S, R, None, 2)
    for res in (a, b):
        check_join(res, want)
    assert_same_blocks(torch, [a], [b])
    coll = (eng.stats.bytes_collective, eng.stats.collective_ops)
    a, b = clock.pair("solo_join_warm", lambda: join(single), lambda: join(eng), S.row_count)
    assert (eng.stats.bytes_collective, eng.stats.collective_ops) == coll  # cache hit
    check_join(b, want)
    del a, b, want

    # a permanent fault on shard 1: its chunks re-run on the root, through
    # the kernel; a malformed request is a real error and propagates
    ops = lambda: mixed_ops(eng, S, ts)  # noqa: E731
    healthy = eng.execute_many(ops())
    shard1 = eng.rowstore.shard_parts(S)[1]
    chunks = sum(len(p) for p in eng.rowstore.shard_parts(S))
    _cuda.reset_launches()
    fail0 = (eng.stats.failovers, eng.stats.bytes_failover)
    with faults.fault_plan(faults.FaultPlan().inject(
            "shard_pass", kind="permanent", times=None, shard=1)):
        failed = clock.solo("failover_batch", lambda: eng.execute_many(ops()), S.row_count)
    # the faulted pass launched nothing: shard 1's chunks ran by failover
    failover_launches = _cuda.LAUNCHES["scan_multi"] - (chunks - len(shard1))
    assert failover_launches == len(shard1), (dict(_cuda.LAUNCHES), chunks)
    assert (eng.stats.failovers - fail0[0],
            eng.stats.bytes_failover - fail0[1]) == (1, sum(c.words.numel() * 4 for c in shard1))
    for x, y in zip(flatten(healthy), flatten(failed)):
        for p_, q_ in zip(x if isinstance(x, tuple) else (x,), y if isinstance(y, tuple) else (y,)):
            assert torch.equal(p_, q_)
    del healthy, failed
    try:
        eng._serve_scan(S, (AggregateRequest(agg_word=40), AggregateRequest(agg_word=1)))
        raise AssertionError("a malformed request did not raise")
    except ValueError as err:
        assert "outside the" in str(err), err
    assert eng.stats.failovers - fail0[0] == 1 and eng.shard_health() == ["healthy"] * SHARDS

    holds = sharded_holds(torch, eng, S, bparts)
    stats = dataclasses.asdict(eng.stats)
    del single, eng, bparts, parts
    gc.collect()
    torch.cuda.empty_cache()

    # the sharded server through ticks A/B/C
    planner.clear_join_build_cache()
    server = QueryServer(num_shards=SHARDS)  # on the card
    breakers.append(server.engine.breaker)
    seen = dict(_cuda.LAUNCHES)
    for name, results, dt, _ in server_ticks(torch, server, S, R, seed, STREAM_CHUNK_ROWS):
        delta = {k: _cuda.LAUNCHES[k] - seen[k] for k in SHARDED_KERNELS}
        seen = dict(_cuda.LAUNCHES)
        for k, v in delta.items():
            clock.launches[k] += v
        if name in ("A", "C"):
            assert delta["hash_join"] >= 1, (name, delta)
        ts_c = max(S.now(), R.now()) if name == "C" else None
        server_oracle(torch, name, results, S, R, ts_c)
        clock.steps.append({"step": f"server_tick_{name}", "rows": S.row_count,
                            "single_s": single_ticks[name], "sharded_s": dt,
                            "launches": delta})
        del results
    srv_snap = server.snapshot()
    assert srv_snap["engine_collective_ops"] >= 1 and srv_snap["engine_shards_quarantined"] == 0
    del server
    gc.collect()
    torch.cuda.empty_cache()

    # the free operators over 4 shards of the card: rows 2, 4, 5 run
    mesh = [torch.device("cuda")] * SHARDS
    w = S.words()
    n = S.row_count
    words = D.pad_rows_to(torch.from_numpy(w).cuda(), SHARDS)
    r_words = D.pad_rows_to(torch.from_numpy(R.words()).cuda(), SHARDS)
    geom = TableGeometry.from_schema(S.schema, ["A1", "A5"], n)
    s_geom = TableGeometry.from_schema(S.schema, ["A1", "A2"], n)
    r_geom = TableGeometry.from_schema(R.schema, ["A2", "A3"], R.row_count)
    free0 = dict(_cuda.LAUNCHES)
    packed = clock.solo("dist_project", lambda: D.dist_project(words, geom, mesh, valid_rows=n), n)
    c0, c1, c2, c4 = host_columns(S, 0, 1, 2, 4)
    assert same_block(packed[:n], [c0, c4])
    del packed
    agg = clock.solo("dist_aggregate", lambda: D.dist_aggregate(
        words, mesh, agg_word=0, pred_word=2, pred_op="gt", pred_k=100, valid_rows=n), n)
    m = c2 > 100
    v = c0[m].astype(np.float64)
    host = agg.cpu().numpy()
    assert count_ok(host[1], int(m.sum()), SHARDS)
    assert abs(host[0] - v.sum()) <= SUM_RTOL * np.abs(v).sum() + 1e-3
    gs, gc_ = clock.solo("dist_groupby", lambda: D.dist_groupby(
        words, mesh, group_word=1, agg_word=0, num_groups=16, valid_rows=n), n)
    gid = np.mod(c1.astype(np.int64), 16)
    want_c = np.bincount(gid, minlength=16)
    assert all(count_ok(x, int(y), SHARDS) for x, y in zip(gc_.cpu().numpy(), want_c))
    want_s = np.bincount(gid, weights=c0.astype(np.float64), minlength=16)
    abs_s = np.bincount(gid, weights=np.abs(c0).astype(np.float64), minlength=16)
    assert np.all(np.abs(gs.cpu().numpy() - want_s) <= SUM_RTOL * abs_s + 1e-3)
    res = clock.solo("dist_join", lambda: D.dist_join(
        words, r_words, mesh, s_geom, r_geom, s_key_word=1, s_val_word=0, r_key_word=0,
        r_val_word=1, s_valid_rows=n, r_valid_rows=R.row_count), n)
    s_want, r_want, m_want = join_oracle(S, R, None, 2)
    for got, exp in zip(res, (c0, r_want, m_want)):
        assert np.array_equal(got[:n].cpu().numpy(), exp)
    free = {k: _cuda.LAUNCHES[k] - free0[k] for k in ("project", "aggregate", "groupby_sum")}
    assert all(v >= SHARDS for v in free.values()), free  # a launch a shard at least
    del words, r_words, res
    padding = dist_padding_check(torch, seed)

    out = {"phase": "sharded", "seconds": time.perf_counter() - started,
           "shards": SHARDS, "rows": S.row_count,
           "build_rows": R.row_count, "steps": clock.steps,
           "bytes_collective": stats["bytes_collective"],
           "collective_ops": stats["collective_ops"],
           "failovers": stats["failovers"], "bytes_failover": stats["bytes_failover"],
           "failover_scan_launches": failover_launches,
           "launches": clock.launches, "free_operator_launches": free,
           "shard_holds_max_abs_err": holds, "server_snapshot_collective": [
               srv_snap["engine_bytes_collective"], srv_snap["engine_collective_ops"]],
           "padding_check_rows": padding, "stats": stats}
    emit(out)
    missing = [k for k, v in clock.launches.items() if v == 0]
    assert not missing, f"kernels never launched on the sharded path: {missing}"
    return out


def dist_padding_check(torch, seed: int) -> int:
    """The free operators at 5,003 rows (one padding row over 4 shards): the
    card equals the CPU, bit for bit, and padding stays out."""
    from repro_torch.core import TableGeometry
    from repro_torch.core import distributed as D

    S, R = build_table(5003, seed, 1024), build_dimension(1023, seed)
    n, nr = S.row_count, R.row_count
    geom = TableGeometry.from_schema(S.schema, ["A1", "A5"], n)
    s_geom = TableGeometry.from_schema(S.schema, ["A1", "A2"], n)
    r_geom = TableGeometry.from_schema(R.schema, ["A2", "A3"], nr)
    outs = []
    for dev in ("cuda", "cpu"):
        mesh = [torch.device(dev)] * SHARDS
        w = D.pad_rows_to(torch.from_numpy(S.words().copy()).to(dev), SHARDS)
        rw = D.pad_rows_to(torch.from_numpy(R.words().copy()).to(dev), SHARDS)
        assert w.shape[0] == 5004 and rw.shape[0] == 1024
        outs.append([
            D.dist_project(w, geom, mesh, valid_rows=n),
            D.dist_aggregate(w, mesh, agg_word=0, pred_word=2, pred_op="gt",
                             pred_k=10, valid_rows=n),
            *D.dist_groupby(w, mesh, group_word=1, agg_word=0, num_groups=16,
                            valid_rows=n),
            *D.dist_join(w, rw, mesh, s_geom, r_geom, s_key_word=1, s_val_word=0,
                         r_key_word=0, r_val_word=1, s_valid_rows=n, r_valid_rows=nr),
        ])
    for x, y in zip(*outs):
        assert torch.equal(x.cpu(), y), (x, y)
    packed, matched = outs[1][0], outs[1][-1]
    assert not packed[n:].any() and not matched[n:].any()
    return n


def small_reference_check(torch, seed: int, breakers: list) -> None:
    """The card against the CPU on small tables, for every revision: the
    engine batch and the server's tick script; then the WAL round."""
    from repro_torch.core import RelationalMemoryEngine, planner
    from repro_torch.serve import QueryServer

    def engine(device, revision="mlp"):
        eng = RelationalMemoryEngine(device=device, revision=revision)
        breakers.append(eng.breaker)
        return eng

    results = []
    for device in ("cuda", "cpu"):
        out = []
        for revision in REVISIONS:
            table = build_table(5000, seed, 1024)
            eng = engine(device, revision)
            out += eng.execute_many(mixed_ops(eng, table, None))
            table.append({c.name: np.arange(300, dtype=np.int32) - 150
                          for c in table.schema.columns})
            table.delete(np.arange(0, 5000, 9))
            out += eng.execute_many(mixed_ops(eng, table, table.now()))
            planner.clear_join_build_cache()
            S, R = build_table(5000, seed, 1024), build_dimension(1024, seed)
            server = QueryServer(engine(device, revision))
            for name, res, _, _ in server_ticks(torch, server, S, R, seed, 1000):
                server_oracle(torch, name, res, S, R,
                              max(S.now(), R.now()) if name == "C" else None)
                out += flatten(res)
        out += wal_round(torch, seed, lambda: engine(device))
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
    emit({"phase": "small_reference", "rows": 5000, "revisions": list(REVISIONS),
          "wal_round": True, "ok": True})


def wal_round(torch, seed: int, engine) -> list:
    """A server with a write-ahead log through the tick script (tick C
    writes S); S recovered from the log; tick C's reads served again from
    the recovered table by a fresh server pinned to the same snapshot.
    Returns tick C's results followed by the recovered server's."""
    from repro_torch.core import RelationalTable, WriteAheadLog, planner
    from repro_torch.serve import QueryServer

    planner.clear_join_build_cache()
    S, R = build_table(5000, seed, 1024), build_dimension(1024, seed)
    wal = WriteAheadLog()
    server = QueryServer(engine(), wal=wal)
    ticks = {name: res for name, res, _, _ in
             server_ticks(torch, server, S, R, seed, 1000)}
    assert server.snapshot()["wal_records"] == 4  # checkpoint + three writes
    recovered = RelationalTable.recover(wal, S.uid)
    assert np.array_equal(recovered.words(), S.words()) and recovered.now() == S.now()
    fresh = QueryServer(engine(), snapshot_reads=True)
    tickets = [fresh.submit(q) for q in tick_c_reads(recovered, R)]
    fresh.drain()
    again = [tk.result(timeout=900) for tk in tickets]
    server_oracle(torch, "C", again, recovered, R, max(recovered.now(), R.now()))
    first, second = flatten(ticks["C"]), flatten(again)
    for a, b in zip(first, second):
        if isinstance(a, float):
            assert a == b, (a, b)
        else:
            for x, y in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                assert torch.equal(x, y)
    return first + second


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

    started = time.perf_counter()
    card(torch)
    t0 = time.perf_counter()
    _cuda.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(_cuda.library_path().name),
          "flash_ptxas": _cuda.ptxas_report("rm_flash.cu"),
          "join_ptxas": _cuda.ptxas_report("rm_join.cu"),
          "scan_ptxas": _cuda.ptxas_report("rm_scan.cu")})

    breakers: list = []  # every engine's breaker; the engines themselves are freed
    small_reference_check(torch, args.seed, breakers)
    t0 = time.perf_counter()
    table = build_table(args.rows, args.seed, args.build_rows)
    dim = build_dimension(args.build_rows, args.seed)
    # S as built, for the sharded phase (the engine and server phases write S)
    pristine = {"columns": [(c.name, c.dtype, c.width, c.codec) for c in table.schema.columns],
                "words": table.words().copy(), "clock": table.now()}
    emit({"phase": "data", "rows": table.row_count,
          "row_bytes_stored": table.row_bytes,
          "bytes_stored": table.row_count * table.row_bytes,
          "build_rows": dim.row_count,
          "seconds": time.perf_counter() - t0})
    kernels = kernels_phase(torch, table, dim, args.reps)
    # the main path first, then the revision study and the selection entry
    # points, so the main path's phases see the card as they did before
    engine = engine_phase(torch, table, args.seed, breakers)
    gc.collect()
    torch.cuda.empty_cache()
    server = server_phase(torch, table, dim, args.seed, breakers)
    gc.collect()
    torch.cuda.empty_cache()
    # the sharded backend on S as --seed built it, beside a single engine
    from repro_torch.core import RelationalTable

    fresh = RelationalTable.from_state(pristine)
    del pristine
    sharded = sharded_phase(torch, fresh, dim, args.seed, breakers,
                            server["tick_seconds"])
    del fresh
    gc.collect()
    torch.cuda.empty_cache()
    revisions = revision_phase(torch, table, args.reps, breakers)
    selection = selection_phase(torch, table, breakers)
    # the LM phases, after S, R and the engines are released
    del table, dim
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "released", "memory_allocated": torch.cuda.memory_allocated()})
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 compared card vs CPU
    torch.backends.cudnn.allow_tf32 = False
    lm_reference_phase(torch, args.seed)
    kernels.update(flash_phase(torch, args.seed, args.reps))
    kernels.update(w8_phase(torch, args.seed))
    lm = lm_serve_phase(torch, args.seed)
    # each kernel's launches on its own path; "project" is the engine phase's
    # (the revision phase's mlp engines launch it too, counted in its line);
    # the flash kernel's in both serving runs (bf16 and int8), the W8
    # kernel's in the int8 run
    launches = {**revisions["launches"], **selection["launches"],
                **engine["launches"], "hash_join": server["launches"]["hash_join"],
                "flash_attention": sum(lm[w]["launches"]["flash_attention"]
                                       for w in ("bf16", "int8")),
                "w8_matmul": lm["int8"]["launches"]["w8_matmul"]}
    for k, v in sharded["launches"].items():  # the sharded phase's path too
        launches[k] += v
    breaker = {k: sum(b.snapshot()[k] for b in breakers)
               for k in ("breaker_trips", "breaker_fallbacks", "breaker_probes",
                         "breaker_open")}
    emit({"phase": "breaker", "engines": len(breakers), **breaker})
    assert not any(breaker.values()), breaker
    assert set(kernels) == set(REPLACES) | set(FUSIONS) | {
        "hash_join_packed", "flash_attention_window"}, sorted(kernels)
    assert len(REPLACES) == 11
    assert all(launches[name] > 0 for name in (*REPLACES, *FUSIONS)), launches
    emit({"phase": "done", "seconds": time.perf_counter() - started})

    emit({"kernels": [{
        "name": name, "route": "cuda",
        "source": SOURCES.get(name, "src/repro_torch/csrc/rm_scan.cu"),
        "replaces": REPLACES.get(name) or FUSIONS[name], "launches": launches[name],
        "max_abs_err": k["max_abs_err"], "ms": k["kernel_ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k["library_ms"],
    } for name, k in kernels.items() if name in REPLACES or name in FUSIONS]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
