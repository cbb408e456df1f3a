"""Build, load and launch the CUDA kernels (``csrc/rm_scan.cu``,
``csrc/rm_spans.cu``, ``csrc/rm_join.cu``, ``csrc/rm_project.cu``,
``csrc/rm_flash.cu``, ``csrc/rm_flash_bwd.cu``, ``csrc/rm_w8.cu``,
``csrc/rm_moe.cu``, ``csrc/rm_rglru.cu``).

The library is compiled by ``nvcc`` for ``sm_90a`` into a shared object with
a plain C interface and loaded with ``ctypes``.  It builds from the sources
in this checkout only, into ``build/repro_torch/`` at the repository root,
under a name keyed by a hash of the sources and flags — and only at the
first CUDA call, so importing this module needs neither ``nvcc`` nor a card.
Each source compiles in its own ``nvcc``, all at once; ``BUILD_LOG`` keeps
what they printed (``-Xptxas -v``: registers, shared memory, spills), also
when the library was built by an earlier process.

Every scan launch goes through :func:`run`: it plans the launch (tile
height, shared-memory layout, per-block partial rows), allocates the outputs
with ``torch.empty``, launches on the current stream without synchronising,
and raises if the launch reports a CUDA error.  A launch's word map (the
source word of every packed output word) lives in device memory, uploaded
once per distinct map (:func:`device_map`), so no launch has a limit on its
packed words; rows wider than ``DIRECT_ROW_WORDS`` are read where they lie
rather than staged (``Plan.direct``), so no row is too wide either.  A
single projection of such rows takes the span kernel instead
(:func:`run_spans`): its launch carries the enabled column ranges
(:func:`span_plan`, planned once per layout), never a word map.  The
hash-join probe, the BSL / PCK projection revisions, the compacting
selection, the GQA flash-attention forward and its gradient, the int8-weight
decode matmul, the MoE expert FFN and the RG-LRU scan have their own
parameter blocks and launchers
(:func:`run_hash_join`, :func:`run_columns`, :func:`run_select`,
:func:`run_flash`, :func:`run_flash_backward`, :func:`run_w8`,
:func:`run_moe`, :func:`run_rglru_scan`, :func:`run_rglru_scan_backward`) under
the same rules.
``LAUNCHES`` counts the launches each wrapper makes, and nothing else
(``project`` counts both forms of the projection: the staged kernel and
the span kernel): a
call inside a CUDA graph's capture records its kernel without launching it
and counts nothing, and the graph's replays launch it without the wrapper
(``torch.profiler`` sees those).  ``CAPTURED`` counts, in the same units,
the calls that a capture recorded instead: a graph replays each once.  ``hash_join`` counts one for each
probe, which is two kernels on the card: the bucket repack
(``rm_join_prepare_kernel``), then the probe (``rm_hash_join_kernel``);
``w8_matmul`` one for each launch: on the tensor cores one kernel for a
group of products that share x (``rm_w8_matmul_tc_kernel``, split-K summed
inside its clusters), on the CUDA cores one product, which is two kernels
when K is split (``rm_w8_matmul_kernel``, then ``rm_w8_reduce_kernel``);
``W8_PRODUCTS`` counts the products those launches and captures took;
``moe_ffn`` one for each launch of ``rm_moe_ffn_kernel``, two an expert FFN
(the gate/up stage, then the down stage); ``rglru_scan`` one for each
launch of ``rm_rglru_scan_kernel``, ``rglru_scan_backward`` one for each
launch of ``rm_rglru_scan_backward_kernel``; ``flash_attention_backward`` one for
each gradient, which is two or three kernels on the card: the row sums
and padded log-sum-exp (``rm_flash_bwd_prep_kernel``), then one pass
(``rm_flash_bwd_one_kernel``, bf16 at D <= 128, narrower heads padded to
64) or a dK / dV pass and a dQ pass (``rm_flash_bwd_dkdv_wide_kernel``
and ``rm_flash_bwd_dq_wide_kernel`` in bf16 at D 256, both passes of
``rm_flash_bwd_simt_kernel`` in float32).
``FLASH_DOUT_COPIES`` counts the gradients whose ``dout`` TMA could not
describe, copied before the launch.

The LM kernels' launchers (:func:`run_flash`, :func:`run_flash_backward`,
:func:`run_w8`, :func:`run_moe`, :func:`run_rglru_scan`,
:func:`run_rglru_scan_backward`) also report each
launch's operations and bytes to an active roofline count
(``roofline.analysis.record_kernel``, by the work formulas ``chip_smoke.py``
takes their bounds from), and take ``meta`` tensors (the dry run): they
check what does not need memory, report the work, and return outputs of the
right shape and type — nothing is launched or counted in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import heapq
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

import torch

from repro_torch.roofline import analysis as roofline

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the staged-tile kernels, in the order of kKernels in rm_scan.cu (the index
# rm_max_blocks takes), then the hash-join probe of rm_join.cu and the
# kernels of rm_project.cu and the attention forward of rm_flash.cu
SCAN_KERNELS = ("project", "filter_project", "aggregate", "groupby_sum",
                "scan_multi", "project_multi")
KERNELS = SCAN_KERNELS + ("hash_join", "project_bsl", "project_pck",
                          "select_compact", "flash_attention", "flash_attention_backward",
                          "w8_matmul", "moe_ffn", "rglru_scan", "rglru_scan_backward")
MULTI_REQUEST = ("scan_multi", "project_multi")  # kernels taking many requests
LAUNCHES = dict.fromkeys(KERNELS, 0)
CAPTURED = dict.fromkeys(KERNELS, 0)  # wrapper calls recorded into a graph
W8_PRODUCTS = {"launched": 0, "captured": 0}  # products of w8_matmul's launches, captures
FLASH_DOUT_COPIES = {"copies": 0}  # dout tensors run_flash_backward copied for TMA
JOIN_THREADS = 256  # must match kJoinThreads in rm_join.cu
JOIN_SECTOR = 32  # bytes: wider probe rows take the probe's streaming form
MAX_GRID_BLOCKS = 1 << 20  # grid-stride kernels: their loops cover any rest
MAX_COLS = 256  # column slices of one BSL / PCK launch (kMaxCols, rm_project.cu)
BSL_ROWS = 256  # rows a BSL block (kBslRows, rm_project.cu)
PCK_PACKERS = 2  # packers a block of PCK's wide form (kPckPackers, rm_project.cu)
PCK_RANGE_WORDS = 1024  # packed words a range of PCK's wide form at most
PCK_PACKER_BYTES = 16 * 1024  # one packer of PCK's wide form at most
MAX_SPANS = 16  # word ranges of one span launch (kMaxSpans, rm_spans.cu)
SPAN_VECS = 2  # 16-byte vectors a lane copies an item of the span kernel (kVecs, rm_spans.cu)
SPAN_WARPS = 8  # warps (items in flight) a block of the span kernel (kSpanWarps)
FLASH_HEAD_DIMS = (16, 32, 64, 128, 256)  # the head widths rm_flash.cu instantiates
FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # FlashParams::dtype
FLASH_BWD_TC_MAX_D = 256  # the widest head the tensor-core backward takes (kTcMaxD)
FLASH_BWD_SEQ_PAD = 128  # its scratch rows' padding (kSeqPad, which the launch checks)
FLASH_BWD_ONE_PASS_D = (64, 128)  # the head widths of its one-pass form (namespace one)
FLASH_BWD_ONE_Q = 64  # a one-pass item's query rows (one::kQ): its counts are a tile's
FLASH_BWD_WIDE_ROWS = 64  # that form's tile rows: a dK / dV block's keys (wide::kRows)
# the chunk plan's costs, in items (one (head, query tile) item: 4 products
# of 64 x 64 x 256): a block's K and V and ring fill, and a cut tile's
# partial (2 x 64 KB of float32 written, then read back by the last block)
FLASH_BWD_BLOCK_COST = 1
FLASH_BWD_PARTIAL_COST = 3
W8_MAX_ROWS = 64  # rows of x the int8-weight matmul takes (a decode step's B)
W8_MAX_RECORDS = 4  # products one launch takes (kW8MaxRecords)
W8_STRIP = 256  # output columns a block of rm_w8_matmul_kernel (kW8Strip)
W8_TC_STRIP = 128  # output columns a block of rm_w8_matmul_tc_kernel (kTcStrip)
W8_FORMS = {"cuda_cores": 0, "tensor": 1}  # W8Params::form
W8_ROWS = 8  # rows of x a block (kW8Rows)
W8_MIN_CHUNK = 128  # K rows a CUDA-core block at least: 32 a warp
W8_MAX_CHUNK = 1024  # K rows a CUDA-core block at most (kW8MaxChunk): the staged x
W8_BLOCKS_PER_SM = 4  # the CUDA-core grid the split of K aims for
W8_STAGE_ROWS = 64  # K rows a stage of the tensor-core ring (kTcStageRows)
W8_MAX_CLUSTER = 8  # ranks of a tensor-core cluster along K (kTcMaxCluster)
W8_TC_MAX_CHUNK = 8192  # K rows a tensor-core rank at most (kTcMaxChunk): the staged x
MOE_ROWS = (4, 8, 16)  # the rows rm_moe_ffn_kernel instantiates (MoeParams::rows)
MOE_MAX_ROWS = MOE_ROWS[-1]  # rows of an expert's buffer (cap) the kernel takes
# rm_rglru_scan_kernel's plan (load() checks rm_rglru_forward_plan)
RGLRU_FWD_LANES = 32  # lanes a block: one warp (kFwdLanes)
RGLRU_FWD_STEPS = 32  # steps a stage of its ring: a TMA box's rows (kFwdSteps)
RGLRU_FWD_STAGES = 3  # stages in its ring (kFwdStages): 24 KB, 8 blocks an SM
# TMA fills the ring of a grid of at most four blocks an SM of the H100's 132;
# a fuller grid reads faster through its warps' own cp.async copies (device
# ms, NVIDIA H100 80GB HBM3 at 700 W, kernel_times.py: B 2 TMA 16% ahead, B 4
# even, B 6 and B 8 cp.async 3-4% ahead)
RGLRU_FWD_TMA_BLOCKS = 4 * 132
RGLRU_FWD_FORMS = {"tma": 0, "async": 1}  # RglruParams::form (kFillTma, kFillAsync)
# rm_rglru_scan_backward_kernel's plan (load() checks rm_rglru_backward_plan)
RGLRU_BWD_LANES = 32  # lanes a block: one warp (kBwdLanes)
RGLRU_BWD_STEPS = 32  # steps a stage of its TMA ring: a box's rows (kBwdSteps)
RGLRU_BWD_STAGES = 4  # stages of the ring (kBwdStages)

# must match rm_common.cuh
THREADS = 256
MAX_REQ = 16
PROJECT, FILTER, AGGREGATE, GROUPBY = range(4)
PRED_OPS = {"none": 0, "gt": 1, "lt": 2}

TILE_BYTES = 32 * 1024  # staged row tile per block
# rows wider than this (four rows past TILE_BYTES) are read in place, not staged
DIRECT_ROW_WORDS = TILE_BYTES // (4 * 4)
SPAN_PLANS = 64  # layouts whose span plans a projection keeps (rme_project.span_plan)
SELECT_INLINE_MAP = 512  # map words the selection's parameter block holds (kSelectInlineMap)
DEVICE_MAPS = 64  # word maps kept on the device (device_map), oldest dropped first
SCAN_RING = 2  # tiles in scan_multi's ring (kScanRing; load() checks rm_scan_ring())
HIST_SMEM_BYTES = 64 * 1024  # group-by histograms kept in shared memory
PARTIAL_BYTES = 64 << 20  # cap on the per-block partials buffer
SMEM_MAX = 227 * 1024  # what one block may use on Hopper


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        CAPTURED[k] = 0
    W8_PRODUCTS.update(launched=0, captured=0)
    FLASH_DOUT_COPIES["copies"] = 0


def _launched(kernel: str) -> None:
    """Count one launch of ``kernel`` by its wrapper; while the current
    stream is capturing a CUDA graph (the capture launches nothing), count
    it in ``CAPTURED`` instead."""
    if torch.cuda.is_current_stream_capturing():
        CAPTURED[kernel] += 1
    else:
        LAUNCHES[kernel] += 1


# ----------------------------------------------------------- ctypes layout
class _Req(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int32) for name in (
        "kind", "out_w", "map_off", "pred_word", "pred_float", "pred_op",
        "k_bits", "ts_word", "ts", "agg_word", "agg_float", "group_word",
        "num_groups", "red_off", "hist_off", "slot")] + [
        ("out", ctypes.c_void_p), ("mask", ctypes.c_void_p)]


class _Params(ctypes.Structure):
    _fields_ = [
        ("words", ctypes.c_void_p), ("partials", ctypes.c_void_p),
        ("map", ctypes.c_void_p), ("n", ctypes.c_longlong),
    ] + [(name, ctypes.c_int32) for name in (
        "row_words", "tile_rows", "n_req", "map_len", "part_w", "n_slots",
        "map_smem", "slot_smem", "tile_stride", "direct")] + [
        ("req", _Req * MAX_REQ)]


class _JoinParams(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "words", "keys", "vals", "begin", "end", "fps", "recs", "s_out", "r_out",
        "m_out")] + [
        ("n", ctypes.c_longlong)] + [(name, ctypes.c_int32) for name in (
            "row_words", "key_word", "val_word", "ts_word", "ts", "build_ts",
            "shift", "cap", "fp_stride", "stream")]


class _ColParams(ctypes.Structure):
    _fields_ = [("words", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("n", ctypes.c_longlong)] + [
        (name, ctypes.c_int32) for name in (
            "row_words", "out_w", "n_cols", "tile_rows", "range_w", "chunk_w", "chunks",
            "pad_")] + [
        (name, ctypes.c_int32 * MAX_COLS) for name in ("src", "dst", "width")]


class _SpanParams(ctypes.Structure):
    _fields_ = [("words", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("n", ctypes.c_longlong)] + [
        (name, ctypes.c_int32) for name in (
            "row_words", "out_w", "n_spans", "chunks")] + [
        (name, ctypes.c_int32 * MAX_SPANS) for name in ("src", "dst", "width", "first")]


class _SelectParams(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in ("words", "out", "counts", "map")] + [
        ("n", ctypes.c_longlong)] + [(name, ctypes.c_int32) for name in (
            "row_words", "out_w", "block_rows", "pad_")] + [
        ("q", _Req), ("map_inline", ctypes.c_int32 * SELECT_INLINE_MAP)]


class _W8Params(ctypes.Structure):
    _fields_ = [("x", ctypes.c_void_p)] + [
        (name, ctypes.c_void_p * W8_MAX_RECORDS) for name in ("q", "s", "y")] + [
        ("partials", ctypes.c_void_p), ("n", ctypes.c_int32 * W8_MAX_RECORDS)] + [
        (name, ctypes.c_int32) for name in (
            "records", "M", "K", "chunk", "splits", "dtype", "form", "pad_")]


class _MoeParams(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in ("x", "count", "w0", "w1", "y")] + [
        (name, ctypes.c_int32) for name in (
            "experts", "cap", "K", "N", "rows", "dtype", "gated", "pad_")]


class _RglruParams(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in ("a", "x", "h")] + [
        (name, ctypes.c_int32) for name in (
            "batch", "seq", "width", "blocks", "smem", "form")]


class _RglruBwdParams(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in ("a", "h", "dh", "da", "dx")] + [
        (name, ctypes.c_int32) for name in ("batch", "seq", "width", "blocks", "smem", "pad_")]


class _FlashParams(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in ("q", "k", "v", "out", "lse")] + [
        (f"{t}_{s}", ctypes.c_longlong) for t in "qkvo" for s in ("sb", "ss", "sh")] + [
        (name, ctypes.c_int32) for name in (
            "batch", "seq", "heads", "kv_heads", "head_dim", "causal", "window",
            "dtype")] + [("scale", ctypes.c_float), ("pad_", ctypes.c_int32)]


class _FlashBwdParams(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "q", "k", "v", "out", "dout", "lse", "dq", "dk", "dv", "lse_pad", "delta",
        "kv_part", "kv_count", "dq_acc", "dq_count")] + [
        (f"{t}_{s}", ctypes.c_longlong) for t in ("q", "k", "v", "o", "g", "dq", "dk")
        for s in ("sb", "ss", "sh")] + [
        (name, ctypes.c_int32) for name in (
            "batch", "seq", "heads", "kv_heads", "head_dim", "causal", "window",
            "dtype", "seq_pad", "kv_chunk", "kv_blocks")] + [("scale", ctypes.c_float)]


# ---------------------------------------------------------------- requests
@dataclasses.dataclass(frozen=True)
class KernelReq:
    """One request as the kernels take it: word offsets and runtime values.

    ``kind`` is PROJECT / FILTER / AGGREGATE / GROUPBY; ``words`` lists the
    source word of every packed output word (project / filter)."""

    kind: int
    words: tuple[int, ...] = ()
    pred_word: int = 0
    pred_float: bool = False
    pred_op: str = "none"
    k_bits: int = 0
    ts_word: int = -1
    ts: int = 0
    agg_word: int = 0
    agg_float: bool = False
    group_word: int = 0
    num_groups: int = 1

    def touched(self) -> list[int]:
        """Every row word the request reads."""
        out = list(self.words)
        if self.pred_op != "none":
            out.append(self.pred_word)
        if self.ts_word >= 0:
            out += [self.ts_word, self.ts_word + 1]
        if self.kind in (AGGREGATE, GROUPBY):
            out.append(self.agg_word)
        if self.kind == GROUPBY:
            out.append(self.group_word)
        return out


def dtype_flag(dtype: str) -> bool:
    """True for float32 words, False for int32; anything else is refused."""
    if dtype not in ("int32", "float32"):
        raise ValueError(f"4-byte numeric column required, got {dtype}")
    return dtype == "float32"


# ----------------------------------------------------------------- planning
def tile_rows(row_words: int) -> int:
    """Rows per staged tile: 256, halved until the tile fits TILE_BYTES, and
    never below 4 (a multiple of 4 rows keeps every tile 16-byte aligned)."""
    rows = THREADS
    while rows > 4 and rows * row_words * 4 > TILE_BYTES:
        rows //= 2
    return rows


@dataclasses.dataclass
class Plan:
    """Shared-memory layout and partial rows of one launch."""

    tile_rows: int
    tile_stride: int  # words between the ring's tiles (0: rows not staged)
    map: list[int]
    map_off: list[int]
    red_off: list[int]  # -1 for blocked requests
    hist_off: list[int]  # -1: histogram in global memory (or none)
    slot: list[int]
    map_smem: int  # -1: the map is read from device memory in place
    slot_smem: int
    n_slots: int
    part_w: int
    smem_bytes: int
    direct: bool = False  # rows read from the row store, not staged


def _round4(x: int) -> int:
    return -(-x // 4) * 4


def plan(reqs: Sequence[KernelReq], row_words: int, stages: int = 1) -> Plan:
    """Lay out one launch; raises if it cannot fit the kernels' limits.

    ``stages`` tiles of the row tile come first (scan_multi's ring; 1 for
    the single-request kernels), then the word map, the aggregate slots and
    the group-by histograms that fit ``HIST_SMEM_BYTES``.  Rows wider than
    ``DIRECT_ROW_WORDS`` are not staged (``direct``): a tile is then
    ``THREADS`` rows for the fused scan (a thread a row) and for launches
    that pack no words, else ``tile_rows(row_words)`` rows (a projection
    packs a word a thread), and the map is read in place (from device
    memory, through the cache: a block serves few such rows, so staging the
    map would cost as much as they do).  A staged launch puts the map in
    shared memory where it fits beside the rest, in place otherwise."""
    if not 0 < len(reqs) <= MAX_REQ:
        raise ValueError(f"a launch carries 1..{MAX_REQ} requests, got {len(reqs)}")
    for r in reqs:
        touched = r.touched()
        if touched and not (0 <= min(touched) and max(touched) < row_words):
            bad = [w for w in touched if not 0 <= w < row_words]
            raise ValueError(f"words {bad} outside the {row_words}-word row")
        if r.pred_op not in PRED_OPS:
            raise ValueError(r.pred_op)
        if r.kind == GROUPBY and r.num_groups < 1:
            raise ValueError("num_groups must be positive")
    maps, map_off, red_off, hist_off, slot = [], [], [], [], []
    part_w = n_slots = 0
    for r in reqs:
        map_off.append(len(maps))
        maps += list(r.words)
        red_off.append(part_w if r.kind in (AGGREGATE, GROUPBY) else -1)
        part_w += {AGGREGATE: 2, GROUPBY: 2 * r.num_groups}.get(r.kind, 0)
        slot.append(n_slots if r.kind == AGGREGATE else -1)
        n_slots += r.kind == AGGREGATE
    direct = row_words > DIRECT_ROW_WORDS
    if direct:
        rows = THREADS if stages > 1 or not maps else tile_rows(row_words)
        stride = 0
    else:
        rows = tile_rows(row_words)
        stride = _round4(rows * row_words)  # keeps every tile 16-byte aligned
    for map_words in ((0,) if direct else (len(maps), 0)):  # staged, else in place
        map_smem = stages * stride
        slot_smem = _round4(map_smem + map_words)
        top = slot_smem + 2 * n_slots * THREADS
        hist_off, hist_bytes = [], 0
        for r in reqs:
            fits = r.kind == GROUPBY and hist_bytes + 8 * r.num_groups <= HIST_SMEM_BYTES
            hist_off.append(top if fits else -1)
            if fits:
                top += 2 * r.num_groups
                hist_bytes += 8 * r.num_groups
        if top * 4 <= SMEM_MAX:
            break
    else:
        raise ValueError(f"{stages} tiles of {row_words}-word rows and the launch's "
                         f"slots need {top * 4} B of shared memory, over {SMEM_MAX}")
    if not map_words:
        map_smem = -1
    return Plan(rows, stride, maps, map_off, red_off, hist_off, slot,
                map_smem, slot_smem, n_slots, part_w, top * 4, direct)


def split(reqs: Sequence[KernelReq]) -> list[list[int]]:
    """Indices of ``reqs`` in groups that each fit one launch: ``MAX_REQ``
    requests at most, whatever their packed words."""
    return [list(range(i, min(i + MAX_REQ, len(reqs)))) for i in range(0, len(reqs), MAX_REQ)]


_DEVICE_MAPS: dict[tuple, torch.Tensor] = {}


def device_map(words: Sequence[int], device: torch.device) -> torch.Tensor:
    """The word map ``words`` as an int32 tensor on ``device``: uploaded on
    first use without synchronising the stream, then kept (the
    ``DEVICE_MAPS`` latest distinct maps), so a repeated query uploads
    nothing."""
    key = (device.index, tuple(words))
    t = _DEVICE_MAPS.pop(key, None)
    if t is None:
        t = torch.tensor(key[1] or (0,), dtype=torch.int32).to(device, non_blocking=True)
        while len(_DEVICE_MAPS) >= DEVICE_MAPS:
            _DEVICE_MAPS.pop(next(iter(_DEVICE_MAPS)))
    _DEVICE_MAPS[key] = t  # most recent last
    return t


# ---------------------------------------------------------------- building
_LIB: ctypes.CDLL | None = None
BUILD_LOG = ""


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librm_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this source hash is already built: one
    ``nvcc -c`` per source, all started together, then one link."""
    global BUILD_LOG
    out = library_path()
    log = out.with_suffix(".log")
    if out.exists():
        BUILD_LOG = log.read_text() if log.exists() else ""
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    sources = sorted(CSRC.glob("*.cu"))
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    texts, failed = [], []
    for src, proc in zip(sources, procs):
        text, _ = proc.communicate(timeout=900)
        texts.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    if not failed:
        link = subprocess.run([_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                               *map(str, objs)],
                              capture_output=True, text=True, timeout=300)
        texts.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append("link")
    BUILD_LOG = "".join(texts)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{BUILD_LOG}")
    log.write_text(BUILD_LOG)
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def ptxas_report(source: str) -> list[str]:
    """The ``-Xptxas -v`` lines ``nvcc`` printed for ``source`` (a file name
    in ``csrc/``) in the last build: each kernel's registers, shared memory,
    spill stores and loads, and any warning."""
    lines, inside = [], False
    for line in BUILD_LOG.splitlines():
        if line.startswith("== "):
            inside = line[3:] == source
        elif inside and line.strip():
            lines.append(line.strip())
    return lines


def load() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    lib.rm_params_size.restype = ctypes.c_int
    lib.rm_error_string.argtypes = [ctypes.c_int]
    lib.rm_error_string.restype = ctypes.c_char_p
    lib.rm_max_blocks.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                  ctypes.POINTER(ctypes.c_int)]
    lib.rm_max_blocks.restype = ctypes.c_int
    for name in SCAN_KERNELS:
        fn = getattr(lib, f"rm_{name}")
        fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.rm_reduce_partials.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p, ctypes.c_void_p]
    lib.rm_reduce_partials.restype = ctypes.c_int
    lib.rm_hash_join.argtypes = [ctypes.POINTER(_JoinParams), ctypes.c_longlong,
                                 ctypes.c_int, ctypes.c_void_p]
    lib.rm_hash_join.restype = ctypes.c_int
    lib.rm_join_params_size.restype = ctypes.c_int
    lib.rm_join_stream_blocks.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.rm_join_stream_blocks.restype = ctypes.c_int
    lib.rm_scan_ring.restype = ctypes.c_int
    if lib.rm_scan_ring() != SCAN_RING:
        raise RuntimeError(f"rm_scan_multi_kernel stages {lib.rm_scan_ring()} tiles, "
                           f"the plan lays out SCAN_RING = {SCAN_RING}")
    lib.rm_project_bsl.argtypes = [ctypes.POINTER(_ColParams), ctypes.c_int, ctypes.c_void_p]
    lib.rm_project_pck.argtypes = [ctypes.POINTER(_ColParams), ctypes.c_int,
                                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.rm_project_spans.argtypes = [ctypes.POINTER(_SpanParams), ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]
    lib.rm_select_compact.argtypes = [ctypes.POINTER(_SelectParams),
                                      ctypes.c_longlong, ctypes.c_void_p]
    lib.rm_flash_attention.argtypes = [ctypes.POINTER(_FlashParams), ctypes.c_void_p]
    lib.rm_flash_backward.argtypes = [ctypes.POINTER(_FlashBwdParams), ctypes.c_int,
                                      ctypes.c_void_p]
    lib.rm_w8_matmul.argtypes = [ctypes.POINTER(_W8Params), ctypes.c_void_p]
    lib.rm_moe_ffn.argtypes = [ctypes.POINTER(_MoeParams), ctypes.c_void_p]
    lib.rm_rglru_scan.argtypes = [ctypes.POINTER(_RglruParams), ctypes.c_void_p]
    lib.rm_rglru_scan_backward.argtypes = [ctypes.POINTER(_RglruBwdParams), ctypes.c_void_p]
    for fn in (lib.rm_rglru_forward_plan, lib.rm_rglru_backward_plan):
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
        fn.restype = None
    for fn in (lib.rm_project_bsl, lib.rm_project_pck, lib.rm_select_compact,
               lib.rm_col_params_size, lib.rm_select_params_size,
               lib.rm_project_spans, lib.rm_span_params_size,
               lib.rm_flash_attention, lib.rm_flash_params_size,
               lib.rm_flash_backward, lib.rm_flash_bwd_params_size,
               lib.rm_w8_matmul, lib.rm_w8_params_size, lib.rm_w8_init,
               lib.rm_moe_ffn, lib.rm_moe_params_size, lib.rm_rglru_scan,
               lib.rm_rglru_params_size, lib.rm_rglru_scan_backward,
               lib.rm_rglru_bwd_params_size):
        fn.restype = ctypes.c_int
    for c_size, struct in ((lib.rm_params_size(), _Params),
                           (lib.rm_join_params_size(), _JoinParams),
                           (lib.rm_col_params_size(), _ColParams),
                           (lib.rm_span_params_size(), _SpanParams),
                           (lib.rm_select_params_size(), _SelectParams),
                           (lib.rm_flash_params_size(), _FlashParams),
                           (lib.rm_flash_bwd_params_size(), _FlashBwdParams),
                           (lib.rm_w8_params_size(), _W8Params),
                           (lib.rm_moe_params_size(), _MoeParams),
                           (lib.rm_rglru_params_size(), _RglruParams),
                           (lib.rm_rglru_bwd_params_size(), _RglruBwdParams)):
        if c_size != ctypes.sizeof(struct):
            raise RuntimeError(
                f"{struct.__name__} layout differs: C {c_size} bytes, ctypes "
                f"{ctypes.sizeof(struct)} bytes"
            )
    for fn, kernel, want in (
            (lib.rm_rglru_forward_plan, "rm_rglru_scan_kernel's (lanes, steps, stages)",
             (RGLRU_FWD_LANES, RGLRU_FWD_STEPS, RGLRU_FWD_STAGES)),
            (lib.rm_rglru_backward_plan, "rm_rglru_scan_backward_kernel's (lanes, steps, stages)",
             (RGLRU_BWD_LANES, RGLRU_BWD_STEPS, RGLRU_BWD_STAGES))):
        plan = [ctypes.c_int(0) for _ in range(3)]
        fn(*map(ctypes.byref, plan))
        if tuple(v.value for v in plan) != want:
            raise RuntimeError(f"{kernel} are {tuple(v.value for v in plan)}, the plan lays "
                               f"out {want}")
    _LIB = lib
    # a load inside a capture leaves it to the W8 wrapper (which raises there)
    if torch.cuda.is_available() and not torch.cuda.is_current_stream_capturing():
        _w8_init(lib, torch.cuda.current_device())
    return lib


_W8_READY: set[int] = set()  # devices where rm_w8_init has run


def _w8_init(lib: ctypes.CDLL, dev: int) -> None:
    """Allow the tensor-core W8 kernel its dynamic shared memory on card
    ``dev``, once: an attribute is never set inside a launch that a CUDA
    graph may capture."""
    if dev in _W8_READY:
        return
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"the W8 kernel's first launch on cuda:{dev} is inside a CUDA "
                           f"graph capture; launch it once before capturing")
    with torch.cuda.device(dev):
        _check(lib, lib.rm_w8_init(), "w8_matmul init")
    _W8_READY.add(dev)


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what}: CUDA error {err} ({lib.rm_error_string(err).decode()})")


_MAX_BLOCKS: dict[tuple, int] = {}
_JOIN_STREAM_BLOCKS: dict[int, int] = {}


def _max_blocks(lib: ctypes.CDLL, kernel: str, smem: int,
                device: torch.device, direct: bool = False) -> int:
    key = (kernel, smem, device.index, direct)
    if key not in _MAX_BLOCKS:
        blocks = ctypes.c_int(0)
        _check(lib, lib.rm_max_blocks(KERNELS.index(kernel), int(direct), smem,
                                      ctypes.byref(blocks)), f"{kernel} occupancy")
        if blocks.value <= 0:
            raise RuntimeError(f"{kernel}: no block fits with {smem} B shared memory")
        _MAX_BLOCKS[key] = blocks.value
    return _MAX_BLOCKS[key]


# ---------------------------------------------------------------- launching
def check_words(words: torch.Tensor) -> None:
    """What the kernels take: a contiguous 2-D int32 tensor on the card."""
    if not words.is_cuda:
        raise ValueError(f"the CUDA kernels need a CUDA tensor, got {words.device}")
    if words.dtype != torch.int32 or words.dim() != 2:
        raise ValueError(f"want (N, row_words) int32 words, got {words.dtype} "
                         f"{tuple(words.shape)}")
    if not words.is_contiguous():
        raise ValueError("row-store words must be contiguous")


def _empty_result(r: KernelReq, n: int, device: torch.device):
    if r.kind == PROJECT:
        return torch.empty((n, len(r.words)), dtype=torch.int32, device=device)
    if r.kind == FILTER:
        return (torch.empty((n, len(r.words)), dtype=torch.int32, device=device),
                torch.empty((n,), dtype=torch.bool, device=device))
    if r.kind == AGGREGATE:
        return torch.zeros(2, dtype=torch.float32, device=device)
    zeros = torch.zeros(r.num_groups, dtype=torch.float32, device=device)
    return zeros, zeros.clone()


def launch_groups(reqs: Sequence[KernelReq], row_words: int,
                  stages: int) -> list[tuple[list[int], Plan, _Params]]:
    """The launches that serve ``reqs``: for each group of requests
    (:func:`split`) its indices, its plan and its parameter block with every
    field set but the pointers (the word map's among them) and the row
    count."""
    out = []
    for group in split(reqs):
        sub = [reqs[i] for i in group]
        pl = plan(sub, row_words, stages)
        params = _Params(
            row_words=row_words, tile_rows=pl.tile_rows, n_req=len(sub),
            map_len=len(pl.map), part_w=pl.part_w, n_slots=pl.n_slots,
            map_smem=pl.map_smem, slot_smem=pl.slot_smem,
            tile_stride=pl.tile_stride, direct=int(pl.direct),
        )
        for j, r in enumerate(sub):
            params.req[j] = _Req(
                kind=r.kind, out_w=len(r.words), map_off=pl.map_off[j],
                pred_word=r.pred_word, pred_float=int(r.pred_float),
                pred_op=PRED_OPS[r.pred_op], k_bits=r.k_bits,
                ts_word=r.ts_word, ts=r.ts, agg_word=r.agg_word,
                agg_float=int(r.agg_float), group_word=r.group_word,
                num_groups=r.num_groups, red_off=pl.red_off[j],
                hist_off=pl.hist_off[j], slot=pl.slot[j],
            )
        out.append((group, pl, params))
    return out


def run(kernel: str, words: torch.Tensor, reqs: Sequence[KernelReq]) -> list:
    """Launch ``kernel`` over ``words`` for ``reqs``; one result per request,
    in the single-op contracts: packed ``(N, out_w)`` int32, ``(packed, bool
    mask)``, float32 ``[sum, count]``, ``(sums[G], counts[G])``.

    A zero-row input launches nothing (a grid of 0 blocks is an invalid
    launch) and returns empty blocks and zero reductions.  More requests than
    one launch carries run as several launches of the same kernel."""
    check_words(words)
    n, row_words = words.shape
    device = words.device
    results = [_empty_result(r, n, device) for r in reqs]
    if n == 0:
        return results
    if len(reqs) > 1 and kernel not in MULTI_REQUEST:
        raise ValueError(f"{kernel} takes one request")
    if kernel == "project" and row_words > DIRECT_ROW_WORDS:
        raise ValueError(f"rows wider than {DIRECT_ROW_WORDS} words are projected by "
                         f"run_spans, not the staged kernel")
    lib = load()
    fn = getattr(lib, f"rm_{kernel}")
    stages = SCAN_RING if kernel == "scan_multi" else 1
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for group, pl, params in launch_groups(reqs, row_words, stages):
            sub = [reqs[i] for i in group]
            n_tiles = -(-n // pl.tile_rows)
            n_blocks = min(n_tiles, _max_blocks(lib, kernel, pl.smem_bytes, device,
                                                pl.direct))
            if pl.part_w:
                n_blocks = max(1, min(n_blocks, PARTIAL_BYTES // (4 * pl.part_w)))
            partials = torch.empty(n_blocks * pl.part_w, dtype=torch.float32,
                                   device=device)
            params.words, params.partials, params.n = words.data_ptr(), partials.data_ptr(), n
            params.map = device_map(pl.map, device).data_ptr()
            for j, (i, r) in enumerate(zip(group, sub)):
                if r.kind == PROJECT:
                    params.req[j].out = results[i].data_ptr()
                elif r.kind == FILTER:
                    params.req[j].out = results[i][0].data_ptr()
                    params.req[j].mask = results[i][1].data_ptr()
            _check(lib, fn(ctypes.byref(params), n_blocks, pl.smem_bytes, stream),
                   f"{kernel} launch")
            _launched(kernel)
            if not pl.part_w:
                continue
            reduced = torch.empty(pl.part_w, dtype=torch.float32, device=device)
            _check(lib, lib.rm_reduce_partials(partials.data_ptr(), n_blocks,
                                               pl.part_w, reduced.data_ptr(),
                                               stream), f"{kernel} finalize")
            for j, i in enumerate(group):
                r, off = sub[j], pl.red_off[j]
                if r.kind == AGGREGATE:
                    results[i] = reduced[off: off + 2]
                elif r.kind == GROUPBY:
                    pairs = reduced[off: off + 2 * r.num_groups].view(-1, 2)
                    results[i] = (pairs[:, 0], pairs[:, 1])
    return results


def join_launch(n: int, row_words: int, num_buckets: int, capacity: int,
                key_word: int, val_word: int, ts_word: int, ts: int,
                build_ts: bool) -> tuple[_JoinParams, int]:
    """The probe's parameter block (pointers left null) and grid for ``n``
    probe rows: a warp probes 32 rows, a block of ``JOIN_THREADS`` threads
    256 rows a pass, and a grid-stride loop covers what ``MAX_GRID_BLOCKS``
    blocks do not.  The fingerprint scratch holds ``fp_stride`` 8-bit
    fingerprints a bucket: 32 bytes per 32 slots.  Rows wider than a 32-byte
    sector take the streaming form (``stream``), which prefetches row words
    on a persistent grid: ``run_hash_join`` caps ``n_blocks`` at what fits
    on the card (``rm_join_stream_blocks``)."""
    params = _JoinParams(
        n=n, row_words=row_words, key_word=key_word, val_word=val_word,
        ts_word=ts_word, ts=ts, build_ts=int(build_ts),
        shift=32 - (num_buckets.bit_length() - 1), cap=capacity,
        fp_stride=32 * -(-capacity // 32), stream=int(4 * row_words > JOIN_SECTOR),
    )
    return params, min(-(-n // JOIN_THREADS), MAX_GRID_BLOCKS)


def run_hash_join(words: torch.Tensor, partitions, key_word: int,
                  val_word: int, ts_word: int, ts: int,
                  build_ts: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the hash-join probe over ``words`` against ``partitions``
    (four ``(P, C)`` int32 tensors: keys, vals, begin, end); returns
    ``(s_proj int32, r_proj int32, matched bool)`` of ``N`` rows.  The
    launch first repacks the buckets into scratch memory (8-bit key
    fingerprints, ``P * fp_stride`` bytes, and a 16-byte record a slot,
    ``P * C * 16`` bytes), then probes.  The caller has checked words,
    offsets and bucket shapes (``rme_join.check_probe``); a zero-row input
    launches nothing."""
    check_words(words)
    parts = [t.contiguous() for t in partitions]
    n, row_words = words.shape
    device = words.device
    s_out = torch.empty(n, dtype=torch.int32, device=device)
    r_out = torch.empty(n, dtype=torch.int32, device=device)
    m_out = torch.empty(n, dtype=torch.bool, device=device)
    if n == 0:
        return s_out, r_out, m_out
    p, cap = parts[0].shape
    lib = load()
    params, n_blocks = join_launch(n, row_words, p, cap, key_word, val_word,
                                   ts_word, ts, build_ts)
    # one scratch buffer: the fingerprints, then the 16-byte records
    # (P * fp_stride is a multiple of 32, so they stay aligned)
    fp_bytes = p * params.fp_stride
    scratch = torch.empty(fp_bytes + 16 * p * cap, dtype=torch.uint8, device=device)
    params.words, params.fps = words.data_ptr(), scratch.data_ptr()
    params.recs = scratch.data_ptr() + fp_bytes
    params.keys, params.vals, params.begin, params.end = (t.data_ptr() for t in parts)
    params.s_out, params.r_out, params.m_out = (
        s_out.data_ptr(), r_out.data_ptr(), m_out.data_ptr())
    with torch.cuda.device(device):
        if params.stream:
            if device.index not in _JOIN_STREAM_BLOCKS:
                blocks = ctypes.c_int(0)
                _check(lib, lib.rm_join_stream_blocks(ctypes.byref(blocks)),
                       "hash_join occupancy")
                if blocks.value <= 0:
                    raise RuntimeError("hash_join: no block of the streaming form fits")
                _JOIN_STREAM_BLOCKS[device.index] = blocks.value
            n_blocks = min(n_blocks, _JOIN_STREAM_BLOCKS[device.index])
        stream = torch.cuda.current_stream(device).cuda_stream
        _check(lib, lib.rm_hash_join(ctypes.byref(params), p, n_blocks, stream),
               "hash_join launch")
    _launched("hash_join")
    return s_out, r_out, m_out


def pck_packer(out_w: int) -> tuple[int, int]:
    """PCK's packer: ``(rows a tile, packed words a pass)``.  A tile holds
    whole packed rows where ``tile_rows(out_w)`` of them fit ``SMEM_MAX``;
    a wider packed row is packed in ranges of the words that fit (a
    multiple of 4), one pass a range."""
    rows = tile_rows(out_w)
    if rows * out_w * 4 <= SMEM_MAX:
        return rows, out_w
    return rows, SMEM_MAX // (4 * rows) // 4 * 4


def pck_plan(out_w: int) -> tuple[int, int, int]:
    """PCK's wide form (rows wider than ``DIRECT_ROW_WORDS``): ``(rows a
    tile, packed words a range, ranges a tile)``.  A range is at most
    ``PCK_RANGE_WORDS`` words, a multiple of 4 (so that a packer row and,
    where ``out_w`` is a multiple of 4, every packed row range start 16-byte
    aligned), and the rows fill a packer of ``PCK_PACKER_BYTES``, at most
    ``THREADS``: each block keeps ``PCK_PACKERS`` of them, small enough that
    several blocks share an SM, and the grid's items are the (row tile,
    range) pairs (``rm_project_pck_wide_kernel``)."""
    range_w = min(PCK_RANGE_WORDS, _round4(out_w))
    rows = max(1, min(THREADS, PCK_PACKER_BYTES // (4 * range_w)))
    return rows, range_w, -(-out_w // range_w)


def bsl_plan(slices: Sequence[tuple[int, int, int]], row_words: int,
             out_w: int) -> tuple[int, tuple[int, ...]]:
    """BSL's chunks: ``(chunk_words, counts)`` — the words a chunk and each
    column's chunks in a row tile, side by side in launch order — for
    ``slices`` (``(src_word, dst_word, width_words)`` per column).  Rows of
    at most ``DIRECT_ROW_WORDS`` keep one block a column and tile
    (``(0, (1, ..., 1))``: today's grid).  Wider rows take the wide form:
    a column's range is cut at ``chunk_words`` apart from the 16-byte
    boundary of the packed row at or before its first word
    (:func:`bsl_chunk`), so a warp copies a (row, chunk) as one item of
    ``SPAN_VECS`` 16-byte vectors a lane — 256 words; 252 where ``out_w`` is
    not a multiple of 4 and a boundary of the packed row is none in memory.
    The kernel counts a column's chunks as here (``rm_project_bsl`` checks
    their sum, ``ColParams::chunks``)."""
    if row_words <= DIRECT_ROW_WORDS:
        return 0, (1,) * len(slices)
    item = 32 * SPAN_VECS * 4
    chunk = item if out_w % 4 == 0 else item - 4
    return chunk, tuple(-(-(bsl_lead(dst, out_w) + w) // chunk) for _, dst, w in slices)


def bsl_lead(dst: int, out_w: int) -> int:
    """Words of the packed row between BSL's first cut of a column at
    ``dst`` and ``dst``: to the 16-byte boundary at or before it where
    ``out_w`` is a multiple of 4 (every row's boundary then), else 0."""
    return dst % 4 if out_w % 4 == 0 else 0


def bsl_chunk(dst: int, width: int, out_w: int, chunk_words: int, k: int) -> tuple[int, int]:
    """The column words ``[lo, hi)`` (offsets in the column) of chunk ``k``
    of a ``width``-word column at packed word ``dst`` (as
    ``rm_project_bsl_wide_kernel`` cuts it)."""
    lead = bsl_lead(dst, out_w)
    return max(0, k * chunk_words - lead), min(width, (k + 1) * chunk_words - lead)


@functools.lru_cache(maxsize=SPAN_PLANS)
def column_params(kernel: str, slices: tuple[tuple[int, int, int], ...], row_words: int,
                  out_w: int) -> _ColParams:
    """The parameter block of a BSL or PCK launch (``"project_bsl"`` or
    ``"project_pck"``) of ``slices`` — ``(src_word, dst_word,
    width_words)`` per enabled column — over ``row_words``-word rows packed
    into ``out_w`` words, every field set but the pointers and the row
    count: the slices checked, PCK's packer (:func:`pck_packer`; rows
    wider than ``DIRECT_ROW_WORDS``: its wide form's ranges, :func:`pck_plan`,
    ``chunks`` the ranges a tile), BSL's chunks (:func:`bsl_plan`).  Planned
    once per layout and kept for the last ``SPAN_PLANS``; a launch copies
    it."""
    if kernel not in ("project_bsl", "project_pck"):
        raise ValueError(kernel)
    if not 0 < len(slices) <= MAX_COLS:
        raise ValueError(f"a launch carries 1..{MAX_COLS} columns, got {len(slices)}")
    for src, dst, w in slices:
        if not (w > 0 and 0 <= src and src + w <= row_words and 0 <= dst
                and dst + w <= out_w):
            raise ValueError(f"column slice {(src, dst, w)} outside the "
                             f"{row_words}-word row or the {out_w}-word output")
    rows, range_w = pck_packer(out_w)
    params = _ColParams(row_words=row_words, out_w=out_w, n_cols=len(slices), tile_rows=rows,
                        range_w=range_w)
    if kernel == "project_pck" and row_words > DIRECT_ROW_WORDS:
        params.tile_rows, params.range_w, params.chunks = pck_plan(out_w)
    if kernel == "project_bsl":
        params.chunk_w, counts = bsl_plan(slices, row_words, out_w)
        params.chunks = sum(counts)
    for j, (src, dst, w) in enumerate(slices):
        params.src[j], params.dst[j], params.width[j] = src, dst, w
    return params


def run_columns(kernel: str, words: torch.Tensor,
                slices: Sequence[tuple[int, int, int]], out_w: int) -> torch.Tensor:
    """Launch a column-walking projection revision (``"project_bsl"`` or
    ``"project_pck"``) over ``words``; ``slices`` holds ``(src_word,
    dst_word, width_words)`` per enabled column.  Returns the packed
    ``(N, out_w)`` int32 block; a zero-row input launches nothing.  The
    host work of a call is the planned block's copy (:func:`column_params`),
    the allocation and the launch."""
    check_words(words)
    n, row_words = words.shape
    block = column_params(kernel, tuple(map(tuple, slices)), row_words, out_w)
    out = words.new_empty((n, out_w))  # int32 on words' card
    if n == 0:
        return out
    params = _ColParams.from_buffer_copy(block)
    params.words, params.out, params.n = words.data_ptr(), out.data_ptr(), n
    lib = load()
    dev = words.get_device()
    # the current stream's raw handle, as run_spans takes it; the launchers
    # make card `dev` current for the launch where it is not
    stream = torch._C._cuda_getCurrentRawStream(dev)
    if kernel == "project_bsl":
        err = lib.rm_project_bsl(ctypes.byref(params), dev, stream)
    else:  # PCK: a block a tile (the wide form: at most a block a (tile, range)
        # item, the launcher keeping no more than the card holds at once)
        n_blocks = min(-(-n // params.tile_rows) * max(1, params.chunks), MAX_GRID_BLOCKS)
        smem = (PCK_PACKERS if params.chunks else 1) * params.tile_rows * params.range_w * 4
        err = lib.rm_project_pck(ctypes.byref(params), n_blocks, smem, dev, stream)
    _check(lib, err, f"{kernel} launch")
    _launched(kernel)
    return out


@dataclasses.dataclass(frozen=True)
class SpanPlan:
    """One layout's launches of the span kernel: the merged word ranges,
    ``MAX_SPANS`` of them a launch (one launch for any configuration-port
    geometry), each range's first item in its launch's row, each launch's
    items a row, and its parameter block with every field set but the
    pointers and the row count."""

    spans: tuple[tuple[int, int, int], ...]  # (src_word, dst_word, width), merged
    first: tuple[int, ...]  # each span's first item in its launch's row
    chunks: tuple[int, ...]  # items a row, a launch
    row_words: int
    out_w: int
    params: tuple[_SpanParams, ...] = dataclasses.field(compare=False, repr=False)


def span_vectors(dst: int, width: int, out_w: int) -> int:
    """The most 16-byte output vectors a ``width``-word range at packed word
    ``dst`` touches in any row: its start's offset in a vector is ``dst``'s
    in every row when ``out_w`` is a multiple of 4, else any."""
    lead = dst % 4 if out_w % 4 == 0 else 3
    return (lead + width - 1) // 4 + 1


def span_plan(slices: tuple[tuple[int, int, int], ...], row_words: int,
              out_w: int) -> SpanPlan:
    """Plan the span kernel for ``slices`` — ``(src_word, dst_word,
    width_words)`` per enabled column — of ``row_words``-word rows packed
    into ``out_w`` words.  Ranges that continue each other in the row and
    in the packed row are merged; each range gets ``ceil(span_vectors /
    (32 * SPAN_VECS))`` items a row.  Raises
    unless the ranges lie in the row and tile the packed row exactly.  (A
    projection plans once per layout: ``rme_project.span_plan`` caches.)"""
    spans: list[list[int]] = []
    end = 0
    for src, dst, w in sorted(slices, key=lambda sl: sl[1]):
        if not (w > 0 and 0 <= src and src + w <= row_words):
            raise ValueError(f"column slice {(src, dst, w)} outside the {row_words}-word row")
        if dst != end:
            raise ValueError(f"column slices leave packed words {end}..{dst - 1} unwritten"
                             if dst > end else f"column slices overlap at packed word {dst}")
        if spans and spans[-1][0] + spans[-1][2] == src:
            spans[-1][2] += w
        else:
            spans.append([src, dst, w])
        end = dst + w
    if end != out_w or not spans:
        raise ValueError(f"column slices pack {end} words, not {out_w}")
    first, chunks, params = [], [], []
    for at in range(0, len(spans), MAX_SPANS):
        group = spans[at:at + MAX_SPANS]
        block = _SpanParams(row_words=row_words, out_w=out_w, n_spans=len(group))
        for j, (src, dst, w) in enumerate(group):
            first.append(block.chunks)
            block.src[j], block.dst[j], block.width[j], block.first[j] = src, dst, w, first[-1]
            block.chunks += -(-span_vectors(dst, w, out_w) // (32 * SPAN_VECS))
        chunks.append(block.chunks)
        params.append(block)
    return SpanPlan(tuple(map(tuple, spans)), tuple(first), tuple(chunks), row_words, out_w,
                    tuple(params))


def span_blocks(n: int, chunks: int) -> int:
    """Blocks of a span launch of ``chunks`` items a row over ``n`` rows: a
    warp an item, a grid-stride loop past ``MAX_GRID_BLOCKS``."""
    return min(-(-n * chunks // SPAN_WARPS), MAX_GRID_BLOCKS)


def run_spans(words: torch.Tensor, pl: SpanPlan) -> torch.Tensor:
    """Launch the span kernel: the packed ``(N, out_w)`` int32 block of
    ``pl``'s ranges over ``words``, whose rows are ``pl.row_words`` words
    (one launch a ``MAX_SPANS`` ranges).  The host work of a call is the
    allocation, a copy of the planned parameter block and the launch,
    whatever the packed width; a zero-row input launches nothing."""
    check_words(words)
    n, row_words = words.shape
    if row_words != pl.row_words:
        raise ValueError(f"the plan is for {pl.row_words}-word rows, got {row_words}")
    out = words.new_empty((n, pl.out_w))  # int32 on words' card
    if n == 0:
        return out
    lib = load()
    dev = words.get_device()
    # the current stream's handle as torch's generated kernels take it (a
    # tenth of the host time of current_stream(dev).cuda_stream); the
    # launcher selects card `dev` for the launch itself where it is not
    # the current one
    stream = torch._C._cuda_getCurrentRawStream(dev)
    for block in pl.params:
        params = _SpanParams.from_buffer_copy(block)
        params.words, params.out, params.n = words.data_ptr(), out.data_ptr(), n
        _check(lib, lib.rm_project_spans(ctypes.byref(params), span_blocks(n, block.chunks),
                                         dev, stream), "project launch")
        _launched("project")
    return out


def run_select(words: torch.Tensor, req: KernelReq,
               block_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the compacting selection: ``req`` carries the packed word map
    (``words``) and the predicate and MVCC test.  Returns ``(blocks
    (n_blocks, block_rows, out_w) int32, counts (n_blocks,) int32)`` with
    ``n_blocks = ceil(N / block_rows)``; a zero-row input launches nothing."""
    check_words(words)
    n, row_words = words.shape
    if block_rows < 1:
        raise ValueError(f"block_rows must be positive, got {block_rows}")
    if not req.words:
        raise ValueError("a selection packs at least one word")
    touched = req.touched()
    if not (0 <= min(touched) and max(touched) < row_words):
        bad = [w for w in touched if not 0 <= w < row_words]
        raise ValueError(f"words {bad} outside the {row_words}-word row")
    out_w = len(req.words)
    n_blocks = -(-n // block_rows)
    blocks = torch.empty((n_blocks, block_rows, out_w), dtype=torch.int32,
                         device=words.device)
    counts = torch.empty(n_blocks, dtype=torch.int32, device=words.device)
    if n == 0:
        return blocks, counts
    params = _SelectParams(
        words=words.data_ptr(), out=blocks.data_ptr(), counts=counts.data_ptr(),
        n=n, row_words=row_words, out_w=out_w, block_rows=block_rows,
        q=_Req(pred_word=req.pred_word, pred_float=int(req.pred_float),
               pred_op=PRED_OPS[req.pred_op], k_bits=req.k_bits,
               ts_word=req.ts_word, ts=req.ts))
    if out_w <= SELECT_INLINE_MAP:  # the map rides in the parameter block
        params.map_inline[:out_w] = req.words
    else:
        params.map = device_map(req.words, words.device).data_ptr()
    lib = load()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        _check(lib, lib.rm_select_compact(ctypes.byref(params), n_blocks, stream),
               "select_compact launch")
    _launched("select_compact")
    return blocks, counts


def flash_tma_strides(shape: Sequence[int], strides: Sequence[int]) -> tuple[int, ...]:
    """Strides as the kernels are given them: a dimension of size 1 is only
    ever read at index 0, so its stride, whatever it is, is passed as the
    head width (a multiple of 16 bytes at every width the kernels take)."""
    return tuple(st if n != 1 else shape[-1] for n, st in zip(shape, strides))


def check_flash_tma(name: str, shape: Sequence[int], strides: Sequence[int],
                    itemsize: int, data_ptr: int) -> None:
    """What the bf16 kernel's TMA descriptors can describe, checked on
    shapes, strides (in elements, unit stride along D already checked) and
    the base address alone: the base 16-byte aligned, every other stride a
    positive multiple of 16 bytes.  Raises ``ValueError`` otherwise."""
    if data_ptr % 16:
        raise ValueError(f"{name} starts at an address that is not 16-byte aligned "
                         f"({data_ptr:#x}); TMA needs 16")
    for dim, st in enumerate(flash_tma_strides(shape, strides)[:-1]):
        if st <= 0 or (st * itemsize) % 16:
            raise ValueError(f"{name} has stride {st} along dimension {dim} "
                             f"({st * itemsize} bytes); TMA needs a positive multiple "
                             f"of 16 bytes")


def _flash_common(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int | None,
                  extra=()) -> int:
    """The checks the flash kernels share, before any build or launch: one
    type (float32 or bfloat16) and a unit stride along D for q, k, v and
    ``extra`` (``(name, tensor)`` pairs of q's shape), a head width the
    kernels instantiate, TMA's layout in bf16 (q, k and v), one card, a
    positive window and a grid of at most 65,535 ``B * H`` rows.  Returns
    the window to pass (S for none)."""
    b, s, h, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v), *extra):
        if t.dtype not in FLASH_DTYPES or t.dtype != q.dtype:
            raise ValueError(f"q, k, v{''.join(', ' + n for n, _ in extra)} must all be "
                             f"float32 or all bfloat16, got {q.dtype} and {name} {t.dtype}")
        if t.numel() and t.stride(3) != 1:
            raise ValueError(f"{name} needs a unit stride along D, got strides {t.stride()}")
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not one of {FLASH_HEAD_DIMS}")
    meta = q.device.type == "meta"
    if q.dtype == torch.bfloat16 and q.numel() and k.numel() and not meta:
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_flash_tma(name, t.shape, t.stride(), t.element_size(), t.data_ptr())
    for name, t in (("q", q), ("k", k), ("v", v), *extra):
        if t.device.type != "cuda" and not meta:
            raise ValueError(f"the CUDA kernels need CUDA tensors, got {name} on {t.device}")
        if t.device != q.device:
            raise ValueError(f"q on {q.device} but {name} on {t.device}")
    win = s if window is None else int(window)
    if win < 1:
        raise ValueError(f"window must be positive, got {window}")
    if b * h > 65535:
        raise ValueError(f"B * H = {b * h} exceeds the grid's 65,535 rows")
    return min(win, s)


def _strides(t: torch.Tensor) -> tuple[int, int, int]:
    """A (B, S, heads, D) tensor's B, S and head strides as the kernels
    take them (:func:`flash_tma_strides`)."""
    return flash_tma_strides(t.shape, t.stride())[:3]


def run_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
              window: int | None, lse: bool = False):
    """Launch the GQA flash-attention forward: q ``(B, S, H, D)``, k and v
    ``(B, S, KH, D)`` (the caller, ``flash_attention``, has checked the
    shapes), on one card, all float32 or all bfloat16, each with a unit
    stride along D (the other strides are free: the kernels read the layout
    through them).  bfloat16 goes to the tensor-core kernel, whose TMA loads
    also need a 16-byte aligned base and strides of multiples of 16 bytes
    (:func:`check_flash_tma`); float32 to the CUDA-core kernel.  Returns a
    new contiguous ``(B, S, H, D)`` output of q's type; an empty input
    launches nothing.  With ``lse`` it returns ``(out, lse)``: the kernel
    also stores each row's log-sum-exp as float32 ``(B, H, S)``, what
    :func:`run_flash_backward` takes (serving stores none)."""
    b, s, h, d = q.shape
    win = _flash_common(q, k, v, window)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    row_lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if lse else None
    if out.numel() == 0:
        return (out, row_lse) if lse else out
    if roofline.counting():
        roofline.record_kernel("flash_attention", *roofline.flash_work(
            b, s, h, k.shape[2], d, causal, win, q.element_size()))
    if q.device.type == "meta":
        return (out, row_lse) if lse else out
    st = {n: _strides(t) for n, t in (("q", q), ("k", k), ("v", v), ("o", out))}
    params = _FlashParams(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), out=out.data_ptr(),
        lse=row_lse.data_ptr() if lse else None,
        **{f"{t}_{n}": st[t][i] for t in "qkvo" for i, n in ((0, "sb"), (1, "ss"), (2, "sh"))},
        batch=b, seq=s, heads=h, kv_heads=k.shape[2], head_dim=d,
        causal=int(bool(causal)), window=win, dtype=FLASH_DTYPES[q.dtype],
        scale=d ** -0.5,
    )
    lib = load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _check(lib, lib.rm_flash_attention(ctypes.byref(params), stream),
               "flash_attention launch")
    _launched("flash_attention")
    return (out, row_lse) if lse else out


def flash_backward_form(dtype: torch.dtype, d: int) -> str:
    """Which form of the backward takes a gradient: ``"one_pass"`` (bf16 up
    to D 128: one wgmma + TMA kernel of five products a pair, dQ's partials
    summed in key order in float32 scratch; its widths are
    ``FLASH_BWD_ONE_PASS_D``, and narrower heads are padded to the first),
    ``"tensor"`` (bf16 at ``FLASH_BWD_TC_MAX_D``, 256: a dK / dV pass, dK
    and dV in a warpgroup each, and a dQ pass on wgmma + TMA) or
    ``"cuda_cores"`` (float32 at every width).  The launcher chooses the same by itself
    (``tensor_form`` and ``launch_form`` in ``csrc/rm_flash_bwd.cu``); the
    wrapper asks to know which ``dout`` the kernel can read and which
    scratch it takes."""
    if dtype != torch.bfloat16 or d > FLASH_BWD_TC_MAX_D:
        return "cuda_cores"
    return "one_pass" if d <= FLASH_BWD_ONE_PASS_D[-1] else "tensor"


def flash_bwd_key_items(s: int, g: int, causal: bool, window: int) -> list[int]:
    """The D 256 form's (head, query tile) items of each 64-key tile: ``g``
    heads times the 64-query tiles any of its keys is seen by (the mask's
    range; ``key_tile_queries`` in ``csrc/rm_flash_bwd.cu``)."""
    rows = FLASH_BWD_WIDE_ROWS
    items = []
    for k0 in range(0, s, rows):
        k_last = min(k0 + rows, s) - 1
        i_lo = k0 if causal else max(0, k0 - window + 1)
        i_hi = min(s - 1, k_last + window - 1)
        items.append(g * (i_hi // rows - i_lo // rows + 1))
    return items


def flash_bwd_chunks(items: Sequence[int], chunk: int) -> list[tuple[int, int, int]]:
    """The dK / dV blocks of one (b, kv head) in launch order: ``(key tile,
    first item, items)``, each tile's items cut into ``ceil(n / chunk)``
    near-equal chunks (as the kernel cuts them)."""
    blocks = []
    for kt, n in enumerate(items):
        splits = -(-n // chunk)
        blocks += [(kt, j * n // splits, (j + 1) * n // splits - j * n // splits)
                   for j in range(splits)]
    return blocks


@functools.lru_cache(maxsize=256)
def flash_bwd_kv_plan(s: int, g: int, causal: bool, window: int, groups: int,
                      sms: int) -> tuple[int, int]:
    """The D 256 form's dK / dV launch for ``groups`` (b, kv head) pairs on
    a card of ``sms`` SMs, one block an SM, kept per shape: ``(chunk,
    blocks)``, the items a block at most and the blocks a pair.  The chunk
    is the one whose blocks, dealt in launch order to the SM that frees
    first, finish soonest, each costing its items plus
    ``FLASH_BWD_BLOCK_COST`` and, in a tile cut in more than one chunk,
    ``FLASH_BWD_PARTIAL_COST``; the larger chunk where two tie."""
    items = flash_bwd_key_items(s, g, causal, window)
    top = max(items)
    candidates = sorted({c for c in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192,
                                     256, 384, 512) if c < top} | {top}, reverse=True)
    best = (float("inf"), top, 0)
    for chunk in candidates:
        blocks = flash_bwd_chunks(items, chunk)
        costs = [n + FLASH_BWD_BLOCK_COST + (FLASH_BWD_PARTIAL_COST if n < items[kt] else 0)
                 for kt, _, n in blocks]
        free = [0.0] * min(sms, len(costs) * groups)
        for _ in range(groups):
            for cost in costs:
                heapq.heapreplace(free, free[0] + cost)
        if max(free) < best[0]:
            best = (max(free), chunk, len(blocks))
    return best[1], best[2]


_SMS: dict[int, int] = {}


def _sms(dev: int) -> int:
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


def flash_dout(dout: torch.Tensor, form: str) -> torch.Tensor:
    """``dout`` as the backward kernel can read it: unchanged where it has a
    unit stride along D (and, in the tensor-core form, where
    :func:`check_flash_tma` takes it), else a contiguous copy, counted in
    ``FLASH_DOUT_COPIES``: autograd may hand over a gradient of any layout,
    a broadcast one (the gradient of a sum) included."""
    readable = not dout.numel() or dout.stride(3) == 1
    if readable and form != "cuda_cores" and dout.device.type != "meta":
        try:
            check_flash_tma("dout", dout.shape, dout.stride(), dout.element_size(),
                            dout.data_ptr())
        except ValueError:
            readable = False
    if readable:
        return dout
    FLASH_DOUT_COPIES["copies"] += 1
    return dout.clone(memory_format=torch.contiguous_format)


def run_flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                       lse: torch.Tensor, dout: torch.Tensor, causal: bool,
                       window: int | None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the flash-attention backward (``csrc/rm_flash_bwd.cu``): from
    q ``(B, S, H, D)``, k and v ``(B, S, KH, D)``, the forward's ``out``
    (q's shape) and float32 ``lse`` ``(B, H, S)`` (``run_flash(...,
    lse=True)``) and ``dout``, returns new contiguous ``(dq, dk, dv)`` in
    q's type.  The form follows :func:`flash_backward_form`; q, k and v
    must meet the forward's checks, ``out`` its type and unit stride along
    D; a ``dout`` of q's type that the kernel cannot read is copied
    (:func:`flash_dout`).  An empty input launches nothing."""
    b, s, h, d = q.shape
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or k.shape[:2] != (b, s) \
            or k.shape[3] != d:
        raise ValueError(f"want q (B, S, H, D), k and v (B, S, KH, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    kh = k.shape[2]
    if kh < 1 or h % kh:
        raise ValueError(f"{h} query heads do not split into groups of {kh} KV heads")
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape:
            raise ValueError(f"{name} must have q's shape {tuple(q.shape)}, got {tuple(t.shape)}")
    if lse.shape != (b, h, s) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 ({b}, {h}, {s}), got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    dout = flash_dout(dout, flash_backward_form(q.dtype, d))
    win = _flash_common(q, k, v, window, (("out", out), ("dout", dout)))
    if lse.device != q.device:
        raise ValueError(f"q on {q.device} but lse on {lse.device}")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((b, s, kh, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0:
        return dq, dk, dv
    if roofline.counting():
        roofline.record_kernel("flash_attention_backward", *roofline.flash_backward_work(
            b, s, h, kh, d, causal, win, q.element_size()))
    if q.device.type == "meta":
        return dq, dk, dv
    dq_d, dk_d, dv_d = dq, dk, dv
    scale = d ** -0.5
    form = flash_backward_form(q.dtype, d)
    if form == "one_pass" and d < FLASH_BWD_ONE_PASS_D[0]:
        # D 16 / 32: the one-pass kernel at its narrowest width, on heads
        # padded with zero columns (they add nothing to S, dP or D_i)
        full = FLASH_BWD_ONE_PASS_D[0]
        q, k, v, out, dout = (torch.nn.functional.pad(t, (0, full - d))
                              for t in (q, k, v, out, dout))
        dq, dk, dv = (torch.empty(t.shape[:3] + (full,), dtype=q.dtype, device=q.device)
                      for t in (dq_d, dk_d, dv_d))
        d = full
    seq_pad = -(-s // FLASH_BWD_SEQ_PAD) * FLASH_BWD_SEQ_PAD
    scratch = torch.empty((2, b * h, seq_pad), dtype=torch.float32, device=q.device)
    dev = q.get_device()
    wide = {}
    if form == "one_pass":
        # dQ's float32 partials, and the work ticket with a count a query tile
        # (zeroed by the prep kernel)
        acc = torch.empty((b * h, seq_pad, d), dtype=torch.float32, device=q.device)
        count = torch.empty(1 + b * h * (seq_pad // FLASH_BWD_ONE_Q), dtype=torch.int32,
                            device=q.device)
        wide = dict(dq_acc=acc.data_ptr(), dq_count=count.data_ptr())
    elif form == "tensor":
        g = h // kh
        chunk, blocks = flash_bwd_kv_plan(s, g, bool(causal), win, b * kh, _sms(dev))
        part = torch.empty((b * kh, blocks, 2, FLASH_BWD_WIDE_ROWS, d), dtype=torch.float32,
                           device=q.device)
        count = torch.empty((b * kh, -(-s // FLASH_BWD_WIDE_ROWS)), dtype=torch.int32,
                            device=q.device)
        wide = dict(kv_part=part.data_ptr(), kv_count=count.data_ptr(), kv_chunk=chunk,
                    kv_blocks=blocks)
    st = {n: _strides(t) for n, t in (("q", q), ("k", k), ("v", v), ("o", out), ("g", dout),
                                      ("dq", dq), ("dk", dk))}
    params = _FlashBwdParams(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), out=out.data_ptr(),
        dout=dout.data_ptr(), lse=lse.data_ptr(), dq=dq.data_ptr(), dk=dk.data_ptr(),
        dv=dv.data_ptr(), lse_pad=scratch.data_ptr(),
        delta=scratch.data_ptr() + scratch.nbytes // 2,
        **{f"{t}_{n}": st[t][i] for t in st for i, n in ((0, "sb"), (1, "ss"), (2, "sh"))},
        batch=b, seq=s, heads=h, kv_heads=kh, head_dim=d, causal=int(bool(causal)),
        window=win, dtype=FLASH_DTYPES[q.dtype], seq_pad=seq_pad, scale=scale, **wide,
    )
    lib = load()
    # the raw handle of the current stream (a tenth of the host time of
    # current_stream(dev).cuda_stream); the launcher makes card `dev`
    # current for the launches where it is not
    _check(lib, lib.rm_flash_backward(ctypes.byref(params), dev,
                                      torch._C._cuda_getCurrentRawStream(dev)),
           "flash_attention_backward launch")
    _launched("flash_attention_backward")
    if dq is not dq_d:
        for padded, kept in ((dq, dq_d), (dk, dk_d), (dv, dv_d)):
            kept.copy_(padded[..., :kept.shape[3]])
    return dq_d, dk_d, dv_d


def w8_form(dtype: torch.dtype, k: int, n: int, q_ptr: int, s_ptr: int) -> str:
    """Which form of the W8 kernel takes a product (N a multiple of 8 and q
    8-byte aligned, checked by :func:`run_w8`): ``"tensor"`` (bf16 on the
    tensor cores: N a multiple of 16, q and s 16-byte aligned, K within
    ``W8_MAX_CLUSTER`` ranks of ``W8_TC_MAX_CHUNK`` rows), else
    ``"cuda_cores"``."""
    if (dtype == torch.bfloat16 and n % 16 == 0 and q_ptr % 16 == 0 and s_ptr % 16 == 0
            and k <= W8_MAX_CLUSTER * W8_TC_MAX_CHUNK):
        return "tensor"
    return "cuda_cores"


def w8_launch(m: int, k: int, ns: Sequence[int], n_sm: int, form: str = "tensor"
              ) -> tuple[tuple[int, int, int], int]:
    """The W8 kernel's plan for ``x (m, k)`` times the records' ``q (k,
    n)``, ``n`` in ``ns``: ``(grid, chunk)``, the grid (strips, K chunks, m
    tiles).

    Tensor cores (one launch for the group): a block owns 128 output columns
    of one record and 8 rows of x; K is cut into at most ``W8_MAX_CLUSTER``
    chunks of ``chunk`` rows (a multiple of ``W8_STAGE_ROWS``, each at least
    one stage), the blocks of one cluster along the grid's y.  The plan depends on K
    alone, so a product's sums are the same in a group or alone.  CUDA
    cores (one record): blocks of 256 columns; K split into chunks of
    ``chunk`` rows (a multiple of ``W8_MIN_CHUNK``, at most
    ``W8_MAX_CHUNK``) so that the grid holds about ``W8_BLOCKS_PER_SM``
    blocks an SM of ``n_sm``."""
    m_tiles = -(-m // W8_ROWS)
    if form == "tensor":
        stages = -(-k // W8_STAGE_ROWS)
        per_rank = -(-stages // W8_MAX_CLUSTER)
        strips = sum(-(-n // W8_TC_STRIP) for n in ns)
        return (strips, -(-stages // per_rank), m_tiles), per_rank * W8_STAGE_ROWS
    (n,) = ns
    strips = -(-n // W8_STRIP)
    want = max(1, -(-W8_BLOCKS_PER_SM * n_sm // (strips * m_tiles)))
    chunk = -(-k // want)
    chunk = -(-chunk // W8_MIN_CHUNK) * W8_MIN_CHUNK
    chunk = min(chunk, W8_MAX_CHUNK)
    return (strips, -(-k // chunk), m_tiles), chunk


_SM_COUNT: dict[int, int] = {}


def run_w8(x: torch.Tensor, records: Sequence[tuple[torch.Tensor, torch.Tensor]]
           ) -> list[torch.Tensor]:
    """Launch the int8-weight matmul ``y_r = x @ (q_r.to(dt) * s_r.to(dt))``
    for each record ``(q_r, s_r)`` of a group that shares x: x ``(M, K)``
    float32 or bfloat16 with ``1 <= M <= W8_MAX_ROWS``, each q ``(K, N)``
    int8 with N a multiple of 8, starting 8-byte aligned, s ``(1, N)``
    bfloat16, all contiguous on one card, at most ``W8_MAX_RECORDS``
    records.  Returns a new ``(M, N)`` tensor of x's type a record.  A group
    whose records all take the tensor cores (:func:`w8_form`) is one launch;
    otherwise each record is a launch of its own form (on the CUDA cores
    with K split, a float32 scratch of ``(splits, M, N)`` partials).
    Enqueues on the current stream without synchronising (a CUDA graph can
    capture it)."""
    if not 1 <= len(records) <= W8_MAX_RECORDS:
        raise ValueError(f"a group takes 1..{W8_MAX_RECORDS} records, got {len(records)}")
    if x.dtype not in FLASH_DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"want x (M, K), got {tuple(x.shape)}")
    m, k = x.shape
    if not 1 <= m <= W8_MAX_ROWS or k < 1:
        raise ValueError(f"the kernel takes 1..{W8_MAX_ROWS} rows and K >= 1; got M {m}, K {k}")
    tensors = [("x", x)]
    for i, (q, s) in enumerate(records):
        if q.dtype != torch.int8 or s.dtype != torch.bfloat16:
            raise ValueError(f"want an int8 q and a bfloat16 s, got {q.dtype} and {s.dtype}")
        if q.dim() != 2 or s.dim() != 2 or q.shape[0] != k or tuple(s.shape) != (1, q.shape[1]):
            raise ValueError(f"x {tuple(x.shape)}, q {tuple(q.shape)} and s {tuple(s.shape)} "
                             f"do not chain (record {i})")
        if q.shape[1] < 1 or q.shape[1] % 8:
            raise ValueError(f"N must be a positive multiple of 8, got {q.shape[1]} (record {i})")
        if q.device.type != "meta" and q.data_ptr() % 8:
            raise ValueError(f"q must start 8-byte aligned (record {i})")
        tensors += [(f"q[{i}]", q), (f"s[{i}]", s)]
    if x.device.type == "meta":
        if roofline.counting():
            roofline.record_kernel("w8_matmul", *roofline.w8_work(
                m, k, [q.shape[1] for q, _ in records], x.element_size()))
        return [x.new_empty((m, q.shape[1])) for q, _ in records]
    for name, t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA kernels need CUDA tensors, got {name} on {t.device}")
        if t.device != x.device:
            raise ValueError(f"x on {x.device} but {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    if dev not in _SM_COUNT:
        _SM_COUNT[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = load()
    _w8_init(lib, dev)

    forms = [w8_form(x.dtype, k, q.shape[1], q.data_ptr(), s.data_ptr()) for q, s in records]
    launches = ([("tensor", list(records))] if all(f == "tensor" for f in forms)
                else [(f, [r]) for f, r in zip(forms, records)])
    out = []
    for form, group in launches:
        if roofline.counting():
            roofline.record_kernel("w8_matmul", *roofline.w8_work(
                m, k, [q.shape[1] for q, _ in group], x.element_size()))
        params, ys, _partials = w8_params(x, group, form, _SM_COUNT[dev])
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            _check(lib, lib.rm_w8_matmul(ctypes.byref(params), stream), "w8_matmul launch")
        _launched("w8_matmul")
        W8_PRODUCTS["captured" if torch.cuda.is_current_stream_capturing()
                    else "launched"] += len(group)
        out += ys
    return out


def w8_params(x: torch.Tensor, group, form: str, n_sm: int
              ) -> tuple[_W8Params, list[torch.Tensor], torch.Tensor | None]:
    """The parameter block of one W8 launch of ``group`` (records that
    :func:`run_w8` has checked) in ``form``, planned by :func:`w8_launch`,
    with its new outputs and, on the CUDA cores with K split, its float32
    partials: ``(params, ys, partials)``."""
    m, k = x.shape
    ns = [q.shape[1] for q, _ in group]
    (_, splits, _), chunk = w8_launch(m, k, ns, n_sm, form)
    ys = [torch.empty((m, n), dtype=x.dtype, device=x.device) for n in ns]
    partials = (torch.empty((splits, m, ns[0]), dtype=torch.float32, device=x.device)
                if form == "cuda_cores" and splits > 1 else None)
    pad = [0] * (W8_MAX_RECORDS - len(group))
    params = _W8Params(
        x=x.data_ptr(),
        q=(ctypes.c_void_p * W8_MAX_RECORDS)(*[q.data_ptr() for q, _ in group], *pad),
        s=(ctypes.c_void_p * W8_MAX_RECORDS)(*[s.data_ptr() for _, s in group], *pad),
        y=(ctypes.c_void_p * W8_MAX_RECORDS)(*[y.data_ptr() for y in ys], *pad),
        partials=partials.data_ptr() if partials is not None else None,
        n=(ctypes.c_int32 * W8_MAX_RECORDS)(*ns, *pad), records=len(group),
        M=m, K=k, chunk=chunk, splits=splits, dtype=FLASH_DTYPES[x.dtype],
        form=W8_FORMS[form])
    return params, ys, partials


def moe_rows(cap: int) -> int:
    """The rows of ``rm_moe_ffn_kernel`` that take ``cap`` rows an expert:
    the least of ``MOE_ROWS`` at or above it."""
    for rows in MOE_ROWS:
        if cap <= rows:
            return rows
    raise ValueError(f"the MoE kernel takes at most {MOE_MAX_ROWS} rows an expert, got {cap}")


def run_moe(x: torch.Tensor, count: torch.Tensor, w0: torch.Tensor,
            w1: torch.Tensor | None) -> torch.Tensor:
    """Launch one stage of the expert FFN over ``x (E, cap, K)`` with
    ``count (E,)`` int64 kept rows an expert: with ``w1`` the gate/up stage,
    ``silu(x @ w0) * (x @ w1)``, else the down stage, ``x @ w0``; each
    weight ``(E, K, N)``; rows at or past an expert's count come out zero.
    All float32 or all bfloat16, contiguous, on one card, 16-byte aligned,
    ``1 <= cap <= MOE_MAX_ROWS``, K and N positive multiples of 8.  Returns
    a new ``(E, cap, N)`` tensor of x's type; enqueues on the current stream
    without synchronising (a CUDA graph can capture it)."""
    if x.dtype not in FLASH_DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"want x (E, cap, K), got {tuple(x.shape)}")
    e, cap, k = x.shape
    if not 1 <= e <= 65535:
        raise ValueError(f"the grid takes 1..65,535 experts, got {e}")
    rows = moe_rows(cap)
    weights = [("w0", w0)] + ([("w1", w1)] if w1 is not None else [])
    n = w0.shape[-1] if w0.dim() == 3 else -1
    for name, w in weights:
        if w.dtype != x.dtype:
            raise ValueError(f"{name} is {w.dtype}, x {x.dtype}: one type for all")
        if w.dim() != 3 or tuple(w.shape) != (e, k, n):
            raise ValueError(f"x {tuple(x.shape)} and {name} {tuple(w.shape)} do not chain "
                             f"(want ({e}, {k}, N), one N for both weights)")
    if k < 8 or k % 8 or n < 8 or n % 8:
        raise ValueError(f"K and N must be positive multiples of 8, got K {k}, N {n}")
    if count.dtype != torch.int64 or tuple(count.shape) != (e,):
        raise ValueError(f"want count ({e},) int64, got {count.dtype} {tuple(count.shape)}")
    if roofline.counting():
        # the whole FFN's work at its gate/up launch (the down launch adds
        # none): the experts with a kept row — all of them on meta, where
        # the counts are not known
        touched = e if x.device.type == "meta" else int((count > 0).sum())
        roofline.record_kernel("moe_ffn", *(roofline.moe_work(
            touched, e, cap, k, n, x.element_size()) if w1 is not None else (0, 0)))
    if x.device.type == "meta":
        return x.new_empty((e, cap, n))
    for name, t in [("x", x), ("count", count), *weights]:
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA kernels need CUDA tensors, got {name} on {t.device}")
        if t.device != x.device:
            raise ValueError(f"x on {x.device} but {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "count" and t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned")
    y = torch.empty((e, cap, n), dtype=x.dtype, device=x.device)
    params = _MoeParams(
        x=x.data_ptr(), count=count.data_ptr(), w0=w0.data_ptr(),
        w1=w1.data_ptr() if w1 is not None else None, y=y.data_ptr(),
        experts=e, cap=cap, K=k, N=n, rows=rows, dtype=FLASH_DTYPES[x.dtype],
        gated=int(w1 is not None))
    lib = load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _check(lib, lib.rm_moe_ffn(ctypes.byref(params), stream), "moe_ffn launch")
    _launched("moe_ffn")
    return y


@dataclasses.dataclass(frozen=True)
class RglruForwardPlan:
    """The launch of ``rm_rglru_scan_kernel``: ``lanes`` a block (one warp),
    ``steps`` a stage of its ring, ``stages`` in the ring, ``smem`` dynamic
    shared bytes a block (the ring, an mbarrier a stage and 128 bytes to
    align the ring), ``blocks`` in the grid (a block a batch row and
    ``lanes`` lanes of it), ``boxes`` (the stages a block walks, from step 0
    up) and ``form`` (how the ring is filled: ``"tma"``, a TMA box an
    operand a stage, or ``"async"``, a 4-byte ``cp.async`` copy a lane a
    step)."""

    lanes: int
    steps: int
    stages: int
    smem: int
    blocks: int
    boxes: int
    form: str


def rglru_forward_plan(b: int, s: int, w: int, aligned: bool) -> RglruForwardPlan:
    """The scan's launch at ``(B, S, W)``: the TMA form where W is a multiple
    of 4, ``aligned`` (a and x both start 16-byte aligned) and the grid at
    most ``RGLRU_FWD_TMA_BLOCKS``, else the ``cp.async`` form.  The C
    launcher checks ``blocks``, ``smem`` and the form against the kernel's
    constants and the inputs."""
    lanes, steps, stages = RGLRU_FWD_LANES, RGLRU_FWD_STEPS, RGLRU_FWD_STAGES
    blocks = b * -(-w // lanes)
    tma = aligned and w % 4 == 0 and blocks <= RGLRU_FWD_TMA_BLOCKS
    return RglruForwardPlan(lanes=lanes, steps=steps, stages=stages,
                            smem=stages * (2 * steps * lanes * 4 + 8) + 128, blocks=blocks,
                            boxes=-(-s // steps), form="tma" if tma else "async")


def rglru_scan_plan(a: torch.Tensor, x: torch.Tensor) -> RglruForwardPlan:
    """The plan :func:`run_rglru_scan` launches for ``a`` and ``x``: their
    shape and whether both start 16-byte aligned."""
    return rglru_forward_plan(*a.shape, aligned=(a.data_ptr() | x.data_ptr()) % 16 == 0)


def run_rglru_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Launch the RG-LRU recurrence ``h[:, t] = a[:, t] * h[:, t - 1] + x[:, t]``
    from ``h[:, -1] = 0`` over ``a`` and ``x (B, S, W)``: float32, contiguous,
    one shape, on one card.  Returns a new ``(B, S, W)`` float32 tensor, each
    step's multiply and add rounded apart (bit-equal to the sequential
    float32 loop).  One launch of ``rm_rglru_scan_kernel``: a warp a block,
    a and x through a ring of stages in shared memory, by TMA where W is a
    multiple of 4, both bases are 16-byte aligned and the grid is at most
    four blocks an SM, else by ``cp.async`` (:func:`rglru_scan_plan`).
    Enqueues on the current stream without synchronising or setting
    anything (a CUDA graph can capture it)."""
    for name, t in (("a", a), ("x", x)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device.type != "cuda" and not (t.device.type == "meta" == a.device.type):
            raise ValueError(f"the CUDA kernels need CUDA tensors, got {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.dim() != 3 or a.shape != x.shape:
        raise ValueError(f"want a and x of one shape (B, S, W), got {tuple(a.shape)} and "
                         f"{tuple(x.shape)}")
    if a.device != x.device:
        raise ValueError(f"a on {a.device} but x on {x.device}")
    b, s, w = a.shape
    if min(b, s, w) < 1 or max(b, s, w) >= 2**31:
        raise ValueError(f"B, S and W must be in [1, 2^31), got {tuple(a.shape)}")
    if -(-w // RGLRU_FWD_LANES) * b >= 2**31:
        raise ValueError(f"B · ceil(W / {RGLRU_FWD_LANES}) blocks must be below 2^31, got "
                         f"{tuple(a.shape)}")
    h = torch.empty_like(a)
    if roofline.counting():
        roofline.record_kernel("rglru_scan", *roofline.rglru_scan_work(b, s, w))
    if a.device.type == "meta":
        return h
    plan = rglru_scan_plan(a, x)
    params = _RglruParams(a=a.data_ptr(), x=x.data_ptr(), h=h.data_ptr(), batch=b, seq=s,
                          width=w, blocks=plan.blocks, smem=plan.smem,
                          form=RGLRU_FWD_FORMS[plan.form])
    lib = load()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        _check(lib, lib.rm_rglru_scan(ctypes.byref(params), stream), "rglru_scan launch")
    _launched("rglru_scan")
    return h


@dataclasses.dataclass(frozen=True)
class RglruBackwardPlan:
    """The launch of ``rm_rglru_scan_backward_kernel``: ``lanes`` a block
    (one warp), ``steps`` a stage of its TMA ring, ``stages`` in the ring,
    ``smem`` dynamic shared bytes a block (the ring, an mbarrier a stage and
    128 bytes to align the ring), ``blocks`` in the grid (a block a batch
    row and ``lanes`` lanes of it) and ``boxes`` (the stages a block walks,
    from the last step down)."""

    lanes: int
    steps: int
    stages: int
    smem: int
    blocks: int
    boxes: int


def rglru_backward_plan(b: int, s: int, w: int) -> RglruBackwardPlan:
    """The scan gradient's launch at ``(B, S, W)``; the C launcher checks
    ``blocks`` and ``smem`` against the kernel's constants."""
    lanes, steps, stages = RGLRU_BWD_LANES, RGLRU_BWD_STEPS, RGLRU_BWD_STAGES
    return RglruBackwardPlan(lanes=lanes, steps=steps, stages=stages,
                             smem=stages * 3 * steps * lanes * 4 + 8 * stages + 128,
                             blocks=b * -(-w // lanes), boxes=-(-s // steps))


def run_rglru_scan_backward(a: torch.Tensor, h: torch.Tensor,
                            dh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the RG-LRU recurrence's gradient: from ``a``, the forward's
    output ``h`` and its gradient ``dh (B, S, W)`` — float32, contiguous,
    one shape, on one card, W a multiple of 4 and each base 16-byte aligned
    (TMA's row strides and addresses) — returns new ``(da, dx)``, the reverse
    recurrence ``g = a[:, t + 1] * g + dh[:, t]`` from ``t = S - 1`` down,
    ``dx = g`` and ``da[:, t] = g[:, t] * h[:, t - 1]`` (``h[:, -1] = 0``),
    each multiply and add rounded apart: bit-equal to the plain reverse
    loop.  One launch of ``rm_rglru_scan_backward_kernel``, enqueued on the
    current stream without synchronising (a CUDA graph can capture it)."""
    names = (("a", a), ("h", h), ("dh", dh))
    for name, t in names:
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device.type != "cuda" and not (t.device.type == "meta" == a.device.type):
            raise ValueError(f"the CUDA kernels need CUDA tensors, got {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != a.device:
            raise ValueError(f"a on {a.device} but {name} on {t.device}")
    if a.dim() != 3 or a.shape != h.shape or a.shape != dh.shape:
        raise ValueError(f"want a, h and dh of one shape (B, S, W), got {tuple(a.shape)}, "
                         f"{tuple(h.shape)} and {tuple(dh.shape)}")
    b, s, w = a.shape
    if min(b, s, w) < 1 or max(b, s, w) >= 2**31:
        raise ValueError(f"B, S and W must be in [1, 2^31), got {tuple(a.shape)}")
    if w % 4:
        raise ValueError(f"W must be a multiple of 4 (TMA's 16-byte row stride), got {w}")
    plan = rglru_backward_plan(b, s, w)
    if plan.blocks >= 2**31:
        raise ValueError(f"B · ceil(W / {plan.lanes}) blocks must be below 2^31, got "
                         f"{plan.blocks}")
    if roofline.counting():
        roofline.record_kernel("rglru_scan_backward", *roofline.rglru_scan_backward_work(b, s, w))
    da, dx = torch.empty_like(a), torch.empty_like(a)
    if a.device.type == "meta":
        return da, dx
    for name, t in names:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned")
    params = _RglruBwdParams(a=a.data_ptr(), h=h.data_ptr(), dh=dh.data_ptr(),
                             da=da.data_ptr(), dx=dx.data_ptr(), batch=b, seq=s, width=w,
                             blocks=plan.blocks, smem=plan.smem)
    lib = load()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        _check(lib, lib.rm_rglru_scan_backward(ctypes.byref(params), stream),
               "rglru_scan_backward launch")
    _launched("rglru_scan_backward")
    return da, dx
