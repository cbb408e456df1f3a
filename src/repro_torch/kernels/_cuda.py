"""Build, load and launch the CUDA kernels (``csrc/rm_scan.cu``,
``csrc/rm_join.cu``, ``csrc/rm_project.cu``, ``csrc/rm_flash.cu``,
``csrc/rm_w8.cu``).

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
and raises if the launch reports a CUDA error.  The hash-join probe, the
BSL / PCK projection revisions, the compacting selection, the GQA
flash-attention forward and the int8-weight decode matmul have their own
parameter blocks and launchers (:func:`run_hash_join`, :func:`run_columns`,
:func:`run_select`, :func:`run_flash`, :func:`run_w8`) under the same rules.
``LAUNCHES`` counts the launches each wrapper makes, and nothing else: a
call inside a CUDA graph's capture records its kernel without launching it
and counts nothing, and the graph's replays launch it without the wrapper
(``torch.profiler`` sees those).  ``CAPTURED`` counts, in the same units,
the calls that a capture recorded instead: a graph replays each once.  ``hash_join`` counts one for each
probe, which is two kernels on the card: the bucket repack
(``rm_join_prepare_kernel``), then the probe (``rm_hash_join_kernel``);
``w8_matmul`` one for each product, which is two kernels when K is split
(``rm_w8_matmul_kernel``, then ``rm_w8_reduce_kernel``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

import torch

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
                          "select_compact", "flash_attention", "w8_matmul")
MULTI_REQUEST = ("scan_multi", "project_multi")  # kernels taking many requests
LAUNCHES = dict.fromkeys(KERNELS, 0)
CAPTURED = dict.fromkeys(KERNELS, 0)  # wrapper calls recorded into a graph
JOIN_THREADS = 256  # must match kJoinThreads in rm_join.cu
JOIN_SECTOR = 32  # bytes: wider probe rows take the probe's streaming form
MAX_GRID_BLOCKS = 1 << 20  # grid-stride kernels: their loops cover any rest
MAX_COLS = 256  # column slices of one BSL / PCK launch (kMaxCols, rm_project.cu)
FLASH_HEAD_DIMS = (16, 32, 64, 128, 256)  # the head widths rm_flash.cu instantiates
FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # FlashParams::dtype
W8_MAX_ROWS = 64  # rows of x the int8-weight matmul takes (a decode step's B)
W8_STRIP = 256  # output columns a block of rm_w8_matmul_kernel (kW8Strip)
W8_TC_STRIP = 128  # output columns a block of rm_w8_matmul_tc_kernel (kW8TcStrip)
W8_FORMS = {"cuda_cores": 0, "tensor": 1}  # W8Params::form
W8_ROWS = 8  # rows of x a block (kW8Rows)
W8_MIN_CHUNK = 128  # K rows a block at least: 32 a warp
W8_MAX_CHUNK = 1024  # K rows a block at most (kW8MaxChunk): the staged x
W8_BLOCKS_PER_SM = 4  # the grid the split of K aims for

# must match rm_common.cuh
THREADS = 256
MAX_REQ = 16
MAX_MAP = 512
PROJECT, FILTER, AGGREGATE, GROUPBY = range(4)
PRED_OPS = {"none": 0, "gt": 1, "lt": 2}

TILE_BYTES = 32 * 1024  # staged row tile per block
SCAN_RING = 2  # tiles in scan_multi's ring (kScanRing; load() checks rm_scan_ring())
HIST_SMEM_BYTES = 64 * 1024  # group-by histograms kept in shared memory
PARTIAL_BYTES = 64 << 20  # cap on the per-block partials buffer
SMEM_MAX = 227 * 1024  # what one block may use on Hopper


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        CAPTURED[k] = 0


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
        ("n", ctypes.c_longlong),
    ] + [(name, ctypes.c_int32) for name in (
        "row_words", "tile_rows", "n_req", "map_len", "part_w", "n_slots",
        "map_smem", "slot_smem", "tile_stride", "pad_")] + [
        ("req", _Req * MAX_REQ), ("map", ctypes.c_int32 * MAX_MAP)]


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
            "row_words", "out_w", "n_cols", "tile_rows")] + [
        (name, ctypes.c_int32 * MAX_COLS) for name in ("src", "dst", "width")]


class _SelectParams(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in ("words", "out", "counts")] + [
        ("n", ctypes.c_longlong)] + [(name, ctypes.c_int32) for name in (
            "row_words", "out_w", "block_rows", "pad_")] + [
        ("q", _Req), ("map", ctypes.c_int32 * MAX_MAP)]


class _W8Params(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in ("x", "q", "s", "y", "partials")] + [
        (name, ctypes.c_int32) for name in (
            "M", "K", "N", "chunk", "splits", "dtype", "form", "pad_")]


class _FlashParams(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in ("q", "k", "v", "out")] + [
        (f"{t}_{s}", ctypes.c_longlong) for t in "qkvo" for s in ("sb", "ss", "sh")] + [
        (name, ctypes.c_int32) for name in (
            "batch", "seq", "heads", "kv_heads", "head_dim", "causal", "window",
            "dtype")] + [("scale", ctypes.c_float), ("pad_", ctypes.c_int32)]


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
    tile_stride: int  # words between the ring's tiles
    map: list[int]
    map_off: list[int]
    red_off: list[int]  # -1 for blocked requests
    hist_off: list[int]  # -1: histogram in global memory (or none)
    slot: list[int]
    map_smem: int
    slot_smem: int
    n_slots: int
    part_w: int
    smem_bytes: int


def _round4(x: int) -> int:
    return -(-x // 4) * 4


def plan(reqs: Sequence[KernelReq], row_words: int, stages: int = 1) -> Plan:
    """Lay out one launch; raises if it cannot fit the kernels' limits.

    ``stages`` tiles of the row tile come first (scan_multi's ring; 1 for
    the single-request kernels), then the word map, the aggregate slots and
    the group-by histograms that fit ``HIST_SMEM_BYTES``."""
    if not 0 < len(reqs) <= MAX_REQ:
        raise ValueError(f"a launch carries 1..{MAX_REQ} requests, got {len(reqs)}")
    for r in reqs:
        bad = [w for w in r.touched() if not 0 <= w < row_words]
        if bad:
            raise ValueError(f"words {bad} outside the {row_words}-word row")
        if r.pred_op not in PRED_OPS:
            raise ValueError(r.pred_op)
        if r.kind == GROUPBY and r.num_groups < 1:
            raise ValueError("num_groups must be positive")
    rows = tile_rows(row_words)
    tile_words = rows * row_words
    if tile_words * 4 > SMEM_MAX // 2:
        raise ValueError(f"rows of {row_words} words are too wide to stage")
    maps, map_off, red_off, hist_off, slot = [], [], [], [], []
    part_w = n_slots = hist_bytes = 0
    for r in reqs:
        map_off.append(len(maps))
        maps += list(r.words)
        red_off.append(part_w if r.kind in (AGGREGATE, GROUPBY) else -1)
        part_w += {AGGREGATE: 2, GROUPBY: 2 * r.num_groups}.get(r.kind, 0)
        slot.append(n_slots if r.kind == AGGREGATE else -1)
        n_slots += r.kind == AGGREGATE
        hist_off.append(-1)
    if len(maps) > MAX_MAP:
        raise ValueError(f"{len(maps)} packed words exceed one launch's {MAX_MAP}")
    stride = _round4(tile_words)  # keeps every tile 16-byte aligned
    map_smem = stages * stride
    slot_smem = _round4(map_smem + len(maps))
    top = slot_smem + 2 * n_slots * THREADS
    for i, r in enumerate(reqs):
        if r.kind == GROUPBY and hist_bytes + 8 * r.num_groups <= HIST_SMEM_BYTES:
            hist_off[i] = top
            top += 2 * r.num_groups
            hist_bytes += 8 * r.num_groups
    if top * 4 > SMEM_MAX:
        raise ValueError(f"{stages} tiles of {row_words}-word rows and the launch's "
                         f"slots need {top * 4} B of shared memory, over {SMEM_MAX}")
    return Plan(rows, stride, maps, map_off, red_off, hist_off, slot,
                map_smem, slot_smem, n_slots, part_w, top * 4)


def split(reqs: Sequence[KernelReq]) -> list[list[int]]:
    """Indices of ``reqs`` in groups that each fit one launch."""
    groups: list[list[int]] = [[]]
    words = 0
    for i, r in enumerate(reqs):
        if groups[-1] and (len(groups[-1]) == MAX_REQ
                           or words + len(r.words) > MAX_MAP):
            groups.append([])
            words = 0
        groups[-1].append(i)
        words += len(r.words)
    return groups


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
    lib.rm_max_blocks.argtypes = [ctypes.c_int, ctypes.c_longlong,
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
    lib.rm_project_bsl.argtypes = [ctypes.POINTER(_ColParams), ctypes.c_void_p]
    lib.rm_project_pck.argtypes = [ctypes.POINTER(_ColParams), ctypes.c_int,
                                   ctypes.c_longlong, ctypes.c_void_p]
    lib.rm_select_compact.argtypes = [ctypes.POINTER(_SelectParams),
                                      ctypes.c_longlong, ctypes.c_void_p]
    lib.rm_flash_attention.argtypes = [ctypes.POINTER(_FlashParams), ctypes.c_void_p]
    lib.rm_w8_matmul.argtypes = [ctypes.POINTER(_W8Params), ctypes.c_void_p]
    for fn in (lib.rm_project_bsl, lib.rm_project_pck, lib.rm_select_compact,
               lib.rm_col_params_size, lib.rm_select_params_size,
               lib.rm_flash_attention, lib.rm_flash_params_size,
               lib.rm_w8_matmul, lib.rm_w8_params_size):
        fn.restype = ctypes.c_int
    for c_size, struct in ((lib.rm_params_size(), _Params),
                           (lib.rm_join_params_size(), _JoinParams),
                           (lib.rm_col_params_size(), _ColParams),
                           (lib.rm_select_params_size(), _SelectParams),
                           (lib.rm_flash_params_size(), _FlashParams),
                           (lib.rm_w8_params_size(), _W8Params)):
        if c_size != ctypes.sizeof(struct):
            raise RuntimeError(
                f"{struct.__name__} layout differs: C {c_size} bytes, ctypes "
                f"{ctypes.sizeof(struct)} bytes"
            )
    _LIB = lib
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what}: CUDA error {err} ({lib.rm_error_string(err).decode()})")


_MAX_BLOCKS: dict[tuple, int] = {}
_JOIN_STREAM_BLOCKS: dict[int, int] = {}


def _max_blocks(lib: ctypes.CDLL, kernel: str, smem: int,
                device: torch.device) -> int:
    key = (kernel, smem, device.index)
    if key not in _MAX_BLOCKS:
        blocks = ctypes.c_int(0)
        _check(lib, lib.rm_max_blocks(KERNELS.index(kernel), smem,
                                      ctypes.byref(blocks)), f"{kernel} occupancy")
        if blocks.value <= 0:
            raise RuntimeError(f"{kernel}: no block fits with {smem} B shared memory")
        _MAX_BLOCKS[key] = blocks.value
    return _MAX_BLOCKS[key]


# ---------------------------------------------------------------- launching
def check_words(words: torch.Tensor) -> None:
    """What the kernels take: a contiguous 2-D int32 tensor on the card."""
    if words.device.type != "cuda":
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
    field set but the pointers and the row count."""
    out = []
    for group in split(reqs):
        sub = [reqs[i] for i in group]
        pl = plan(sub, row_words, stages)
        params = _Params(
            row_words=row_words, tile_rows=pl.tile_rows, n_req=len(sub),
            map_len=len(pl.map), part_w=pl.part_w, n_slots=pl.n_slots,
            map_smem=pl.map_smem, slot_smem=pl.slot_smem,
            tile_stride=pl.tile_stride,
        )
        params.map[: len(pl.map)] = pl.map
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
    lib = load()
    fn = getattr(lib, f"rm_{kernel}")
    stages = SCAN_RING if kernel == "scan_multi" else 1
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for group, pl, params in launch_groups(reqs, row_words, stages):
            sub = [reqs[i] for i in group]
            n_tiles = -(-n // pl.tile_rows)
            n_blocks = min(n_tiles, _max_blocks(lib, kernel, pl.smem_bytes, device))
            if pl.part_w:
                n_blocks = max(1, min(n_blocks, PARTIAL_BYTES // (4 * pl.part_w)))
            partials = torch.empty(n_blocks * pl.part_w, dtype=torch.float32,
                                   device=device)
            params.words, params.partials, params.n = words.data_ptr(), partials.data_ptr(), n
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


def run_columns(kernel: str, words: torch.Tensor,
                slices: Sequence[tuple[int, int, int]], out_w: int) -> torch.Tensor:
    """Launch a column-walking projection revision (``"project_bsl"`` or
    ``"project_pck"``) over ``words``; ``slices`` holds ``(src_word,
    dst_word, width_words)`` per enabled column.  Returns the packed
    ``(N, out_w)`` int32 block; a zero-row input launches nothing."""
    check_words(words)
    n, row_words = words.shape
    if not 0 < len(slices) <= MAX_COLS:
        raise ValueError(f"a launch carries 1..{MAX_COLS} columns, got {len(slices)}")
    for src, dst, w in slices:
        if not (w > 0 and 0 <= src and src + w <= row_words and 0 <= dst
                and dst + w <= out_w):
            raise ValueError(f"column slice {(src, dst, w)} outside the "
                             f"{row_words}-word row or the {out_w}-word output")
    out = torch.empty((n, out_w), dtype=torch.int32, device=words.device)
    if n == 0:
        return out
    rows = tile_rows(out_w)
    smem = rows * out_w * 4
    if smem > SMEM_MAX:
        raise ValueError(f"packed rows of {out_w} words are too wide to stage")
    params = _ColParams(words=words.data_ptr(), out=out.data_ptr(), n=n,
                        row_words=row_words, out_w=out_w, n_cols=len(slices),
                        tile_rows=rows)
    for j, (src, dst, w) in enumerate(slices):
        params.src[j], params.dst[j], params.width[j] = src, dst, w
    lib = load()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        if kernel == "project_bsl":
            err = lib.rm_project_bsl(ctypes.byref(params), stream)
        elif kernel == "project_pck":
            n_blocks = min(-(-n // rows), MAX_GRID_BLOCKS)
            err = lib.rm_project_pck(ctypes.byref(params), n_blocks, smem, stream)
        else:
            raise ValueError(kernel)
        _check(lib, err, f"{kernel} launch")
    _launched(kernel)
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
    if not 0 < len(req.words) <= MAX_MAP:
        raise ValueError(f"1..{MAX_MAP} packed words, got {len(req.words)}")
    bad = [w for w in req.touched() if not 0 <= w < row_words]
    if bad:
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
    params.map[:out_w] = req.words
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


def run_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
              window: int | None) -> torch.Tensor:
    """Launch the GQA flash-attention forward: q ``(B, S, H, D)``, k and v
    ``(B, S, KH, D)`` (the caller, ``flash_attention``, has checked the
    shapes), on one card, all float32 or all bfloat16, each with a unit
    stride along D (the other strides are free: the kernels read the layout
    through them).  bfloat16 goes to the tensor-core kernel, whose TMA loads
    also need a 16-byte aligned base and strides of multiples of 16 bytes
    (:func:`check_flash_tma`); float32 to the CUDA-core kernel.  Returns a
    new contiguous ``(B, S, H, D)`` output of q's type; an empty input
    launches nothing."""
    b, s, h, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in FLASH_DTYPES or t.dtype != q.dtype:
            raise ValueError(f"q, k and v must all be float32 or all bfloat16, got "
                             f"{q.dtype}, {k.dtype}, {v.dtype}")
        if t.numel() and t.stride(3) != 1:
            raise ValueError(f"{name} needs a unit stride along D, got strides {t.stride()}")
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not one of {FLASH_HEAD_DIMS}")
    if q.dtype == torch.bfloat16 and q.numel() and k.numel():
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_flash_tma(name, t.shape, t.stride(), t.element_size(), t.data_ptr())
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA kernels need CUDA tensors, got {name} on {t.device}")
        if t.device != q.device:
            raise ValueError(f"q on {q.device} but {name} on {t.device}")
    win = s if window is None else int(window)
    if win < 1:
        raise ValueError(f"window must be positive, got {window}")
    if b * h > 65535:
        raise ValueError(f"B * H = {b * h} exceeds the grid's 65,535 rows")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    st = {n: flash_tma_strides(t.shape, t.stride())
          for n, t in (("q", q), ("k", k), ("v", v), ("o", out))}
    params = _FlashParams(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), out=out.data_ptr(),
        **{f"{t}_{n}": st[t][i] for t in "qkvo" for i, n in ((0, "sb"), (1, "ss"), (2, "sh"))},
        batch=b, seq=s, heads=h, kv_heads=k.shape[2], head_dim=d,
        causal=int(bool(causal)), window=min(win, s), dtype=FLASH_DTYPES[q.dtype],
        scale=d ** -0.5,
    )
    lib = load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _check(lib, lib.rm_flash_attention(ctypes.byref(params), stream),
               "flash_attention launch")
    _launched("flash_attention")
    return out


def w8_form(dtype: torch.dtype, n: int, q_ptr: int, s_ptr: int) -> str:
    """Which form of the W8 kernel takes a product (N a multiple of 8 and q
    8-byte aligned, checked by :func:`run_w8`): ``"tensor"`` (bf16 on the
    tensor cores: N a multiple of 16, q and s 16-byte aligned), else
    ``"cuda_cores"``."""
    if dtype == torch.bfloat16 and n % 16 == 0 and q_ptr % 16 == 0 and s_ptr % 16 == 0:
        return "tensor"
    return "cuda_cores"


def w8_launch(m: int, k: int, n: int, n_sm: int,
              form: str = "tensor") -> tuple[int, int, int, int]:
    """The W8 kernel's grid for ``x (m, k) @ q (k, n)`` on a card of
    ``n_sm`` SMs: ``(strips, splits, m_tiles, chunk)``.  Blocks of 128
    (tensor cores) or 256 output columns and 8 rows of x; K is split into
    chunks of ``chunk`` rows (a multiple of ``W8_MIN_CHUNK``, at most
    ``W8_MAX_CHUNK``) so that the grid holds about ``W8_BLOCKS_PER_SM``
    blocks an SM."""
    strip = W8_TC_STRIP if form == "tensor" else W8_STRIP
    strips, m_tiles = -(-n // strip), -(-m // W8_ROWS)
    want = max(1, -(-W8_BLOCKS_PER_SM * n_sm // (strips * m_tiles)))
    chunk = -(-k // want)
    chunk = -(-chunk // W8_MIN_CHUNK) * W8_MIN_CHUNK
    chunk = min(chunk, W8_MAX_CHUNK)
    return strips, -(-k // chunk), m_tiles, chunk


_SM_COUNT: dict[int, int] = {}


def run_w8(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Launch the int8-weight matmul ``y = x @ (q.to(dt) * s.to(dt))``: x
    ``(M, K)`` float32 or bfloat16 with ``1 <= M <= W8_MAX_ROWS``, q ``(K,
    N)`` int8 with N a multiple of 8, starting 8-byte aligned, s ``(1, N)``
    bfloat16, all contiguous on one card; the form by :func:`w8_form`.  Returns a new ``(M, N)`` tensor of x's type; with K
    split, a float32 scratch of ``(splits, M, N)`` partials.  Enqueues on
    the current stream without synchronising (a CUDA graph can capture
    it)."""
    if x.dtype not in FLASH_DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if q.dtype != torch.int8 or s.dtype != torch.bfloat16:
        raise ValueError(f"want an int8 q and a bfloat16 s, got {q.dtype} and {s.dtype}")
    if x.dim() != 2 or q.dim() != 2 or s.dim() != 2:
        raise ValueError(f"want x (M, K), q (K, N), s (1, N); got {tuple(x.shape)}, "
                         f"{tuple(q.shape)}, {tuple(s.shape)}")
    (m, k), n = x.shape, q.shape[1]
    if q.shape[0] != k or tuple(s.shape) != (1, n):
        raise ValueError(f"x {tuple(x.shape)}, q {tuple(q.shape)} and s {tuple(s.shape)} "
                         f"do not chain")
    if not 1 <= m <= W8_MAX_ROWS or k < 1 or n < 1 or n % 8:
        raise ValueError(f"the kernel takes 1..{W8_MAX_ROWS} rows, K >= 1 and N a multiple "
                         f"of 8; got M {m}, K {k}, N {n}")
    for name, t in (("x", x), ("q", q), ("s", s)):
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA kernels need CUDA tensors, got {name} on {t.device}")
        if t.device != x.device:
            raise ValueError(f"x on {x.device} but {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.data_ptr() % 8:
        raise ValueError("q must start 8-byte aligned")
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    if dev not in _SM_COUNT:
        _SM_COUNT[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    form = w8_form(x.dtype, n, q.data_ptr(), s.data_ptr())
    _, splits, _, chunk = w8_launch(m, k, n, _SM_COUNT[dev], form)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    partials = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
                if splits > 1 else None)
    params = _W8Params(
        x=x.data_ptr(), q=q.data_ptr(), s=s.data_ptr(), y=y.data_ptr(),
        partials=partials.data_ptr() if partials is not None else None,
        M=m, K=k, N=n, chunk=chunk, splits=splits, dtype=FLASH_DTYPES[x.dtype],
        form=W8_FORMS[form])
    lib = load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _check(lib, lib.rm_w8_matmul(ctypes.byref(params), stream), "w8_matmul launch")
    _launched("w8_matmul")
    return y
