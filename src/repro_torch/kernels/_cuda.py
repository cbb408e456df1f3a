"""Build, load and launch the CUDA kernels (``csrc/rm_scan.cu``,
``csrc/rm_join.cu``).

The library is compiled by ``nvcc`` for ``sm_90a`` into a shared object with
a plain C interface and loaded with ``ctypes``.  It builds from the sources
in this checkout only, into ``build/repro_torch/`` at the repository root,
under a name keyed by a hash of the sources and flags — and only at the
first CUDA call, so importing this module needs neither ``nvcc`` nor a card.

Every scan launch goes through :func:`run`: it plans the launch (tile
height, shared-memory layout, per-block partial rows), allocates the outputs
with ``torch.empty``, launches on the current stream without synchronising,
and raises if the launch reports a CUDA error.  The hash-join probe has its
own parameter block and launcher, :func:`run_hash_join`, under the same
rules.  ``LAUNCHES`` counts the launches of each kernel; nothing else adds
to it.
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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the scan kernels, in the order of kKernels in rm_scan.cu (the index
# rm_max_blocks takes), then the hash-join probe of rm_join.cu
SCAN_KERNELS = ("project", "filter_project", "aggregate", "groupby_sum",
                "scan_multi")
KERNELS = SCAN_KERNELS + ("hash_join",)
LAUNCHES = dict.fromkeys(KERNELS, 0)
JOIN_THREADS = 256  # must match kJoinThreads in rm_join.cu
JOIN_MAX_BLOCKS = 1 << 20  # the probe's grid-stride loop covers any rest

# must match rm_common.cuh
THREADS = 256
MAX_REQ = 16
MAX_MAP = 512
PROJECT, FILTER, AGGREGATE, GROUPBY = range(4)
PRED_OPS = {"none": 0, "gt": 1, "lt": 2}

TILE_BYTES = 32 * 1024  # staged row tile per block
HIST_SMEM_BYTES = 64 * 1024  # group-by histograms kept in shared memory
PARTIAL_BYTES = 64 << 20  # cap on the per-block partials buffer
SMEM_MAX = 227 * 1024  # what one block may use on Hopper


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
        "map_smem", "slot_smem")] + [
        ("req", _Req * MAX_REQ), ("map", ctypes.c_int32 * MAX_MAP)]


class _JoinParams(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "words", "keys", "vals", "begin", "end", "s_out", "r_out", "m_out")] + [
        ("n", ctypes.c_longlong)] + [(name, ctypes.c_int32) for name in (
            "row_words", "key_word", "val_word", "ts_word", "ts", "build_ts",
            "shift", "cap")]


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


def plan(reqs: Sequence[KernelReq], row_words: int) -> Plan:
    """Lay out one launch; raises if it cannot fit the kernels' limits."""
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
    map_smem = _round4(tile_words)
    slot_smem = _round4(map_smem + len(maps))
    top = slot_smem + 2 * n_slots * THREADS
    for i, r in enumerate(reqs):
        if r.kind == GROUPBY and hist_bytes + 8 * r.num_groups <= HIST_SMEM_BYTES:
            hist_off[i] = top
            top += 2 * r.num_groups
            hist_bytes += 8 * r.num_groups
    return Plan(rows, maps, map_off, red_off, hist_off, slot, map_smem,
                slot_smem, n_slots, part_w, top * 4)


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
    """Compile the library unless this source hash is already built."""
    global BUILD_LOG
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


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
    lib.rm_hash_join.argtypes = [ctypes.POINTER(_JoinParams), ctypes.c_int,
                                 ctypes.c_void_p]
    lib.rm_hash_join.restype = ctypes.c_int
    lib.rm_join_params_size.restype = ctypes.c_int
    for c_size, struct in ((lib.rm_params_size(), _Params),
                           (lib.rm_join_params_size(), _JoinParams)):
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
    if len(reqs) > 1 and kernel != "scan_multi":
        raise ValueError(f"{kernel} takes one request")
    lib = load()
    fn = getattr(lib, f"rm_{kernel}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for group in split(reqs):
            sub = [reqs[i] for i in group]
            pl = plan(sub, row_words)
            n_tiles = -(-n // pl.tile_rows)
            n_blocks = min(n_tiles, _max_blocks(lib, kernel, pl.smem_bytes, device))
            if pl.part_w:
                n_blocks = max(1, min(n_blocks, PARTIAL_BYTES // (4 * pl.part_w)))
            partials = torch.empty(n_blocks * pl.part_w, dtype=torch.float32,
                                   device=device)
            params = _Params(
                words=words.data_ptr(), partials=partials.data_ptr(), n=n,
                row_words=row_words, tile_rows=pl.tile_rows, n_req=len(sub),
                map_len=len(pl.map), part_w=pl.part_w, n_slots=pl.n_slots,
                map_smem=pl.map_smem, slot_smem=pl.slot_smem,
            )
            params.map[: len(pl.map)] = pl.map
            for j, (i, r) in enumerate(zip(group, sub)):
                out = results[i][0] if r.kind == FILTER else results[i]
                params.req[j] = _Req(
                    kind=r.kind, out_w=len(r.words), map_off=pl.map_off[j],
                    pred_word=r.pred_word, pred_float=int(r.pred_float),
                    pred_op=PRED_OPS[r.pred_op], k_bits=r.k_bits,
                    ts_word=r.ts_word, ts=r.ts, agg_word=r.agg_word,
                    agg_float=int(r.agg_float), group_word=r.group_word,
                    num_groups=r.num_groups, red_off=pl.red_off[j],
                    hist_off=pl.hist_off[j], slot=pl.slot[j],
                    out=out.data_ptr() if r.kind in (PROJECT, FILTER) else None,
                    mask=results[i][1].data_ptr() if r.kind == FILTER else None,
                )
            _check(lib, fn(ctypes.byref(params), n_blocks, pl.smem_bytes, stream),
                   f"{kernel} launch")
            LAUNCHES[kernel] += 1
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


def run_hash_join(words: torch.Tensor, partitions, key_word: int,
                  val_word: int, ts_word: int, ts: int,
                  build_ts: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the hash-join probe over ``words`` against ``partitions``
    (four ``(P, C)`` int32 tensors: keys, vals, begin, end); returns
    ``(s_proj int32, r_proj int32, matched bool)`` of ``N`` rows.  The
    caller has checked words, offsets and bucket shapes
    (``rme_join.check_probe``); a zero-row input launches nothing."""
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
    params = _JoinParams(
        words=words.data_ptr(), keys=parts[0].data_ptr(),
        vals=parts[1].data_ptr(), begin=parts[2].data_ptr(),
        end=parts[3].data_ptr(), s_out=s_out.data_ptr(),
        r_out=r_out.data_ptr(), m_out=m_out.data_ptr(), n=n,
        row_words=row_words, key_word=key_word, val_word=val_word,
        ts_word=ts_word, ts=ts, build_ts=int(build_ts),
        shift=32 - (p.bit_length() - 1), cap=cap,
    )
    n_blocks = min(-(-n // JOIN_THREADS), JOIN_MAX_BLOCKS)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _check(lib, lib.rm_hash_join(ctypes.byref(params), n_blocks, stream),
               "hash_join launch")
    LAUNCHES["hash_join"] += 1
    return s_out, r_out, m_out
