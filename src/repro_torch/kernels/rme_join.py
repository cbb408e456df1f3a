"""Device-resident hash equi-join — the port of ``repro.kernels.rme_join``.

* :func:`build_partitions` hash-partitions the build side's ``{key, payload,
  __ts_begin, __ts_end}`` column words into **static buckets** on the
  engine's device — a ``(P, C)`` tensor per column, ``P`` buckets of
  capacity ``C`` (the observed maximum occupancy, so nothing overflows).
  The host-side partitioning is numpy and byte-identical to the
  reference's; the planner caches the result per build-table version.
* :func:`hash_join` probes a row-store chunk or a packed block against the
  buckets and returns one slot per probe row: ``(s_proj, r_proj, matched)``.
  On a CUDA tensor it launches ``rm_hash_join_kernel`` (``csrc/rm_join.cu``,
  the Hopper form of the reference's ``_probe_kernel``); on a CPU tensor it
  runs :func:`hash_join_torch`, the plain version (the counterpart of the
  reference's ``hash_join_xla``).

The bucket hash is Fibonacci multiplicative hashing, ``bucket = (key *
2654435761) >>> (32 - log2 P)`` on the key's unsigned 32-bit pattern — the
same top bits in numpy (:func:`bucket_of_np`), in plain PyTorch
(:func:`bucket_of`) and in the kernel.  Empty slots hold a key fill that
provably hashes to another bucket (:func:`bucket_fills`), so they never
match.  Under ``build_ts`` the build rows' bucketed timestamps take the
snapshot test too, so one cached partition set serves every snapshot.

A build side with repeated keys (MVCC version pairs after updates, or a
broken primary-key contract) matches every equal slot: ``r_proj`` is then
the int32 sum of their payloads, wrapping as the reference's does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _cuda

# target average bucket occupancy: P is the smallest power of two with
# n_rows / P <= TARGET_BUCKET_LOAD (capacity C is then the observed maximum)
TARGET_BUCKET_LOAD = 16

# Fibonacci hashing constant (2654435761 = floor(2^32 / golden ratio))
MIX = 2654435761
MIX_UINT32 = np.uint32(MIX)

# the plain version gathers (rows, C) slots per column: it walks the probe
# rows in slices of about this many slot words to bound its memory
PLAIN_SLICE_WORDS = 1 << 26


class JoinPartitions(NamedTuple):
    """The build side as static buckets: four ``(P, C)`` int32 tensors on
    one device.  A NamedTuple, so the planner's build cache accounts an
    entry's bytes by iterating it, as it does for the sorted-index tuples.
    Empty ``keys`` slots hold fills that hash to another bucket; their
    ``begin=1, end=0`` timestamps are never visible either."""

    keys: torch.Tensor  # (P, C) raw int32 key words
    vals: torch.Tensor  # (P, C) raw int32 payload words
    begin: torch.Tensor  # (P, C) __ts_begin of each build row
    end: torch.Tensor  # (P, C) __ts_end of each build row

    @property
    def num_buckets(self) -> int:
        return self.keys.shape[0]

    @property
    def capacity(self) -> int:
        return self.keys.shape[1]

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self)


def num_buckets_for(n_rows: int) -> int:
    """Smallest power-of-two bucket count with average load <= the target
    (never below 2, so the hash has at least one output bit)."""
    p = 2
    while p * TARGET_BUCKET_LOAD < n_rows:
        p <<= 1
    return p


def bucket_of_np(key: np.ndarray, p: int) -> np.ndarray:
    """Fibonacci bucket hash, numpy spelling: top ``log2 p`` bits of the
    wrapped ``key * 2654435761`` product."""
    mixed = np.asarray(key, dtype=np.int32).view(np.uint32) * MIX_UINT32
    return (mixed >> np.uint32(32 - (p.bit_length() - 1))).astype(np.int64)


def bucket_of(key: torch.Tensor, p: int) -> torch.Tensor:
    """Fibonacci bucket hash on int32 keys, PyTorch spelling, as int64
    bucket indices — bit-identical to :func:`bucket_of_np`.  The 32-bit
    wrapped product is formed from 16-bit halves of the key, so no int64
    product can overflow."""
    k = key.to(torch.int64) & 0xFFFFFFFF
    lo = (k & 0xFFFF) * MIX
    hi = (((k >> 16) * MIX) & 0xFFFF) << 16
    mixed = (lo + hi) & 0xFFFFFFFF
    return mixed >> (32 - (p.bit_length() - 1))


def bucket_fills(p: int) -> np.ndarray:
    """Per-bucket empty-slot key fills that provably never false-match:
    ``hash(0) = 0`` (safe everywhere but bucket 0) and ``hash(1) =
    2654435761 >>> (32 - log2 p) >= 1`` for any ``p >= 2`` (safe in bucket
    0)."""
    fills = np.zeros(p, dtype=np.int32)
    fills[0] = 1
    return fills


def estimated_partition_bytes(n_rows: int) -> int:
    """Planner-side estimate of a build table's partition bytes (four
    ``(P, C)`` int32 arrays at the target load), available before anything
    is built."""
    p = num_buckets_for(n_rows)
    c = max(1, -(-n_rows // p))
    return 4 * p * c * 4


def partitions_from_numpy(keys: np.ndarray, vals: np.ndarray,
                          begin: np.ndarray, end: np.ndarray,
                          device: str | torch.device = "cpu") -> JoinPartitions:
    """A partition set from four ``(P, C)`` int32 numpy arrays — how a set
    built elsewhere (the reference package's, a file) is carried across."""
    # own copies: the caller's arrays may be read-only or change later
    arrs = [np.array(a, dtype=np.int32, order="C") for a in (keys, vals, begin, end)]
    shape = arrs[0].shape
    if len(shape) != 2 or any(a.shape != shape for a in arrs):
        raise ValueError(f"want four equal (P, C) arrays, got {[a.shape for a in arrs]}")
    p = shape[0]
    if p < 2 or p & (p - 1):
        raise ValueError(f"the bucket count must be a power of two >= 2, got {p}")
    return JoinPartitions(*(torch.from_numpy(a).to(device) for a in arrs))


def build_partitions(
    key: np.ndarray,
    val: np.ndarray,
    ts_begin: np.ndarray | None = None,
    ts_end: np.ndarray | None = None,
    device: str | torch.device = "cpu",
) -> JoinPartitions:
    """Hash-partition the build side's raw column words into buckets on
    ``device``.  Host-side numpy, run once per build-table version; the
    returned tensors are the device-resident state every later probe
    reuses."""
    key = np.asarray(key, dtype=np.int32)
    val = np.asarray(val, dtype=np.int32)
    n = key.shape[0]
    p = num_buckets_for(n)
    g = bucket_of_np(key, p)
    counts = np.bincount(g, minlength=p)
    cap = max(int(counts.max()) if n else 1, 1)
    # slot index of each row within its bucket (stable order within buckets)
    order = np.argsort(g, kind="stable")
    starts = np.cumsum(counts) - counts
    slot = np.arange(n, dtype=np.int64) - np.repeat(starts, counts)
    gb = g[order]

    def scatter(fill: np.ndarray, values: np.ndarray) -> np.ndarray:
        arr = np.broadcast_to(fill[:, None], (p, cap)).copy()
        arr[gb, slot] = values[order]
        return arr

    return partitions_from_numpy(
        scatter(bucket_fills(p), key),  # fills provably never match
        scatter(np.zeros(p, np.int32), val),
        scatter(np.ones(p, np.int32),
                np.zeros(n, np.int32) if ts_begin is None
                else np.asarray(ts_begin, dtype=np.int32)),
        scatter(np.zeros(p, np.int32),
                np.zeros(n, np.int32) if ts_end is None
                else np.asarray(ts_end, dtype=np.int32)),
        device=device,
    )


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits (two's-complement wrap)."""
    return (((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _probe_slice(words: torch.Tensor, parts: JoinPartitions, key_word: int,
                 val_word: int, ts_word: int, ts: int, build_ts: bool):
    s_key = words[:, key_word]
    g = bucket_of(s_key, parts.num_buckets)
    match = parts.keys.index_select(0, g) == s_key[:, None]  # (n, C)
    if build_ts:
        match &= parts.begin.index_select(0, g) <= ts
        match &= parts.end.index_select(0, g) > ts
    if ts_word >= 0:
        valid = (words[:, ts_word] <= ts) & (words[:, ts_word + 1] > ts)
    else:
        valid = torch.ones(s_key.shape, dtype=torch.bool, device=words.device)
    matched = match.any(dim=1) & valid
    vals = parts.vals.index_select(0, g)
    r_val = _wrap_i32(torch.where(match, vals, torch.zeros_like(vals)).sum(dim=1))
    zero = torch.zeros((), dtype=torch.int32, device=words.device)
    return (torch.where(valid, words[:, val_word], zero),
            torch.where(matched, r_val, zero), matched)


def check_probe(words: torch.Tensor, partitions: JoinPartitions, key_word: int,
                val_word: int, ts_word: int, ts: int) -> None:
    """What both versions take: ``(N, R)`` int32 words with the named words
    inside the row, and four equal ``(P, C)`` int32 bucket tensors on the
    words' device with P a power of two >= 2."""
    if words.dtype != torch.int32 or words.dim() != 2:
        raise ValueError(f"want (N, row_words) int32 words, got {words.dtype} "
                         f"{tuple(words.shape)}")
    row_words = words.shape[1]
    if not (0 <= key_word < row_words and 0 <= val_word < row_words):
        raise ValueError(f"key/val words {key_word}, {val_word} outside the "
                         f"{row_words}-word row")
    if not (ts_word == -1 or 0 <= ts_word <= row_words - 2):
        raise ValueError(f"ts_word {ts_word} must be -1 or name the two MVCC words")
    if not -(1 << 31) <= ts < (1 << 31):
        raise ValueError(f"snapshot time {ts} is outside int32")
    shape = partitions.keys.shape
    for t in partitions:
        if t.dtype != torch.int32 or t.shape != shape or t.dim() != 2:
            raise ValueError("partitions must be four equal (P, C) int32 tensors")
        if t.device != words.device:
            raise ValueError(f"partitions on {t.device}, words on {words.device}")
    p = shape[0]
    if p < 2 or p & (p - 1):
        raise ValueError(f"the bucket count must be a power of two >= 2, got {p}")


def hash_join_torch(
    words: torch.Tensor,
    partitions: JoinPartitions,
    key_word: int,
    val_word: int,
    ts_word: int = -1,
    ts: int = 0,
    build_ts: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: one gather of the probe key's bucket per
    partition column, then the match and visibility math.  Walks the rows
    in slices so the ``(rows, C)`` gathers stay bounded."""
    check_probe(words, partitions, key_word, val_word, ts_word, ts)
    n = words.shape[0]
    step = max(1, PLAIN_SLICE_WORDS // max(partitions.capacity, 1))
    if n <= step:
        return _probe_slice(words, partitions, key_word, val_word, ts_word,
                            ts, build_ts)
    outs = [_probe_slice(words[i: i + step], partitions, key_word, val_word,
                         ts_word, ts, build_ts) for i in range(0, n, step)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def hash_join(
    words: torch.Tensor,
    partitions: JoinPartitions,
    key_word: int,
    val_word: int,
    ts_word: int = -1,
    ts: int = 0,
    build_ts: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Probe ``words`` (a row-store chunk or a packed block) against build
    partitions; returns ``(s_proj int32, r_proj int32, matched bool)``, one
    slot per probe row.

    ``key_word``/``val_word`` address the probe key and payload within the
    row — schema offsets on the row store, packed offsets on a shared-scan
    block.  ``ts_word >= 0`` fuses the probe rows' MVCC test from their
    hidden timestamp words; ``build_ts`` fuses the same test against the
    build rows.  Rows are position-local, so per-chunk outputs concatenate.
    """
    if words.device.type == "cpu":
        return hash_join_torch(words, partitions, key_word, val_word,
                               ts_word, ts, build_ts)
    check_probe(words, partitions, key_word, val_word, ts_word, ts)
    return _cuda.run_hash_join(words, partitions, key_word, val_word,
                               ts_word, ts, build_ts)


def probe_vmem_footprint_bytes(
    partitions: JoinPartitions, row_words: int, block_rows: int = 256,
) -> int:
    """The reference's modeled VMEM working set of one probe grid step: the
    double-buffered row tile and output columns, plus the bucket arrays
    resident for the whole pass.  The engine keeps the model for its
    ``last_block_rows`` accounting; the CUDA kernel has no such tile."""
    return (2 * block_rows * (row_words + 3) * 4) + partitions.nbytes
