"""Row-sharded serving — the port of ``repro.core.distributed``: rows sharded
like parallel DRAM banks.

The paper exploits "the inherent parallelism of memory cells — e.g., by
issuing outstanding parallel requests to separate DRAM banks" (§1).  At
cluster scale the analogous parallelism is *row-range sharding*: each shard
owns a row range of the table (a "bank"), runs the RME datapath locally, and
only reduced results (scalars, group accumulators, broadcast build sides)
cross between shards.

Two layers live here:

* **Free sharded operators** (:func:`dist_project`, :func:`dist_aggregate`,
  :func:`dist_groupby`, :func:`dist_join`): a loop over the shards of a
  device list, each shard's rows going to the port's kernel for the op on
  the shard's device (``rm_project_kernel``, ``rm_aggregate_kernel``,
  ``rm_groupby_kernel``; their plain versions on the CPU), then an explicit
  combine on the first device.  The join's sort and ``searchsorted`` are
  torch ops, as they are XLA ops outside any kernel in the reference.
* **The sharded execution backend** (:class:`ShardedRowStore` +
  :class:`ShardedEngine`), a drop-in for the single-device engine.  Each
  shard keeps its own delta-chunked base + tail buffers (appends upload to
  one owning shard, timestamp patches rewrite only the owning shard's
  words), a tick's fused pass runs **per shard** (``scan_shard``: the fused
  scan kernel once per shard chunk), and only reduced results cross shards:
  aggregate and group-by partials combine through
  :func:`~repro_torch.kernels.rme_scan_multi.combine_chunk_outputs`, packed
  and filter blocks reassemble in global row order from the ownership
  segments, and joins broadcast only the cached build partitions.
  ``EngineStats`` charges the interconnect (``bytes_collective`` /
  ``collective_ops``) exactly as the reference does: O(result or build)
  bytes, never O(rows).

Deliberate differences from the reference (``ROADMAP.md`` §3):

* **A mesh is a device list**: ``mesh`` is a sequence of devices of one
  type, one per shard, each resolved as the engine's own device is (the
  counterpart of ``mesh.devices.flat``).  ``num_shards`` without a mesh gives logical
  shards on the engine's ``device`` — the card unless the caller asks for
  the CPU.
* **No named mesh axes**: the ``dist_*`` operators take no ``axes``, and
  the reference's ``table_sharding`` (a JAX ``NamedSharding``) has no
  counterpart.
* **Failover keeps the kernel**: a shard pass retries and fails over on an
  injected :class:`~repro_torch.core.faults.FaultError` only.  Any other
  exception (a real error of a CUDA kernel included) propagates and is not
  counted.  A failed-over shard re-runs its chunks on the root device
  through ``scan_multi`` — the CUDA kernel on the card, never the plain
  version there.

The serving loop's pipelined primitives are inherited unchanged:
``execute_many_async`` wraps this class's ``execute_many`` (whose per-shard
passes enqueue without a host sync), and ``stream_project`` iterates
``device_chunks``, which :meth:`ShardedRowStore.chunks` yields in global row
order, so streamed chunks concatenate to the same packed block on both
backends.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from collections.abc import Sequence
from typing import Iterator

import numpy as np
import torch

from repro_torch.kernels import common
from repro_torch.kernels import ops as K
from repro_torch.kernels import rme_join as KJ
from repro_torch.kernels import rme_scan_multi as KR

from . import faults
from .engine import MAX_TAIL_CHUNKS, DeviceRowStore, EngineStats, RelationalMemoryEngine
from .requests import JoinOp, JoinResult
from .schema import WORD, TableGeometry
from .table import RelationalTable


def mesh_devices(mesh) -> list[torch.device]:
    """The port's mesh: a sequence of devices of one type, one per shard,
    each resolved by :func:`~repro_torch.kernels.common.resolve_device`.

    A mesh never mixes the card and the host: a shard's tensors and the
    root's then share a type, so a card shard never fails over to a host
    root, and a card chunk never takes the breaker's plain route.
    """
    if isinstance(mesh, (str, torch.device)) or not isinstance(mesh, Sequence):
        raise TypeError(
            f"a mesh is a sequence of devices, one per shard; got "
            f"{type(mesh).__name__}")
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    types = {torch.device("cuda" if d is None else d).type for d in mesh}
    if len(types) > 1:
        raise ValueError(
            f"a mesh holds devices of one type; got {sorted(types)}")
    return [common.resolve_device(d) for d in mesh]


# ============================================================ free operators
def pad_rows_to(words, shards: int) -> torch.Tensor:
    """Pad the row count to a multiple of ``shards`` with zero rows.

    Padding must be *masked*, never trusted to be inert: every sharded
    operator takes ``valid_rows`` (the true row count), and no padded row
    reaches a kernel — packed projections come back zero there, aggregates
    and group-bys never see them, and the join neither builds nor probes
    them (a padded row's key word is 0, a legitimate key).  A numpy buffer
    is copied (tables mutate theirs in place).
    """
    if not isinstance(words, torch.Tensor):
        words = torch.from_numpy(np.array(words, dtype=np.int32))
    pad = (-words.shape[0]) % shards
    if pad:
        words = torch.cat([words, words.new_zeros((pad, words.shape[1]))])
    return words


def _shard_rows(words: torch.Tensor, devices: list[torch.device],
                valid_rows: int | None) -> Iterator[tuple[torch.Tensor, int]]:
    """Each shard's valid rows on its own device, with the shard's row count
    (valid and padding): equal contiguous ranges, as the reference's
    ``P(axes, None)`` row sharding."""
    n = words.shape[0]
    if n % len(devices):
        raise ValueError(f"{n} rows do not split over {len(devices)} shards; "
                         "pad them first (pad_rows_to)")
    rows = n // len(devices)
    n_valid = n if valid_rows is None else valid_rows
    for s, dev in enumerate(devices):
        lo = s * rows
        take = max(0, min(rows, n_valid - lo))
        yield words[lo:lo + take].to(dev), rows


def dist_project(words: torch.Tensor, geom: TableGeometry, mesh,
                 valid_rows: int | None = None) -> torch.Tensor:
    """Row-sharded packed projection: each shard reorganizes its own bank
    with the projection kernel; the blocks come back in row order on the
    first device, padding rows zero."""
    devices = mesh_devices(mesh)
    root, out_w = devices[0], geom.out_words_per_row
    parts = []
    for w, rows in _shard_rows(words, devices, valid_rows):
        if w.shape[0]:
            parts.append(K.project(w, geom).to(root))
        if rows > w.shape[0]:
            parts.append(torch.zeros((rows - w.shape[0], out_w),
                                     dtype=torch.int32, device=root))
    if not parts:
        return torch.zeros((0, out_w), dtype=torch.int32, device=root)
    return torch.cat(parts)


def dist_aggregate(
    words: torch.Tensor,
    mesh,
    agg_word: int,
    agg_dtype: str = "int32",
    pred_word: int = 0,
    pred_dtype: str = "int32",
    pred_op: str = "none",
    pred_k=0,
    valid_rows: int | None = None,
) -> torch.Tensor:
    """Distributed Q0/Q3: per-bank fused masked sum (the aggregate kernel
    over each shard's valid rows), then one sum of the partials.  Returns
    float32 ``[sum, count]`` on the first device."""
    devices = mesh_devices(mesh)
    total = torch.zeros(2, dtype=torch.float32, device=devices[0])
    for w, _ in _shard_rows(words, devices, valid_rows):
        if w.shape[0]:
            total = total + K.aggregate(
                w, agg_word, agg_dtype, pred_word, pred_dtype, pred_op,
                pred_k).to(devices[0])
    return total


def dist_groupby(
    words: torch.Tensor,
    mesh,
    group_word: int,
    agg_word: int,
    num_groups: int,
    agg_dtype: str = "int32",
    pred_word: int | None = None,
    pred_dtype: str = "int32",
    pred_op: str = "none",
    pred_k=0,
    valid_rows: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Distributed Q4: the group-by kernel over each shard's valid rows,
    then one add of the ``(G,)`` partials.  Group ids are the floored
    modulo every path shares (``common.group_ids``)."""
    devices = mesh_devices(mesh)
    root = devices[0]
    sums = torch.zeros(num_groups, dtype=torch.float32, device=root)
    counts = torch.zeros(num_groups, dtype=torch.float32, device=root)
    if pred_word is None:
        pred_word, pred_op = 0, "none"
    for w, _ in _shard_rows(words, devices, valid_rows):
        if w.shape[0]:
            s, c = K.groupby_sum(w, group_word, agg_word, num_groups,
                                 agg_dtype, pred_word, pred_dtype, pred_op,
                                 pred_k)
            sums, counts = sums + s.to(root), counts + c.to(root)
    return sums, counts


def dist_join(
    s_words: torch.Tensor,
    r_words: torch.Tensor,
    mesh,
    s_geom: TableGeometry,
    r_geom: TableGeometry,
    s_key_word: int,
    s_val_word: int,
    r_key_word: int,
    r_val_word: int,
    s_valid_rows: int | None = None,
    r_valid_rows: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Distributed broadcast equi-join.

    Both tables are row-sharded.  Each shard projects its slim {key, val}
    pair (the projection kernel); the build side R's valid rows are gathered
    and sorted by key (stable, so the left position of a present key is its
    first row) — the only collective — and broadcast; every shard probes its
    own S rows with ``searchsorted``.  Word offsets index the *packed*
    projected views.  Returns (s_val, matched r_val, match mask) over the
    padded S rows on the first device; padding rows never match.
    """
    devices = mesh_devices(mesh)
    root = devices[0]
    r_parts = [K.project(w, r_geom).to(root)
               for w, _ in _shard_rows(r_words, devices, r_valid_rows)
               if w.shape[0]]
    r_all = (torch.cat(r_parts) if r_parts else
             torch.zeros((0, r_geom.out_words_per_row), dtype=torch.int32,
                         device=root))
    rk, order = torch.sort(r_all[:, r_key_word], stable=True)
    rv = r_all[:, r_val_word][order]
    outs = []
    for w, rows in _shard_rows(s_words, devices, s_valid_rows):
        dev, n = w.device, w.shape[0]
        s_val = torch.zeros(rows, dtype=torch.int32, device=dev)
        r_val = torch.zeros(rows, dtype=torch.int32, device=dev)
        matched = torch.zeros(rows, dtype=torch.bool, device=dev)
        if n:
            s_p = K.project(w, s_geom)
            s_val[:n] = s_p[:, s_val_word]
        if n and rk.numel():
            s_key = s_p[:, s_key_word].contiguous()
            keys, vals = rk.to(dev), rv.to(dev)
            pos = torch.searchsorted(keys, s_key).clamp_(max=keys.numel() - 1)
            hit = keys[pos] == s_key
            r_val[:n] = torch.where(hit, vals[pos], torch.zeros_like(s_key))
            matched[:n] = hit
        outs.append((s_val.to(root), r_val.to(root), matched.to(root)))
    return tuple(torch.cat(parts) for parts in zip(*outs))


# =================================================================== backend
def shard_ranges(n_rows: int, shards: int) -> tuple[tuple[int, int], ...]:
    """Contiguous balanced row ranges: ``(start, n)`` per shard.

    The first ``n_rows % shards`` shards take one extra row, so shard sizes
    differ by at most one and their concatenation is ``[0, n_rows)`` in
    order — the row-range ownership map of the sharded backend.
    """
    base, extra = divmod(n_rows, shards)
    out, start = [], 0
    for s in range(shards):
        n = base + (1 if s < extra else 0)
        out.append((start, n))
        start += n
    return tuple(out)


@dataclasses.dataclass
class _ShardChunk:
    """One shard-resident buffer: rows the shard owns, with their global ids.

    ``segments`` maps the chunk's local rows, in order, back to global row
    ranges ``(global_start, n_rows)``.  A freshly uploaded chunk has one
    segment; shard-local compaction concatenates chunk buffers device-side
    and their segment lists along with them, so ownership survives merging
    of non-adjacent ranges (round-robin appends make a shard's ranges
    non-contiguous).
    """

    words: torch.Tensor
    segments: tuple[tuple[int, int], ...]

    @property
    def rows(self) -> int:
        return self.words.shape[0]


@dataclasses.dataclass
class _ShardedEntry:
    """One table's sharded device residency: per-shard chunk lists.

    ``rows`` / ``patch_seq`` are the same sync watermarks as the
    single-device ``_StoreEntry``; ``next_owner`` round-robins append
    ownership so sustained ingest spreads across banks.
    """

    shards: list[list[_ShardChunk]]
    rows: int
    patch_seq: int
    next_owner: int = 0


class ShardedRowStore(DeviceRowStore):
    """Per-shard delta-chunked row-store buffers — one bank per shard.

    The single-device :class:`DeviceRowStore` keeps a table as base + tail
    chunks on one device; this subclass splits the base into one contiguous
    row range per shard (:func:`shard_ranges`) and keeps the whole delta
    machinery *per shard*:

    * a **full upload** places each shard's range on ``devices[s]``,
    * an **append** uploads the new tail rows to exactly one owning shard
      (round-robin), O(new rows) bytes to one bank — no other shard moves,
    * a **delete/update** rewrites, in place, the ``__ts_end`` words of only
      the chunks whose segments own the touched rows — O(touched rows),
    * **compaction** is shard-local and device-side (charges nothing).

    Host-side consumers (``get`` / ``tail`` / ``chunks``) reassemble global
    row order from the ownership segments on the root device (the first);
    the scan path never pays them: :meth:`shard_parts` hands the engine the
    raw per-shard chunk lists.
    """

    def __init__(self, stats: EngineStats | None = None, delta: bool = True,
                 num_shards: int = 1, devices: Sequence | None = None,
                 device: torch.device = torch.device("cpu")):
        super().__init__(stats, delta=delta, device=device)
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.num_shards = num_shards
        self._devices = (list(devices) if devices is not None
                         else [device] * num_shards)
        if len(self._devices) != num_shards:
            raise ValueError("devices must have one entry per shard")
        self._root = self._devices[0]

    # ---------------------------------------------------------- placement
    def _place(self, host: np.ndarray, shard: int) -> torch.Tensor:
        # a copy even on the CPU: the table mutates its buffer in place
        return torch.from_numpy(np.ascontiguousarray(host)).to(
            self._devices[shard], copy=True)

    def _to_root(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self._root)

    # ----------------------------------------------------------------- sync
    def _full_upload(self, table: RelationalTable) -> _ShardedEntry:
        faults.maybe_fault("upload", table=table.uid, delta=False)
        host = table.words()
        shards: list[list[_ShardChunk]] = [[] for _ in range(self.num_shards)]
        for s, (start, n) in enumerate(
            shard_ranges(table.row_count, self.num_shards)
        ):
            if n:
                shards[s].append(_ShardChunk(
                    self._place(host[start:start + n], s), ((start, n),)))
        ent = _ShardedEntry(shards, table.row_count, table.mutation_version)
        if table.uid not in self._finalized:
            weakref.finalize(
                table, self._finalize_entry, weakref.ref(self), table.uid
            )
            self._finalized.add(table.uid)
        self._buffers[table.uid] = ent
        self._charge(host.size * host.itemsize, is_delta=False)
        return ent

    def _apply_patches(self, ent: _ShardedEntry, table: RelationalTable,
                       patches: list[np.ndarray]) -> int:
        """Rewrite patched ``__ts_end`` words inside the owning shards only.

        Global patch indices route through each chunk's ownership segments;
        a shard owning none of the touched rows is never touched itself.  The
        words are patched in place, as in the single-device store: no packed
        block or cached view holds a timestamp word.  Returns the bytes
        shipped (one word per patched row).
        """
        idx = np.concatenate([p[p < ent.rows] for p in patches]) if patches else \
            np.empty(0, dtype=np.int64)
        if idx.size == 0:
            return 0
        vals = np.asarray(table.ts_end_at(idx))
        ts_word = table.ts_end_word
        for chunks in ent.shards:
            for chunk in chunks:
                local, lvals, off = [], [], 0
                for g0, n in chunk.segments:
                    sel = (idx >= g0) & (idx < g0 + n)
                    if sel.any():
                        local.append(idx[sel] - g0 + off)
                        lvals.append(vals[sel])
                    off += n
                if local:
                    dev = chunk.words.device
                    rows = torch.from_numpy(np.concatenate(local)).to(dev)
                    chunk.words[rows, ts_word] = torch.from_numpy(
                        np.ascontiguousarray(np.concatenate(lvals))).to(dev)
        return idx.size * WORD

    def _sync(self, table: RelationalTable) -> _ShardedEntry:
        """Bring the sharded copy current: deltas land only in owning shards."""
        ent = self._buffers.get(table.uid)
        if ent is not None and not self.delta and (
            ent.rows != table.row_count
            or ent.patch_seq != table.mutation_version
        ):
            ent = None  # baseline mode: any change → whole-table re-upload
        if ent is None:
            return self._full_upload(table)
        patches = (table.patches_since(ent.patch_seq)
                   if ent.patch_seq != table.mutation_version else [])
        if patches is None:  # lagged past the trimmed patch log: full re-sync
            return self._full_upload(table)
        if patches or table.row_count > ent.rows:
            # before any entry mutation: a fault here leaves every shard at
            # its pre-sync state, so a bare retry re-syncs cleanly
            faults.maybe_fault("upload", table=table.uid, delta=True)
        moved = self._apply_patches(ent, table, patches)
        ent.patch_seq = table.mutation_version
        if table.row_count > ent.rows:
            tail = table.tail_words(ent.rows)
            owner = ent.next_owner
            ent.shards[owner].append(_ShardChunk(
                self._place(tail, owner), ((ent.rows, tail.shape[0]),)))
            ent.next_owner = (owner + 1) % self.num_shards
            ent.rows = table.row_count
            moved += tail.size * tail.itemsize
        self._charge(moved, is_delta=True)
        for s, chunks in enumerate(ent.shards):
            if len(chunks) > MAX_TAIL_CHUNKS:
                # shard-local device-side compaction: segments ride along,
                # so merged non-adjacent ranges keep their global ids
                ent.shards[s] = [_ShardChunk(
                    torch.cat([c.words for c in chunks], dim=0),
                    tuple(seg for c in chunks for seg in c.segments),
                )]
        return ent

    # ------------------------------------------------------------ accessors
    @staticmethod
    def _pieces(ent: _ShardedEntry) -> Iterator[tuple[int, torch.Tensor]]:
        """Every resident ``(global_start, rows)`` piece, unordered."""
        for chunks in ent.shards:
            for chunk in chunks:
                off = 0
                for start, n in chunk.segments:
                    yield start, chunk.words[off:off + n]
                    off += n

    def _gathered(self, ent: _ShardedEntry,
                  from_row: int = 0) -> list[torch.Tensor]:
        """Root-device pieces in global row order, from ``from_row`` on (a
        row slice of a chunk is contiguous, as the kernels want)."""
        parts = []
        for start, w in sorted(self._pieces(ent), key=lambda p: p[0]):
            if start + w.shape[0] > from_row:
                parts.append(self._to_root(w[max(from_row - start, 0):]))
        return parts

    def get(self, table: RelationalTable) -> torch.Tensor:
        """The table's row store as one root-device tensor (synced first).

        The sharded layout stays authoritative — this is the merge view for
        single-buffer consumers (validity masks, solo materializations),
        assembled from the ownership segments on every call.
        """
        parts = self._gathered(self._sync(table))
        if not parts:
            return torch.zeros((0, table.row_words), dtype=torch.int32,
                               device=self._root)
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)

    def chunks(self, table: RelationalTable) -> tuple[torch.Tensor, ...]:
        """Global-order chunk views (synced first), for chunk-iterating
        consumers that are not shard-aware."""
        parts = self._gathered(self._sync(table))
        if not parts:
            return (torch.zeros((0, table.row_words), dtype=torch.int32,
                                device=self._root),)
        return tuple(parts)

    def tail(self, table: RelationalTable, start_row: int) -> torch.Tensor:
        """Rows ``[start_row, row_count)`` in global order, on the root."""
        parts = self._gathered(self._sync(table), from_row=start_row)
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)

    def shard_parts(self, table: RelationalTable) -> list[list[_ShardChunk]]:
        """The synced per-shard chunk lists — the sharded scan operand.

        Index ``s`` is shard ``s``'s resident chunks on its own device (an
        empty list for a shard that owns no rows yet); nothing is gathered.
        """
        return [list(chunks) for chunks in self._sync(table).shards]

    @property
    def occupancy_bytes(self) -> int:
        return sum(
            c.words.numel() * c.words.element_size()
            for ent in self._buffers.values()
            for chunks in ent.shards for c in chunks
        )


def _empty_scan_result(req: "KR.ScanRequest", device: torch.device):
    """The canonical output of a fused request over zero rows — what a
    0-row table (no chunks on any shard) must still answer with."""
    if isinstance(req, KR.ProjectRequest):
        return torch.zeros((0, req.geom.out_words_per_row), dtype=torch.int32,
                           device=device)
    if isinstance(req, KR.FilterRequest):
        return (torch.zeros((0, req.geom.out_words_per_row),
                            dtype=torch.int32, device=device),
                torch.zeros((0,), dtype=torch.bool, device=device))
    if isinstance(req, KR.AggregateRequest):
        return torch.zeros(2, dtype=torch.float32, device=device)
    return (torch.zeros(req.num_groups, dtype=torch.float32, device=device),
            torch.zeros(req.num_groups, dtype=torch.float32, device=device))


class ShardedEngine(RelationalMemoryEngine):
    """The sharded execution backend — same results, per-bank datapath.

    Drop-in for :class:`RelationalMemoryEngine`: the whole serving surface
    (``execute_many``, ``materialize``, the planner's physical routes, the
    ``QueryServer``) runs unchanged on top of two overridden hooks —

    * :meth:`_serve_scan` — a tick's fused request tuple runs as **one
      fused pass per shard** (``scan_shard``: the fused scan kernel over
      each of the shard's resident chunks, a lone request included).
      Aggregate/group-by partials combine shard-locally, then once across
      shards — those reduced partials are the *only* scan bytes crossing
      shards, charged to ``bytes_collective``.  Packed/filter blocks
      reassemble into global row order at finalize.
    * :meth:`_join_direct` — the build side's cached hash partitions are
      broadcast once per build version to every shard (the join's only
      collective, O(build rows)); each shard probes its own rows in place
      with the hash-join probe kernel.

    ``mesh`` is a sequence of devices of one type: shard ``s``'s buffers
    live on ``mesh[s]`` and the first is the root (the engine's ``device``,
    where results and the join build land).  ``num_shards`` without a mesh runs
    the identical code path as logical shards on ``device`` — the card
    unless the caller passes ``"cpu"``.  Results equal the single-device
    engine's; exact float equality of re-associated sums holds whenever the
    sums are exactly representable (int32 payloads below 2^24).

    ``shard_retries``, ``retry_backoff_s``, ``quarantine_after`` and
    ``quarantine_probe_every`` are the failover policy of
    :meth:`_shard_pass`.
    """

    def __init__(self, mesh: Sequence | None = None,
                 num_shards: int | None = None,
                 shard_retries: int = 2,
                 retry_backoff_s: float = 0.0,
                 quarantine_after: int = 3,
                 quarantine_probe_every: int = 4,
                 **kwargs):
        if mesh is not None:
            if kwargs.get("device") is not None:
                raise ValueError("a mesh names its devices: pass mesh or "
                                 "device, not both")
            devices = mesh_devices(mesh)
            if num_shards is None:
                num_shards = len(devices)
            if num_shards > len(devices):
                raise ValueError(
                    f"num_shards={num_shards} exceeds mesh size {len(devices)}"
                )
            devices = devices[:num_shards]
            kwargs["device"] = devices[0]
        else:
            num_shards = 1 if num_shards is None else num_shards
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        super().__init__(**kwargs)
        if mesh is None:
            devices = [self.device] * num_shards
        self.mesh = mesh
        self.num_shards = num_shards
        self._devices = devices
        self.rowstore = ShardedRowStore(
            self.stats, delta=self.delta, num_shards=num_shards,
            devices=devices, device=self.device,
        )
        # broadcast replicas of join build partitions, one set per build
        # version: (table uid, mutation version) -> (source parts, replicas)
        self._bcast_parts: dict[tuple, tuple] = {}
        # failover policy (docs/reliability.md): injected transient shard-pass
        # faults retry with exponential backoff, then — or immediately on a
        # permanent fault — the shard's chunks re-execute on the root
        # device; repeated failures quarantine the shard (straight to
        # failover) with periodic half-open probes back to health
        self.shard_retries = shard_retries
        self.retry_backoff_s = retry_backoff_s
        self.quarantine_after = quarantine_after
        self.quarantine_probe_every = quarantine_probe_every
        self._health = [
            {"state": "healthy", "failures": 0, "skips": 0}
            for _ in range(self.num_shards)
        ]

    @property
    def backend(self) -> str:
        return "sharded"

    def reset(self) -> None:
        """Single-device reset plus the per-shard broadcast-replica cache."""
        super().reset()
        self._bcast_parts.clear()

    def _to_root(self, x):
        """Move a tensor (or a tuple of them) to the root shard's device."""
        if isinstance(x, tuple):
            return tuple(t.to(self.device) for t in x)
        return x.to(self.device)

    # ------------------------------------------------------- the scan hook
    def _serve_scan(self, table: RelationalTable,
                    reqs: tuple["KR.ScanRequest", ...],
                    shared: bool = False) -> list:
        """One fused pass per shard; only reduced partials cross shards.

        Requests are chunk-agnostic (word offsets, row-position-local), so
        the identical lowered tuple streams over every shard's chunks.  A
        lone request takes the same path — per-bank parallelism applies to
        solo queries too, and the per-shard pass count stays exactly one
        (``shared`` is accepted for the base-class hook contract).

        Every per-shard pass runs through :meth:`_shard_pass` (bounded
        retry → root-device failover → quarantine), and the cross-shard
        combine of reduced partials through :meth:`_combine_collective`.
        """
        faults.maybe_fault("scan_launch", table=table.uid)
        shards = self.rowstore.shard_parts(table)
        self._fused_block_rows(reqs, table.row_words)  # the modeled guard
        per_shard: list[tuple[list[_ShardChunk], list[list]]] = []
        for s, chunks in enumerate(shards):
            if not chunks:
                continue
            outs = self._shard_pass(table, s, chunks, reqs)
            per_shard.append((chunks, outs))
            for c in chunks:
                self.charge_scan(table, reqs, row_count=c.rows)
        self.stats.shared_scans += 1
        self.stats.rows_projected += table.row_count
        active = len(per_shard)
        results = []
        for r, req in enumerate(reqs):
            if not per_shard:
                # a 0-row table owns no chunks on any shard: emit the same
                # canonical empty/zero outputs the single-device pass yields
                results.append(_empty_scan_result(req, self.device))
                continue
            reduced = KR.reduced_result_bytes(req)
            if reduced is not None:
                # shard-local combine first, then one cross-shard combine of
                # the O(result)-sized partials — the modeled collective
                partials = [
                    self._to_root(KR.combine_chunk_outputs(
                        req, [chunk_outs[r] for chunk_outs in outs]))
                    for _, outs in per_shard
                ]
                if active > 1:
                    self.stats.bytes_collective += (active - 1) * reduced
                    self.stats.collective_ops += 1
                    results.append(self._combine_collective(req, partials))
                else:
                    results.append(KR.combine_chunk_outputs(req, partials))
            else:
                # blocked output: reassemble global row order from the
                # ownership segments (finalize gather, not a collective)
                pieces = []
                for chunks, outs in per_shard:
                    for chunk, chunk_outs in zip(chunks, outs):
                        out = chunk_outs[r]
                        off = 0
                        for start, n in chunk.segments:
                            piece = (
                                (out[0][off:off + n], out[1][off:off + n])
                                if isinstance(req, KR.FilterRequest)
                                else out[off:off + n]
                            )
                            pieces.append((start, piece))
                            off += n
                pieces.sort(key=lambda p: p[0])
                parts = [self._to_root(p) for _, p in pieces]
                results.append(KR.combine_chunk_outputs(req, parts))
        return results

    # -------------------------------------------------- failover machinery
    def _shard_pass(self, table: RelationalTable, shard: int, chunks,
                    reqs: tuple["KR.ScanRequest", ...]) -> list[list]:
        """One shard's fused pass with bounded retry, failover, quarantine.

        An injected transient fault retries up to ``shard_retries`` times
        with ``retry_backoff_s * 2**attempt`` backoff; an injected permanent
        fault — or retry exhaustion — re-executes this shard's chunks on the
        root device via :meth:`_failover_pass` (equal results; the tick
        completes without the shard).  ``quarantine_after`` consecutive
        failed passes quarantine the shard: subsequent passes go straight
        to failover, with every ``quarantine_probe_every``-th pass probing
        the shard half-open.  A successful pass restores full health.  Any
        exception that is not an injected fault — a real kernel error —
        propagates: it is neither retried nor failed over.
        """
        health = self._health[shard]
        if health["state"] == "quarantined":
            health["skips"] += 1
            if health["skips"] % self.quarantine_probe_every != 0:
                return self._failover_pass(chunks, reqs)
        attempt = 0
        while True:
            try:
                faults.maybe_fault("shard_pass", shard=shard,
                                   table=table.uid)
                outs = KR.scan_shard([c.words for c in chunks], reqs)
            except faults.FaultError as err:
                permanent = isinstance(err, faults.PermanentFault)
                if not permanent and attempt < self.shard_retries:
                    self.stats.retries += 1
                    if self.retry_backoff_s:
                        time.sleep(self.retry_backoff_s * (2 ** attempt))
                    attempt += 1
                    continue
                health["failures"] += 1
                if health["failures"] >= self.quarantine_after:
                    health["state"] = "quarantined"
                return self._failover_pass(chunks, reqs)
            health["state"] = "healthy"
            health["failures"] = 0
            health["skips"] = 0
            return outs

    def _failover_pass(self, chunks,
                       reqs: tuple["KR.ScanRequest", ...]) -> list[list]:
        """Re-execute a failed shard's chunks on the root device.

        ``scan_multi`` serves the same request tuple over the same chunk
        rows — the CUDA kernel on a card mesh, the plain version on a host
        one (a mesh never mixes the two) — so the per-chunk outputs, and everything combined from them,
        equal the healthy shard pass.  Charged as one ``failovers`` event
        plus the shard's row bytes re-shipped (``bytes_failover``).
        """
        outs = []
        moved = 0
        for c in chunks:
            outs.append(KR.scan_multi(self._to_root(c.words), reqs))
            moved += c.words.numel() * c.words.element_size()
        self.stats.failovers += 1
        self.stats.bytes_failover += moved
        return outs

    def _combine_collective(self, req: "KR.ScanRequest", partials):
        """The cross-shard combine with bounded transient retry.

        The partials are already on the root device, so a retry just re-runs
        the O(result)-sized combine.  A permanent fault (or retry
        exhaustion) propagates typed — the serving layer turns it into a
        per-ticket error.
        """
        attempt = 0
        while True:
            try:
                faults.maybe_fault("collective_combine")
                return KR.combine_chunk_outputs(req, partials)
            except faults.TransientFault:
                if attempt >= self.shard_retries:
                    raise
                self.stats.retries += 1
                if self.retry_backoff_s:
                    time.sleep(self.retry_backoff_s * (2 ** attempt))
                attempt += 1

    def shard_health(self) -> list[str]:
        """Per-shard health states (``"healthy"`` / ``"quarantined"``)."""
        return [h["state"] for h in self._health]

    # ------------------------------------------------------- the join hook
    def _shard_partitions(self, right_table: RelationalTable, parts):
        """Broadcast replicas of the build partitions, one per shard.

        Cached per build-table version: the first probe after a build (or a
        build-side write) pays one ``(shards - 1) * parts.nbytes`` charge;
        every warm probe reuses the device-resident replicas for free.  The
        replicas live only here, never in the planner's build cache.
        """
        key = (right_table.uid, right_table.mutation_version)
        hit = self._bcast_parts.get(key)
        if hit is not None and hit[0] is parts:
            return hit[1]
        replicas = KJ.broadcast_partitions(parts, self._devices)
        if self.num_shards > 1:
            self.stats.bytes_collective += (self.num_shards - 1) * parts.nbytes
            self.stats.collective_ops += 1
        self._bcast_parts[key] = (parts, replicas)
        return replicas

    def _join_direct(self, op: JoinOp) -> JoinResult:
        """Solo join, sharded: every shard probes its own rows in place.

        Only the broadcast build partitions cross shards — probe rows never
        move, and the per-probe-row outputs reassemble into global row order
        exactly like blocked scan outputs.
        """
        table = op.table
        parts = self._op_partitions(op)
        replicas = self._shard_partitions(op.right_table, parts)
        shards = self.rowstore.shard_parts(table)
        key_word = table.schema.word_offset(op.key)
        val_word = table.schema.word_offset(op.left_proj)
        snap = op.snapshot_ts is not None
        ts_word = table.ts_begin_word if snap else -1
        route = (table.uid, "join") if self._reroutes else None
        acc_req = op.lower()  # its intervals are exactly the probe footprint
        self.stats.rows_projected += table.row_count
        pieces = []
        for s, chunks in enumerate(shards):
            for chunk in chunks:
                out = self._probe_join(
                    chunk.words, replicas[s], key_word, val_word, ts_word,
                    op.snapshot_ts or 0, snap, route,
                )
                self.charge_scan(table, (acc_req,), row_count=chunk.rows)
                off = 0
                for start, n in chunk.segments:
                    pieces.append((start, tuple(o[off:off + n] for o in out)))
                    off += n
        pieces.sort(key=lambda p: p[0])
        if not pieces:  # a 0-row probe table owns no chunks on any shard
            return JoinResult(
                s_proj=torch.zeros(0, dtype=torch.int32, device=self.device),
                r_proj=torch.zeros(0, dtype=torch.int32, device=self.device),
                matched=torch.zeros(0, dtype=torch.bool, device=self.device),
            )
        return JoinResult.concat(
            [JoinResult(*self._to_root(t)) for _, t in pieces]
        )
