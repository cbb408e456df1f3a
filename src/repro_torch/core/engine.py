"""The Relational Memory Engine (RME) — host-side orchestration; the port of
``repro.core.engine``.

* ``register`` plays the **Configuration Port**: it writes the table geometry
  and returns an :class:`~repro_torch.core.ephemeral.EphemeralView` handle.
* The **Reorganization Buffer** becomes :class:`ReorgCache`: reorganized
  column groups keyed by geometry, validated by an *epoch* (``reset()`` is
  O(1)).
* **Hot vs cold** accesses map to cache hit vs kernel launch.  The engine
  counts both, plus exact bytes pulled from the row store
  (:class:`EngineStats`, the software PMU) — counters that do not depend on
  the platform, so they equal the reference engine's on the same ops.

A table's device copy is a :class:`DeviceRowStore` entry: a base chunk plus
appended tail chunks, kept current at O(delta) upload cost (appended rows as
new tails, deleted/updated rows as ``__ts_end`` patches replayed from the
table's patch log).  :meth:`RelationalMemoryEngine.execute_many` coalesces
any mix of project / filter / aggregate / group-by ops per table: two or
more requests on a table run one fused pass per resident chunk
(``rm_scan_multi_kernel``), a lone request runs its single-op kernel.
A join op alone on its table streams the hash-join probe
(``rm_hash_join_kernel``) over the resident chunks; a join sharing its
table's pass probes the packed block that pass produced.  The build side's
hash buckets are built once per build-table version and live in the
planner's join build cache.

The engine runs on one device, chosen at construction: ``device=None`` means
the card and raises without one; ``device="cpu"`` runs the kernels' plain
PyTorch versions.  ``revision`` selects the paper's §5.2 projection datapath
(``"bsl"``, ``"pck"``, ``"mlp"``): a lone projection and every streamed
chunk reach that revision's kernel, while the fused pass and the join probe
are the same kernels for every revision, as in the reference.

The reference's fault-injection sites (:func:`faults.maybe_fault`: ``upload``,
``stream_chunk``, ``scan_launch``, ``lowering``, ``join_build``) sit at the
same places, and the same :class:`faults.CircuitBreaker` guards kernel
dispatch per (table, request-shape) route.  Two deliberate differences.
The breaker reroutes only on a CPU engine, where the plain version is the
path anyway: there an *injected* ``lowering`` fault (or an open route)
serves the dispatch with the plain version, counted in
``breaker.snapshot()``.  On the card there is no fallback: the breaker is
not consulted and an injected ``lowering`` fault propagates like the other
sites' faults, to the server's retries.  And any other exception — a real
build or launch error of a CUDA kernel included — propagates and is not
recorded, so the plain version never stands in for a kernel on the card.
The sharded backend (:mod:`repro_torch.core.distributed`) subclasses this
engine and overrides its scan and join hooks.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import common
from repro_torch.kernels import ops as K
from repro_torch.kernels import rme_scan_multi as KR
from repro_torch.kernels._cuda import device_map
from repro_torch.tracing import WAIT, span

from . import faults
from .descriptor import bytes_moved
from .ephemeral import EphemeralView
from .requests import (AggregateOp, FilterOp, GroupByOp, JoinOp, JoinResult,
                       ProjectOp, ScanOp, finalize_scan_result)
from .schema import WORD, TableGeometry
from .table import RelationalTable

# the fused-pass tile guard never shrinks below this (grid overhead dominates)
MIN_FUSED_BLOCK_ROWS = 32

# streamed projections never slice finer than this: below it the per-chunk
# launch overhead dwarfs the chunk itself
MIN_STREAM_CHUNK_ROWS = 32

# tail chunks are coalesced (device-side, no host transfer) beyond this count
# so per-chunk pass overhead stays bounded under sustained appends
MAX_TAIL_CHUNKS = 8


@dataclasses.dataclass
class EngineStats:
    """Counters surfaced to the benchmarks (the 'PMU' of the software RME).

    Charging rules, as in the reference engine:

    * ``bytes_from_dram`` — bus-beat-exact Eq.(3) bytes a scan pulled from
      the row store (union geometry for shared passes, charged once per
      chunk per pass).
    * ``bytes_to_cpu`` — packed bytes shipped up the hierarchy (per view;
      scalar syncs charge their 8 bytes at the blocking call).
    * ``bytes_uploaded`` / ``uploads`` — every host→device row-store
      transfer (full uploads *and* deltas; one event per sync).
    * ``bytes_uploaded_delta`` / ``delta_uploads`` — the delta subset:
      appended tail rows and patched ``__ts_end`` words only.
    * ``delta_hits`` — reorg-cache entries served by an incremental
      tail-chunk projection (also counted in ``cold_misses``).
    * ``bytes_saved_compression`` — plain-width minus codec-narrowed bytes
      of every charged pass (``charge_scan`` is the single charge point).
    * ``decodes`` / ``decode_cache_hits`` — client-visible decodes of
      encoded packed results vs per-table-version cache hits.
    * ``join_builds`` / ``bytes_join_build`` — hash-partition builds of a
      join's build side and their bytes (also charged as an upload).

    * ``bytes_collective`` / ``collective_ops`` — the sharded backend's
      interconnect traffic: cross-shard combines of reduced partials and
      build-partition broadcasts (never O(rows)).
    * ``retries`` / ``failovers`` / ``bytes_failover`` — the sharded
      backend's shard-pass retries, root-device failovers and the shard
      bytes they re-shipped.

    The circuit breaker's reroutes (a CPU engine's only) are counted in
    ``engine.breaker.snapshot()``, as in the reference.
    """

    hot_hits: int = 0
    cold_misses: int = 0
    shared_scans: int = 0  # batched multi-view passes over a row store
    subsumed_requests: int = 0  # requests served by slicing a covering scan
    rows_projected: int = 0
    bytes_from_dram: int = 0  # bus-beat-accurate bytes the engine pulled
    bytes_to_cpu: int = 0  # packed bytes shipped up the hierarchy
    bytes_uploaded: int = 0  # host→device row-store transfer bytes (all)
    uploads: int = 0  # host→device row-store transfer count (all)
    bytes_uploaded_delta: int = 0  # of bytes_uploaded: delta-only transfers
    delta_uploads: int = 0  # of uploads: delta-only transfer events
    delta_hits: int = 0  # cache entries served by tail-chunk delta scans
    last_block_rows: int = 0  # row-tile height the fused-pass VMEM guard chose
    join_builds: int = 0  # build-side hash partitionings
    bytes_join_build: int = 0  # their partition-array bytes
    bytes_collective: int = 0  # cross-shard bytes (sharded backend)
    collective_ops: int = 0  # cross-shard combines and broadcasts
    retries: int = 0  # transient shard-pass / combine retries
    failovers: int = 0  # shard passes re-executed on the root device
    bytes_failover: int = 0  # shard bytes those failovers re-shipped
    bytes_saved_compression: int = 0  # plain-minus-narrow bytes codecs kept off the bus
    decodes: int = 0  # client-read decodes of encoded packed results
    decode_cache_hits: int = 0  # decode results served from the per-version cache

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)


@dataclasses.dataclass
class PassHandle:
    """One enqueued op batch: the named half of the launch/finalize split.

    ``execute_many`` never syncs with the host — every result it returns is
    a device tensor (or a cache hit) whose kernels may still be running.
    ``results`` is aligned with the submitted ops; ``block_until_ready()`` is
    the only blocking member.
    """

    results: list

    def block_until_ready(self) -> "PassHandle":
        devices = set()
        for r in self.results:
            for t in (r if isinstance(r, tuple) else (r,)):
                if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                    devices.add(t.device)
        with span(WAIT):
            for dev in devices:
                torch.cuda.synchronize(dev)
        return self


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ReorgCache:
    """Epoch-validated cache of reorganized views (the two SPMs of Fig. 5).

    An entry is valid iff its stored epoch equals the cache's current epoch —
    the paper's single-cycle invalidation.  Entries carry the **row
    coverage** they were built from (``table.row_count`` at build time):
    packed projections never include the hidden MVCC timestamp words, so an
    entry stays byte-valid for the rows it covers across any number of
    deletes/updates, and an append is delta-served (tail projection +
    concatenate) instead of discarded.
    """

    def __init__(self, capacity_bytes: int = 2 << 20):  # paper: 2 MB data SPM
        self.capacity_bytes = capacity_bytes
        self.epoch = 0
        self._entries: dict[tuple, tuple[int, object, torch.Tensor]] = {}
        self._bytes = 0

    def reset(self) -> None:
        """Single-cycle SPM invalidation: bump the epoch; entries expire lazily."""
        self.epoch += 1

    def peek(self, key: tuple, version) -> torch.Tensor | None:
        """Exact-version probe without side effects (the planner costs
        queries with it)."""
        hit = self._entries.get(key)
        if hit is None:
            return None
        epoch, ver, arr = hit
        if epoch != self.epoch or ver != version:
            return None
        return arr

    def lookup(self, key: tuple) -> tuple[object, torch.Tensor] | None:
        """Epoch-valid entry *regardless of version*: ``(version, arr)`` —
        the delta-serving probe.  Never mutates cache state."""
        hit = self._entries.get(key)
        if hit is None:
            return None
        epoch, ver, arr = hit
        if epoch != self.epoch:
            return None
        return ver, arr

    def put(self, key: tuple, version, arr: torch.Tensor) -> None:
        nbytes = _nbytes(arr)
        if nbytes > self.capacity_bytes:
            return  # larger than the SPM: streamed, never cached (paper §6 scaling)
        old = self._entries.pop(key, None)
        if old is not None:
            self._bytes -= _nbytes(old[2])
        # evict stale-epoch entries first, then FIFO until it fits
        for k in [k for k, (e, _, _) in self._entries.items() if e != self.epoch]:
            _, _, a = self._entries.pop(k)
            self._bytes -= _nbytes(a)
        while self._bytes + nbytes > self.capacity_bytes and self._entries:
            oldest = next(iter(self._entries))  # FIFO: evict the oldest insert
            _, _, a = self._entries.pop(oldest)
            self._bytes -= _nbytes(a)
        self._entries[key] = (self.epoch, version, arr)
        self._bytes += nbytes



@dataclasses.dataclass
class _StoreEntry:
    """One table's device residency: base + tail chunks and sync positions."""

    chunks: list[torch.Tensor]  # consecutive row ranges; concat == rows [0, rows)
    rows: int  # append watermark this copy has synced to
    patch_seq: int  # table.mutation_version this copy has replayed to


class DeviceRowStore:
    """Delta-chunked device-resident row-store buffers, keyed by ``table.uid``.

    The first access to a table ships its word buffer to the device; after
    that the copy is kept in sync incrementally: appended rows upload as a
    new **tail chunk**, deleted/updated rows replay the table's patch log
    (only the hidden ``__ts_end`` word of each touched row is rewritten), and
    nothing else re-crosses the host→device boundary.  With ``delta=False``
    any change re-ships the whole table (the pre-delta baseline).  Every
    transfer is charged to the engine's PMU.
    """

    def __init__(self, stats: EngineStats | None = None, delta: bool = True,
                 device: torch.device = torch.device("cpu")):
        self.stats = stats
        self.delta = delta
        self.device = device
        self._buffers: dict[int, _StoreEntry] = {}
        self._finalized: set[int] = set()  # uids with a registered finalizer

    @staticmethod
    def _finalize_entry(store_ref: "weakref.ref[DeviceRowStore]", uid: int) -> None:
        store = store_ref()
        if store is not None:
            store._buffers.pop(uid, None)
            store._finalized.discard(uid)

    # ----------------------------------------------------------------- sync
    def _charge(self, nbytes: int, is_delta: bool) -> None:
        if self.stats is None or nbytes == 0:
            return
        self.stats.uploads += 1
        self.stats.bytes_uploaded += nbytes
        if is_delta:
            self.stats.delta_uploads += 1
            self.stats.bytes_uploaded_delta += nbytes

    def _upload(self, host: np.ndarray) -> torch.Tensor:
        # a copy even on the CPU: the table mutates its buffer in place.  A
        # copy from pageable memory to the card waits for the stream
        src = torch.from_numpy(np.ascontiguousarray(host))
        with span(WAIT):
            return src.to(self.device, copy=True)

    def _full_upload(self, table: RelationalTable) -> _StoreEntry:
        faults.maybe_fault("upload", table=table.uid, delta=False)
        host = table.words()
        ent = _StoreEntry([self._upload(host)], table.row_count,
                          table.mutation_version)
        if table.uid not in self._finalized:
            # dead tables must not pin device memory: evict with their owner,
            # holding the store weakly (one finalizer per uid)
            weakref.finalize(table, self._finalize_entry, weakref.ref(self), table.uid)
            self._finalized.add(table.uid)
        self._buffers[table.uid] = ent
        self._charge(host.size * host.itemsize, is_delta=False)
        return ent

    def _apply_patches(self, ent: _StoreEntry, table: RelationalTable,
                       patches: list[np.ndarray]) -> int:
        """Rewrite patched ``__ts_end`` words inside the resident chunks.

        Only rows below the entry's pre-sync watermark need patching — rows
        at or above it arrive in the freshly uploaded tail chunk.  The words
        are patched in place (the reference builds new arrays): no packed
        block or cached view ever holds a timestamp word, so nothing handed
        out earlier can change under its holder.  Returns the bytes shipped.
        """
        idx = np.concatenate([p[p < ent.rows] for p in patches]) if patches else \
            np.empty(0, dtype=np.int64)
        if idx.size == 0:
            return 0
        vals = np.asarray(table.ts_end_at(idx))
        ts_word = table.ts_end_word
        start = 0
        for chunk in ent.chunks:
            end = start + chunk.shape[0]
            sel = (idx >= start) & (idx < end)
            if sel.any():
                rows = torch.from_numpy(idx[sel] - start)
                ends = torch.from_numpy(np.ascontiguousarray(vals[sel]))
                with span(WAIT):  # two copies from pageable memory
                    rows, ends = rows.to(self.device), ends.to(self.device)
                chunk[rows, ts_word] = ends
            start = end
        return idx.size * WORD  # one rewritten timestamp word per row

    def _sync(self, table: RelationalTable) -> _StoreEntry:
        """Bring the table's device copy current, shipping only the delta."""
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
            # before any entry mutation: a fault here leaves the resident
            # copy at its pre-sync state, so a bare retry re-syncs cleanly
            faults.maybe_fault("upload", table=table.uid, delta=True)
        moved = self._apply_patches(ent, table, patches)
        ent.patch_seq = table.mutation_version
        if table.row_count > ent.rows:
            tail = table.tail_words(ent.rows)
            ent.chunks.append(self._upload(tail))
            ent.rows = table.row_count
            moved += tail.size * tail.itemsize
        self._charge(moved, is_delta=True)
        if len(ent.chunks) > MAX_TAIL_CHUNKS:
            # device-side compaction: no host transfer, nothing charged
            ent.chunks = [torch.cat(ent.chunks, dim=0)]
        return ent

    # ------------------------------------------------------------ accessors
    def get(self, table: RelationalTable) -> torch.Tensor:
        """The table's row store as **one** device tensor (synced first);
        multi-chunk entries are coalesced device-side and kept coalesced."""
        ent = self._sync(table)
        if len(ent.chunks) > 1:
            ent.chunks = [torch.cat(ent.chunks, dim=0)]
        return ent.chunks[0]

    def chunks(self, table: RelationalTable) -> tuple[torch.Tensor, ...]:
        """The table's resident chunk list (synced first), for per-chunk scans."""
        return tuple(self._sync(table).chunks)

    def tail(self, table: RelationalTable, start_row: int) -> torch.Tensor:
        """Device rows ``[start_row, row_count)`` — the delta-scan operand for
        incrementally maintained views, sliced from the resident chunks."""
        ent = self._sync(table)
        parts, start = [], 0
        for chunk in ent.chunks:
            end = start + chunk.shape[0]
            if end > start_row:
                parts.append(chunk[max(start_row - start, 0):])
            start = end
        # the kernels take contiguous words; a row slice of a chunk is one
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


# -------------------------------------------------- request subsumption
def _geom_words(geom) -> tuple[int, ...]:
    """The absolute row-word indices a geometry enables, packed order."""
    words: list[int] = []
    for off, width in zip(geom.abs_offsets, geom.col_widths):
        words.extend(range(off // WORD, (off + width) // WORD))
    return tuple(words)


def _request_width(req: "KR.ScanRequest") -> int:
    """Covering-candidate ordering key: widest projections become the
    representatives, so subset requests fold into them."""
    if isinstance(req, (KR.ProjectRequest, KR.FilterRequest)):
        return len(_geom_words(req.geom))
    return -1  # aggregate/group-by requests never cover packed outputs


def _request_covers(a: "KR.ScanRequest", b: "KR.ScanRequest") -> bool:
    """Does serving ``a`` let the engine derive ``b``'s output exactly?

    ``a``'s enabled words must be a superset of ``b``'s and ``a``'s predicate
    weaker-or-equal, so every row ``b`` keeps is intact in ``a``'s packed
    output.  Aggregate/group-by outputs take no part.
    """
    if not isinstance(a, (KR.ProjectRequest, KR.FilterRequest)):
        return False
    if not isinstance(b, (KR.ProjectRequest, KR.FilterRequest)):
        return False
    aw = set(_geom_words(a.geom))
    if isinstance(b, KR.ProjectRequest):
        # a filter's packed output zeroes failing rows — never a pure project
        return isinstance(a, KR.ProjectRequest) and aw >= set(_geom_words(b.geom))
    need = set(_geom_words(b.geom))
    if b.pred_op != "none":
        need.add(b.pred_word)
    if isinstance(a, KR.ProjectRequest):
        # visibility lives in ts words the packed block does not carry
        return b.ts_word < 0 and aw >= need
    if (a.ts_word, a.ts) != (b.ts_word, b.ts):
        return False
    weaker = a.pred_op == "none" or (
        a.pred_word == b.pred_word
        and a.pred_dtype == b.pred_dtype
        and a.pred_op == b.pred_op
        and (a.pred_k <= b.pred_k if a.pred_op == "gt" else a.pred_k >= b.pred_k)
    )
    return weaker and aw >= need


def _cover_requests(
    reqs: tuple["KR.ScanRequest", ...],
) -> tuple[tuple["KR.ScanRequest", ...], dict]:
    """Greedy covering: (representatives in input order, covered→rep map)."""
    cover: dict = {}
    reps: list = []
    for req in sorted(reqs, key=_request_width, reverse=True):
        rep = next((r for r in reps if _request_covers(r, req)), None)
        if rep is not None:
            cover[req] = rep
        else:
            reps.append(req)
    return tuple(r for r in reqs if r not in cover), cover


class RelationalMemoryEngine:
    """Host-side RME: registers ephemeral views and materializes them on access.

    ``device`` is where the row store lives and the kernels run: ``None``
    means the card (a ``RuntimeError`` if there is none), ``"cpu"`` runs the
    plain PyTorch versions.  ``revision`` is the paper's §5.2 datapath:
    ``"bsl"``, ``"pck"`` or ``"mlp"``.  ``delta_uploads=False`` disables the write-path
    delta machinery (any change re-ships the table; a grown table turns
    cached views cold).  ``block_rows`` and ``vmem_bytes`` model the
    reference's row tile and 2 MB SPM: the fused-pass guard halves the
    modeled tile until it fits, exactly as the reference does, and records
    it in ``EngineStats.last_block_rows`` — the CUDA kernels choose their
    own tile.  ``breaker_threshold`` / ``breaker_cooldown`` configure the
    lowering circuit breaker (:attr:`breaker`), which reroutes on a CPU
    engine only.
    """

    def __init__(
        self,
        revision: str = "mlp",
        block_rows: int = K.DEFAULT_BLOCK_ROWS,
        cache_bytes: int = 2 << 20,
        vmem_bytes: int = 2 << 20,  # paper: 2 MB data SPM
        delta_uploads: bool = True,
        breaker_threshold: int = 3,
        breaker_cooldown: int = 4,
        subsume: bool = True,
        device: str | torch.device | None = None,
    ):
        K.check_revision(revision)
        self.device = common.resolve_device(device)
        self.revision = revision
        self.block_rows = block_rows
        self.vmem_bytes = vmem_bytes
        self.delta = delta_uploads
        # subsumption-aware sharing: a batch member whose projection ⊆ and
        # predicate ⊇ another's is served by slicing/masking the covering
        # request's output instead of its own slot in the fused pass
        self.subsume = subsume
        self.cache = ReorgCache(cache_bytes)
        self.stats = EngineStats()
        self.rowstore = DeviceRowStore(self.stats, delta=delta_uploads,
                                       device=self.device)
        # decode-on-finalize cache: decoded client reads of encoded packed
        # outputs, keyed per table version/storage epoch (FIFO-capped)
        self._decode_cache: dict[tuple, object] = {}
        # lowering circuit breaker: flips a repeatedly-failing (table,
        # request-shape) route to the plain version for a cooldown.  Only a
        # CPU engine consults it: the card has no fallback to flip to.
        self.breaker = faults.CircuitBreaker(
            threshold=breaker_threshold, cooldown=breaker_cooldown
        )
        self._reroutes = self.device.type == "cpu"

    @property
    def backend(self) -> str:
        """Execution-backend identity: ``"single"`` here, ``"sharded"`` on
        :class:`~repro_torch.core.distributed.ShardedEngine`.
        ``compile_plan(..., backend=...)`` validates against it."""
        return "single"

    # ---------------------------------------------------------------- config
    def register(
        self,
        table: RelationalTable,
        columns: Sequence[str],
        snapshot_ts: int | None = None,
        frame: int = 0,
    ) -> EphemeralView:
        """Configuration-port write: define a column-group view over ``table``.

        Nothing is materialized here; the returned view triggers the engine
        on first access.  ``snapshot_ts`` pins the view's MVCC visibility.
        """
        geom = TableGeometry.from_schema(
            table.schema, columns, row_count=table.row_count, frame=frame
        )
        return EphemeralView(self, table, tuple(columns), geom, snapshot_ts)

    def reset(self) -> None:
        """The configuration port's software reset SW (Table 1): invalidate
        the reorg cache (epoch bump, O(1)) and the planner's module-global
        join build cache (keyed by table version, not engine epoch, so it
        needs an explicit clear).  The device row store is kept — it mirrors
        the row store itself, not derived state."""
        self.cache.reset()
        from .planner import clear_join_build_cache  # deferred: planner imports us

        clear_join_build_cache()

    # --------------------------------------------------------------- engine
    def view_key(self, table: RelationalTable, geom: TableGeometry) -> tuple:
        """The reorg-cache key for a view: the column *layout* (row count
        excluded, so a grown table's view shares its slot and can be
        delta-served), the revision and the table's ``storage_epoch`` (a
        codec re-fit rewrites stored code words in place)."""
        return (table.uid, geom.layout_key(), self.revision,
                getattr(table, "storage_epoch", 0))

    def peek_project(self, table: RelationalTable,
                     geom: TableGeometry) -> torch.Tensor | None:
        """Side-effect-free full-hot probe for planner/server costing: the
        cached packed block iff it covers every current row."""
        return self.cache.peek(self.view_key(table, geom), table.row_count)

    def projection_is_cached(self, table: RelationalTable,
                             geom: TableGeometry) -> bool:
        """Side-effect-free: will :meth:`_project_from_cache` serve this
        view without a full scan (a full hot hit, or in delta mode a
        tail-only delta serve)?"""
        ent = self.cache.lookup(self.view_key(table, geom))
        if ent is None:
            return False
        rows_cached = ent[0]
        if rows_cached == table.row_count:
            return True
        return (self.delta and isinstance(rows_cached, int)
                and 0 < rows_cached < table.row_count)

    def device_words(self, table: RelationalTable) -> torch.Tensor:
        """The table's device-resident word buffer as one tensor (synced at
        O(delta) cost; multi-chunk entries are coalesced device-side)."""
        return self.rowstore.get(table)

    def device_chunks(self, table: RelationalTable) -> tuple[torch.Tensor, ...]:
        """The table's resident base+tail chunk list (synced, O(delta))."""
        return self.rowstore.chunks(table)

    def valid_mask(self, table: RelationalTable, ts: int) -> torch.Tensor:
        """MVCC row visibility at snapshot ``ts`` from the device-resident
        hidden timestamp words: ``ts_begin <= ts < ts_end``."""
        words = self.device_words(table)
        begin = words[:, table.ts_begin_word]
        end = words[:, table.ts_end_word]
        return (begin <= ts) & (ts < end)

    def _project_from_cache(
        self, table: RelationalTable, geom: TableGeometry
    ) -> torch.Tensor | None:
        """Serve a projection from the reorg cache: full hot hit, or an
        incremental tail scan over the appended rows merged with the cached
        block (delta serve).  Returns ``None`` when a cold rebuild is needed.
        Packed projections contain only user-column words, so coverage is
        the only axis: an entry built at watermark ``w`` is byte-exact for
        rows ``[0, w)`` forever.
        """
        ent = self.cache.lookup(self.view_key(table, geom))
        if ent is None:
            return None
        rows_cached, cached = ent
        if rows_cached == table.row_count:
            self.stats.hot_hits += 1
            return cached
        if not self.delta:  # pre-delta compatibility mode: growth = cold
            return None
        if not isinstance(rows_cached, int) or not 0 < rows_cached < table.row_count:
            return None
        # incremental view maintenance: project only the appended tail
        n_tail = table.row_count - rows_cached
        tail = self.rowstore.tail(table, rows_cached)
        tail_geom = dataclasses.replace(geom, row_count=n_tail)
        packed_tail = K.project_any(tail, tail_geom, revision=self.revision)
        packed = torch.cat([cached, packed_tail], dim=0)
        self.stats.delta_hits += 1
        self.stats.cold_misses += 1  # a (tail-sized) scan did run
        moved = bytes_moved(tail_geom)
        self.stats.rows_projected += n_tail
        self.stats.bytes_from_dram += moved["rme"]
        self.stats.bytes_to_cpu += moved["columnar"]
        self.cache.put(self.view_key(table, geom), table.row_count, packed)
        return packed

    def materialize(self, view: EphemeralView) -> torch.Tensor:
        """Assemble the packed column group for ``view``: hot out of the
        reorganization cache, incrementally (cached block + tail scan) when
        the table only grew, or cold through the projection kernel."""
        table, geom = view.table, view.geometry
        served = self._project_from_cache(table, geom)
        if served is not None:
            return served
        self.stats.cold_misses += 1
        words = self.device_words(table)
        packed = K.project_any(words, geom, revision=self.revision)
        moved = bytes_moved(geom)
        self.stats.rows_projected += geom.row_count
        self.stats.bytes_from_dram += moved["rme"]
        self.stats.bytes_to_cpu += moved["columnar"]
        self.cache.put(self.view_key(table, geom), table.row_count, packed)
        return packed

    def stream_project(self, view: EphemeralView,
                       chunk_rows: int | None = None):
        """The view's packed projection as an iterator of chunks, one per
        resident row-store chunk (re-sliced to at most ``chunk_rows`` rows,
        never below ``MIN_STREAM_CHUNK_ROWS``).

        Charging is per emitted chunk, with the rules of a cold
        materialization of that many rows.  A view the reorg cache serves
        arrives as one free chunk; a cold stream's concatenation lands in
        the cache after the last chunk.  The *call* snapshots the resident
        chunk list eagerly (uploading what is needed); only the per-chunk
        scans are lazy, so writes applied after the call cannot leak into
        the stream.
        """
        table, geom = view.table, view.geometry
        served = self._project_from_cache(table, geom)
        if served is not None:
            return iter((served,))
        self.stats.cold_misses += 1
        if chunk_rows is not None:
            chunk_rows = max(int(chunk_rows), MIN_STREAM_CHUNK_ROWS)
        chunks = tuple(self.device_chunks(table))
        return self._stream_chunks(table, geom, chunks, chunk_rows,
                                   table.row_count)

    def _stream_chunks(self, table: RelationalTable, geom, chunks,
                       chunk_rows: int | None, row_count: int):
        """The lazy half of :meth:`stream_project`: scan + charge + yield
        per chunk, then cache the concatenation under the snapshotted
        ``row_count``."""
        parts = []
        for chunk in chunks:
            start = 0
            while start < chunk.shape[0]:
                faults.maybe_fault("stream_chunk", table=table.uid,
                                   index=len(parts))
                stop = (chunk.shape[0] if chunk_rows is None
                        else min(start + chunk_rows, chunk.shape[0]))
                piece = chunk[start:stop]  # a row slice of a chunk is contiguous
                start = stop
                cg = dataclasses.replace(geom, row_count=piece.shape[0])
                packed = K.project_any(piece, cg, revision=self.revision)
                moved = bytes_moved(cg)
                self.stats.rows_projected += cg.row_count
                self.stats.bytes_from_dram += moved["rme"]
                self.stats.bytes_to_cpu += moved["columnar"]
                parts.append(packed)
                yield packed
        if parts:
            full = parts[0] if len(parts) == 1 else torch.cat(parts, 0)
            self.cache.put(self.view_key(table, geom), row_count, full)

    def execute_many(self, ops: Sequence[ScanOp]) -> list:
        """Serve a heterogeneous op batch with one shared scan per table.

        Any mix of project / filter / aggregate / group-by / join ops is
        coalesced per table: each table's cold work is lowered to kernel
        scan requests (equal requests share one output slot; a request
        another covers is derived from it), and two or more requests run one
        fused pass per resident chunk, combined across chunks, with bus-beat
        bytes charged once per chunk via the union geometry.  A lone request
        keeps its single-op kernel; a lone unpredicated join streams the
        probe over the row-store chunks instead.  Hot projections are served
        from the reorganization cache (including delta serves over appended
        tails), and every cold projection lands there.  Results are returned
        in input order, each matching its op's single-op contract.
        """
        for op in ops:
            if not isinstance(op, (ProjectOp, FilterOp, AggregateOp, GroupByOp,
                                   JoinOp)):
                raise TypeError(f"not a scan op: {type(op).__name__}")
        results: list = [None] * len(ops)
        pending: dict[int, list[tuple[int, KR.ScanRequest]]] = {}
        tables: dict[int, RelationalTable] = {}
        for i, op in enumerate(ops):
            if isinstance(op, ProjectOp):
                served = self._project_from_cache(op.table, op.view.geometry)
                if served is not None:
                    results[i] = served
                    continue
            pending.setdefault(op.table.uid, []).append((i, op.lower()))
            tables[op.table.uid] = op.table
        for tid, entries in pending.items():
            table = tables[tid]
            uniq = dict.fromkeys(req for _, req in entries)
            reqs = tuple(uniq)
            self.stats.cold_misses += len(entries)
            if (len(entries) == 1 and isinstance(ops[entries[0][0]], JoinOp)
                    and ops[entries[0][0]].pred_op == "none"):
                # a join alone on its table skips the packed materialization:
                # the probe streams the row-store chunks, and nothing crosses
                # toward the CPU but the join result
                results[entries[0][0]] = self._join_direct(ops[entries[0][0]])
                continue
            cover: dict = {}
            if self.subsume and len(reqs) > 1:
                reqs, cover = _cover_requests(reqs)
            outs = self._serve_scan(table, reqs, shared=bool(cover))
            by_req = dict(zip(reqs, outs))
            for req, rep in cover.items():
                by_req[req] = self._derive_covered(rep, req, by_req[rep])
            self.stats.subsumed_requests += len(cover)
            # a packed block consumed only by join probes stays on the
            # device: bytes_to_cpu is charged only for a non-join consumer
            cpu_reqs = {req for i, req in entries
                        if not isinstance(ops[i], JoinOp)}
            for req, out in by_req.items():
                if isinstance(req, KR.ProjectRequest):
                    geom = req.geom
                    if req in cpu_reqs:
                        self.stats.bytes_to_cpu += (
                            geom.row_count * geom.out_bytes_per_row)
                    self.cache.put(
                        self.view_key(table, geom), table.row_count, out
                    )
            for i, req in entries:
                out = by_req[req]
                results[i] = (self._finish_join(ops[i], out)
                              if isinstance(ops[i], JoinOp)
                              else finalize_scan_result(ops[i], out))
        return results

    def execute_many_async(self, ops: Sequence[ScanOp]) -> PassHandle:
        """:meth:`execute_many` wrapped in a :class:`PassHandle`: identical
        serving and accounting, nothing synced with the host."""
        with span("rm::engine.pass"):
            return PassHandle(self.execute_many(ops))

    def materialize_many(self, views: Sequence[EphemeralView]) -> list[torch.Tensor]:
        """Materialize a batch of views with one shared scan per table
        (each view becomes a :class:`ProjectOp` of :meth:`execute_many`)."""
        return self.execute_many([ProjectOp(v) for v in views])

    # -------------------------------------------- fused one-pass internals
    def _serve_scan(self, table: RelationalTable,
                    reqs: tuple["KR.ScanRequest", ...],
                    shared: bool = False) -> list:
        """Serve one table's de-duplicated request tuple.

        A lone request runs its single-op kernel (no shared scan counted);
        two or more fuse into one heterogeneous pass per resident chunk.
        ``shared=True`` forces the fused path for a lone request too — how a
        subsumption-collapsed batch keeps the union-geometry charging and
        ``shared_scans`` accounting of the multi-consumer pass it replaces.
        """
        faults.maybe_fault("scan_launch", table=table.uid)
        if len(reqs) == 1 and not shared:
            words = self.device_words(table)
            return [self._execute_solo(words, table, reqs[0])]
        chunks = self.device_chunks(table)
        self._fused_block_rows(reqs, table.row_words)  # the modeled guard
        route = ((table.uid, tuple(KR._strip_dynamic(r) for r in reqs))
                 if self._reroutes else None)
        per_chunk = [self._scan_chunk(chunk, reqs, route) for chunk in chunks]
        outs = (per_chunk[0] if len(per_chunk) == 1 else [
            KR.combine_chunk_outputs(req, [o[r] for o in per_chunk])
            for r, req in enumerate(reqs)
        ])
        self.stats.shared_scans += 1
        self.stats.rows_projected += table.row_count
        for chunk in chunks:
            self.charge_scan(table, reqs, row_count=chunk.shape[0])
        return outs

    def _guarded(self, route, op: str, kernel, plain):
        """Kernel dispatch behind the lowering circuit breaker.

        On a CPU engine (``route`` is its key) a ``closed`` route runs
        ``kernel()``; an injected ``lowering`` fault records a failure
        against the route and this serve runs ``plain()`` (same results);
        an ``open`` route skips the attempt for the cooldown.  On the card
        (``route`` is ``None``) there is no fallback: ``plain()`` is never
        called and an injected ``lowering`` fault propagates.  Every other
        exception — injected faults of other sites, and any real error of a
        kernel — propagates unrecorded."""
        if route is None:
            faults.maybe_fault("lowering", op=op)
            return kernel()
        if not self.breaker.allow(route):
            return plain()
        try:
            faults.maybe_fault("lowering", op=op)
            out = kernel()
        except faults.FaultError as err:
            if err.site != "lowering":
                raise
            self.breaker.record_failure(route)
            return plain()
        self.breaker.record_success(route)
        return out

    def _scan_chunk(self, chunk: torch.Tensor,
                    reqs: tuple["KR.ScanRequest", ...], route) -> list:
        """One chunk's fused pass behind the breaker: the CUDA kernel on the
        card, its plain version on the CPU."""
        return self._guarded(route, "scan", lambda: KR.scan_multi(chunk, reqs),
                             lambda: KR.scan_multi_torch(chunk, reqs))

    def _execute_solo(self, words: torch.Tensor, table: RelationalTable,
                      req: "KR.ScanRequest"):
        """One request: accounting here, kernel dispatch behind the breaker
        in :meth:`_solo_kernel` (a zero-row store launches nothing and, as
        in the reference, skips the breaker)."""
        if isinstance(req, KR.ProjectRequest):
            self.stats.rows_projected += req.geom.row_count
            self.stats.bytes_from_dram += bytes_moved(req.geom)["rme"]
        else:
            self.stats.rows_projected += table.row_count
            self.charge_scan(table, (req,))
        if words.shape[0] == 0:
            return self._solo_kernel(words, req)
        route = (table.uid, (KR._strip_dynamic(req),)) if self._reroutes else None
        return self._guarded(route, "scan", lambda: self._solo_kernel(words, req),
                             lambda: KR.scan_multi_torch(words, (req,))[0])

    def _solo_kernel(self, words: torch.Tensor, req: "KR.ScanRequest"):
        """Single-op kernel dispatch."""
        if isinstance(req, KR.ProjectRequest):
            return K.project_any(words, req.geom, revision=self.revision)
        if isinstance(req, KR.FilterRequest):
            return K.filter_project(
                words, req.geom, pred_word=req.pred_word,
                pred_dtype=req.pred_dtype, pred_op=req.pred_op,
                pred_k=req.pred_k, ts=req.ts, ts_word=req.ts_word,
            )
        if isinstance(req, KR.AggregateRequest):
            return K.aggregate(
                words, agg_word=req.agg_word, agg_dtype=req.agg_dtype,
                pred_word=req.pred_word, pred_dtype=req.pred_dtype,
                pred_op=req.pred_op, pred_k=req.pred_k, ts=req.ts,
                ts_word=req.ts_word,
            )
        return K.groupby_sum(
            words, group_word=req.group_word, agg_word=req.agg_word,
            num_groups=req.num_groups, agg_dtype=req.agg_dtype,
            pred_word=req.pred_word, pred_dtype=req.pred_dtype,
            pred_op=req.pred_op, pred_k=req.pred_k, ts=req.ts,
            ts_word=req.ts_word,
        )

    def _derive_covered(self, covering: "KR.ScanRequest",
                        covered: "KR.ScanRequest", out):
        """Finalize a subsumed request from its covering request's output:
        a column gather of the covering packed block, and for a covered
        filter its (code-space) predicate re-evaluated on the raw packed
        words.  No row-store pass, no decode."""
        geom = covering.geom
        word_out: dict[int, int] = {}
        for off, width in zip(geom.abs_offsets, geom.col_widths):
            for j in range(width // WORD):
                word_out[off // WORD + j] = len(word_out)
        packed, mask = (out if isinstance(covering, KR.FilterRequest)
                        else (out, None))
        # the index and the constant are kept on the device (device_map): a
        # first upload does not wait for the stream, a repeated one is none
        idx = device_map([word_out[w] for w in _geom_words(covered.geom)],
                         packed.device)
        sliced = packed.index_select(1, idx)
        if isinstance(covered, KR.ProjectRequest):
            return sliced
        if covered.pred_op != "none":
            vals = common.decode(packed[:, word_out[covered.pred_word]],
                                 covered.pred_dtype)
            k_bits = device_map(
                [common.pred_k_bits(covered.pred_k, covered.pred_dtype)],
                packed.device)
            k = common.decode(k_bits, covered.pred_dtype)
            m = vals > k if covered.pred_op == "gt" else vals < k
        else:
            m = torch.ones(sliced.shape[0], dtype=torch.bool, device=packed.device)
        if mask is not None:
            m = m & mask
        return torch.where(m[:, None], sliced, torch.zeros_like(sliced)), m

    # ---------------------------------------------- device-resident join
    def _build_join_partitions(self, table: RelationalTable, key: str,
                               payload: str):
        """Hash-partition the build side's {key, payload, ts} columns into
        buckets on the engine's device and insert them into the planner's
        join build cache (one build per build-table version).  The upload
        is charged once here: ``bytes_uploaded``/``uploads`` plus the
        ``join_builds``/``bytes_join_build`` split."""
        from .planner import DEVICE_JOIN_PATH, _insert_build_index

        faults.maybe_fault("join_build", table=table.uid)
        words = table.words()
        parts = K.build_partitions(
            words[:, table.schema.word_offset(key)],
            words[:, table.schema.word_offset(payload)],
            words[:, table.ts_begin_word],
            words[:, table.ts_end_word],
            device=self.device,
        )
        self.stats.join_builds += 1
        self.stats.bytes_join_build += parts.nbytes
        self.stats.uploads += 1
        self.stats.bytes_uploaded += parts.nbytes
        _insert_build_index(parts, table, key, payload, DEVICE_JOIN_PATH)
        return parts

    def _op_partitions(self, op: JoinOp):
        """The op's build partitions: the compile-time cache hit, or a fresh
        build-and-insert."""
        if op.partitions is not None:
            return op.partitions
        return self._build_join_partitions(op.right_table, op.key,
                                           op.right_proj)

    def _probe_join(self, words: torch.Tensor, partitions, key_word: int,
                    val_word: int, ts_word: int, ts: int, build_ts: bool,
                    route):
        """One probe pass behind the breaker (``route`` is the caller's key,
        ``None`` on the card): the CUDA kernel on the card, its plain version
        on the CPU.
        The reference's SPM guard is kept as a model: the row tile is halved
        while the modeled working set (row tile + resident buckets) exceeds
        ``vmem_bytes``, and the choice lands in
        ``EngineStats.last_block_rows``."""
        block_rows = self.block_rows
        while (block_rows // 2 >= MIN_FUSED_BLOCK_ROWS
               and K.probe_vmem_footprint_bytes(
                   partitions, words.shape[1], block_rows) > self.vmem_bytes):
            block_rows //= 2
        self.stats.last_block_rows = block_rows
        args = (words, partitions, key_word, val_word, ts_word, ts, build_ts)
        return self._guarded(route, "join", lambda: K.hash_join(*args),
                             lambda: K.hash_join_torch(*args))

    def _join_direct(self, op: JoinOp) -> JoinResult:
        """Solo join: stream the probe over the device row-store chunks (no
        packed materialization).  Bus beats are charged per chunk via the
        union geometry of the probe-side request."""
        table = op.table
        parts = self._op_partitions(op)
        chunks = self.device_chunks(table)
        key_word = table.schema.word_offset(op.key)
        val_word = table.schema.word_offset(op.left_proj)
        snap = op.snapshot_ts is not None
        ts_word = table.ts_begin_word if snap else -1
        route = (table.uid, "join") if self._reroutes else None
        outs = [
            self._probe_join(chunk, parts, key_word, val_word, ts_word,
                             op.snapshot_ts or 0, snap, route)
            for chunk in chunks
        ]
        acc_req = op.lower()  # its intervals are exactly the probe footprint
        self.stats.rows_projected += table.row_count
        for chunk in chunks:
            self.charge_scan(table, (acc_req,), row_count=chunk.shape[0])
        return JoinResult.concat([JoinResult(*o) for o in outs])

    def _finish_join(self, op: JoinOp, out) -> JoinResult:
        """Probe a shared-scan output: the op's probe-side scan rode the
        fused pass (a packed block, or ``(packed, mask)`` under a snapshot
        or predicate); the bucket probe runs on that block, so the join
        costs the tick no extra row-store pass."""
        parts = self._op_partitions(op)
        packed, mask = out if isinstance(out, tuple) else (out, None)
        key_word, _ = op.view.column_words(op.key)
        val_word, _ = op.view.column_words(op.left_proj)
        s, r, m = self._probe_join(
            packed, parts, key_word, val_word, ts_word=-1,
            ts=op.snapshot_ts or 0, build_ts=op.snapshot_ts is not None,
            route=(op.table.uid, "join") if self._reroutes else None,
        )
        if mask is not None:  # packed blocks carry no ts words: mask outside
            zero = torch.zeros((), dtype=s.dtype, device=s.device)
            s = torch.where(mask, s, zero)
            r = torch.where(mask, r, zero)
            m = m & mask
        return JoinResult(s_proj=s, r_proj=r, matched=m)

    def scan_bytes(self, table: RelationalTable,
                   reqs: Sequence["KR.ScanRequest"],
                   row_count: int | None = None) -> int:
        """Bus-beat bytes of one pass serving ``reqs``: Eq. (3) bursts over
        the union of every request's enabled words (``row_count`` prices a
        pass over one chunk).  The row stride is the schema's unless a fused
        MVCC snapshot enables the hidden timestamp words; encoded columns are
        priced at the codecs' narrow word budget, capped by the plain cost.
        """
        narrow, _ = self._scan_bytes_pair(table, reqs, row_count)
        return narrow

    def charge_scan(self, table: RelationalTable,
                    reqs: Sequence["KR.ScanRequest"],
                    row_count: int | None = None) -> int:
        """Book one pass's bus-beat bytes — the single charge point:
        ``bytes_from_dram`` takes the (possibly codec-narrowed) cost,
        ``bytes_saved_compression`` the plain-minus-narrow remainder."""
        narrow, plain = self._scan_bytes_pair(table, reqs, row_count)
        self.stats.bytes_from_dram += narrow
        self.stats.bytes_saved_compression += plain - narrow
        return narrow

    def _scan_bytes_pair(self, table: RelationalTable,
                         reqs: Sequence["KR.ScanRequest"],
                         row_count: int | None = None) -> tuple[int, int]:
        """(narrow, plain) Eq.(3) bytes of one pass; equal when no enabled
        word is codec-backed."""
        max_end = max(o + w for r in reqs for o, w in K.request_intervals(r))
        row_bytes = table.schema.row_bytes
        if max_end > row_bytes:
            row_bytes = table.row_words * WORD
        rows = table.row_count if row_count is None else row_count
        union = K.union_geometry(reqs, row_bytes=row_bytes, row_count=rows)
        plain = bytes_moved(union)["rme"]
        codecs = getattr(table, "codecs", None)
        if not codecs:
            return plain, plain
        enabled: set[int] = set()
        for r in reqs:
            for o, w in K.request_intervals(r):
                enabled.update(range(o // WORD, -(-(o + w) // WORD)))
        by_word = {table.schema.word_offset(n): c for n, c in codecs.items()}
        if not any(w in enabled for w in by_word):
            return plain, plain
        per_row = sum(
            by_word[w].code_bytes if w in by_word else WORD for w in enabled
        )
        return min(plain, rows * per_row), plain

    # FIFO cap on cached decoded client reads
    DECODE_CACHE_MAX = 64

    def decode_column(self, table: RelationalTable, name: str, codes,
                      token: tuple = ()):
        """Decode-on-finalize: map a packed result's raw code words for
        column ``name`` back to values, cached per table version — the only
        place the engine decodes."""
        codec = table.codecs[name]
        key = (table.uid, name, table.version,
               getattr(table, "storage_epoch", 0), token)
        if key in self._decode_cache:
            self.stats.decode_cache_hits += 1
            return self._decode_cache[key]
        self.stats.decodes += 1
        out = codec.decode(codes)
        while len(self._decode_cache) >= self.DECODE_CACHE_MAX:
            self._decode_cache.pop(next(iter(self._decode_cache)))
        self._decode_cache[key] = out
        return out

    def _fused_block_rows(self, reqs: Sequence["KR.ScanRequest"],
                          row_words: int) -> int:
        """SPM budget guard of the reference: halve the modeled row tile until
        the fused pass's modeled VMEM working set fits ``vmem_bytes`` (never
        below the floor).  Kept for the accounting only."""
        block_rows = self.block_rows
        while (block_rows // 2 >= MIN_FUSED_BLOCK_ROWS
               and K.scan_vmem_footprint_bytes(reqs, row_words, block_rows)
               > self.vmem_bytes):
            block_rows //= 2
        self.stats.last_block_rows = block_rows
        return block_rows

    def aggregate_async(
        self,
        table: RelationalTable,
        agg_col: str,
        pred_col: str | None = None,
        pred_op: str = "none",
        pred_k=0,
        snapshot_ts: int | None = None,
    ) -> torch.Tensor:
        """Non-blocking fused aggregate: the device ``[sum, count]`` pair, as
        a one-op :meth:`execute_many` batch.  No ``bytes_to_cpu`` here —
        nothing crosses to the host until a caller syncs."""
        op = AggregateOp(table, agg_col, pred_col=pred_col, pred_op=pred_op,
                         pred_k=pred_k, snapshot_ts=snapshot_ts)
        return self.execute_many([op])[0]

    def aggregate(
        self,
        table: RelationalTable,
        agg_col: str,
        pred_col: str | None = None,
        pred_op: str = "none",
        pred_k=0,
        snapshot_ts: int | None = None,
    ) -> tuple[float, float]:
        """Fused near-memory ``SELECT SUM(agg), COUNT(*) WHERE pred`` (Q0/Q3):
        the blocking wrapper around :meth:`aggregate_async` (the one host
        sync)."""
        out = self.aggregate_async(
            table, agg_col, pred_col=pred_col, pred_op=pred_op, pred_k=pred_k,
            snapshot_ts=snapshot_ts,
        )
        self.stats.bytes_to_cpu += 8  # the [sum, count] pair crosses on sync
        with span(WAIT):
            host = out.cpu()
        return float(host[0]), float(host[1])

    def vmem_budget_bytes(self, geom: TableGeometry) -> int:
        """The 'area report' analogue: the reference kernels' modeled VMEM
        working set of one engine step for ``geom`` under this revision."""
        return K.vmem_footprint_bytes(geom, self.block_rows, self.revision)
