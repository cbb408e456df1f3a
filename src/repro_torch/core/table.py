"""Row-major in-memory relational table with MVCC timestamps (paper §4) —
the port's own copy of ``repro.core.table`` (numpy only), plus
:meth:`RelationalTable.from_state` to carry a table across from a plain dict.

The base data is *always* a row store ("the source data tables are always stored
in physical memory according to the same format — i.e., as a row-store").  Host
numpy plays the role of DRAM: appends and in-place updates are cheap row-wise
operations.  Analytics never touch this buffer directly — they go through
ephemeral column-group views that the RME materializes on the fly (ephemeral.py).

MVCC (paper §4): every row carries two hidden timestamp fields.  ``ts_begin`` is
set at insertion, ``ts_end`` marks deletion/replacement (``TS_INF`` while live).
A snapshot at time ``t`` sees rows with ``ts_begin <= t < ts_end`` — snapshot
isolation, exactly the scheme the paper sketches.

Write-path change tracking
--------------------------
The table exposes its mutation history in two orthogonal pieces instead of one
monolithic version counter, because the two kinds of OLTP write touch storage
in structurally different ways:

* **Appends** only ever add rows at the tail.  ``append_watermark`` (an alias
  of ``row_count``) is the high-water mark: physical rows ``[0, w)`` are
  immutable *in their user-column words* once written — all later writes land
  at ``>= w`` or in the hidden ``__ts_end`` word.
* **Destructive mutations** (``delete``, and the delete half of ``update``)
  rewrite exactly one hidden word per touched row (``__ts_end``).
  ``mutation_version`` counts these events, and the **patch log** records the
  physical rows each event touched, so a consumer holding an older device copy
  can replay just the patched timestamp words instead of re-reading the table
  (``patches_since``).

``version`` is the derived pair ``(row_count, mutation_version)``: equal
versions imply byte-identical storage, so it remains a valid cache-invalidation
token for consumers that don't care about deltas (e.g. the q5 build-index
cache), while delta-aware consumers (:class:`~repro_torch.core.engine.DeviceRowStore`,
the reorganization cache) compare the components to ship O(delta) bytes.
"""

from __future__ import annotations

import itertools
from typing import Mapping, Sequence

import numpy as np

from .compression import Codec, DeltaCodec, DictCodec, fit_codec
from .schema import Column, TableSchema

# process-unique table identities for engine-side caches: id() values are
# recycled by the allocator, so a dead table's address can resurrect its
# cache entries — uid never repeats
_TABLE_UIDS = itertools.count()

TS_INF = np.iinfo(np.int32).max

_MVCC_COLS = (Column("__ts_begin", "int32"), Column("__ts_end", "int32"))

# the patch log keeps at most this many delete events; consumers lagging
# further behind fall back to a full re-sync (DeviceRowStore re-upload)
MAX_PATCH_EVENTS = 256


def _storage_schema(schema: TableSchema) -> TableSchema:
    return TableSchema(schema.columns + _MVCC_COLS)


def _encode_column(col: Column, values: np.ndarray, n: int) -> np.ndarray:
    """Encode ``values`` for ``col`` into an (n, col.words) int32 word array."""
    if col.dtype == "char":
        raw = np.zeros((n, col.width), dtype=np.uint8)
        vals = np.asarray(values, dtype=np.dtype((np.bytes_, col.width)))
        raw[:] = vals.view(np.uint8).reshape(n, col.width)
        return raw.view(np.int32).reshape(n, col.words)
    arr = np.ascontiguousarray(np.asarray(values, dtype=col.np_dtype))
    return arr.view(np.int32).reshape(n, col.words)


def _decode_column(col: Column, words: np.ndarray) -> np.ndarray:
    """Decode an (n, col.words) int32 word array back to ``col``'s dtype."""
    n = words.shape[0]
    raw = np.ascontiguousarray(words, dtype=np.int32)
    if col.dtype == "char":
        return raw.view(np.uint8).reshape(n, col.width).view(
            np.dtype((np.bytes_, col.width))
        ).reshape(n)
    return raw.view(col.np_dtype).reshape(n)


class RelationalTable:
    """Append-friendly row store over int32 words (the 'DRAM' of the system).

    Storage is ``(capacity, row_words)`` int32; the user-visible schema is
    extended with the two MVCC word columns.  Mutations are tracked at delta
    granularity: appends advance ``append_watermark`` (= ``row_count``),
    destructive mutations advance ``mutation_version`` and log the patched
    rows, and the derived ``version`` pair invalidates anything cached against
    an older state — mirroring the RME's single-cycle SPM invalidation without
    forcing full re-materialization on O(1) writes.
    """

    def __init__(self, schema: TableSchema, capacity: int = 1024,
                 codecs: Mapping[str, Codec] | None = None):
        self.schema = schema
        self.storage_schema = _storage_schema(schema)
        self._words = np.zeros(
            (max(capacity, 16), self.storage_schema.row_words), dtype=np.int32
        )
        self.row_count = 0
        self.uid = next(_TABLE_UIDS)  # never-recycled cache identity
        self._clock = 0
        # destructive-mutation tracking: one patch-log entry (the touched
        # physical rows) per delete event; the base index supports trimming
        self._patch_log: list[np.ndarray] = []
        self._patch_base = 0
        # table-level codecs (paper §4): encoded columns store int32 code
        # words; ``codecs`` pre-seeds fitted codecs (e.g. one dictionary
        # shared by two tables' join keys), and columns *declaring* a codec
        # in the schema get an empty fit here that the first append re-fits.
        # ``storage_epoch`` counts in-place re-encodes of stored words — the
        # one mutation appends/patches can't describe — so any device copy
        # or derived cache must treat an epoch bump as a full re-sync.
        self.codecs: dict[str, Codec] = {}
        self.storage_epoch = 0
        for name, codec in (codecs or {}).items():
            col = schema.column(name)  # raises KeyError for unknown names
            if col.dtype not in ("int32", "str"):
                raise ValueError(
                    f"column {name!r}: codecs need int32 or str storage,"
                    f" not {col.dtype}"
                )
            self.codecs[name] = codec
        for col in schema.columns:
            if col.codec is not None and col.name not in self.codecs:
                empty = np.array(
                    [], dtype=np.str_ if col.dtype == "str" else np.int32
                )
                self.codecs[col.name] = fit_codec(col.codec, empty)

    # ------------------------------------------------------------------ time
    def now(self) -> int:
        return self._clock

    def tick(self) -> int:
        self._clock += 1
        return self._clock

    # ------------------------------------------------------------- versioning
    @property
    def append_watermark(self) -> int:
        """Rows ``[0, append_watermark)`` exist; their user-column words are
        immutable (only the hidden ``__ts_end`` word may change later)."""
        return self.row_count

    @property
    def mutation_version(self) -> int:
        """Count of destructive-mutation events (``delete`` / ``update``)."""
        return self._patch_base + len(self._patch_log)

    @property
    def version(self) -> tuple[int, int]:
        """``(append_watermark, mutation_version)`` — equal pairs imply
        byte-identical storage.  Kept as the coarse invalidation token for
        consumers without a delta path."""
        return (self.row_count, self.mutation_version)

    @property
    def ts_begin_word(self) -> int:
        return self.schema.row_words

    @property
    def ts_end_word(self) -> int:
        return self.schema.row_words + 1

    def patches_since(self, seq: int) -> list[np.ndarray] | None:
        """Patched-row arrays for mutation events ``(seq, mutation_version]``.

        Returns ``None`` when ``seq`` predates the trimmed log — the caller's
        copy is too old to patch forward and must fully re-sync.  Each entry
        lists physical rows whose ``__ts_end`` word was rewritten by one
        event; replaying them in order (values from :meth:`ts_end_at`)
        reproduces the current timestamp state.
        """
        if seq < self._patch_base:
            return None
        return self._patch_log[seq - self._patch_base :]

    def ts_end_at(self, rows: np.ndarray) -> np.ndarray:
        """Current ``__ts_end`` words of the given physical rows."""
        return self._words[np.asarray(rows), self.ts_end_word]

    def _log_patch(self, rows: np.ndarray) -> None:
        self._patch_log.append(np.asarray(rows, dtype=np.int64))
        if len(self._patch_log) > MAX_PATCH_EVENTS:
            drop = len(self._patch_log) - MAX_PATCH_EVENTS
            del self._patch_log[:drop]
            self._patch_base += drop

    # --------------------------------------------------------------- storage
    @property
    def row_words(self) -> int:
        return self.storage_schema.row_words

    @property
    def row_bytes(self) -> int:
        return self.storage_schema.row_bytes

    def words(self) -> np.ndarray:
        """The live row-major word buffer (view; do not mutate)."""
        return self._words[: self.row_count]

    def tail_words(self, start_row: int) -> np.ndarray:
        """Rows ``[start_row, row_count)`` — the append delta a consumer that
        synced at watermark ``start_row`` still has to ship."""
        return self._words[start_row : self.row_count]

    def _grow(self, need: int) -> None:
        cap = self._words.shape[0]
        if need <= cap:
            return
        new_cap = max(need, cap * 2)
        grown = np.zeros((new_cap, self.row_words), dtype=np.int32)
        grown[: self.row_count] = self._words[: self.row_count]
        self._words = grown

    def _append_rows(self, n: int, ts: int) -> int:
        """Reserve ``n`` tail rows stamped ``[ts, TS_INF)``; returns the start."""
        self._grow(self.row_count + n)
        at = self.row_count
        self._words[at : at + n, self.ts_begin_word] = ts
        self._words[at : at + n, self.ts_end_word] = TS_INF
        return at

    # ------------------------------------------------------------ compression
    def _value_dtype(self, col: Column) -> np.dtype:
        return np.dtype(np.str_ if col.dtype == "str" else np.int32)

    def _encode_stored(self, col: Column, values: np.ndarray, n: int) -> np.ndarray:
        """``values`` -> the (n, col.words) int32 words the row store keeps:
        codec code words for encoded columns, plain words otherwise.  New
        values outside the fitted codec trigger an honest re-fit (never a
        silent corruption): see :meth:`_refit_codec`."""
        codec = self.codecs.get(col.name)
        if codec is None:
            return _encode_column(col, values, n)
        values = np.asarray(values, dtype=self._value_dtype(col))
        try:
            codes = codec.encode(values)
        except ValueError:
            codes = self._refit_codec(col, values)
        return codes.reshape(n, 1)

    def _refit_codec(self, col: Column, values: np.ndarray) -> np.ndarray:
        """Re-fit ``col``'s codec over old ∪ new values and re-encode the
        stored code words in place.

        This is the honest answer to an append/update outside the fitted
        dictionary (or FOR delta range): the alternative — encoding to a
        clipped or aliased code — would silently corrupt.  An in-place
        re-encode is the one storage mutation the append-watermark/patch-log
        contract cannot express, so it bumps ``storage_epoch``, advances the
        patch base past every handed-out sequence (``patches_since`` returns
        ``None`` → device copies fully re-sync), and thereby also bumps
        ``mutation_version`` (join-build and broadcast caches invalidate).
        A FOR column whose value range stops fitting 32-bit deltas falls
        back to plain int32 storage — the codec is dropped, not fudged.
        Returns the new code words for ``values``.
        """
        old = self.codecs[col.name]
        woff = self.schema.word_offset(col.name)
        stored = self._words[: self.row_count, woff]
        if isinstance(old, DictCodec):
            old_values = old.decode_np(stored)
            pool = (np.concatenate([old.dictionary, values])
                    if old.dictionary.size else values)
            merged = DictCodec.fit(pool)
            if self.row_count:
                self._words[: self.row_count, woff] = merged.encode(old_values)
            self.codecs[col.name] = merged
            self._bump_storage_epoch()
            return merged.encode(values)
        assert isinstance(old, DeltaCodec)
        old_values = old.decode_np(stored).astype(np.int64)
        merged_vals = np.concatenate([old_values,
                                      np.asarray(values, dtype=np.int64)])
        new = DeltaCodec.fit_global(merged_vals)
        try:
            restored = new.encode(old_values) if self.row_count else None
            codes = new.encode(np.asarray(values, dtype=np.int64))
        except ValueError:
            # the value range exceeds 32-bit deltas: drop to plain storage
            if self.row_count:
                self._words[: self.row_count, woff] = old_values.astype(np.int32)
            del self.codecs[col.name]
            self._bump_storage_epoch()
            return np.asarray(values, dtype=np.int32)
        if restored is not None:
            self._words[: self.row_count, woff] = restored
        self.codecs[col.name] = new
        self._bump_storage_epoch()
        return codes

    def _bump_storage_epoch(self) -> None:
        mv = self.mutation_version
        self._patch_log.clear()
        self._patch_base = mv + 1  # every older sync token re-syncs in full
        self.storage_epoch += 1

    # ------------------------------------------------------------------ OLTP
    def append(self, columns: Mapping[str, Sequence | np.ndarray]) -> np.ndarray:
        """Append new rows (insert); returns the new physical row indices.

        Appends never touch existing rows: the delta a device-resident copy
        must ship is exactly the new rows' words (see ``append_watermark``).
        """
        missing = set(self.schema.names) - set(columns)
        if missing:
            raise ValueError(f"missing columns {sorted(missing)}")
        n = len(next(iter(columns.values())))
        ts = self.tick()
        at = self._append_rows(n, ts)
        woff = 0
        for col in self.schema.columns:
            enc = self._encode_stored(col, np.asarray(columns[col.name]), n)
            self._words[at : at + n, woff : woff + col.words] = enc
            woff += col.words
        self.row_count += n
        return np.arange(at, at + n)

    def delete(self, rows: np.ndarray) -> int:
        """MVCC delete: end the validity of the given physical rows.

        Only the hidden ``__ts_end`` word of each still-live row is rewritten;
        the touched rows are recorded in the patch log so delta-aware
        consumers upload O(rows) timestamp words, not the whole table.  A
        delete that touches no live row is a no-op (no mutation event).
        Returns the number of rows actually deleted — already-dead or
        duplicated ids don't count.
        """
        ts = self.tick()
        rows = np.asarray(rows)
        live = self._words[rows, self.ts_end_word] == TS_INF
        touched = np.unique(rows[live])
        if touched.size == 0:
            return 0
        self._words[touched, self.ts_end_word] = ts
        self._log_patch(touched)
        return int(touched.size)

    def update(self, rows: np.ndarray, values: Mapping[str, np.ndarray]) -> np.ndarray:
        """MVCC update: end old versions, append replacements (paper §4).

        Columns absent from ``values`` are copied as raw storage words —
        never round-tripped through decode/encode — so untouched columns are
        byte-identical in the replacement rows (and immune to any lossy
        re-encoding) and the copy is one sliced word move instead of a
        per-column decode pass.
        """
        rows = np.asarray(rows)
        n = len(rows)
        user_words = self.schema.row_words
        # encode the touched columns *before* snapshotting raw words: an
        # out-of-codec value re-fits the codec and rewrites stored code words
        # in place, and the raw copy must see the re-encoded state
        enc = {}
        for name, vals in values.items():
            col = self.schema.column(name)  # raises KeyError for unknown names
            enc[name] = self._encode_stored(col, np.asarray(vals), n)
        raw = self._words[rows, :user_words].copy()  # before delete patches ts
        for name, e in enc.items():
            woff = self.schema.word_offset(name)
            raw[:, woff : woff + self.schema.column(name).words] = e
        self.delete(rows)
        ts = self.tick()
        at = self._append_rows(n, ts)
        self._words[at : at + n, :user_words] = raw
        self.row_count += n
        return np.arange(at, at + n)

    # ------------------------------------------------------------------ OLAP
    def snapshot_mask(self, ts: int | None = None) -> np.ndarray:
        """Row-validity mask at snapshot time ``ts`` (defaults to now)."""
        ts = self._clock if ts is None else ts
        begin = self._words[: self.row_count, self.ts_begin_word]
        end = self._words[: self.row_count, self.ts_end_word]
        return (begin <= ts) & (ts < end)

    def read_column_at(self, name: str, rows: np.ndarray) -> np.ndarray:
        col = self.schema.column(name)
        woff = self.schema.word_offset(name)
        words = self._words[rows, woff : woff + col.words]
        codec = self.codecs.get(name)
        if codec is not None:  # code words -> values (host-side, no device)
            return codec.decode_np(words.reshape(-1), np.asarray(rows))
        return _decode_column(col, words)

    def read_column(self, name: str, ts: int | None = None) -> np.ndarray:
        """Direct row-wise read of one column (the slow path the paper beats)."""
        mask = self.snapshot_mask(ts)
        return self.read_column_at(name, np.nonzero(mask)[0])

    # ------------------------------------------------------------- factories
    @staticmethod
    def from_columns(
        schema: TableSchema, columns: Mapping[str, np.ndarray],
        codecs: Mapping[str, Codec] | None = None,
    ) -> "RelationalTable":
        """``codecs`` pre-seeds fitted codecs — the spelling for a dictionary
        *shared* across tables (encoded join keys must agree on one
        table-level dictionary, so both tables are built from the same
        fitted :class:`~repro_torch.core.compression.DictCodec`)."""
        n = len(next(iter(columns.values())))
        t = RelationalTable(schema, capacity=n, codecs=codecs)
        t.append(columns)
        return t

    @staticmethod
    def from_state(state: Mapping) -> "RelationalTable":
        """Rebuild a table from a plain state dict, byte for byte.

        ``state`` holds only builtins and numpy arrays, so any producer (the
        reference package's table, a file) can fill it:

        * ``columns`` — ``(name, dtype, width, codec_kind)`` per user column;
        * ``words`` — the ``(row_count, storage_row_words)`` int32 storage
          words, the hidden ``__ts_begin``/``__ts_end`` words included;
        * ``clock`` — the MVCC clock;
        * ``codecs`` — per encoded column, ``{"kind": "dict", "dictionary":
          array}`` or ``{"kind": "for", "references": array, "frame_rows":
          int, "code_bits": int}``;
        * ``storage_epoch`` (optional, default 0).

        The stored words are copied as they are (never re-encoded), so the
        rebuilt table's ``words()`` equal the source's exactly.
        """
        schema = TableSchema.of(*(Column(n, d, w, c)
                                  for n, d, w, c in state["columns"]))
        words = np.ascontiguousarray(state["words"], dtype=np.int32)
        n = words.shape[0]
        if words.ndim != 2 or words.shape[1] != len(_MVCC_COLS) + schema.row_words:
            raise ValueError(
                f"state words {words.shape} do not match the storage row of"
                f" {schema.row_words} user words plus the MVCC words"
            )
        codecs: dict[str, Codec] = {}
        for name, spec in state.get("codecs", {}).items():
            if spec["kind"] == "dict":
                codecs[name] = DictCodec(np.asarray(spec["dictionary"]))
            elif spec["kind"] == "for":
                codecs[name] = DeltaCodec(
                    np.asarray(spec["references"], dtype=np.int64),
                    int(spec["frame_rows"]), int(spec["code_bits"]),
                )
            else:
                raise ValueError(f"unknown codec kind {spec['kind']!r}")
        t = RelationalTable(schema, capacity=n)
        # exactly the source's codecs: a declared codec the source dropped
        # (a FOR column that fell back to plain words) must stay dropped
        t.codecs = codecs
        t._words[:n] = words
        t.row_count = n
        t._clock = int(state["clock"])
        t.storage_epoch = int(state.get("storage_epoch", 0))
        return t


def columnar_copy(table: RelationalTable, names: Sequence[str]) -> dict[str, np.ndarray]:
    """A materialized column-store copy — the paper's 'direct columnar' baseline.

    This is what adaptive-layout systems maintain (and must invalidate); the RME
    makes it unnecessary.  Used only as a comparison point in the benchmarks.
    """
    mask = table.snapshot_mask()
    idx = np.nonzero(mask)[0]
    return {n: table.read_column_at(n, idx) for n in names}
