"""Write-ahead log for the HTAP write path — crash-consistent host writes;
the port's copy of ``repro.core.wal`` (stdlib and numpy only).

The record format is the reference's, byte for byte, so a log written by
either package is read by the other: a record body names the schema and
codec classes under the reference package's module paths (``repro.core.*``),
and reading maps those names onto the port's own classes
(``repro_torch.core.*``) without importing the reference package.

The row store is the single source of truth (``core/table.py``), and it
lives in volatile host memory; a crash mid-workload loses every applied
write.  Mainlining Databases (Li et al., PAPERS.md) shows the standard
cure for a columnar/HTAP design: append a durable delta log *before* the
store mutates, and replay it on recovery.  This module is that log.

Records are length-framed and CRC-checksummed::

    [u32 body_len][u32 crc32(body)][body = pickle((key, kind, payload))]

``key`` identifies the table (the server uses ``table.uid``), ``kind`` is
``"checkpoint"`` / ``"insert"`` / ``"update"`` / ``"delete"``, and the
payload carries exactly the arguments the matching
:class:`~repro.core.table.RelationalTable` method takes.  The serving
layer (``QueryServer(wal=...)``) appends one ``checkpoint`` record the
first time a table takes a write — the full word buffer, row count, and
MVCC clock at that instant — then one record per applied write, *before*
the host store mutates (write-ahead discipline: a crash between append
and apply replays an extra record, never loses an acknowledged one).

Recovery tolerates a torn tail by construction: :meth:`records` walks the
frames in order and stops cleanly at the first truncated or
checksum-corrupt record, so a crash at *any* byte boundary yields the
longest valid prefix.  :meth:`~repro.core.table.RelationalTable.recover`
replays that prefix into a byte-identical table (identical storage words
*and* MVCC clock — replaying the same mutation sequence re-derives the
same timestamps), from which the engine's delta-chunked device store
rebuilds byte-identical resident chunks on first sync.

The log is an in-memory ``bytearray`` with optional file persistence:
pass ``path=`` to mirror every append to disk (flushed per record), and
``WriteAheadLog.open(path)`` to load one back.  Tests drive the
in-memory form and simulate crashes with :meth:`truncated`.
"""

from __future__ import annotations

import dataclasses
import io
import pickle
import struct
import sys
import zlib
from typing import Any, Iterator

_HEADER = struct.Struct("<II")  # (body_len, crc32)

# the classes a record body names live in this package's core under the
# reference's module paths
_PORT, _REFERENCE = "repro_torch.core.", "repro.core."


class _Pickler(pickle._Pickler):
    """The stdlib pickler (its pure-Python form emits the same bytes as the
    C one) with the port's classes named under the reference's paths."""

    def save_global(self, obj, name=None):
        module = getattr(obj, "__module__", "") or ""
        if not module.startswith(_PORT):
            return super().save_global(obj, name)
        # one string object per module name, so the memo shares it between
        # the module's classes exactly as the C pickler's does
        self.save(sys.intern(_REFERENCE + module[len(_PORT):]))
        self.save(name or obj.__qualname__)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _Unpickler(pickle.Unpickler):
    """Reads the reference's class paths as the port's classes."""

    def find_class(self, module, name):
        if module.startswith(_REFERENCE):
            module = _PORT + module[len(_REFERENCE):]
        return super().find_class(module, name)


def _dumps(obj) -> bytes:
    buf = io.BytesIO()
    _Pickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def _loads(body: bytes):
    return _Unpickler(io.BytesIO(body)).load()


@dataclasses.dataclass(frozen=True)
class WALRecord:
    """One decoded log record (``end`` = byte offset just past its frame)."""

    key: Any
    kind: str
    payload: dict
    offset: int
    end: int


class WriteAheadLog:
    """Append-only checksummed record log (see module docstring)."""

    def __init__(self, path: str | None = None):
        self._buf = bytearray()
        self.path = path
        self._file = open(path, "ab") if path is not None else None

    # ------------------------------------------------------------- writing
    def append(self, key: Any, kind: str, payload: dict) -> int:
        """Frame, checksum, and append one record; returns its index.

        The record is fully in the log (and flushed to ``path``, if any)
        before this returns — the caller may then mutate the host store.
        """
        body = _dumps((key, kind, payload))
        frame = _HEADER.pack(len(body), zlib.crc32(body) & 0xFFFFFFFF) + body
        self._buf.extend(frame)
        if self._file is not None:
            self._file.write(frame)
            self._file.flush()
        return self.record_count - 1

    # ------------------------------------------------------------- reading
    def records(self) -> Iterator[WALRecord]:
        """Decode records in order, stopping at the first torn or corrupt
        frame (the surviving prefix of a crashed log)."""
        buf, off = self._buf, 0
        while off + _HEADER.size <= len(buf):
            n, crc = _HEADER.unpack_from(buf, off)
            body = bytes(buf[off + _HEADER.size: off + _HEADER.size + n])
            if len(body) < n:
                return  # torn tail: the final append never completed
            if zlib.crc32(body) & 0xFFFFFFFF != crc:
                return  # corrupt tail: bit rot or a torn in-place write
            key, kind, payload = _loads(body)
            end = off + _HEADER.size + n
            yield WALRecord(key, kind, payload, off, end)
            off = end

    def boundaries(self) -> list[int]:
        """Byte offsets at each record boundary (0, after record 0, ...) —
        the crash points the recovery property test sweeps."""
        out = [0]
        out.extend(rec.end for rec in self.records())
        return out

    @property
    def record_count(self) -> int:
        return sum(1 for _ in self.records())

    @property
    def nbytes(self) -> int:
        return len(self._buf)

    # ------------------------------------------------- crash simulation/IO
    def to_bytes(self) -> bytes:
        return bytes(self._buf)

    @classmethod
    def from_bytes(cls, data: bytes) -> "WriteAheadLog":
        wal = cls()
        wal._buf = bytearray(data)
        return wal

    def truncated(self, nbytes: int) -> "WriteAheadLog":
        """A new log holding only the first ``nbytes`` — a crash that tore
        the tail at an arbitrary byte position."""
        return WriteAheadLog.from_bytes(self._buf[:nbytes])

    def corrupted_tail(self) -> "WriteAheadLog":
        """A new log whose final record's body has one flipped bit — the
        checksum must reject it and recovery must keep the prefix."""
        recs = list(self.records())
        if not recs:
            return WriteAheadLog.from_bytes(self._buf)
        data = bytearray(self._buf)
        data[recs[-1].end - 1] ^= 0x01
        return WriteAheadLog.from_bytes(data)

    @classmethod
    def open(cls, path: str) -> "WriteAheadLog":
        """Load a persisted log for recovery (tolerates a torn tail)."""
        with open(path, "rb") as f:
            data = f.read()
        wal = cls.from_bytes(data)
        return wal

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
