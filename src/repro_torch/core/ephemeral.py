"""Ephemeral variables — the paper's software/hardware interface (§3); the
port of ``repro.core.ephemeral``.

An ephemeral variable "does not correspond to a real main memory location";
accessing it sets the RME in motion.  Registration captures the geometry
(the configuration-port write), and the first data access materializes the
packed column group through the engine — hot out of the reorganization
cache, cold through the projection kernel.  OLTP mutations of the base table
are tracked at delta granularity, so an append turns the next access into an
incremental tail scan merged with the cached block, and deletes/updates —
which only rewrite hidden timestamp words the packed block never contains —
don't perturb it at all; visibility is applied by ``valid_mask``/``column``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from .schema import TableGeometry
from .table import RelationalTable

if TYPE_CHECKING:  # pragma: no cover
    from .engine import RelationalMemoryEngine

_TORCH_DTYPES = {"int32": torch.int32, "float32": torch.float32,
                 "int64": torch.int64, "float64": torch.float64}


class EphemeralView:
    """A registered column-group view; materialized on access, never stored.

    Supports whole-group reads (``packed()``), per-column reads
    (``column(name)`` — decoded to the column dtype), and row slicing
    (``view[i:j]``), all snapshot-consistent when a snapshot time was given.
    """

    def __init__(
        self,
        engine: "RelationalMemoryEngine",
        table: RelationalTable,
        columns: tuple[str, ...],
        geometry: TableGeometry,
        snapshot_ts: int | None = None,
    ):
        self.engine = engine
        self.table = table
        self.columns = columns
        self.geometry = geometry
        self.snapshot_ts = snapshot_ts
        # packed layout follows physical column order (the RME walks rows
        # front-to-back); map user order -> packed word slices once.
        ordered = sorted(columns, key=table.schema.byte_offset)
        self._packed_slice: dict[str, tuple[int, int]] = {}
        acc = 0
        for name in ordered:
            w = table.schema.column(name).words
            self._packed_slice[name] = (acc, w)
            acc += w

    # ------------------------------------------------------------- accesses
    def packed(self) -> torch.Tensor:
        """The packed (N, out_words) int32 view — what the CPU cache sees."""
        return self.engine.materialize(self)

    def valid_mask(self) -> torch.Tensor:
        """MVCC validity of each physical row at the view's snapshot time."""
        ts = self.table.now() if self.snapshot_ts is None else self.snapshot_ts
        return self.engine.valid_mask(self.table, ts)

    def column(self, name: str) -> torch.Tensor | np.ndarray:
        """One projected column, decoded to its schema dtype (live rows only).

        Numeric columns come back as tensors on the engine's device; ``char``
        columns and string dictionaries as host numpy arrays (torch has no
        byte-string dtype)."""
        if name not in self._packed_slice:
            raise KeyError(f"{name!r} is not part of this ephemeral view {self.columns}")
        packed = self.packed()
        off, w = self._packed_slice[name]
        col = self.table.schema.column(name)
        live = packed[:, off : off + w][self.valid_mask()]
        codec = self.table.codecs.get(name)
        if codec is not None:
            # decode-on-finalize: the packed block carries raw code words;
            # the engine decodes (and caches per table version) only here,
            # when a client actually reads the column
            token = ("ts", self.snapshot_ts) if self.snapshot_ts is not None else ()
            return self.engine.decode_column(
                self.table, name, live.reshape(-1), token=token
            )
        if col.dtype == "char":
            return live.cpu().numpy().view(np.uint8).reshape(-1, col.width)
        if col.dtype == "uint32":
            # torch's uint32 supports few operations: hand back host values
            return live.reshape(-1).cpu().numpy().view(np.uint32)
        # 8-byte types occupy two words little-endian
        return live.contiguous().view(_TORCH_DTYPES[col.dtype]).reshape(-1)

    def column_words(self, name: str) -> tuple[int, int]:
        """(word offset, word width) of ``name`` inside the packed view."""
        return self._packed_slice[name]

    def __getitem__(self, idx) -> torch.Tensor:
        return self.packed()[idx]

    @property
    def shape(self) -> tuple[int, int]:
        return (self.geometry.row_count, self.geometry.out_words_per_row)

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"EphemeralView(cols={self.columns}, rows={self.geometry.row_count},"
            f" words/row={self.geometry.out_words_per_row}, ts={self.snapshot_ts})"
        )
