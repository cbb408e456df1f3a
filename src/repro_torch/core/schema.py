"""Table schemas and RME geometry (paper §5, Table 1) — the port's own copy
of ``repro.core.schema``; nothing here depends on the framework.

The paper's RME is configured with the *geometry* of a row-major table:
row size ``R`` (bytes), row count ``N``, the number of enabled columns ``Q``,
per-column widths ``C_Aj`` and per-column relative offsets ``O_Aj`` (offset from
the *previous* enabled column), and a frame number ``F``.

TPU adaptation: TPU vector memory is not byte addressed; the natural granule is a
4-byte lane word.  All column widths and offsets must therefore be multiples of
4 bytes (``WORD`` below).  This mirrors the paper's own bus-width alignment
(``B_w = 16`` bytes on the ZCU102) one level down: descriptors there are
bus-aligned, here they are word/lane aligned.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

WORD = 4  # bytes per TPU lane word; all layout math is word-aligned.

# The configuration port's Q cap (paper Table 1: at most 11 enabled columns).
# Per-view geometries and the planner both honor it; union geometries built
# for shared-scan *accounting* may exceed it (see geometry_from_intervals).
MAX_ENABLED_COLUMNS = 11

# numpy dtypes allowed for decoded columns. char fields are fixed-width byte
# strings handled as raw words.
_SUPPORTED = {
    "int32": (np.int32, 4),
    "float32": (np.float32, 4),
    "int64": (np.int64, 8),
    "float64": (np.float64, 8),
    "uint32": (np.uint32, 4),
}


@dataclasses.dataclass(frozen=True)
class Column:
    """One attribute of a relation.

    ``dtype`` is one of the supported scalar names, ``"char"`` (fixed-width
    byte string; ``width`` gives the field size in bytes, word aligned), or
    ``"str"`` — a variable-length string column stored as one int32
    dictionary-code word (paper §4: encoded columns live in the row store as
    narrow code words; decoding happens on result materialization).

    ``codec`` optionally declares table-level compression for the stored
    words: ``"dict"`` (order-preserving dictionary, int32 or str values) or
    ``"for"`` (global frame-of-reference, int32 only).  ``"str"`` columns are
    dictionary-coded by construction, so their ``codec`` is forced to
    ``"dict"``.  The codec itself (dictionary / reference) is fitted and
    owned by the :class:`~repro_torch.core.table.RelationalTable` at ingest.
    """

    name: str
    dtype: str = "int32"
    width: int | None = None  # bytes; inferred for scalar dtypes
    codec: str | None = None  # "dict" | "for" | None

    def __post_init__(self):
        if self.dtype == "char":
            if self.width is None or self.width % WORD != 0 or self.width <= 0:
                raise ValueError(
                    f"char column {self.name!r} needs a positive word-aligned width,"
                    f" got {self.width}"
                )
        elif self.dtype == "str":
            if self.width not in (None, WORD):
                raise ValueError(
                    f"str column {self.name!r} is one code word ({WORD}B), got"
                    f" width {self.width}"
                )
            object.__setattr__(self, "width", WORD)
            if self.codec not in (None, "dict"):
                raise ValueError(
                    f"str column {self.name!r} is dictionary-coded; codec"
                    f" {self.codec!r} is not expressible"
                )
            object.__setattr__(self, "codec", "dict")
        elif self.dtype in _SUPPORTED:
            expect = _SUPPORTED[self.dtype][1]
            if self.width is None:
                object.__setattr__(self, "width", expect)
            elif self.width != expect:
                raise ValueError(
                    f"column {self.name!r}: dtype {self.dtype} is {expect}B, got width"
                    f" {self.width}"
                )
        else:
            raise ValueError(f"unsupported dtype {self.dtype!r} for column {self.name!r}")
        if self.codec is not None:
            if self.codec not in ("dict", "for"):
                raise ValueError(
                    f"column {self.name!r}: unknown codec {self.codec!r};"
                    " want 'dict' or 'for'"
                )
            if self.dtype not in ("int32", "str"):
                raise ValueError(
                    f"column {self.name!r}: codec {self.codec!r} needs an"
                    f" int32 or str column, not {self.dtype}"
                )
            if self.codec == "for" and self.dtype != "int32":
                raise ValueError(
                    f"column {self.name!r}: FOR encoding needs int32 values"
                )

    @property
    def words(self) -> int:
        return self.width // WORD

    @property
    def np_dtype(self) -> np.dtype:
        if self.dtype == "char":
            return np.dtype((np.bytes_, self.width))
        if self.dtype == "str":
            return np.dtype(object)  # decoded values are numpy str arrays
        return np.dtype(_SUPPORTED[self.dtype][0])


@dataclasses.dataclass(frozen=True)
class TableSchema:
    """Physical row layout: columns are stored back-to-back, row-major."""

    columns: tuple[Column, ...]

    def __post_init__(self):
        names = [c.name for c in self.columns]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names in {names}")

    @staticmethod
    def of(*cols: Column | tuple) -> "TableSchema":
        out = []
        for c in cols:
            out.append(c if isinstance(c, Column) else Column(*c))
        return TableSchema(tuple(out))

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(c.name for c in self.columns)

    @property
    def row_bytes(self) -> int:
        return sum(c.width for c in self.columns)

    @property
    def row_words(self) -> int:
        return self.row_bytes // WORD

    def column(self, name: str) -> Column:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(name)

    def byte_offset(self, name: str) -> int:
        off = 0
        for c in self.columns:
            if c.name == name:
                return off
            off += c.width
        raise KeyError(name)

    def word_offset(self, name: str) -> int:
        return self.byte_offset(name) // WORD


@dataclasses.dataclass(frozen=True)
class TableGeometry:
    """The RME configuration-port contents (paper Table 1).

    Offsets ``O_Aj`` follow the paper's convention: the offset in bytes of the
    j-th enabled column *relative to the previous enabled column's offset*
    (``O_A0`` is absolute).  Absolute offsets are therefore the prefix sums.
    """

    row_bytes: int  # R
    row_count: int  # N
    col_widths: tuple[int, ...]  # C_Aj  (bytes)
    col_rel_offsets: tuple[int, ...]  # O_Aj  (bytes, relative chain)
    frame: int = 0  # F
    max_columns: int = MAX_ENABLED_COLUMNS  # the configuration port's Q cap

    def __post_init__(self):
        q = len(self.col_widths)
        if q == 0 or q != len(self.col_rel_offsets):
            raise ValueError("col_widths / col_rel_offsets mismatch or empty")
        if q > self.max_columns:
            raise ValueError(f"Q={q} exceeds max enabled columns {self.max_columns}")
        if self.row_bytes % WORD or any(w % WORD for w in self.col_widths) or any(
            o % WORD for o in self.col_rel_offsets
        ):
            raise ValueError("geometry must be word aligned (TPU adaptation)")
        offs = self.abs_offsets
        for o, w in zip(offs, self.col_widths):
            if o + w > self.row_bytes:
                raise ValueError(
                    f"column at offset {o} width {w} exceeds row size {self.row_bytes}"
                )
        if any(
            offs[j] < offs[j - 1] + self.col_widths[j - 1] for j in range(1, q)
        ):
            raise ValueError("enabled columns must be non-overlapping and ordered")

    @property
    def q(self) -> int:  # Q
        return len(self.col_widths)

    @property
    def abs_offsets(self) -> tuple[int, ...]:
        """Absolute byte offset of each enabled column: prefix sums of O_Aj."""
        out, acc = [], 0
        for o in self.col_rel_offsets:
            acc += o
            out.append(acc)
        return tuple(out)

    @property
    def out_bytes_per_row(self) -> int:
        return sum(self.col_widths)

    @property
    def out_words_per_row(self) -> int:
        return self.out_bytes_per_row // WORD

    @property
    def row_words(self) -> int:
        return self.row_bytes // WORD

    # --- word-granule view used by the TPU kernels -------------------------
    @property
    def col_word_offsets(self) -> tuple[int, ...]:
        return tuple(o // WORD for o in self.abs_offsets)

    @property
    def col_word_widths(self) -> tuple[int, ...]:
        return tuple(w // WORD for w in self.col_widths)

    @property
    def out_word_offsets(self) -> tuple[int, ...]:
        """Word offset of each enabled column within a packed output row."""
        out, acc = [], 0
        for w in self.col_word_widths:
            out.append(acc)
            acc += w
        return tuple(out)

    def layout_key(self) -> tuple:
        """The geometry's identity *minus the row count* — what delta-aware
        caches key on.  Two views of the same column group over the same row
        layout share one cache slot even as the table grows; the rows a
        cached block actually covers travel in the entry's version token
        (see :class:`repro_torch.core.engine.ReorgCache`)."""
        return (
            self.row_bytes,
            self.col_widths,
            self.col_rel_offsets,
            self.frame,
        )

    @staticmethod
    def from_schema(
        schema: TableSchema, names: Sequence[str], row_count: int, frame: int = 0
    ) -> "TableGeometry":
        """Build the config-port contents for a column group over ``schema``.

        Enabled columns are sorted by physical offset (the RME walks rows
        front-to-back); the projected order follows physical order, matching the
        paper's packed layout.
        """
        cols = sorted(names, key=schema.byte_offset)
        if len(set(cols)) != len(cols):
            raise ValueError(f"duplicate columns in {names}")
        abs_offs = [schema.byte_offset(n) for n in cols]
        widths = [schema.column(n).width for n in cols]
        rel = [abs_offs[0]] + [abs_offs[j] - abs_offs[j - 1] for j in range(1, len(cols))]
        return TableGeometry(
            row_bytes=schema.row_bytes,
            row_count=row_count,
            col_widths=tuple(widths),
            col_rel_offsets=tuple(rel),
            frame=frame,
        )


def geometry_from_intervals(
    intervals: Sequence[tuple[int, int]], row_bytes: int, row_count: int
) -> TableGeometry:
    """The union accounting geometry over ``(byte_offset, byte_width)`` spans.

    Overlapping and *adjacent* intervals collapse into one burst chain — the
    single definition of the shared-scan charging rule, used by the
    heterogeneous one-pass scan's ``union_geometry``.  ``max_columns``
    is lifted to whatever the merge produces: this is an accounting geometry,
    not a configuration-port write, so the paper's Q cap does not apply.
    """
    if not intervals:
        raise ValueError("geometry_from_intervals needs at least one interval")
    spans = sorted((o, o + w) for o, w in intervals)
    merged: list[list[int]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    widths = tuple(e - s for s, e in merged)
    rel = [merged[0][0]]
    for j in range(1, len(merged)):
        rel.append(merged[j][0] - merged[j - 1][0])
    return TableGeometry(
        row_bytes=row_bytes,
        row_count=row_count,
        col_widths=widths,
        col_rel_offsets=tuple(rel),
        max_columns=max(len(merged), MAX_ENABLED_COLUMNS),
    )


def merge_geometries(geoms: Sequence[TableGeometry]) -> TableGeometry:
    """Union geometry of several views over one row layout (the shared scan).

    When the engine serves a batch of ephemeral views from a single Fetch-Unit
    stream, the bytes it pulls from the row store are governed by the *union*
    of the enabled-column byte intervals (see :func:`geometry_from_intervals`),
    so co-planned views are charged for the shared scan exactly once.
    """
    if not geoms:
        raise ValueError("merge_geometries needs at least one geometry")
    row_bytes = geoms[0].row_bytes
    if any(g.row_bytes != row_bytes for g in geoms):
        raise ValueError("cannot merge geometries over different row layouts")
    return geometry_from_intervals(
        [(o, w) for g in geoms for o, w in zip(g.abs_offsets, g.col_widths)],
        row_bytes=row_bytes,
        row_count=max(g.row_count for g in geoms),
    )


def paper_schema() -> TableSchema:
    """The exact row layout from the paper's Listing 1 (64-byte rows)."""
    return TableSchema.of(
        Column("key", "int64"),
        Column("text_fld1", "char", 8),
        Column("text_fld2", "char", 12),
        Column("text_fld3", "char", 20),  # paper lists 20B; keeps row at 64B? see note
        Column("num_fld1", "int32"),
        Column("num_fld2", "int32"),
        Column("num_fld3", "int32"),
        Column("num_fld4", "int32"),
    )
    # Note: the paper's Listing 1 sums to >64B with five 8-byte longs; its
    # benchmark (§6.2) instead uses 64B rows of 4B columns.  We follow the
    # benchmark geometry here and keep Listing 1's field names.


def benchmark_schema(row_bytes: int = 64, col_bytes: int = 4) -> TableSchema:
    """The synthetic benchmark table (§6.2): n equal-width numeric columns."""
    if row_bytes % col_bytes:
        raise ValueError("row_bytes must be a multiple of col_bytes")
    n = row_bytes // col_bytes
    cols = []
    for i in range(n):
        if col_bytes == 4:
            cols.append(Column(f"A{i + 1}", "int32"))
        else:
            cols.append(Column(f"A{i + 1}", "char", col_bytes))
    return TableSchema.of(*cols)
