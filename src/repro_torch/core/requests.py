"""Engine-level scan ops — the port of ``repro.core.requests``.

The kernel layer (:mod:`repro_torch.kernels.rme_scan_multi`) speaks word
offsets; callers speak tables, ephemeral views and column names.  A *scan
op* names the table (and, for packed outputs, the registered
:class:`~repro_torch.core.ephemeral.EphemeralView`) plus the operator
parameters, and :meth:`lower` translates it to the kernel request via the
table's schema.  :meth:`RelationalMemoryEngine.execute_many` coalesces any
mix of these per table into one heterogeneous one-pass scan (or routes a
lone op to its single-op kernel).

Ops use identity equality (two clients asking the same aggregate are two
ops); de-duplication happens at the kernel-request level.  Every op also
knows its result size (:meth:`result_bytes`).  A :class:`JoinOp` lowers to
its probe-side scan request only; the bucket probe runs on that scan's
output (or straight on the row-store chunks when the join is alone).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import common
from repro_torch.kernels import rme_scan_multi as KR

from .compression import DeltaCodec, DictCodec
from .ephemeral import EphemeralView
from .table import RelationalTable


@dataclasses.dataclass
class JoinResult:
    """Static-shape join output: one slot per probe row + match validity.

    Every join route — host sort-probe, flipped sort-probe, device hash
    probe — emits exactly this contract, so routes are interchangeable.
    Under a ``snapshot_ts``, probe rows invisible at the snapshot carry
    zeros and ``matched=False``.
    """

    s_proj: torch.Tensor  # projected column from the probe side S
    r_proj: torch.Tensor  # matched column from the build side R (0 where no match)
    matched: torch.Tensor  # bool mask

    @classmethod
    def concat(cls, parts: Sequence["JoinResult"]) -> "JoinResult":
        """Row-wise concatenation of per-chunk join outputs back into
        probe-table row order (join outputs are row-local)."""
        if len(parts) == 1:
            return parts[0]
        return cls(
            s_proj=torch.cat([p.s_proj for p in parts]),
            r_proj=torch.cat([p.r_proj for p in parts]),
            matched=torch.cat([p.matched for p in parts]),
        )


@dataclasses.dataclass(frozen=True, eq=False)
class ProjectOp:
    """Materialize a registered view's packed column group."""

    view: EphemeralView

    @property
    def table(self) -> RelationalTable:
        return self.view.table

    def lower(self) -> KR.ProjectRequest:
        return KR.ProjectRequest(self.view.geometry)

    def result_bytes(self) -> int:
        g = self.view.geometry
        return g.row_count * g.out_bytes_per_row


def _pred_fields(table: RelationalTable, pred_col: str | None, pred_op: str,
                 pred_k, snapshot_ts: int | None, default_word: int,
                 default_dtype: str) -> dict:
    schema = table.schema
    if pred_col is None:
        pred_word, pred_dtype = default_word, default_dtype
    else:
        pred_word = schema.word_offset(pred_col)
        pred_dtype = schema.column(pred_col).dtype
        codec = table.codecs.get(pred_col)
        if codec is not None:
            # compile-time predicate translation (paper §4): the stored words
            # are raw int32 codes, and the codec's order structure maps the
            # value-space constant to the equivalent code-space constant —
            # the kernel compares codes, zero decode in-scan
            pred_dtype = "int32"
            if pred_op != "none":
                pred_op, pred_k = codec.translate_pred(pred_op, pred_k)
    return dict(
        pred_word=pred_word,
        pred_dtype=pred_dtype,
        pred_op=pred_op,
        pred_k=pred_k,
        ts_word=schema.row_words if snapshot_ts is not None else -1,
        ts=0 if snapshot_ts is None else snapshot_ts,
    )


@dataclasses.dataclass(frozen=True, eq=False)
class FilterOp:
    """Fused selection + projection: packed block with failing rows zeroed
    plus a validity bitmap (the ``rme_filter`` contract)."""

    view: EphemeralView
    pred_col: str
    pred_op: str = "gt"
    pred_k: int | float = 0
    snapshot_ts: int | None = None

    @property
    def table(self) -> RelationalTable:
        return self.view.table

    def lower(self) -> KR.FilterRequest:
        schema = self.table.schema
        return KR.FilterRequest(
            self.view.geometry,
            **_pred_fields(
                self.table, self.pred_col, self.pred_op, self.pred_k,
                self.snapshot_ts, schema.word_offset(self.pred_col),
                schema.column(self.pred_col).dtype,
            ),
        )

    def result_bytes(self) -> int:
        # (packed block, bool validity mask) — the rme_filter contract
        g = self.view.geometry
        return g.row_count * (g.out_bytes_per_row + 1)


@dataclasses.dataclass(frozen=True, eq=False)
class AggregateOp:
    """Fused ``SELECT SUM(agg), COUNT(*) WHERE pred``: a ``[sum, count]``
    scalar pair, nothing else leaves the engine."""

    table: RelationalTable
    agg_col: str
    pred_col: str | None = None
    pred_op: str = "none"
    pred_k: int | float = 0
    snapshot_ts: int | None = None

    def lower(self) -> KR.AggregateRequest:
        schema = self.table.schema
        agg_word = schema.word_offset(self.agg_col)
        agg_dtype = _agg_lower_dtype(self.table, self.agg_col)
        return KR.AggregateRequest(
            agg_word=agg_word,
            agg_dtype=agg_dtype,
            **_pred_fields(self.table, self.pred_col, self.pred_op,
                           self.pred_k, self.snapshot_ts, agg_word, agg_dtype),
        )

    def result_bytes(self) -> int:
        return 8  # the [sum, count] float pair


@dataclasses.dataclass(frozen=True, eq=False)
class GroupByOp:
    """Fused ``SELECT SUM(agg), COUNT(*) ... GROUP BY group`` partials."""

    table: RelationalTable
    group_col: str
    agg_col: str
    num_groups: int
    pred_col: str | None = None
    pred_op: str = "none"
    pred_k: int | float = 0
    snapshot_ts: int | None = None

    def lower(self) -> KR.GroupByRequest:
        schema = self.table.schema
        agg_word = schema.word_offset(self.agg_col)
        agg_dtype = _agg_lower_dtype(self.table, self.agg_col)
        group_codec = self.table.codecs.get(self.group_col)
        num_groups = self.num_groups
        if group_codec is not None:
            # group on raw codes: dictionary codes are dense [0, n), so the
            # kernel's modulo grouping is the identity over the code domain
            # and the op-level finalize remaps the per-code partials into the
            # caller's value groups from the dictionary alone
            if not isinstance(group_codec, DictCodec):
                raise ValueError(
                    "group-by keys need a dict codec (FOR codes are not "
                    "group identities)"
                )
            n = int(group_codec.dictionary.size)
            if (group_codec.dictionary.dtype.kind in ("U", "S", "O")
                    and self.num_groups < n):
                raise ValueError(
                    f"num_groups={self.num_groups} cannot cover the "
                    f"{n}-entry string dictionary"
                )
            num_groups = max(n, 1)
        return KR.GroupByRequest(
            group_word=schema.word_offset(self.group_col),
            agg_word=agg_word,
            num_groups=num_groups,
            agg_dtype=agg_dtype,
            **_pred_fields(self.table, self.pred_col, self.pred_op,
                           self.pred_k, self.snapshot_ts, agg_word, agg_dtype),
        )

    def result_bytes(self) -> int:
        return self.num_groups * 8  # (G, 2) float partials


@dataclasses.dataclass(frozen=True, eq=False)
class JoinOp:
    """Device-resident equi-join: probe-side scan + bucketed build probe.

    The op names the registered probe-side ``{left_proj, key}`` view, the
    build table, and (optionally) the hash partitions the planner found in
    the build cache at compile time (``None`` means build-and-insert at
    execution).

    :meth:`lower` emits only the **probe-side scan request** — a plain
    ``ProjectRequest`` (or, snapshot-pinned or predicated, a
    ``FilterRequest`` whose mask is the predicate AND the MVCC visibility) —
    so a join in a mixed tick coalesces into the same one-pass scan as
    co-tick ops on the probe table; the bucket probe then runs on the packed
    output (``RelationalMemoryEngine._finish_join``).  A join alone on its
    table skips the packed materialization: the engine streams the probe
    kernel over the device row-store chunks (``_join_direct``).
    """

    view: EphemeralView  # probe-side {left_proj, key} registered view
    left_proj: str
    key: str
    right_table: RelationalTable
    right_proj: str
    snapshot_ts: int | None = None
    partitions: object | None = None  # JoinPartitions from the build cache
    # probe-side predicate pushed below the join (optimizer), fused into the
    # probe scan like a FilterOp's
    pred_col: str | None = None
    pred_op: str = "none"
    pred_k: int | float = 0

    @property
    def table(self) -> RelationalTable:
        return self.view.table

    def lower(self) -> KR.ProjectRequest | KR.FilterRequest:
        check_join_encoding(self.table, self.right_table, self.key,
                            self.left_proj, self.right_proj)
        if self.snapshot_ts is None and self.pred_op == "none":
            return KR.ProjectRequest(self.view.geometry)
        # with no real predicate this is the inert spelling over the (int32)
        # key column, whose mask is visibility alone
        pred_col = self.pred_col if self.pred_op != "none" else self.key
        return KR.FilterRequest(
            self.view.geometry,
            **_pred_fields(self.table, pred_col, self.pred_op, self.pred_k,
                           self.snapshot_ts, 0, "int32"),
        )

    def result_bytes(self) -> int:
        # JoinResult: s_proj (4B) + r_proj (4B) + matched (1B) per probe row
        return self.view.geometry.row_count * 9


@dataclasses.dataclass
class MultiJoinResult:
    """A left-deep join chain's output: the shared probe projection, one
    build-side column per join (in the client's spelling order), and the
    conjunction of the per-join match masks.  Rows failing any join (or the
    probe-side predicate/snapshot) carry zeros and ``matched=False``."""

    s_proj: torch.Tensor
    r_projs: tuple[torch.Tensor, ...]
    matched: torch.Tensor


ScanOp = ProjectOp | FilterOp | AggregateOp | GroupByOp | JoinOp


def _agg_lower_dtype(table: RelationalTable, agg_col: str) -> str:
    """The kernel-visible dtype of an aggregate column, codec-aware.

    A FOR-encoded column sums on its raw int32 deltas (the affine fix-up is
    applied by :func:`finalize_scan_result`); dictionary codes carry no
    additive structure, so summing them would be silent garbage — reject."""
    codec = table.codecs.get(agg_col)
    if codec is None:
        return table.schema.column(agg_col).dtype
    if isinstance(codec, DictCodec):
        raise ValueError(
            f"column {agg_col!r} is dict-encoded: codes are ranks, not "
            "addends — aggregate a FOR-encoded or plain column instead"
        )
    return "int32"  # FOR deltas are plain int32 words


def check_join_encoding(left: RelationalTable, right: RelationalTable,
                        key: str, left_proj: str, right_proj: str) -> None:
    """Execute-time guard for the device join route on encoded tables.

    Raw code words are join identities only when *both* key columns encode
    through one table-level dictionary — a re-fit on either side between
    compile and execute breaks that, which is why :meth:`JoinOp.lower`
    re-checks on every execution.  Projected payloads must be plain
    numeric: the probe emits zeros for unmatched rows, and zero is a valid
    code word."""
    for table, col in ((left, left_proj), (right, right_proj)):
        if col in table.codecs:
            raise ValueError(
                f"join payload column {col!r} must be plain numeric "
                "(unmatched rows emit 0, which is a valid code word)"
            )
    a, b = left.codecs.get(key), right.codecs.get(key)
    if a is None and b is None:
        return
    if a is None or b is None:
        raise ValueError(
            f"join key {key!r} is encoded on one side only — codes cannot "
            "compare against plain values"
        )
    if not (isinstance(a, DictCodec) and isinstance(b, DictCodec)):
        raise ValueError("join keys need dict codecs (FOR deltas are not "
                         "join identities)")
    if a is not b and not np.array_equal(a.dictionary, b.dictionary):
        raise ValueError(
            f"join key {key!r} needs one shared table-level dictionary "
            "(fit both tables with the same DictCodec)"
        )


def _remap_group_partials(codec: DictCodec, num_groups: int, sums, counts):
    """Per-code group-by partials -> the caller's value-group domain.

    The kernel grouped on raw codes (dense ``[0, n_dict)``); the dictionary
    alone determines where each code's partial lands, so this touches no row
    data and never decodes.  Integer dictionaries re-bucket by the shared
    ``group_ids`` lowering over the *values*; string dictionaries have no
    modulo semantics — each distinct string is its own group, zero-padded up
    to the caller's ``num_groups`` (coverage checked at lowering)."""
    d = codec.dictionary
    if d.size == 0:
        zeros = torch.zeros(num_groups, dtype=torch.float32, device=sums.device)
        return zeros, zeros
    if d.dtype.kind in ("U", "S", "O"):
        pad = num_groups - int(d.size)
        if pad > 0:
            sums = torch.cat([sums, sums.new_zeros(pad)])
            counts = torch.cat([counts, counts.new_zeros(pad)])
        return sums, counts
    g = common.group_ids(
        torch.as_tensor(d.astype(np.int32), device=sums.device), num_groups
    ).long()
    return (sums.new_zeros(num_groups).index_add_(0, g, sums),
            counts.new_zeros(num_groups).index_add_(0, g, counts))


def finalize_scan_result(op: ScanOp, out):
    """Op-level fix-ups after a raw-code fused pass — the only post-scan
    work compressed execution needs, all O(result) and decode-free.

    * ``AggregateOp`` over a FOR column: the kernel summed raw deltas, so
      ``sum = base * count + sum(deltas)`` (paper §4's aggregation identity).
    * ``GroupByOp``: the same affine fix-up per group, then per-code
      partials remap to the caller's group domain via the dictionary.
    * Everything else (including packed filter/project outputs, which carry
      raw codes until a client *reads* them) passes through untouched.
    """
    if isinstance(op, AggregateOp):
        codec = op.table.codecs.get(op.agg_col)
        if isinstance(codec, DeltaCodec):
            return torch.stack([out[0] + codec.base * out[1], out[1]])
        return out
    if isinstance(op, GroupByOp):
        sums, counts = out
        agg_codec = op.table.codecs.get(op.agg_col)
        if isinstance(agg_codec, DeltaCodec):
            sums = sums + agg_codec.base * counts
        group_codec = op.table.codecs.get(op.group_col)
        if isinstance(group_codec, DictCodec):
            sums, counts = _remap_group_partials(
                group_codec, op.num_groups, sums, counts
            )
        return sums, counts
    return out
