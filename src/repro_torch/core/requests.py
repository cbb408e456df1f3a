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
knows its result size (:meth:`result_bytes`).

The join op and its results are not ported yet (ROADMAP queue 1, join
offload).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import common
from repro_torch.kernels import rme_scan_multi as KR

from .compression import DeltaCodec, DictCodec
from .ephemeral import EphemeralView
from .table import RelationalTable


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


ScanOp = ProjectOp | FilterOp | AggregateOp | GroupByOp


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
