"""The relational mix's answers, computed plainly over the benchmark's own
columns at the snapshot every read is pinned to (the rows set-up deleted are
hidden): sums exact in float64, group-by averages from float64 sums and
integer counts, projections as the stacked columns with failing rows zeroed
and the validity mask beside them.

``precision="bfloat16"`` is the control: the same answers with the values
held, summed and projected in bfloat16, the step below the float32 sums the
configuration states.
"""

from __future__ import annotations

import numpy as np
import torch


class Oracle:
    def __init__(self, columns: dict[str, torch.Tensor], deleted: np.ndarray, device,
                 precision: str = "exact"):
        if precision not in ("exact", "bfloat16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision
        self.cols = {k: torch.as_tensor(v, device=device) for k, v in columns.items()}
        n = len(next(iter(columns.values())))
        self.visible = torch.ones(n, dtype=torch.bool, device=device)
        self.visible[torch.from_numpy(deleted).to(device)] = False
        self._memo: dict = {}

    def _mask(self, q) -> torch.Tensor:
        if q.pred is None:
            return self.visible
        col, op, k = q.pred
        v = self.cols[col]
        return self.visible & ((v > k) if op == "gt" else (v < k))

    def _values(self, col: str) -> torch.Tensor:
        v = self.cols[col]
        return v.to(torch.bfloat16) if self.precision == "bfloat16" else v.double()

    def answer(self, q):
        """``q``'s answer: ``(sum, sum of |v|)`` for a sum; ``(averages,
        mean |v| a group)`` for a group-by; ``(packed, mask)`` for a block."""
        if q.blocked:  # O(rows) answers are not kept
            return self._answer(q)
        key = q.key()
        if key not in self._memo:
            self._memo[key] = self._answer(q)
        return self._memo[key]

    def _answer(self, q):
        mask = self._mask(q)
        if q.kind in ("sum", "select_sum"):
            vals = self._values(q.agg)[mask]
            absv = self.cols[q.agg][mask].double().abs().sum()
            return vals.sum().double(), absv
        if q.kind == "groupby_avg":
            g = torch.remainder(self.cols[q.group], q.groups)[mask].long()
            vals = self._values(q.agg)[mask]
            sums = torch.zeros(q.groups, dtype=vals.dtype, device=vals.device)
            sums.index_add_(0, g, vals)
            counts = torch.bincount(g, minlength=q.groups).double()
            absv = torch.zeros(q.groups, dtype=torch.float64, device=vals.device)
            absv.index_add_(0, g, self.cols[q.agg][mask].double().abs())
            return (sums.double() / counts.clamp(min=1.0),
                    absv / counts.clamp(min=1.0))
        block = torch.stack([self.cols[c] for c in q.columns], dim=1)
        if self.precision == "bfloat16":
            block = block.to(torch.bfloat16).to(torch.int32)
        return torch.where(mask[:, None], block, torch.zeros((), dtype=block.dtype,
                                                             device=block.device)), mask


def gaps(q, got, want) -> dict[str, float]:
    """How far ``got`` lies from ``want`` (:meth:`Oracle.answer`'s form):
    ``sum_err``, the gap over the sum of |v|; ``avg_err``, the widest
    group's gap over its mean |v|; ``mismatches``, words and mask bits that
    differ."""
    if q.kind in ("sum", "select_sum"):
        s, absv = want
        return {"sum_err": abs(float(got) - float(s)) / max(float(absv), 1.0)}
    if q.kind == "groupby_avg":
        avg, mean_abs = want
        got = torch.as_tensor(got, device=avg.device).double()
        return {"avg_err": float(((got - avg).abs() / mean_abs.clamp(min=1.0)).max())}
    packed, mask = want
    got_packed, got_mask = got
    if tuple(got_packed.shape) != tuple(packed.shape) or got_mask.shape != mask.shape:
        return {"mismatches": float(packed.numel() + mask.numel())}
    bad = (got_packed.to(packed.device) != packed).sum() + (got_mask.to(mask.device) != mask).sum()
    return {"mismatches": float(bad)}
