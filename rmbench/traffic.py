"""The one generator of relational traffic: it reads a mix (``mixes/*.json``
whose ``driver`` is ``relational``) and the configuration, and draws from
``--seed`` an endless stream of queries.

A mix lists a ``block`` of query templates, each ``{"kind", ...}`` with an
optional ``count``.  The stream is that block over and over, each copy in
its own seeded order, so every seed sends the same amount of each kind of
work in another order.  A query's columns are drawn from the seed as well:
``columns`` distinct columns for a projection, an aggregated and a
predicate column outside the configuration's key column, a group column
distinct from both.  A predicate is ``col > k`` with ``k`` the mix's
constant for the template's ``selectivity`` (percent of rows kept).  A
query is drawn for the answer check with the mix's ``check`` share of its
size class (``blocked_share``, ``small_share``); the first query of every
blocked template is always drawn, so the largest answers are checked.

Kinds: ``sum`` (SUM of a column), ``project`` (``columns`` columns),
``select_project`` (``columns`` columns of the rows passing the predicate),
``select_sum`` (SUM over the passing rows) and ``groupby_avg`` (AVG of a
column over the passing rows, grouped by another column modulo ``groups``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from .inputs import column_names, seed64

KINDS = ("sum", "project", "select_project", "select_sum", "groupby_avg")
BLOCKED = ("project", "select_project")  # answers of O(rows) bytes


@dataclasses.dataclass(frozen=True)
class Query:
    index: int  # position in the stream
    kind: str
    columns: tuple[str, ...] = ()  # projected, in physical order
    agg: str | None = None
    group: str | None = None
    groups: int = 0
    pred: tuple[str, str, int] | None = None  # (column, "gt", k)
    keep: bool = False  # drawn for the answer check
    variant: tuple = ()  # the template's (kind, columns, selectivity)

    def key(self) -> tuple:
        return (self.kind, self.columns, self.agg, self.group, self.groups, self.pred)

    @property
    def blocked(self) -> bool:
        return self.kind in BLOCKED


def _templates(mix: dict) -> list[dict]:
    out = []
    for t in mix["block"]:
        if t["kind"] not in KINDS:
            raise ValueError(f"unknown query kind {t['kind']!r}")
        out += [t] * t.get("count", 1)
    return out


def stream(cfg: dict, mix: dict, seed: int, salt: int = 0) -> Iterator[Query]:
    """Queries for ``cfg``'s table under ``mix``, endlessly, from ``seed``
    (``salt`` draws an independent stream from the same seed, e.g. for the
    warm-up)."""
    rng = np.random.default_rng((seed64(seed), 7, salt))
    names = column_names(cfg["columns"])
    value_cols = [c for c in names if c != cfg["key_column"]]
    consts = {int(s): k for s, k in mix["selectivity_constants"].items()}
    order = {c: i for i, c in enumerate(names)}
    templates = _templates(mix)
    share = {True: mix["check"]["blocked_share"], False: mix["check"]["small_share"]}
    seen: set[tuple] = set()
    index = 0
    while True:
        for j in rng.permutation(len(templates)):
            t = templates[j]
            kind = t["kind"]
            pred = None
            if "selectivity" in t:
                pred = (str(rng.choice(value_cols)), "gt", consts[t["selectivity"]])
            q = {"kind": kind, "pred": pred}
            if kind in BLOCKED:
                picked = rng.choice(names, size=t["columns"], replace=False)
                q["columns"] = tuple(sorted(map(str, picked), key=order.get))
            else:
                aggs = [c for c in value_cols if pred is None or c != pred[0]]
                q["agg"] = str(rng.choice(aggs))
            if kind == "groupby_avg":
                groups = [c for c in names if c not in (q["agg"], pred and pred[0])]
                q["group"] = str(rng.choice(groups))
                q["groups"] = t["groups"]
            draw = rng.random()
            variant = (kind, t.get("columns"), t.get("selectivity"))
            keep = draw < share[kind in BLOCKED] or (kind in BLOCKED and variant not in seen)
            seen.add(variant)
            yield Query(index=index, keep=keep, variant=variant, **q)
            index += 1
