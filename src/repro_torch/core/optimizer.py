"""Logical plan optimizer — rewrite passes over the :mod:`repro_torch.core.plan` IR.

The paper's closing argument (§8) is that native column access lets the
software layer *state* a query and leave the datapath choice to a planner.
This module is the missing middle of that story: a small visitor/rewriter
protocol (every :class:`~repro_torch.core.plan.PlanNode` exposes ``map_children``;
a pass is a :class:`Rewrite` applied bottom-up to fixpoint) and four concrete
passes that canonicalize client spellings before costing and lowering:

* **pushdown-filter** — sinks Filters below Projects and below a Join's
  probe side, so predicates always sit against the scan they gate.
* **prune-columns** — drops Projects that only widen the scanned column
  group (under Aggregate/GroupBy, and inner Projects under the outermost
  one).  Because the rme union geometry enables exactly the shape's column
  set, pruning directly shrinks ``bytes_from_dram``.
* **normalize-pred** — canonicalizes predicate constants through the
  compression layer's code-space translation: on a dict-encoded column every
  value-space constant with the same translated code collapses to the
  dictionary value of that code, and float constants over int32 columns snap
  to the equivalent integer spelling.  Canonical spellings make distinct
  client spellings *equal*, which is what lets decompose collapse repeated
  filters and the engine's subsumption layer share scans across tickets.
* **eliminate-trivial-pred** — removes all-pass predicates where the result
  contract permits it (under Aggregate/GroupBy and on a Join's probe spine):
  the predicate word leaves the union geometry, again shrinking bytes.

Constant-*false* elimination is the planner's half of the story: it calls
:func:`pred_class` on the canonical shape and routes a provably-empty plan
to a zero-op constant result (``repro_torch.core.planner``), reported as the
``eliminate-empty`` pass in ``PhysicalQuery.explain()``.

Everything here is pure tree-to-tree: no pass reads row data — only schemas
and fitted codecs (dictionary ranks, FOR references), which are exactly the
compile-time artifacts the lowering layer already consults.
"""

from __future__ import annotations

import math

import numpy as np

from .compression import DeltaCodec, DictCodec
from .plan import (
    Aggregate,
    Filter,
    GroupBy,
    Join,
    PlanBuilder,
    PlanNode,
    Predicate,
    Project,
    Scan,
)
from .table import RelationalTable

_I32 = np.iinfo(np.int32)


def rewrite(node: PlanNode, fn) -> PlanNode:
    """Apply ``fn`` to every node bottom-up, rebuilding only changed spines.

    ``fn`` takes a node (whose children are already rewritten) and returns a
    replacement — or the node itself for "no change".  Identity is the
    fixpoint signal: an untouched subtree comes back as the *same* object.
    """

    def rec(n: PlanNode) -> PlanNode:
        return fn(n.map_children(rec))

    return rec(node)


def base_table(node: PlanNode) -> RelationalTable | None:
    """The base (probe-side) scan table of a subtree, if it has one.

    Follows first children — through Filter/Project chains and down a join
    chain's probe spine — mirroring how ``decompose`` resolves column names.
    """
    while not isinstance(node, Scan):
        kids = node.children()
        if not kids:
            return None
        node = kids[0]
    return node.table


# ----------------------------------------------------------- classification
def pred_class(table: RelationalTable, pred: Predicate) -> str:
    """Classify a predicate as ``"never"``, ``"all"``, or ``"some"``.

    Works in the *translated* domain: for encoded columns the codec maps the
    value-space constant into code space first (the same translation
    ``requests._pred_fields`` applies at lowering), so the classification is
    exact for dictionary ranks and FOR shifts.  Columns this cannot reason
    about (float32, string dictionaries) classify as ``"some"``.
    """
    try:
        col = table.schema.column(pred.col)
    except KeyError:
        return "some"
    codec = table.codecs.get(pred.col)
    if isinstance(codec, DictCodec):
        if codec.dictionary.dtype.kind in ("U", "S", "O"):
            return "some"
        n = int(codec.dictionary.size)
        op, c = codec.translate_pred(pred.op, pred.k)
        if op == "gt":
            if c >= n - 1:
                return "never"
            return "all" if c < 0 else "some"
        if c <= 0:
            return "never"
        return "all" if c >= n else "some"
    if isinstance(codec, DeltaCodec):
        if not codec.single_frame:
            return "some"
        op, k = codec.translate_pred(pred.op, pred.k)
        if op == "none":
            return "all"
        if (op == "gt" and k >= _I32.max) or (op == "lt" and k <= _I32.min):
            return "never"
        return "some"
    if col.dtype != "int32":
        return "some"
    k = pred.k
    if isinstance(k, float) and not math.isfinite(k):
        return "some"
    if pred.op == "gt":
        if k >= _I32.max:
            return "never"
        return "all" if k < _I32.min else "some"
    if k <= _I32.min:
        return "never"
    return "all" if k > _I32.max else "some"


# ------------------------------------------------------------------ passes
class Rewrite:
    """One optimizer pass: a named whole-tree rewrite.

    ``apply`` must return the *same object* when nothing changed — that is
    how :func:`optimize` detects the fixpoint and how ``explain()`` knows
    which passes actually fired.
    """

    name = "rewrite"

    def apply(self, node: PlanNode) -> PlanNode:
        raise NotImplementedError


class PushdownFilter(Rewrite):
    """Sink Filters below Projects and below a Join's probe side."""

    name = "pushdown-filter"

    def apply(self, node: PlanNode) -> PlanNode:
        def rule(n: PlanNode) -> PlanNode:
            if not isinstance(n, Filter):
                return n
            child = n.child
            if isinstance(child, Project):
                pushed = rule(Filter(child.child, n.col, n.op, n.k))
                return Project(pushed, child.columns)
            if isinstance(child, Join):
                table = base_table(child)
                if table is not None and n.col in table.schema.names:
                    pushed = rule(Filter(child.left, n.col, n.op, n.k))
                    return child.map_children(
                        lambda c: pushed if c is child.left else c
                    )
            return n

        return rewrite(node, rule)


def _strip_projects(node: PlanNode) -> PlanNode:
    """Remove Project nodes along a Filter/Project chain (stops at Scan/Join)."""
    if isinstance(node, Project):
        return _strip_projects(node.child)
    if isinstance(node, Filter):
        child = _strip_projects(node.child)
        return node if child is node.child else Filter(child, node.col, node.op, node.k)
    return node


class PruneColumns(Rewrite):
    """Drop Projects that only widen the scanned column group.

    A Project under an Aggregate/GroupBy contributes nothing to the result —
    it only forces extra columns into the union geometry; under another
    Project the outermost defines the output.  Removing them shrinks
    ``shape.columns`` and with it the bytes the rme datapath enables.
    """

    name = "prune-columns"

    def apply(self, node: PlanNode) -> PlanNode:
        def rule(n: PlanNode) -> PlanNode:
            if isinstance(n, (Aggregate, GroupBy, Project)):
                return n.map_children(_strip_projects)
            return n

        return rewrite(node, rule)


class NormalizePred(Rewrite):
    """Canonicalize predicate constants via the codec's code-space map.

    * float constants over int32-backed columns snap to the equivalent
      integer bound (``gt 3.5`` ≡ ``gt 3``, ``lt 3.5`` ≡ ``lt 4``);
    * on a numeric dict-encoded column, every constant translating to the
      same code rank rewrites to that rank's dictionary value — two clients
      spelling ``gt 7`` and ``gt 9`` over ``{3, 12, 40}`` now produce equal
      Filters, which decompose collapses and the subsumption layer shares.
    """

    name = "normalize-pred"

    def apply(self, node: PlanNode) -> PlanNode:
        def rule(n: PlanNode) -> PlanNode:
            if not isinstance(n, Filter):
                return n
            table = base_table(n)
            if table is None or n.col not in table.schema.names:
                return n
            if table.schema.column(n.col).dtype != "int32":
                return n
            k = n.k
            if isinstance(k, float):
                if not math.isfinite(k):
                    return n
                k = math.floor(k) if n.op == "gt" else math.ceil(k)
            codec = table.codecs.get(n.col)
            if isinstance(codec, DictCodec) and codec.dictionary.dtype.kind not in (
                "U", "S", "O"
            ):
                pred = Predicate(n.col, n.op, k)
                if pred_class(table, pred) == "some":
                    _, c = codec.translate_pred(n.op, k)
                    k = int(codec.dictionary[c])
            if k == n.k:
                return n
            return Filter(n.child, n.col, n.op, k)

        return rewrite(node, rule)


def _drop_all_pass(node: PlanNode, table: RelationalTable | None) -> PlanNode:
    """Remove all-pass Filters along a chain (contract-safe contexts only)."""
    if isinstance(node, Filter):
        child = _drop_all_pass(node.child, table)
        if (
            table is not None
            and node.col in table.schema.names
            and pred_class(table, Predicate(node.col, node.op, node.k)) == "all"
        ):
            return child
        return node if child is node.child else Filter(
            child, node.col, node.op, node.k
        )
    if isinstance(node, Project):
        child = _drop_all_pass(node.child, table)
        return node if child is node.child else Project(child, node.columns)
    return node


class EliminateTrivialPred(Rewrite):
    """Drop all-pass predicates where the result contract allows it.

    Safe under Aggregate/GroupBy (the scalar/partials are predicate-free
    anyway) and on a Join's probe spine (the probe mask of an all-pass
    predicate is all-true).  *Not* applied to bare filter plans — their
    contract is (packed, mask), and dropping the Filter would change the
    result type.  The predicate word leaves the union geometry, so the scan
    moves strictly fewer bytes.
    """

    name = "eliminate-trivial-pred"

    def apply(self, node: PlanNode) -> PlanNode:
        def rule(n: PlanNode) -> PlanNode:
            if isinstance(n, (Aggregate, GroupBy)):
                return n.map_children(lambda c: _drop_all_pass(c, base_table(c)))
            if isinstance(n, Join):
                return n.map_children(
                    lambda c: _drop_all_pass(c, base_table(c))
                    if c is n.left
                    else c
                )
            return n

        return rewrite(node, rule)


#: The default pass pipeline, in application order.  Public API: pass a
#: custom sequence to :func:`optimize` to run a subset (or your own
#: :class:`Rewrite` subclasses).
PASSES: tuple[Rewrite, ...] = (
    PushdownFilter(),
    PruneColumns(),
    NormalizePred(),
    EliminateTrivialPred(),
)

_MAX_ROUNDS = 8


def optimize_trace(
    node: PlanNode | PlanBuilder, passes: tuple[Rewrite, ...] = PASSES
) -> tuple[PlanNode, tuple[str, ...]]:
    """Run ``passes`` to fixpoint; return (optimized tree, passes that fired)."""
    if isinstance(node, PlanBuilder):
        node = node.node
    applied: list[str] = []
    for _ in range(_MAX_ROUNDS):
        changed = False
        for p in passes:
            out = p.apply(node)
            if out is not node:
                node = out
                changed = True
                if p.name not in applied:
                    applied.append(p.name)
        if not changed:
            break
    return node, tuple(applied)


def optimize(
    node: PlanNode | PlanBuilder, passes: tuple[Rewrite, ...] = PASSES
) -> PlanNode:
    """Canonicalize a logical plan (the tree the unoptimized route would run
    is semantically identical — the differential suite pins byte equality)."""
    return optimize_trace(node, passes)[0]
