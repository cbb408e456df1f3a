"""Logical query plans — the declarative layer the paper's §8 argues for.

The closing argument of the paper is that native column access "can vastly
simplify the software logic": once the RME serves any column group at row-store
cost, the *software* no longer hand-routes each query — it states the query
shape and lets a planner pick the datapath.  This module is that statement
layer: a small immutable operator tree (Scan / Filter / Project / Aggregate /
GroupBy / Join) plus a fluent :func:`plan` builder, deliberately scoped to the
query shapes the engine can serve natively (the Relational Memory Benchmark,
Listing 5 — Q0 through Q5).

Nothing here executes.  :func:`repro_torch.core.planner.compile_plan` lowers a tree
to a :class:`~repro_torch.core.planner.PhysicalQuery` routed through fused offload
kernels, shared-scan materialization, or host-side fallback; the
:class:`~repro_torch.serve.query_server.QueryServer` admission-queues trees from many
clients and coalesces their scans.  Plans are backend-agnostic: the same tree
compiles unchanged for the single-device engine and the mesh-sharded backend
(``compile_plan(..., backend=...)`` only *validates* the pairing — see
:class:`repro_torch.core.distributed.ShardedEngine`).  :func:`decompose` is the shared front end:
it flattens a tree into the canonical ``QueryShape`` both consumers route on,
rejecting shapes the physical layer cannot serve (:class:`PlanError`).
"""

from __future__ import annotations

import dataclasses

from .table import RelationalTable

AGG_OPS = ("sum", "count", "avg")
GROUP_OPS = ("sum", "avg")
PRED_OPS = ("gt", "lt")


class PlanError(ValueError):
    """A logical plan the physical layer cannot serve (shape, ops, columns)."""


# ------------------------------------------------------------------ nodes
@dataclasses.dataclass(frozen=True, eq=False)
class PlanNode:
    """Base of the logical operator tree. Immutable; identity comparison."""

    def children(self) -> tuple["PlanNode", ...]:
        return ()

    def map_children(self, fn) -> "PlanNode":
        """Rebuild this node with ``fn`` applied to each child.

        Returns ``self`` unchanged when ``fn`` is the identity on every
        child — rewrite passes rely on that to detect fixpoints cheaply.
        This is the single structural hook :mod:`repro_torch.core.optimizer`
        builds its visitor/rewriter protocol on.
        """
        return self


@dataclasses.dataclass(frozen=True, eq=False)
class Scan(PlanNode):
    """Leaf: the row store of one relation (always a row store, paper §4)."""

    table: RelationalTable


@dataclasses.dataclass(frozen=True, eq=False)
class Filter(PlanNode):
    """``WHERE col <op> k`` — one predicate, matching the fused kernels."""

    child: PlanNode
    col: str
    op: str
    k: int | float = 0

    def __post_init__(self):
        if self.op not in PRED_OPS:
            raise PlanError(f"filter op {self.op!r}; want one of {PRED_OPS}")

    def children(self) -> tuple[PlanNode, ...]:
        return (self.child,)

    def map_children(self, fn) -> PlanNode:
        child = fn(self.child)
        return self if child is self.child else dataclasses.replace(self, child=child)


@dataclasses.dataclass(frozen=True, eq=False)
class Project(PlanNode):
    """``SELECT col, ...`` — a column group (an ephemeral-view registration)."""

    child: PlanNode
    columns: tuple[str, ...]

    def __post_init__(self):
        if not self.columns:
            raise PlanError("projection needs at least one column")
        if len(set(self.columns)) != len(self.columns):
            raise PlanError(f"duplicate columns in projection {self.columns}")

    def children(self) -> tuple[PlanNode, ...]:
        return (self.child,)

    def map_children(self, fn) -> PlanNode:
        child = fn(self.child)
        return self if child is self.child else dataclasses.replace(self, child=child)


@dataclasses.dataclass(frozen=True, eq=False)
class Aggregate(PlanNode):
    """``SELECT <op>(col)`` — a scalar the engine can answer near-memory."""

    child: PlanNode
    col: str
    op: str = "sum"

    def __post_init__(self):
        if self.op not in AGG_OPS:
            raise PlanError(f"aggregate op {self.op!r}; want one of {AGG_OPS}")

    def children(self) -> tuple[PlanNode, ...]:
        return (self.child,)

    def map_children(self, fn) -> PlanNode:
        child = fn(self.child)
        return self if child is self.child else dataclasses.replace(self, child=child)


@dataclasses.dataclass(frozen=True, eq=False)
class GroupBy(PlanNode):
    """``SELECT <op>(agg) ... GROUP BY group`` over a static group domain."""

    child: PlanNode
    group: str
    agg: str
    op: str = "avg"
    num_groups: int = 64

    def __post_init__(self):
        if self.op not in GROUP_OPS:
            raise PlanError(f"group-by op {self.op!r}; want one of {GROUP_OPS}")
        if self.num_groups <= 0:
            raise PlanError("num_groups must be positive (static accumulators)")

    def children(self) -> tuple[PlanNode, ...]:
        return (self.child,)

    def map_children(self, fn) -> PlanNode:
        child = fn(self.child)
        return self if child is self.child else dataclasses.replace(self, child=child)


@dataclasses.dataclass(frozen=True, eq=False)
class Join(PlanNode):
    """``SELECT L.left_proj, R.right_proj FROM L JOIN R ON L.key = R.key``.

    The build side ``right`` is assumed duplicate-free on ``key`` (primary
    key), as in the paper's setup; the build side must be a plain scan — the
    RME's role is slimming each side to {key, payload} before the CPU joins.
    The probe side may be another Join (a left-deep chain the planner orders
    by cost) or a Filter over the probe scan (a probe-side predicate fused
    into the probe pass).
    """

    left: PlanNode
    right: PlanNode
    key: str
    left_proj: str
    right_proj: str

    def children(self) -> tuple[PlanNode, ...]:
        return (self.left, self.right)

    def map_children(self, fn) -> PlanNode:
        left, right = fn(self.left), fn(self.right)
        if left is self.left and right is self.right:
            return self
        return dataclasses.replace(self, left=left, right=right)


# ---------------------------------------------------------------- builder
class PlanBuilder:
    """Fluent plan construction: ``plan(t).filter("A3", "gt", 0).sum("A1")``.

    Each method returns a new builder over an extended tree; ``build()``
    returns the root node.  Builders are accepted anywhere a node is (the
    compiler and server call ``build()`` themselves).
    """

    def __init__(self, node: PlanNode):
        self.node = node

    def build(self) -> PlanNode:
        return self.node

    def filter(self, col: str, op: str, k: int | float = 0) -> "PlanBuilder":
        return PlanBuilder(Filter(self.node, col, op, k))

    def project(self, *columns: str) -> "PlanBuilder":
        return PlanBuilder(Project(self.node, tuple(columns)))

    def aggregate(self, col: str, op: str = "sum") -> "PlanBuilder":
        return PlanBuilder(Aggregate(self.node, col, op))

    def sum(self, col: str) -> "PlanBuilder":
        return self.aggregate(col, "sum")

    def avg(self, col: str) -> "PlanBuilder":
        return self.aggregate(col, "avg")

    def count(self, col: str) -> "PlanBuilder":
        return self.aggregate(col, "count")

    def groupby(
        self, group: str, agg: str, op: str = "avg", num_groups: int = 64
    ) -> "PlanBuilder":
        return PlanBuilder(GroupBy(self.node, group, agg, op, num_groups))

    def join(
        self,
        right: "PlanBuilder | PlanNode | RelationalTable",
        key: str,
        left_proj: str,
        right_proj: str,
    ) -> "PlanBuilder":
        if isinstance(right, RelationalTable):
            right = Scan(right)
        elif isinstance(right, PlanBuilder):
            right = right.node
        return PlanBuilder(Join(self.node, right, key, left_proj, right_proj))

    def __repr__(self) -> str:  # pragma: no cover
        return f"PlanBuilder({describe(self.node)})"


def plan(table: RelationalTable) -> PlanBuilder:
    """Start a plan over ``table``'s row store.

    Plans are pure descriptions — nothing reads the table until
    :func:`repro_torch.core.planner.compile_plan` lowers the tree and the resulting
    :class:`~repro_torch.core.planner.PhysicalQuery` runs.  Execution therefore
    observes the table state (and, on the rme path, the optional
    ``snapshot_ts`` passed to ``compile_plan``) at *run* time: through the
    :class:`~repro_torch.serve.query_server.QueryServer` that means the post-write
    snapshot of the tick that serves the plan, while writes that land after
    the tick cost the engine only their delta (tail-chunk uploads, timestamp
    patches) — never a re-materialization of the plan's inputs.
    """
    return PlanBuilder(Scan(table))


# ----------------------------------------------------------- decomposition
@dataclasses.dataclass(frozen=True)
class Predicate:
    """The single fused predicate the kernels evaluate in-scan."""

    col: str
    op: str
    k: int | float


@dataclasses.dataclass(frozen=True)
class JoinSpec:
    right_table: RelationalTable
    key: str
    left_proj: str
    right_proj: str


@dataclasses.dataclass(frozen=True, eq=False)
class QueryShape:
    """Canonical flattened query: what the physical layer routes on.

    ``kind`` is one of ``"project"`` (with or without a fused predicate),
    ``"aggregate"``, ``"groupby"``, ``"join"``.  ``columns`` is the column
    group the rme datapath would enable for this query — the planner costs
    and the server coalesces on exactly this set.  ``joins`` carries every
    spec of a left-deep join chain innermost-first (``join`` aliases the
    first spec for single-join consumers); for ``kind == "join"`` the
    optional ``pred`` is a probe-side predicate fused into the probe pass.
    """

    kind: str
    table: RelationalTable
    columns: tuple[str, ...]
    pred: Predicate | None = None
    agg: Aggregate | None = None
    group: GroupBy | None = None
    join: JoinSpec | None = None
    joins: tuple[JoinSpec, ...] = ()


def _base_scan(node: PlanNode) -> Scan:
    if not isinstance(node, Scan):
        raise PlanError(f"expected a plain Scan, got {type(node).__name__}")
    return node


def _ordered(table: RelationalTable, columns) -> tuple[str, ...]:
    """Physical (byte-offset) order — the packed layout the RME emits."""
    for name in columns:
        table.schema.column(name)  # raises KeyError for unknown columns
    return tuple(sorted(set(columns), key=table.schema.byte_offset))


def _collapse_filters(table: RelationalTable, filters) -> Predicate | None:
    """Collapse a stack of Filters into the single fused predicate.

    Identical spellings collapse; two *distinct* predicates still exceed
    what the fused kernels evaluate and raise :class:`PlanError`.
    """
    preds: list[Predicate] = []
    for f in filters:
        table.schema.column(f.col)  # admission-time check, like _ordered
        preds.append(Predicate(f.col, f.op, f.k))
    uniq = list(dict.fromkeys(preds))
    if len(uniq) > 1:
        raise PlanError("at most one distinct Filter per plan (fused predicate)")
    return uniq[0] if uniq else None


def _decompose_join(root: Join, outer_filters: list[Filter]) -> QueryShape:
    """Flatten a left-deep join chain (plus probe-side Filters) to a shape."""
    specs: list[JoinSpec] = []
    filters = list(outer_filters)
    node: PlanNode = root
    while True:
        if isinstance(node, Join):
            right = _base_scan(node.right)
            _ordered(right.table, (node.key, node.right_proj))  # validate names
            specs.append(
                JoinSpec(right.table, node.key, node.left_proj, node.right_proj)
            )
            node = node.left
        elif isinstance(node, Filter):
            filters.append(node)
            node = node.child
        elif isinstance(node, Scan):
            break
        else:
            raise PlanError(f"expected a plain Scan, got {type(node).__name__}")
    table = node.table
    specs.reverse()  # innermost (first-applied) join first
    for spec in specs:
        _ordered(table, (spec.left_proj, spec.key))  # probe names, base table
    pred = _collapse_filters(table, filters)
    cols = _ordered(
        table, tuple(c for s in specs for c in (s.left_proj, s.key))
    )
    return QueryShape(
        kind="join", table=table, columns=cols, pred=pred,
        join=specs[0], joins=tuple(specs),
    )


def decompose(node: PlanNode | PlanBuilder) -> QueryShape:
    """Flatten a plan tree into the canonical :class:`QueryShape`.

    Accepted shapes (the Relational Memory Benchmark queries, plus the
    orderings rewrite passes produce):
    ``[Aggregate|GroupBy]? <- (Project|Filter)* <- Scan`` — Project and
    Filter commute freely and names always resolve against the base scan's
    schema, so every reordering of the same operators yields the same shape
    — or a left-deep Join chain ``Filter* <- Join(... Join(Filter* <- Scan,
    Scan) ..., Scan)``.  Repeated identical Filters collapse to the single
    fused predicate (two distinct predicates raise); nested Projects keep
    the outermost as the output group; Projects under Aggregate/GroupBy
    widen the scanned column group (the optimizer's pruning pass removes
    them).
    """
    if isinstance(node, PlanBuilder):
        node = node.node

    agg: Aggregate | None = None
    group: GroupBy | None = None
    if isinstance(node, Aggregate):
        agg, node = node, node.child
    elif isinstance(node, GroupBy):
        group, node = node, node.child

    projects: list[Project] = []
    filters: list[Filter] = []
    while not isinstance(node, (Scan, Join)):
        if isinstance(node, Project):
            projects.append(node)
            node = node.child
        elif isinstance(node, Filter):
            filters.append(node)
            node = node.child
        elif isinstance(node, (Aggregate, GroupBy)):
            raise PlanError(
                f"{type(node).__name__} must be the plan root, not an input"
            )
        else:
            raise PlanError(f"unsupported plan node {type(node).__name__}")

    if isinstance(node, Join):
        if agg is not None or group is not None:
            raise PlanError(
                f"{'Aggregate' if agg is not None else 'GroupBy'} over a Join"
                " is not supported"
            )
        if projects:
            raise PlanError("Project above a Join is not supported")
        return _decompose_join(node, filters)
    table = node.table
    pred = _collapse_filters(table, filters)
    proj_cols = tuple(c for p in projects for c in p.columns)

    if agg is not None:
        cols = _ordered(
            table, (agg.col,) + ((pred.col,) if pred else ()) + proj_cols
        )
        return QueryShape("aggregate", table, cols, pred=pred, agg=agg)
    if group is not None:
        cols = _ordered(
            table,
            (group.group, group.agg) + ((pred.col,) if pred else ()) + proj_cols,
        )
        return QueryShape("groupby", table, cols, pred=pred, group=group)
    # the scan must also read the predicate column, but the *output* group is
    # the (outermost) projection — columns is what the fused filter emits
    out = projects[0].columns if projects else table.schema.names
    _ordered(table, proj_cols)  # inner projections: validate, outermost wins
    return QueryShape("project", table, _ordered(table, out), pred=pred)


def describe(node: PlanNode | PlanBuilder) -> str:
    """One-line pretty form, root first: ``Sum(A1) <- Filter(A3 gt 0) <- Scan``."""
    if isinstance(node, PlanBuilder):
        node = node.node
    if isinstance(node, Scan):
        return f"Scan[{node.table.row_count}x{len(node.table.schema.columns)}]"
    if isinstance(node, Filter):
        return f"Filter({node.col} {node.op} {node.k}) <- {describe(node.child)}"
    if isinstance(node, Project):
        return f"Project({','.join(node.columns)}) <- {describe(node.child)}"
    if isinstance(node, Aggregate):
        return f"{node.op.title()}({node.col}) <- {describe(node.child)}"
    if isinstance(node, GroupBy):
        return (
            f"GroupBy({node.group}, {node.op}({node.agg}), G={node.num_groups})"
            f" <- {describe(node.child)}"
        )
    if isinstance(node, Join):
        return (
            f"Join(on {node.key}: {node.left_proj}, {node.right_proj})"
            f" <- [{describe(node.left)} | {describe(node.right)}]"
        )
    return type(node).__name__
