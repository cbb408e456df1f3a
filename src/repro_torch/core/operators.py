"""Relational operators over the three access paths of the paper's §6 — the
port of ``repro.core.operators``.

Every query from the Relational Memory Benchmark (Listing 5) is expressed
against three interchangeable data paths so the benchmarks can reproduce the
paper's comparisons:

* ``"rme"`` — through the engine: ephemeral views / fused near-memory kernels.
  Only the enabled columns' bytes cross toward compute.
* ``"row"`` — *direct row-wise access*: the full row store is shipped and the
  columns are sliced CPU-side (the strided-access baseline the paper beats).
* ``"col"`` — *direct columnar access*: a materialized column-store copy
  (``columnar_copy``), i.e. what adaptive-layout systems maintain.  Tuple
  reconstruction shows up naturally as per-column array traffic.

All paths produce identical results; tests assert cross-path equality and the
benchmarks report time + exact bytes moved per path.

Since the plan-IR refactor, ``q0``–``q5`` are *thin plan constructors*: each
builds a logical plan (:mod:`repro_torch.core.plan`) and hands it to
:func:`repro_torch.core.planner.compile_plan`, which routes it to the best physical
path — fused offload kernels, shared-scan materialization, or host-side
fallback.  The physical execution bodies (and the q5 sorted build-side index
cache) live in :mod:`repro_torch.core.planner`; the names re-exported below keep the
established ``operators`` surface stable for tests and benchmarks.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .engine import RelationalMemoryEngine
from .plan import plan
from .planner import (  # noqa: F401  (re-exported operator surface)
    _BUILD_INDEX_CACHE,
    JOIN_BUILD_STATS,
    CompileOptions,
    JoinResult,
    clear_join_build_cache,
    compile_plan,
)
from .table import RelationalTable, columnar_copy

PATHS = ("rme", "row", "col")


# ----------------------------------------------------------------- queries
def q0_sum(
    engine: RelationalMemoryEngine,
    table: RelationalTable,
    col: str = "A1",
    path: str = "rme",
    colstore: Mapping[str, np.ndarray] | None = None,
) -> float:
    """Q0: SELECT SUM(A1) FROM S."""
    q = plan(table).sum(col)
    return compile_plan(
        q, engine, options=CompileOptions(path=path, colstore=colstore)
    ).run()


def q1_project(
    engine: RelationalMemoryEngine,
    table: RelationalTable,
    cols: tuple[str, ...],
    path: str = "rme",
    colstore: Mapping[str, np.ndarray] | None = None,
) -> torch.Tensor:
    """Q1: SELECT A1..Ak FROM S — returns the packed (N, k_words) group.

    The ``col`` path pays tuple reconstruction: k separate column arrays are
    re-interleaved into row order (the paper's increasing cost with
    projectivity); ``row`` ships full rows then slices.
    """
    q = plan(table).project(*cols)
    return compile_plan(
        q, engine, options=CompileOptions(path=path, colstore=colstore)
    ).run()


def q2_select_project(
    engine: RelationalMemoryEngine,
    table: RelationalTable,
    proj: str = "A1",
    pred: str = "A3",
    k: int = 0,
    path: str = "rme",
    colstore: Mapping[str, np.ndarray] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Q2: SELECT A1 FROM S WHERE A3 > k — returns (values, mask).

    ``values`` are raw packed words on every path (the fused kernel's output
    contract — decode float32 columns with a bitcast, as ``EphemeralView
    .column`` does); previously the row/col baselines decoded while the rme
    kernel did not, so the paths disagreed for non-int32 columns.
    """
    q = plan(table).filter(pred, "gt", k).project(proj)
    packed, mask = compile_plan(
        q, engine, options=CompileOptions(path=path, colstore=colstore)
    ).run()
    return packed[:, 0], mask


def q3_select_aggregate(
    engine: RelationalMemoryEngine,
    table: RelationalTable,
    agg: str = "A2",
    pred: str = "A4",
    k: int = 0,
    path: str = "rme",
    colstore: Mapping[str, np.ndarray] | None = None,
) -> float:
    """Q3: SELECT SUM(A2) FROM S WHERE A4 < k."""
    q = plan(table).filter(pred, "lt", k).sum(agg)
    return compile_plan(
        q, engine, options=CompileOptions(path=path, colstore=colstore)
    ).run()


def q4_groupby_avg(
    engine: RelationalMemoryEngine,
    table: RelationalTable,
    agg: str = "A1",
    pred: str = "A3",
    group: str = "A2",
    k: int = 0,
    num_groups: int = 64,
    path: str = "rme",
    colstore: Mapping[str, np.ndarray] | None = None,
) -> torch.Tensor:
    """Q4: SELECT AVG(A1) FROM S WHERE A3 < k GROUP BY A2 (group domain mod G)."""
    q = plan(table).filter(pred, "lt", k).groupby(group, agg, "avg", num_groups)
    return compile_plan(
        q, engine, options=CompileOptions(path=path, colstore=colstore)
    ).run()


def q5_hash_join(
    engine: RelationalMemoryEngine,
    s_table: RelationalTable,
    r_table: RelationalTable,
    s_proj: str = "A1",
    key: str = "A2",
    r_proj: str = "A3",
    path: str = "rme",
    s_colstore: Mapping[str, np.ndarray] | None = None,
    r_colstore: Mapping[str, np.ndarray] | None = None,
) -> JoinResult:
    """Q5: SELECT S.A1, R.A3 FROM S JOIN R ON S.A2 = R.A2.

    RME's role (paper §6): project only {key, projected} from each side, so
    the join's data movement shrinks from full rows to two slim columns per
    table; the join itself stays on the CPU ("relying on traditional CPUs for
    data processing once good locality has been achieved").  Both sides go
    through the batch path: one shared scan per table.
    """
    q = plan(s_table).join(r_table, key=key, left_proj=s_proj, right_proj=r_proj)
    return compile_plan(
        q, engine, options=CompileOptions(
            path=path, colstore=s_colstore, right_colstore=r_colstore
        )
    ).run()


def run_query(name: str, *args, **kwargs):
    return {
        "q0": q0_sum,
        "q1": q1_project,
        "q2": q2_select_project,
        "q3": q3_select_aggregate,
        "q4": q4_groupby_avg,
        "q5": q5_hash_join,
    }[name](*args, **kwargs)


def make_colstore(table: RelationalTable, cols) -> dict[str, np.ndarray]:
    """Materialize the 'direct columnar' baseline copy for the given columns."""
    return columnar_copy(table, list(cols))
