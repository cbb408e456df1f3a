"""Distribution substrate — the port of ``repro.distributed``: logical axis
rules and DTensor placements, compressed collectives, the GPipe pipeline."""

from .partitioning import (  # noqa: F401
    axis_rules,
    current_rules,
    logical_spec,
    lsc,
    param_partition_spec,
    set_axis_rules,
)
