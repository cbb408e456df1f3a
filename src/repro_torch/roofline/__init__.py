"""Roofline analysis of the port's steps on H100 figures, counted from
torch as a step runs (``analysis``), and the table of dry-run cells
(``report``) — the port of ``repro.roofline``."""

from .analysis import (
    HW,
    CellResult,
    Hardware,
    analyze_step,
    count_step,
    roofline_terms,
    wire_bytes,
)

__all__ = ["HW", "CellResult", "Hardware", "analyze_step", "count_step", "roofline_terms",
           "wire_bytes"]
