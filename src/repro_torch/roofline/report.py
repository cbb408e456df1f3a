"""Render the roofline table from the port's dry-run cell JSONs — the port
of ``repro.roofline.report``.  The terms are counts at the H100's data-sheet
figures (``roofline.analysis.HW``), not measured times.

Usage: PYTHONPATH=src python -m repro_torch.roofline.report build/dryrun [mesh]
       PYTHONPATH=src python -m repro_torch.roofline.report AFTER mesh --compare BEFORE
"""

from __future__ import annotations

import glob
import json
import os
import sys


def load_cells(directory: str) -> list[dict]:
    cells = []
    for f in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(f) as fh:
            cells.append(json.load(fh))
    return cells


def _gib(x) -> str:
    return "—" if x is None else f"{x / 2**30:.1f}"


def fmt_table(cells: list[dict], mesh: str = "pod16x16") -> str:
    lines = [
        "| arch | shape | compute (s) | memory (s) | collective (s) | "
        "dominant | args GiB/dev | model TFLOP | useful | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}
    rows = [c for c in cells if c.get("mesh") == mesh]
    rows.sort(key=lambda c: (c["arch"], order.get(c["shape"], 9)))
    for c in rows:
        if c.get("status", "ok").startswith("SKIP"):
            lines.append(
                f"| {c['arch']} | {c['shape']} | — | — | — | SKIP "
                f"(full attention @500k) | — | — | — | — |"
            )
            continue
        t = c["terms"]
        lines.append(
            "| {arch} | {shape} | {c:.3f} | {m:.3f} | {k:.3f} | {dom} | "
            "{args} | {mf:.1f} | {useful:.2f} | {frac:.3f} |".format(
                arch=c["arch"], shape=c["shape"], c=t["compute"],
                m=t["memory"], k=t["collective"], dom=c["dominant"],
                args=_gib(c["memory"].get("argument_bytes")),
                mf=c["model_flops"] / 1e12,
                useful=c.get("useful_flops_ratio", 0),
                frac=c.get("roofline_fraction", 0),
            )
        )
    return "\n".join(lines)


def fmt_compare(base_dir: str, opt_dir: str, mesh: str = "pod16x16") -> str:
    """Before/after table (step-time lower bound per cell)."""
    base = {(c["arch"], c["shape"]): c for c in load_cells(base_dir)
            if c.get("mesh") == mesh and not c.get("status", "ok").startswith("SKIP")}
    opt = {(c["arch"], c["shape"]): c for c in load_cells(opt_dir)
           if c.get("mesh") == mesh and not c.get("status", "ok").startswith("SKIP")}
    lines = [
        "| arch | shape | LB before (s) | LB after (s) | speedup | "
        "dominant before→after |",
        "|---|---|---|---|---|---|",
    ]
    for key in sorted(base):
        if key not in opt:
            continue
        b, o = base[key], opt[key]
        lb_b = b.get("step_time_lower_bound_s", 0)
        lb_o = o.get("step_time_lower_bound_s", 0)
        if not lb_b or not lb_o:
            continue
        lines.append(
            f"| {key[0]} | {key[1]} | {lb_b:.3f} | {lb_o:.3f} | "
            f"{lb_b/lb_o:.2f}× | {b['dominant']}→{o['dominant']} |"
        )
    return "\n".join(lines)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    directory = argv[0] if argv else "results/dryrun"
    mesh = argv[1] if len(argv) > 1 else "pod16x16"
    if len(argv) > 2 and argv[2] == "--compare":
        print(fmt_compare(argv[3], directory, mesh))
        return
    print(fmt_table(load_cells(directory), mesh))


if __name__ == "__main__":
    main()
