"""The controls that set the upper readings of a cell's limits, on the card
at the cell's own size (the benchmark's own runs never run them):

    python3 -m rmbench.control --workload <cell> --seeds 1,2,3 [--seconds 3]

For every seed it prints one JSON line with the numbers the cell compares,
read from the program and from each control in the program's place:

* a relational cell: the program's answers of a short window at the cell's
  own load, and the reference's answers computed in bfloat16 (the step below
  the float32 sums the configuration states), each against the exact
  reference;
* a training cell (no window: set-up's first steps): the program, the
  reference with every product's operands in float8 e4m3 (the step below
  the bfloat16 products), and the reference fed half of each batch (the
  mean taken over the rest), each against the float32 reference.  A step
  that leaves the state unchanged reads 1 on the change by construction.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from . import manifest, run
from .trace import HostClock


def relational(cell, seed: int, seconds: float, device) -> dict:
    driver = cell.driver()
    s = driver.serve(cell, seed, seconds, False, device, HostClock(run.T0))
    want = driver.oracle(cell.config, seed, device)
    args = (cell.config, s["answers"], seed, device)
    prog = driver.judge(*args, want=want)
    ctrl = driver.judge(*args, precision="bfloat16", want=want)
    return {"answers": len(s["answers"]), "program": {c.name: c.value for c in prog},
            "control_bfloat16": {c.name: c.value for c in ctrl}}


def train(cell, seed: int, device) -> dict:
    driver = cell.driver()
    m, mix = cell.config, cell.mix
    prog, tokens, labels, leaves = driver.first_steps(cell, seed, device)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = driver.reference_run(m, mix, leaves, seed, tokens, labels, device)
    out = {"program": driver.gaps(prog, ref)}
    for name, kw in (("control_fp8", {"matmul": "fp8"}), ("half_batch", {"rows": 0.5})):
        other = driver.reference_run(m, mix, leaves, seed, tokens, labels, device, **kw)
        out[name] = driver.gaps(other, ref)
        del other
    out["state_unchanged"] = {"change_gap": 1.0}
    return out


def main(argv=None, bench_dir=None, device: str | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    cell = manifest.Manifest(bench_dir or manifest.BENCH_DIR).cell(args.workload)
    if device is None:
        if not torch.cuda.is_available():
            print("rmbench.control: no CUDA device", file=sys.stderr)
            return 3
        device = "cuda"
    dev = torch.device(device)
    run.use_program(cell.bench_dir.parent)
    for seed in (int(x) for x in args.seeds.split(",")):
        if cell.config["driver"] == "train":
            line = train(cell, seed, dev)
        else:
            line = relational(cell, seed, args.seconds, dev)
        print(json.dumps({"workload": args.workload, "seed": seed, **line}), flush=True)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
