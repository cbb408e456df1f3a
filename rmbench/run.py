"""One run of one cell of the port's benchmark.

    python3 -m rmbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The run sets up the cell from its files
(``BENCHMARK.json`` names them), warms every shape its traffic uses,
measures for ``--seconds``, checks what the measured window produced against
the plain reference, and prints one JSON line last: the end-to-end metrics
with ``--trace 0``, the per-layer metrics (and ``breakdown``) with ``--trace
1``.  Each number compared is printed beside its limit as the last lines of
standard error.  Without a CUDA device (or with fewer than the cell asks
for), without the program (``src/repro_torch``), or with JAX loaded once the
window has closed, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # the run's start: set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # whole top-level module names


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list[str]:
    return sorted(k for k in list(sys.modules) if k.split(".")[0] in FORBIDDEN)


def use_program(root: Path) -> None:
    """Put the checkout's ``src`` first on the import path and import the
    program, or fail."""
    src = root / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        raise SystemExit(f"the program is not in this checkout ({src / 'repro_torch'} "
                         "is missing): nothing to measure")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    import repro_torch  # noqa: F401


def device_info(torch, device, outcome, trace: bool) -> dict:
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": outcome.memory_peak_bytes}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": outcome.memory_peak_bytes}
    if trace and outcome.trace is not None:
        info["busy_s"] = outcome.trace.busy_s
        info["window_s"] = outcome.trace.window_s
    return info


def main(argv=None, bench_dir=None, device: str | None = None) -> int:
    """``device`` (tests only) runs the cell on that device without looking
    for a card, and holds against the run only the JAX modules it loaded
    itself (a test process may hold others); the command line always runs
    on the card and refuses any."""
    from . import manifest
    from .result import result_line
    from .trace import HostClock

    clock = HostClock(T0)
    preloaded = set(forbidden_modules()) if device is not None else set()
    args = parse_args(argv)
    m = manifest.Manifest(bench_dir or manifest.BENCH_DIR)
    cell = m.cell(args.workload)
    import torch

    clock.mark("torch_s")
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"rmbench: {args.workload} needs {cell.chips} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    clock.mark("cuda_s")
    use_program(m.root)
    driver = cell.driver()
    clock.mark("program_s")
    outcome = driver.run(cell, seed=args.seed, seconds=args.seconds,
                         trace=bool(args.trace), device=dev, clock=clock)
    found = [name for name in forbidden_modules() if name not in preloaded]
    if found:
        print(f"rmbench: the run loaded {found}: the port must not load JAX or "
              "the JAX package", file=sys.stderr)
        return 4
    layer_values = {}
    if args.trace:
        layer_values = {name: read(outcome.layer) for name, read in cell.readers().items()}
    line = result_line(cell, outcome, bool(args.trace),
                       device_info(torch, dev, outcome, bool(args.trace)), layer_values)
    print(f"rmbench: {args.workload} seed {args.seed} trace {args.trace} "
          f"{json.dumps(outcome.layer.get('timings', {}))}", file=sys.stderr)
    for c in outcome.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
