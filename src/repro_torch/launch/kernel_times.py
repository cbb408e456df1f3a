"""Time the fused scan and the hash-join probe three ways, at the shapes of
``chip_smoke.py``'s kernel lines, on one NVIDIA GPU:

* ``events_ms``: CUDA events around one wrapper call, host work included
  (as ``chip_smoke.py`` reports ``kernel_ms``), median of ``--reps``;
* ``device_ms``: the device time of the kernels that call launches, from
  ``torch.profiler`` over ``--reps`` calls, per call; ``device_kernels``
  splits it by kernel (``None``, and ``device_ms_estimated`` in its place,
  where the trace lost launches: ``chip_smoke.device_ms``);
* ``host_ms``: the host time to enqueue one call (planning, allocation,
  launch), mean over ``--reps`` calls issued back to back.

    python3 src/repro_torch/launch/kernel_times.py [--src DIR] [--rows N] [--reps R]

``--src`` puts another checkout's ``src`` directory first on the path, so
one run of this script can measure two commits of the port the same way
(the tables come from ``chip_smoke.py`` of the checkout holding this
script).  Prints one JSON line per case.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]


def host_ms(torch, fn, reps: int) -> float:
    """Mean host time to enqueue one call, ``reps`` calls back to back."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.mean(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from repro_torch.kernels import ops as K

    table = CS.build_table(args.rows or CS.ROWS, 0, CS.BUILD_ROWS)
    dim = CS.build_dimension(CS.BUILD_ROWS, 0)
    words = torch.from_numpy(table.words()).cuda()
    reqs = CS.path_requests(table, table.now())
    fused = [reqs[k] for k in ("project", "filter", "aggregate", "groupby", "aggregate2")]
    dw = dim.words()
    parts = K.build_partitions(dw[:, 1], dw[:, 2], dw[:, dim.ts_begin_word],
                               dw[:, dim.ts_end_word], device="cuda")
    packed = words[:, :2].contiguous()
    ts = table.now()
    cases = [
        ("scan_multi", lambda: K.scan_multi(words, fused)),
        ("hash_join", lambda: K.hash_join(words, parts, 1, 0, 16, ts, True)),
        ("hash_join_packed", lambda: K.hash_join(packed, parts, 1, 0, -1, ts, True)),
    ]
    import repro_torch

    for name, fn in cases:
        print(json.dumps({
            "case": name, "tag": args.tag, "package": str(Path(repro_torch.__file__).parent),
            "events_ms": CS.time_ms(torch, fn, args.reps),
            **CS.device_fields(torch, fn, args.reps),
            "host_ms": host_ms(torch, fn, args.reps),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
