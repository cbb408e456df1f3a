"""What holds a train step's peak on the card, on one NVIDIA GPU.

The step is ``chip_smoke.py``'s train phase's: ``qwen3-8b`` at full width,
its first ``TRAIN_LAYERS`` layers (``--arch recurrentgemma-9b``: the
``train_rg`` line's, its first ``TRAIN_RG_LAYERS``), from ``--seed``, trained through
``make_train_step`` on the batches of ``TrainPipeline(seed=0)`` over the
same record store.  One warm-up step and ``--steps`` timed ones (their
peak as the train phase reads it), then one step under the CUDA caching
allocator's trace (``torch.cuda.memory._record_memory_history`` with
Python frames), which ``chip_smoke.memory_split`` reads: the bytes the
step added at their highest, and at their highest before the update, by
what allocated them.  Prints one JSON line: the card, the step seconds,
both peaks, the memory held before the traced step (parameters, AdamW
moments, the rest: the record store, the batch) and the split.

    python3 src/repro_torch/launch/train_memory.py [--src DIR] [--arch A] [--steps N]
        [--seed S]

``--src`` puts another checkout's ``src`` directory first on the path, so
one run of this script measures two commits' train steps the same way
(this checkout's ``chip_smoke.py`` reads the trace).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--arch", default="qwen3-8b", choices=("qwen3-8b", "recurrentgemma-9b"))
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("train_memory: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from repro_torch.configs import get_config
    from repro_torch.data import TrainPipeline
    from repro_torch.kernels import _cuda
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.step import init_train_state

    smi = CS.card(torch)["nvidia_smi"]
    _cuda.load()
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py's LM and train phases
    layers = {CS.TRAIN_ARCH: CS.TRAIN_LAYERS, CS.TRAIN_RG_ARCH: CS.TRAIN_RG_LAYERS}[args.arch]
    cfg = dataclasses.replace(get_config(args.arch), n_layers=layers)
    store = CS.record_store(torch, CS.TRAIN_SEQ, CS.TRAIN_SAMPLES, cfg.vocab)
    batches = TrainPipeline(store, batch_size=CS.TRAIN_BATCH, seed=0).batches()
    model = build_model(cfg, device="cuda", seed=args.seed, param_dtype=cfg.param_dtype)
    state = init_train_state(model)
    step = make_train_step(model, AdamWConfig(**CS.TRAIN_OPT), grad_accum=cfg.grad_accum)
    torch.cuda.reset_peak_memory_stats()
    seconds = []
    for _ in range(1 + args.steps):
        batch = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    params = sum(t.numel() * t.element_size() for t in state["params"].values())
    batch = next(batches)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(stacks="python", max_entries=4_000_000)
    try:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        trace = torch.cuda.memory._snapshot()["device_traces"][0]
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    print(json.dumps({
        "card": smi, "src": str(args.src), "arch": cfg.name,
        "reduced": {"n_layers": [get_config(args.arch).n_layers, layers]},
        "warm_up_seconds": seconds[0], "step_seconds": seconds[1:], "peak": peak,
        "traced_peak": torch.cuda.max_memory_allocated(), "base": base,
        "parameters": params, "moments": 2 * params, "base_rest": base - 3 * params,
        "split": CS.memory_split(trace)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
