"""Train ``chip_smoke.py``'s train phase's steps once for each way of
computing the flash gradient, on one NVIDIA GPU, and print each run's
losses and ``grad_norm`` by step, one JSON line a run.

The steps are the train phase's: ``qwen3-8b`` at full width, its first
``TRAIN_LAYERS`` layers, from the same seed, record store and batches,
1 + ``TRAIN_STEPS`` steps of AdamW.  The runs differ only in the backward
of ``FlashAttention``:

* ``kernel``: the backward kernel (``csrc/rm_flash_bwd.cu``), the port's;
* ``plain``: its plain version (``flash_attention_backward_torch``) on the
  same output and lse: the same arithmetic, P and dS rounded to bf16 from
  ``exp`` where the kernel takes ``exp2``, float32 sums in another order;
* ``recompute``: autograd of the plain forward (``flash_attention_torch``
  in key steps of ``TRAIN_ATTN_CHUNK``), the flash gradient before the
  backward kernel was written.

It runs ``RUNS`` in order, the kernel twice: two runs of one kind should
agree bit for bit; two kinds part as far as a few AdamW steps carry their
bf16 rounding differences.

    python3 src/repro_torch/launch/train_drift.py
"""

from __future__ import annotations

import dataclasses
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
RUNS = ("kernel", "plain", "recompute", "kernel")
SEED = 0  # chip_smoke.py's default --seed: the train phase's weights


def backward(torch, CS, FA, kind: str):
    """The flash gradient of ``kind`` with ``run_flash_backward``'s
    arguments, or None for the kernel itself."""
    if kind == "plain":
        def plain(*args):
            return FA.flash_attention_backward_torch(*args, block_k=CS.TRAIN_ATTN_CHUNK)
        return plain
    if kind == "recompute":
        def recompute(q, k, v, out, lse, dout, causal, window):
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            with torch.enable_grad():
                o = FA.flash_attention_torch(*leaves, causal, window,
                                             block_k=CS.TRAIN_ATTN_CHUNK)
            return torch.autograd.grad(o, leaves, dout)
        return recompute
    return None


def train(torch, CS, kind: str) -> dict:
    """One run of the train phase's steps with the flash gradient of
    ``kind``: each step's loss and ``grad_norm``."""
    from repro_torch.configs import get_config
    from repro_torch.data import TrainPipeline
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.step import init_train_state

    cfg = dataclasses.replace(get_config(CS.TRAIN_ARCH), n_layers=CS.TRAIN_LAYERS)
    store = CS.record_store(torch, CS.TRAIN_SEQ, CS.TRAIN_SAMPLES, cfg.vocab)
    model = build_model(cfg, device="cuda", seed=SEED, param_dtype=cfg.param_dtype)
    state = init_train_state(model)
    step_fn = make_train_step(model, AdamWConfig(**CS.TRAIN_OPT), grad_accum=cfg.grad_accum)
    batches = TrainPipeline(store, batch_size=CS.TRAIN_BATCH, seed=0).batches()
    kernel, fn = _cuda.run_flash_backward, backward(torch, CS, FA, kind)
    steps = []
    try:
        if fn is not None:
            _cuda.run_flash_backward = fn
        _cuda.reset_launches()
        for _ in range(1 + CS.TRAIN_STEPS):
            state, metrics = step_fn(state, next(batches))
            steps.append({k: float(metrics[k]) for k in ("loss", "grad_norm")})
        launches = _cuda.LAUNCHES["flash_attention_backward"]
    finally:
        _cuda.run_flash_backward = kernel
    del state, model, store, batches, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return {"run": kind, "steps": steps, "backward_kernel_launches": launches}


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS

    for kind in RUNS:
        line = train(torch, CS, kind)
        line["device"] = torch.cuda.get_device_name(0)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
