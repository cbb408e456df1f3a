"""Serving launcher: continuous batching over the port's decoder.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b --smoke \\
      --requests 8 --slots 4 --max-new 16 [--int8] [--device cpu]

Runs on the card unless ``--device cpu`` is given; without a card the
default raises.  Weights and prompts are drawn from ``--seed``.  ``--int8``
serves with ``quantize_for_serving``'s int8 matmul weights (on the card a
decode step's products run the W8 kernel).  The rate is printed beside the
device it was measured on (the card's name) and the weights it served with.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import build_model
from repro_torch.models.layers import quantize_for_serving
from repro_torch.serve import Request, ServeSession


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default: the card) or 'cpu'")
    ap.add_argument("--int8", action="store_true",
                    help="int8-quantize matmul weights (the decode-cell path)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device=args.device, seed=args.seed)
    if args.int8:
        quantize_for_serving(model)
    device = model.device
    where = (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
    sess = ServeSession(model, batch_slots=args.slots, max_len=args.max_len)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, 8 + i % 8).astype(np.int32),
                    max_new=args.max_new) for i in range(args.requests)]
    for r in reqs:
        sess.submit(r)
    if device.type == "cuda":
        from repro_torch.kernels import _cuda

        _cuda.load()  # build the kernels (nvcc) before the clock starts
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    sess.run_to_completion()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in reqs)
    weights = "int8" if args.int8 else cfg.compute_dtype
    print(f"{cfg.name}: {toks} tokens / {dt:.2f}s = {toks/dt:.0f} tok/s "
          f"on {where} ({weights} weights, {cfg.compute_dtype} compute)")
    for r in reqs[:4]:
        print(f"  req {r.rid}: {r.out}")


if __name__ == "__main__":
    main()
