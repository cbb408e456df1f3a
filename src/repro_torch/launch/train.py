"""Training launcher — the port of ``repro.launch.train``: mesh, rules,
a record store, its batch pipeline, a train state and the trainer loop.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b --smoke \\
      --steps 100 --batch 16 --seq 128 --ckpt-dir <dir> [--device cpu]
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen3-8b --smoke --model-axis 2 --ckpt-dir <dir> [--device cpu]

Runs on the card unless ``--device cpu`` is given; without a card the
default raises.  The corpus is ``synthetic_corpus(--samples, --seq, vocab,
seed=1)`` ingested row-major into a ``RecordStore`` on that device, read
through ``TrainPipeline`` (on the card every batch's view is packed by the
projection kernel); the weights are drawn from ``--seed`` as master weights
in the config's ``param_dtype``.  A run restarted with the same flags
resumes from the last checkpoint under ``--ckpt-dir``, its batch stream
sought to the restored step.  As the reference's, it drives token-input
decoders only (``qwen2-vl-72b`` and ``seamless-m4t-medium`` are refused).

Under ``torchrun`` (``WORLD_SIZE`` set) each process joins the process
group — NCCL on its card (``LOCAL_RANK``), gloo with ``--device cpu`` —
builds the same seeded store and pipeline, and trains through
``train.sharded.make_sharded_train_step`` on a ``(world / model_axis,
model_axis)`` mesh (``launch.mesh.host_device_mesh``), its state placed by
the mesh's specs and restored onto them (the mesh may differ between runs).
A world of one with ``--model-axis 1`` keeps the unsharded
``make_train_step``; a model axis that does not divide the world raises.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import RecordStore, TrainPipeline, synthetic_corpus
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.mesh import host_device_mesh
from repro_torch.models import build_model
from repro_torch.train import AdamWConfig, make_train_step
from repro_torch.train.sharded import (
    make_sharded_train_step,
    shard_train_state,
    train_state_shardings,
)
from repro_torch.train.step import init_train_state
from repro_torch.train.trainer import Trainer, TrainerConfig


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--samples", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default: the card) or 'cpu'")
    return ap.parse_args(argv)


def main(argv=None) -> list[dict]:
    args = parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if not cfg.embed_inputs or cfg.is_encdec:
        raise SystemExit("this CLI drives token-input decoder archs; see "
                         "examples/ for VLM/enc-dec batches")
    device = resolve_device(args.device)
    joined = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if joined:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
            device = resolve_device(args.device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                device_id=device if device.type == "cuda" else None)
    try:
        return _train(args, cfg, device)
    finally:
        if joined:
            dist.destroy_process_group()


def _train(args, cfg, device) -> list[dict]:
    world = dist.get_world_size() if dist.is_initialized() else 1
    lead = not dist.is_initialized() or dist.get_rank() == 0
    say = print if lead else (lambda *a: None)
    mesh = None
    if world > 1 or args.model_axis != 1:
        mesh = host_device_mesh(args.model_axis, device.type)
    model = build_model(cfg, device=device, seed=args.seed, param_dtype=cfg.param_dtype)
    where = "" if mesh is None else f", mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}"
    say(f"device {device}{where}, arch {cfg.name}")

    store = RecordStore(seq_len=args.seq, device=device)
    tok, lab = synthetic_corpus(args.samples, args.seq, cfg.vocab, seed=1)
    store.ingest(tok, lab)
    pipe = TrainPipeline(store, batch_size=args.batch, seed=0)

    state = init_train_state(model)
    opt = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                      decay_steps=args.steps)
    shardings = None
    if mesh is None:
        step_fn = make_train_step(model, opt, grad_accum=cfg.grad_accum)
    else:
        shardings = train_state_shardings(mesh, state["params"])
        state = shard_train_state(state, mesh)
        step_fn = make_sharded_train_step(model, opt, mesh, grad_accum=cfg.grad_accum)
    trainer = Trainer(
        step_fn, state, pipe.batches(),
        TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, log_every=10),
        state_shardings=shardings,
    )
    if trainer.try_restore():
        say(f"resumed from step {trainer.step}")
        trainer.batches = pipe.batches(start_step=trainer.step)
    history = trainer.run()
    for row in history:
        say(" ".join(f"{k}={v:.4g}" for k, v in row.items()))
    say(f"done at step {trainer.step}; stragglers: {trainer.straggler_steps}")
    return history


if __name__ == "__main__":
    main()
