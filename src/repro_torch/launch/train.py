"""Training launcher — the port of ``repro.launch.train``: a record store,
its batch pipeline, a train state and the trainer loop on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b --smoke \\
      --steps 100 --batch 16 --seq 128 --ckpt-dir <dir> [--device cpu]

Runs on the card unless ``--device cpu`` is given; without a card the
default raises.  The corpus is ``synthetic_corpus(--samples, --seq, vocab,
seed=1)`` ingested row-major into a ``RecordStore`` on that device, read
through ``TrainPipeline`` (on the card every batch's view is packed by the
projection kernel); the weights are drawn from ``--seed`` as master weights
in the config's ``param_dtype``.  A run restarted with the same flags
resumes from the last checkpoint under ``--ckpt-dir``, its batch stream
sought to the restored step.  As the reference's, it drives token-input
decoders only (``qwen2-vl-72b`` and ``seamless-m4t-medium`` are refused).
The reference's mesh (``--model-axis``) waits for the port's sharding rules:
any value but 1 raises, naming ROADMAP queue 1 item 8.12.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import RecordStore, TrainPipeline, synthetic_corpus
from repro_torch.kernels.common import resolve_device
from repro_torch.models import build_model
from repro_torch.train import AdamWConfig, make_train_step
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
    if args.model_axis != 1:
        raise SystemExit("--model-axis other than 1 needs the port's sharding rules "
                         "(ROADMAP queue 1 item 8.12)")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if not cfg.embed_inputs or cfg.is_encdec:
        raise SystemExit("this CLI drives token-input decoder archs; see "
                         "examples/ for VLM/enc-dec batches")
    device = resolve_device(args.device)
    model = build_model(cfg, device=device, seed=args.seed, param_dtype=cfg.param_dtype)
    print(f"device {device}, arch {cfg.name}")

    store = RecordStore(seq_len=args.seq, device=device)
    tok, lab = synthetic_corpus(args.samples, args.seq, cfg.vocab, seed=1)
    store.ingest(tok, lab)
    pipe = TrainPipeline(store, batch_size=args.batch, seed=0)

    state = init_train_state(model)
    opt = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                      decay_steps=args.steps)
    step_fn = make_train_step(model, opt, grad_accum=cfg.grad_accum)
    trainer = Trainer(
        step_fn, state, pipe.batches(),
        TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, log_every=10),
    )
    if trainer.try_restore():
        print(f"resumed from step {trainer.step}")
        trainer.batches = pipe.batches(start_step=trainer.step)
    history = trainer.run()
    for row in history:
        print(" ".join(f"{k}={v:.4g}" for k, v in row.items()))
    print(f"done at step {trainer.step}; stragglers: {trainer.straggler_steps}")
    return history


if __name__ == "__main__":
    main()
