"""Trainer loop — the port of ``repro.train.trainer``: preemption-safe
checkpoints, restore, stragglers.

* **Checkpoint/restart** — CheckpointManager cadence + a final checkpoint on
  SIGTERM/SIGINT (preemption notice).  ``try_restore`` puts the latest
  checkpoint's leaves on the devices of the current state's, or, given
  ``state_shardings`` (``train.sharded.train_state_shardings``), places
  them on the current mesh — the elastic restore, onto whatever mesh the
  restart got — and the data pipeline seeks to the restored step so the
  batch stream is bit-identical.
* **Straggler mitigation** — per-step wall times feed a rolling median; steps
  slower than ``straggler_factor ×`` median are logged and counted, and the
  hook is exposed for tests.  Where there is a card, a step's time ends
  in ``torch.cuda.synchronize()``, so it is the device's time, not the
  enqueue's.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    ckpt_every: int = 50
    ckpt_keep: int = 3
    log_every: int = 10
    straggler_factor: float = 2.0
    straggler_window: int = 32


class Trainer:
    def __init__(
        self,
        step_fn: Callable,  # (state, batch) -> (state, metrics)
        state: Any,
        batches: Iterator[dict],
        cfg: TrainerConfig,
        state_shardings=None,
        on_straggler: Callable[[int, float, float], None] | None = None,
    ):
        self.step_fn = step_fn
        self.state = state
        self.batches = batches
        self.cfg = cfg
        self.state_shardings = state_shardings
        self.on_straggler = on_straggler
        self.manager = CheckpointManager(
            cfg.ckpt_dir, keep=cfg.ckpt_keep, every_steps=cfg.ckpt_every
        )
        self.step = 0
        self.history: list[dict] = []
        self._times: list[float] = []
        self._preempted = False
        self.straggler_steps: list[int] = []

    # ------------------------------------------------------------- lifecycle
    def try_restore(self) -> bool:
        """Resume from the latest checkpoint if one exists (elastic restart)."""
        try:
            step, state = self.manager.restore(self.state, self.state_shardings)
        except FileNotFoundError:
            return False
        self.state = state
        self.step = step
        return True

    def _handle_preemption(self, signum, frame):  # pragma: no cover - signal path
        self._preempted = True

    def _watch_stragglers(self, dt: float) -> None:
        self._times.append(dt)
        window = self._times[-self.cfg.straggler_window :]
        if len(window) >= 8:
            med = float(np.median(window[:-1]))
            if dt > self.cfg.straggler_factor * med:
                self.straggler_steps.append(self.step)
                if self.on_straggler is not None:
                    self.on_straggler(self.step, dt, med)

    # ------------------------------------------------------------------ run
    def run(self) -> list[dict]:
        prev_term = signal.signal(signal.SIGTERM, self._handle_preemption)
        prev_int = signal.getsignal(signal.SIGINT)
        try:
            for batch in self.batches:
                if self.step >= self.cfg.total_steps or self._preempted:
                    break
                t0 = time.perf_counter()
                self.state, metrics = self.step_fn(self.state, batch)
                if torch.cuda.is_available():  # the step's time is the device's
                    torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                self.step += 1
                self._watch_stragglers(dt)
                if self.step % self.cfg.log_every == 0 or self.step == 1:
                    row = {k: float(v) for k, v in metrics.items()}
                    row.update(step=self.step, sec=dt)
                    self.history.append(row)
                if self.manager.should_save(self.step):
                    self.manager.save(self.step, self.state)
            # preemption or completion: always leave a resumable checkpoint
            self.manager.save(self.step, self.state)
        finally:
            signal.signal(signal.SIGTERM, prev_term)
            signal.signal(signal.SIGINT, prev_int)
        return self.history
