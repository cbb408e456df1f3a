"""Batched LM serving: continuous decode over a fixed-capacity request batch
— the port of ``repro.serve.engine``.

``make_decode_step`` is one cached decode step over the whole batch:
(cache, tokens, pos) -> (logits, cache).  ``ServeSession`` wraps it with
the reference's small scheduler: requests join free slots, finished slots
free on EOS/length, every slot shares the same step (static shapes; slot
liveness is a mask, not a dynamic batch).  PyTorch runs eagerly, so the
reference's ``jax.jit`` has no counterpart here; each tick reads its next
tokens back to the host once (``argmax`` on the model's device, which
picks the first maximum as ``jnp.argmax`` does).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


def make_prefill(model, max_len: int) -> Callable:
    def prefill(batch):
        return model.prefill(batch, max_len)

    return prefill


def make_decode_step(model) -> Callable:
    def decode_step(cache, tokens, pos):
        return model.decode_step(cache, tokens, pos)

    return decode_step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeSession:
    """Greedy continuous-batching session over one model + cache capacity.

    Synchronous, as the reference's: one decode step per ``tick``.  The
    model holds its weights (the reference passes them beside it) and
    decides the device: the session's cache and tokens live where the
    model does — the card, unless the model was built on the CPU.
    """

    def __init__(self, model, batch_slots: int, max_len: int, eos_id: int = -1):
        self.model = model
        self.device = model.device
        self.slots = batch_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.prefill_fn = make_prefill(model, max_len)
        self.decode_fn = make_decode_step(model)
        self.cache = model.init_cache(batch_slots, max_len)
        self.live: dict[int, Request] = {}  # slot -> request
        self.pos = 0
        self.queue: list[Request] = []

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _next_tokens(self, logits: torch.Tensor) -> np.ndarray:
        return logits.argmax(-1).cpu().numpy()

    def _admit(self) -> None:
        """Admit queued requests into free slots (same-length prompt batch):
        every slot is prefilled, empty ones as zeros, and all share ``pos``."""
        free = [s for s in range(self.slots) if s not in self.live]
        admit = self.queue[: len(free)]
        if not admit:
            return
        del self.queue[: len(admit)]
        s_len = max(len(r.prompt) for r in admit)
        toks = np.zeros((self.slots, s_len), np.int32)
        for slot, r in zip(free, admit):
            toks[slot, -len(r.prompt):] = r.prompt
            self.live[slot] = r
        logits, self.cache = self.prefill_fn(
            {"tokens": torch.from_numpy(toks).to(self.device)})
        self.pos = s_len
        nxt = self._next_tokens(logits)
        for slot, r in zip(free, admit):
            r.out.append(int(nxt[slot]))

    def tick(self) -> bool:
        """One decode step for every live slot; returns False when idle."""
        if not self.live and self.queue:
            self._admit()
        if not self.live:
            return False
        toks = np.zeros((self.slots, 1), np.int32)
        for slot, r in self.live.items():
            toks[slot, 0] = r.out[-1] if r.out else 0
        logits, self.cache = self.decode_fn(
            self.cache, torch.from_numpy(toks).to(self.device), self.pos)
        self.pos += 1
        nxt = self._next_tokens(logits)
        for slot in list(self.live):
            r = self.live[slot]
            tok = int(nxt[slot])
            r.out.append(tok)
            if tok == self.eos_id or len(r.out) >= r.max_new or (
                self.pos >= self.max_len - 1
            ):
                r.done = True
                del self.live[slot]
        return True

    def run_to_completion(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if not self.tick() and not self.queue:
                break
