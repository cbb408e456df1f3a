"""Batched LM serving: continuous decode over a fixed-capacity request batch
— the port of ``repro.serve.engine``.  ``make_decode_step`` takes every
model of the port (attention KV caches, recurrent states, an
encoder-decoder's cross K/V); ``ServeSession``, as the reference's, serves
the token-input decoders.

``make_decode_step`` is one cached decode step over the whole batch:
(cache, tokens, pos) -> (logits, cache).  ``ServeSession`` wraps it with
the reference's small scheduler: requests join free slots, finished slots
free on EOS/length, every slot shares the same step (static shapes; slot
liveness is a mask, not a dynamic batch).  Each tick reads its next tokens
back to the host once (``argmax`` on the model's device, which picks the
first maximum as ``jnp.argmax`` does).

The reference compiles the step once (``jax.jit``, ``pos`` a traced array).
Its counterpart here is a CUDA graph: on the card ``make_decode_step``
returns a :class:`GraphedDecodeStep`, which captures ``model.decode_step``
once over static ``tokens`` / ``pos`` buffers (``tokens`` as it comes:
(B, 1) token ids, or (B, 1, D) embeddings for a model without a token
embedding) and the cache it is first handed, and replays it every tick —
one launch of the graph in place of the step's thousands of kernel
launches.  On the CPU the step stays eager.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.kernels import _cuda

# an attention cache's keys: a step writes its token's slot, and the same
# step again writes the same values there, so a warm-up needs no undo
KV_KEYS = ("k", "v")
# an encoder-decoder layer's cross K/V: a step only reads them
CROSS_KEYS = ("cross_k", "cross_v")


def make_prefill(model, max_len: int) -> Callable:
    def prefill(batch):
        return model.prefill(batch, max_len)

    return prefill


def make_decode_step(model) -> Callable:
    """The session's decode step: a :class:`GraphedDecodeStep` on the card,
    the model's eager ``decode_step`` on the CPU."""
    if model.device.type == "cuda":
        return GraphedDecodeStep(model)

    def decode_step(cache, tokens, pos):
        return model.decode_step(cache, tokens, pos)

    return decode_step


class GraphedDecodeStep:
    """``model.decode_step`` captured once into a ``torch.cuda.CUDAGraph``
    and replayed: the counterpart of ``jax.jit(make_decode_step(model))``.

    The first call adopts the cache it is handed as the graph's own (its
    tensors are the addresses the graph writes: an attention layer's KV
    cache, a recurrent layer's ``conv`` and ``ssm`` / ``h`` state, an
    encoder-decoder layer's ``cross_k`` / ``cross_v``), copies
    ``tokens`` and ``pos`` into static device buffers, runs the step once
    eagerly on a side stream (a warm-up: the cuBLAS handles and workspaces
    exist before the capture) and captures it.  That warm-up writes the
    token's keys and values into the KV cache at ``pos``, and the replay
    that follows writes the same values there again; a recurrent state,
    which a step advances in place, is put back as it was before the
    warm-up, so the replay starts from the state the call was handed; the
    cross K/V, which a step only reads, is neither saved nor put back.
    Every call then copies its ``tokens`` and ``pos`` into the buffers,
    replays, and returns a copy of the logits and the captured cache.

    A later call with another cache of the same layout — a session's next
    admission, whose prefill made a new cache — copies that cache into the
    captured one, key by key (a device copy, about 2.5 GB for qwen3-8b's 8
    × 2,112 slots) rather than capturing again: a capture costs an eager
    step and a capture pass on the host and holds a memory pool of its own,
    where the copy is one pass over the cache on the device.  A cache of
    other keys, shapes or dtypes raises.  A capture that fails raises (the
    step never falls back to eager).

    The graph also holds the addresses of the model's weights.  A model
    whose weights were replaced after the capture (``quantize_for_serving``
    frees each one) raises at the next call: it needs a new step.

    Kernel launch counts (``_cuda.LAUNCHES``) hold the warm-up step's
    launches only: the capture records kernels without launching them, and
    a replay launches them without their wrappers.  ``captured`` holds what
    the wrappers recorded into the graph (``_cuda.CAPTURED`` over the
    capture), which each replay launches once, and ``captured_w8_products``
    the int8 products those W8 launches take (``_cuda.W8_PRODUCTS``);
    ``replays`` counts the replays, one a call."""

    def __init__(self, model):
        self.model = model
        self.graph: torch.cuda.CUDAGraph | None = None
        self.cache: list[dict] | None = None
        # each captured weight: its module's dict, name, tensor and address
        self.weights: list[tuple[dict, str, torch.Tensor, int]] = []
        # host clock: the warm-up (synced), the capture and, of it, the
        # graph context's entry and the recording
        self.capture_seconds: dict[str, float] = {}
        self.captured: dict[str, int] = {}
        self.captured_w8_products = 0
        self.replays = 0

    def _weights_unchanged(self) -> bool:
        return all(d.get(name) is t and t.data_ptr() == ptr
                   for d, name, t, ptr in self.weights)

    def _capture(self, cache, tokens, pos) -> None:
        device = self.model.device
        t0 = time.perf_counter()
        self.cache = cache
        self.tokens = torch.as_tensor(tokens, device=device).clone()
        self.pos = torch.zeros((), dtype=torch.int64, device=device)
        self._set_pos(pos)
        # the recurrent states the warm-up advances, to put back after it
        states = [{n: t.clone() for n, t in c.items() if n not in KV_KEYS + CROSS_KEYS}
                  for c in cache]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self.model.decode_step(cache, self.tokens, self.pos)
            for c, saved in zip(cache, states):
                for n, t in saved.items():
                    c[n].copy_(t)
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        del states
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        before = dict(_cuda.CAPTURED)
        products = _cuda.W8_PRODUCTS["captured"]
        with torch.cuda.graph(graph):  # entered: synced, gc.collect(), empty_cache()
            t2 = time.perf_counter()
            self.logits, _ = self.model.decode_step(cache, self.tokens, self.pos)
            t3 = time.perf_counter()  # recorded; the capture's end instantiates the graph
        self.captured = {k: n - before[k] for k, n in _cuda.CAPTURED.items()}
        self.captured_w8_products = _cuda.W8_PRODUCTS["captured"] - products
        self.weights = [(d, name, t, t.data_ptr()) for m in self.model.modules()
                        for d in (m._parameters, m._buffers)
                        for name, t in d.items() if t is not None]
        self.graph = graph
        self.capture_seconds = {"warm_up": t1 - t0, "capture": time.perf_counter() - t1,
                                "enter": t2 - t1, "record": t3 - t2}

    def _set_pos(self, pos) -> None:
        if isinstance(pos, torch.Tensor):
            self.pos.copy_(pos)
        else:  # a fill on the device: no copy from the host
            self.pos.fill_(int(pos))

    def _adopt(self, cache) -> None:
        """Copy ``cache`` into the captured cache, key by key (the same
        layers, keys, shapes and dtypes)."""
        if len(cache) != len(self.cache) or any(
                mine.keys() != new.keys() or any(
                    mine[n].shape != new[n].shape or mine[n].dtype != new[n].dtype
                    for n in mine)
                for mine, new in zip(self.cache, cache)):
            raise ValueError("the decode step was captured over a cache of other keys, "
                             "shapes or dtypes")
        for mine, new in zip(self.cache, cache):
            for n in mine:
                if mine[n] is not new[n]:
                    mine[n].copy_(new[n])

    def __call__(self, cache, tokens, pos):
        if self.graph is None:
            self._capture(cache, tokens, pos)
        else:
            if not self._weights_unchanged():
                raise RuntimeError("the model's weights changed since the decode step was "
                                   "captured (e.g. quantize_for_serving); make a new step")
            if cache is not self.cache:
                self._adopt(cache)
            self.tokens.copy_(torch.as_tensor(tokens, device=self.tokens.device))
            self._set_pos(pos)
        self.graph.replay()
        self.replays += 1
        return self.logits.clone(), self.cache


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
