"""The training driver: a dense decoder trained on the card through the
port's own path — a ``RecordStore`` holding the corpus, ``TrainPipeline``
packing each batch with the projection kernel, the step ``make_train_step``
builds (gradients summed over microbatches in float32, AdamW in place).

Set-up makes the corpus and the weights from ``--seed`` (``inputs``), builds
one step object and drives it through the mix's first ``check_steps`` steps
— the window's own call and feed, on rows that all differ — keeping their
batches, their losses, each leaf's gradient norm as the optimizer got it
(from its first moment after step 1) and each leaf's distance from the start
after the last of them.  The window then goes on with the same object,
syncing once a step as the port's ``Trainer`` does, until ``--seconds`` have
passed.

``correct``: once the window has closed and the program's state is freed,
``reference.decoder`` trains the same weights on the same rows of the
corpus for ``check_steps`` steps, and the checks hold the program to it (and
every window loss finite).

The traced run adds CUDA events around the update in every window step, then
``profile_steps`` more steps under ``torch.profiler``.
"""

from __future__ import annotations

import dataclasses
import gc
import statistics
import time

import torch

from rmbench import inputs
from rmbench.reference import decoder
from rmbench.result import Check, Outcome, rate
from rmbench.trace import profiled, record

GRAD_FLOOR = 1e-3  # leaves whose reference gradient is under this share of the median leaf's


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def port_config(m: dict, microbatches: int):
    """The port's config for the file's widths (``port_arch``'s other
    settings kept)."""
    from repro_torch.configs import get_config

    base = get_config(m["port_arch"])
    cfg = dataclasses.replace(
        base, n_layers=m["num_hidden_layers"], d_model=m["hidden_size"],
        n_heads=m["num_attention_heads"], n_kv_heads=m["num_key_value_heads"],
        head_dim=m["head_dim"], d_ff=m["intermediate_size"], vocab=m["vocab_size"],
        rope_theta=float(m["rope_theta"]), qk_norm=True, qkv_bias=m["attention_bias"],
        compute_dtype=m["compute_dtype"], param_dtype=m["param_dtype"],
        grad_accum=microbatches)
    if cfg.padded_vocab != m["vocab_size"] or m["tie_word_embeddings"]:
        raise ValueError("the vocabulary must be padded already and the head untied")
    return cfg


def _timed_update(real, times: list):
    def update(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args)
        end.record()
        times.append((start, end))
        return out
    return update


def setup(cell, seed: int, device) -> dict:
    """Make the inputs, build the step object and drive it through the first
    ``check_steps`` steps: ``{"state", "step_fn", "batches", "first": the
    program's readings, "phases": set-up's seconds, "tokens", "labels",
    "leaves"}``."""
    from repro_torch.data import RecordStore, TrainPipeline
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.step import init_train_state

    m, mix = cell.config, cell.mix
    seq, micro = mix["seq"], mix["microbatches"]
    cfg = port_config(m, micro)
    phases, t0 = {}, time.perf_counter()
    tokens, labels = inputs.corpus(mix["samples"], seq, m["vocab_size"], seed)
    store = RecordStore(seq_len=seq, device=device)
    store.ingest(tokens, labels)
    store.engine.device_words(store.table)
    phases["store_s"] = time.perf_counter() - t0
    model = build_model(cfg, device=device, seed=None, param_dtype=cfg.param_dtype)
    params = dict(model.state_dict(keep_vars=True))
    leaves = inputs.decoder_leaves(m)
    got = {k: tuple(v.shape) for k, v in params.items()}
    if got != {name: shape for name, shape, _ in leaves}:
        raise ValueError(f"the model's weights are not the configuration's: {sorted(got)}")
    inputs.fill_weights(leaves, seed, params)
    del params
    state = init_train_state(model)
    step_fn = make_train_step(model, AdamWConfig(**m["optimizer"]), grad_accum=micro)
    batches = TrainPipeline(store, batch_size=mix["batch"], seed=mix["pipeline_seed"]).batches()
    _sync(device)
    phases["model_s"] = time.perf_counter() - t0 - phases["store_s"]

    first, losses, grad_norms = [], [], {}
    for i in range(mix["check_steps"]):
        b = next(batches)
        first.append({k: v.clone() for k, v in b.items()})
        state, metrics = step_fn(state, b)
        _sync(device)
        losses.append(float(metrics["loss"]))
        phases[f"step{i + 1}_s"] = time.perf_counter() - t0 - sum(phases.values())
        if i == 0:
            grad_norms = {k: float(torch.linalg.vector_norm(t, dtype=torch.float64))
                          / (1 - m["optimizer"]["beta1"]) for k, t in state["opt"]["mu"].items()}
    change = inputs.distance_from_start(leaves, seed, state["params"])
    _sync(device)
    phases["distance_s"] = time.perf_counter() - t0 - sum(phases.values())
    return {"phases": phases, "state": state, "step_fn": step_fn, "batches": batches,
            "tokens": tokens, "labels": labels, "leaves": leaves,
            "first": {"batches": first, "losses": losses, "grad_norms": grad_norms,
                      "change": change}}


def first_steps(cell, seed: int, device) -> tuple:
    """The program's readings of the first steps, its state freed:
    ``(readings, tokens, labels, leaves)``."""
    s = setup(cell, seed, device)
    return s["first"], s["tokens"], s["labels"], s["leaves"]


def run(cell, seed: int, seconds: float, trace: bool, device, clock) -> Outcome:
    from repro_torch.train import step as step_module

    m, mix = cell.config, cell.mix
    start_s = clock.now()
    s = setup(cell, seed, device)
    s["phases"] = {**clock.marks, "start_s": start_s, **s["phases"]}
    state, step_fn, batches = s["state"], s["step_fn"], s["batches"]
    gc.collect()
    setup_s = clock.now()

    layer: dict = {"config": m, "mix": mix, "trace": None, "device": device.type}
    updates: list = []
    real_update = step_module.adamw_update
    if trace and device.type == "cuda":
        step_module.adamw_update = _timed_update(real_update, updates)
    window_losses, steps = [], 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)  # the window's peak, not set-up's
    start = time.perf_counter()
    try:
        while True:
            with record("step"):
                state, metrics = step_fn(state, next(batches))
                _sync(device)
            window_losses.append(metrics["loss"])
            steps += 1
            if time.perf_counter() - start >= seconds:
                break
        end = time.perf_counter()
    finally:
        step_module.adamw_update = real_update
    e2e = {"train_tokens_per_s": rate(steps * mix["batch"] * mix["seq"], end - start),
           "setup_s": setup_s}
    if trace:
        if updates:
            layer["update_ms"] = statistics.fmean(a.elapsed_time(b) for a, b in updates)
        layer["window"] = {"steps": steps, "seconds": end - start}
        with profiled(device) as prof:
            for _ in range(mix["profile_steps"]):
                with record("step"):
                    state, metrics = step_fn(state, next(batches))
                    _sync(device)
                window_losses.append(metrics["loss"])
        layer["trace"] = prof.trace
        layer["profile_steps"] = mix["profile_steps"]
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    nonfinite = int((~torch.isfinite(torch.stack(window_losses))).sum())
    attempted = len(window_losses)
    first, tokens, labels, leaves = s["first"], s["tokens"], s["labels"], s["leaves"]
    phases = s["phases"]

    del s, state, step_fn, batches, metrics, window_losses
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = reference_run(m, mix, leaves, seed, tokens, labels, device)
    checks = judge(m, first, ref, nonfinite)
    layer["timings"] = {"setup_s": setup_s, **phases, "window_s": end - start,
                        "steps": steps, "reference_s": time.perf_counter() - t0}
    return Outcome(e2e, layer, checks, attempted, nonfinite, peak)


def reference_batches(mix, tokens, labels, device, rows: float = 1.0) -> list:
    """The first ``check_steps`` batches as the pipeline's shuffle picks
    them from the corpus (``rows``: the share of each batch's rows kept)."""
    out = []
    for step in range(mix["check_steps"]):
        pick = inputs.batch_rows(len(tokens), mix["batch"], step, mix["pipeline_seed"])
        pick = pick[:int(len(pick) * rows)]
        out.append((torch.from_numpy(tokens[pick]).to(device),
                    torch.from_numpy(labels[pick]).to(device)))
    return out


def reference_run(m, mix, leaves, seed, tokens, labels, device, matmul: str = "float32",
                  rows: float = 1.0) -> dict:
    """The plain reference over the same weights and rows: per-step losses,
    the first step's per-leaf gradient norms, each leaf's distance from the
    start after the last step, and the batches it read."""
    params = {name: torch.empty(shape, dtype=torch.float32, device=device)
              for name, shape, _ in leaves}
    inputs.fill_weights(leaves, seed, params)
    batches = reference_batches(mix, tokens, labels, device, rows)
    micro = mix["microbatches"] if rows == 1.0 else max(1, int(mix["microbatches"] * rows))
    out = decoder.train(m, m["optimizer"], params, batches, micro, matmul)
    out["change"] = inputs.distance_from_start(leaves, seed, params)
    out["batches"] = [{"tokens": tk, "labels": lb} for tk, lb in batches]
    del params
    return out


def _worst_leaf(prog: dict, ref: dict, names) -> float:
    """The widest gap of two per-leaf norms over the reference's norm of the
    leaf or of the median leaf, whichever is larger."""
    med = statistics.median(ref[k] for k in names)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in names)


def gaps(prog: dict, ref: dict) -> dict[str, float]:
    """The numbers compared: mismatched batch ids, the widest per-step loss
    gap (over the reference's loss), the worst leaf's gradient-norm gap and
    the worst leaf's change gap (leaves whose reference gradient is under
    ``GRAD_FLOOR`` of the median leaf's left out: they move by round-off)."""
    bad = 0
    for got, want in zip(prog["batches"], ref["batches"]):
        for k in ("tokens", "labels"):
            a, b = got[k], want[k].to(got[k].device)
            bad += (a.numel() + b.numel()) if a.shape != b.shape else int((a != b).sum())
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    names = sorted(ref["grad_norms"])
    med = statistics.median(ref["grad_norms"][k] for k in names)
    moved = [k for k in names if ref["grad_norms"][k] >= GRAD_FLOOR * med]
    return {"batch_mismatch": float(bad), "loss_gap": loss,
            "grad_gap": _worst_leaf(prog["grad_norms"], ref["grad_norms"], names),
            "change_gap": _worst_leaf(prog["change"], ref["change"], moved)}


def judge(m, prog: dict, ref: dict, nonfinite: int) -> list[Check]:
    limits = m["limits"]
    out = [Check(k, v, limits[k]) for k, v in gaps(prog, ref).items() if k in limits]
    out.append(Check("nonfinite_loss", float(nonfinite), 0.0))
    return out
