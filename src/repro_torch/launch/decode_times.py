"""Time one decode step and the serving ticks of ``chip_smoke.py``'s serve
cells on one NVIDIA GPU, so that two checkouts of the port can be held
against each other the same way:

* ``tick_ms_median``: the median decode tick of the cell's serving run, on
  the host clock and synced (``chip_smoke.py``'s ``decode_tick_ms_median``:
  ``ServeSession`` for the token decoders, ``chip_smoke.drive`` for the VLM
  and the encoder-decoder; every tick a CUDA graph's replay);
* ``replayed_ms``: one decode step of the first admission replayed from a
  CUDA graph, the median of five means of 50 replays between CUDA events
  (``chip_smoke.profile_step``, as its ``decode_replayed`` profile);
* ``eager_ms``: the same for the eager ``decode_step`` (five means of 10);
* ``replayed_busy_ms``, ``replayed_launches``, ``eager_launches``: the
  device time and the kernels of one profiled step;
* ``logits_sha256``: the first 16 hex digits of the SHA-256 of the first
  replayed step's logits (two runs of one checkout must agree).

The cells (``--cells``, default all): ``bf16`` and ``int8`` (qwen3-8b, the
second quantized in place by ``quantize_for_serving``), ``moe``
(qwen3-moe-235b-a22b, 12 of 94 layers), ``hybrid`` (recurrentgemma-9b),
``vlm`` (qwen2-vl-72b, 32 of 80 layers) and ``encdec``
(seamless-m4t-medium), with ``chip_smoke.py``'s slots, cache length,
prompts and weights drawn from ``--seed``.

    python3 src/repro_torch/launch/decode_times.py [--src DIR] [--cells NAME,...]
        [--seed S] [--tag T]

``--src`` puts another checkout's ``src`` directory first on the path (the
cells and helpers come from ``chip_smoke.py`` of the checkout holding this
script).  Prints one JSON line per cell.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import hashlib
import json
import statistics
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[3]
CELLS = ("bf16", "int8", "moe", "hybrid", "vlm", "encdec")


def digest(t) -> str:
    """The first 16 hex digits of the SHA-256 of ``t``'s bytes."""
    import torch

    raw = t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


def step_times(torch, CS, model, cache, x, pos) -> dict:
    """One decode step at ``(x, pos)`` on ``cache``, replayed and eager."""
    from repro_torch.serve.engine import make_decode_step

    step = make_decode_step(model)
    logits, _ = step(cache, x, pos)
    sha = digest(logits)
    replayed = CS.profile_step(torch, lambda: step(cache, x, pos), replays=50)
    eager = CS.profile_step(torch, lambda: model.decode_step(cache, x, pos), replays=10)
    del step
    return {"replayed_ms": replayed["replayed_ms"], "replayed_ms_runs": replayed["replayed_ms_runs"],
            "replayed_busy_ms": replayed["device_busy_ms"],
            "replayed_launches": replayed["kernel_launches"],
            "eager_ms": eager["replayed_ms"], "eager_ms_runs": eager["replayed_ms_runs"],
            "eager_launches": eager["kernel_launches"], "logits_sha256": sha}


def token_cell(torch, CS, model, cfg, seed: int) -> dict:
    """A token decoder's serving run and one step of its first admission."""
    prompts = CS.lm_prompts(np.random.default_rng(seed + 11), CS.LM_REQUESTS,
                            *CS.LM_PROMPT, cfg.vocab)
    _, _, decodes, step, _ = CS.serve_session(torch, model, prompts, CS.LM_SLOTS,
                                              CS.LM_MAX_LEN, CS.LM_MAX_NEW, True)
    ticks = [1e3 * t for t, _ in decodes]
    del step, decodes
    toks = CS.first_admission(torch, prompts, model.device)
    _, cache = model.prefill({"tokens": toks}, CS.LM_MAX_LEN)
    return {"tick_ms_median": statistics.median(ticks), "ticks": len(ticks),
            **step_times(torch, CS, model, cache, toks[:, -1:].contiguous(), toks.shape[1])}


def input_cell(torch, CS, model, cfg, seed: int) -> dict:
    """The VLM's or the encoder-decoder's two admissions through
    ``chip_smoke.drive`` and one step of the first admission."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    dt = model.compute_dtype
    adm = CS.input_admissions(
        torch, cfg, CS.VLM_PROMPTS, CS.LM_SLOTS, CS.LM_MAX_NEW, CS.ENCDEC_FRAMES,
        lambda shape: torch.randn(shape, generator=gen, device="cuda").mul_(0.5).to(dt),
        lambda shape: torch.randint(0, cfg.vocab, shape, generator=gen, device="cuda"),
        CS.VLM_PREFIX, CS.VLM_GRID)
    _, _, decodes, step = CS.drive(torch, model, adm, CS.LM_MAX_LEN, CS.LM_MAX_NEW, True)
    ticks = [1e3 * t for t, _ in decodes]
    del step, decodes
    batch, step_inputs = adm[0]
    s = (batch["embeds"] if "embeds" in batch else batch["tokens"]).shape[1]
    logits, cache = model.prefill(batch, CS.LM_MAX_LEN)
    x = logits.argmax(-1)[:, None] if step_inputs is None else step_inputs[0]
    return {"tick_ms_median": statistics.median(ticks), "ticks": len(ticks),
            **step_times(torch, CS, model, cache, x, s)}


def run_cells(torch, CS, wanted: set, seed: int):
    """Yield ``(cell, arch, layers, line)`` for each wanted cell."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.layers import quantize_for_serving

    def model_of(arch, n_layers=None):
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=n_layers) if n_layers else full
        gc.collect()
        torch.cuda.empty_cache()
        return build_model(cfg, seed=seed), cfg  # on the card

    if wanted & {"bf16", "int8"}:
        model, cfg = model_of(CS.LM_ARCH)
        if "bf16" in wanted:
            yield "bf16", cfg, token_cell(torch, CS, model, cfg, seed)
        if "int8" in wanted:
            quantize_for_serving(model)
            yield "int8", cfg, token_cell(torch, CS, model, cfg, seed)
        del model
    for cell, arch, layers, run in (("moe", CS.MOE_ARCH, CS.MOE_LAYERS, token_cell),
                                    ("hybrid", CS.HYBRID_ARCH, None, token_cell),
                                    ("vlm", CS.VLM_ARCH, CS.VLM_LAYERS, input_cell),
                                    ("encdec", CS.ENCDEC_ARCH, None, input_cell)):
        if cell in wanted:
            model, cfg = model_of(arch, layers)
            yield cell, cfg, run(torch, CS, model, cfg, seed)
            del model


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    wanted = set(c for c in args.cells.split(",") if c)
    if not wanted <= set(CELLS):
        ap.error(f"--cells: unknown {sorted(wanted - set(CELLS))}; the cells are {CELLS}")
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS

    import repro_torch
    from repro_torch.kernels import _cuda

    _cuda.load()
    for cell, cfg, line in run_cells(torch, CS, wanted, args.seed):
        print(json.dumps({"cell": cell, "arch": cfg.name, "layers": cfg.n_layers,
                          "tag": args.tag, "package": str(Path(repro_torch.__file__).parent),
                          "device": torch.cuda.get_device_name(0), **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
