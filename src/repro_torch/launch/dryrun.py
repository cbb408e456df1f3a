"""Multi-pod dry run: count every (arch × shape × mesh) cell on ``meta`` —
the port of ``repro.launch.dryrun``.

The reference lowers and compiles each cell's jitted step for 512
placeholder host devices and reads its HLO.  Here each cell runs as rank 0
of a fake process group of 256 or 512 ranks
(``launch.mesh.make_production_mesh``: every collective returns at once),
on ``meta`` tensors (nothing is allocated or computed), under
``roofline.analysis.count_step``, which counts every operation, every
hand-written kernel's reported work and every collective as they go:

  1. builds the model on ``meta`` and the cell's stand-ins by the specs
     (``launch.specs``), cut to this rank's part;
  2. runs one step under the mesh's axis rules: the port's sharded train
     step (train: ``train.sharded.make_sharded_train_step``, the state as
     DTensors on the fake mesh), ``prefill`` (prefill), or the
     ``quantize_for_serving`` model's ``decode_step`` on a cache cut by
     ``specs.shard_cache`` (decode: decode-SP, and the MoE block's
     expert-parallel forms for the MoE configs);
  3. writes a JSON cell report: the counts, the three roofline terms at the
     H100's figures (``roofline.analysis.HW``), the rank's argument bytes.

Where the reference leaves placement to GSPMD, the port computes whole on
each rank for its batch rows (the non-MoE products, the cross caches, the
recurrent states, the whole parameters gathered once a step), and the
counts say exactly that.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --keep-going --out build/dryrun
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ARCH_NAMES, SHAPES, cell_status, get_config
from repro_torch.distributed.partitioning import mesh_axis_rules, mesh_shape, rules_for_mesh
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.roofline.analysis import analyze_step, count_step, tree_bytes
from repro_torch.train import AdamWConfig
from repro_torch.train.sharded import make_sharded_train_step, shard_train_state


def model_flops_estimate(cfg, sh) -> float:
    """6·N·D model FLOPs (dense) / 6·N_active·D (MoE); decode: D=batch·1."""
    n = cfg.active_param_count()
    if sh.kind == "train":
        return 6.0 * n * sh.tokens
    if sh.kind == "prefill":
        return 2.0 * n * sh.tokens
    return 2.0 * n * sh.global_batch  # decode: one token per sequence


def grad_accum_for(cfg, sh, sizes: dict) -> int:
    """The reference's cap: a microbatch must still divide the batch
    shards, or its batch dim silently de-shards (replicates!) on the wider
    mesh — cap grad-accum so each microbatch keeps ≥1 sample per batch
    shard."""
    batch_shards = 1
    for name in ("pod", "data"):
        batch_shards *= sizes.get(name, 1)
    return max(min(cfg.grad_accum, sh.global_batch // batch_shards), 1)


def count_on_mesh(cfg, sh, mesh, grad_accum: int | None = None):
    """One step of config ``cfg`` at shape ``sh`` on this rank of ``mesh``,
    counted on ``meta``: ``(counts, state_bytes, batch_bytes)`` — the
    rank's argument bytes by the specs.  ``grad_accum`` defaults to
    :func:`grad_accum_for`'s cap."""
    if sh.kind == "train":
        model = build_model(cfg, device="meta", seed=None, param_dtype=cfg.param_dtype)
        state = shard_train_state(S.train_state_shapes(model, cfg), mesh)
        batch = S.train_batch_shapes(cfg, sh)
        accum = grad_accum or grad_accum_for(cfg, sh, mesh_shape(mesh))
        step = make_sharded_train_step(model, AdamWConfig(), mesh, grad_accum=accum)
        _, counts = count_step(step, state, batch)
        return counts, tree_bytes(state), tree_bytes(S.shard_inputs(mesh, batch))
    model = build_model(cfg, device="meta", seed=None)
    if sh.kind == "prefill":
        batch = S.shard_inputs(mesh, S.prefill_batch_shapes(cfg, sh))
        with mesh_axis_rules(mesh):
            _, counts = count_step(model.prefill, batch, sh.seq_len)
        return counts, tree_bytes(model.state_dict()), tree_bytes(batch)
    # decode: int8 serving weights, whole on every rank
    from repro_torch.models.layers import quantize_for_serving

    quantize_for_serving(model)
    cache = S.shard_cache(mesh, S.cache_shapes(model, cfg, sh))
    tokens = S.shard_inputs(mesh, {"tokens": S.decode_token_shapes(cfg, sh)})["tokens"]
    with mesh_axis_rules(mesh):
        _, counts = count_step(model.decode_step, cache, tokens, S.sds((), torch.int32))
    return counts, tree_bytes(model.state_dict()) + tree_bytes(cache), tree_bytes(tokens)


def count_cell(arch: str, shape: str, multi_pod: bool):
    """One cell's step on rank 0 of the production mesh, counted:
    ``(counts, mesh, cfg, sh, state_bytes, batch_bytes)``."""
    cfg = get_config(arch)
    sh = SHAPES[shape]
    mesh = make_production_mesh(multi_pod=multi_pod)
    counts, state_bytes, batch_bytes = count_on_mesh(cfg, sh, mesh)
    return counts, mesh, cfg, sh, state_bytes, batch_bytes


def run_cell(arch: str, shape: str, multi_pod: bool, verbose: bool = True) -> dict:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    status = cell_status(arch, shape)
    if status != "run":
        return {
            "arch": arch, "shape": shape, "mesh": mesh_name, "status": status,
        }
    t0 = time.time()
    counts, mesh, cfg, sh, state_bytes, batch_bytes = count_cell(arch, shape, multi_pod)
    dt = time.time() - t0
    result = analyze_step(
        counts, arch=arch, shape=shape, mesh_name=mesh_name,
        n_devices=mesh.size(), model_flops=model_flops_estimate(cfg, sh),
        state_bytes=state_bytes, batch_bytes=batch_bytes,
    )
    out = dataclasses.asdict(result)
    summary = result.summary()
    out["terms"] = {k: summary[k] for k in ("compute", "memory", "collective")}
    out["dominant"] = summary["dominant"]
    out["useful_flops_ratio"] = summary["useful_flops_ratio"]
    out["roofline_fraction"] = summary["roofline_fraction"]
    out["step_time_lower_bound_s"] = summary["step_time_lower_bound_s"]
    out["count_seconds"] = dt
    out["aten_calls"] = counts["aten_calls"]
    out["rules"] = {k: list(v) for k, v in rules_for_mesh(mesh).items()}
    if verbose:
        t = result.terms()
        print(
            f"[{mesh_name}] {arch} × {shape}: counted in {dt:.1f}s  "
            f"compute {t['compute']*1e3:.2f}ms  memory {t['memory']*1e3:.2f}ms  "
            f"collective {t['collective']*1e3:.2f}ms  "
            f"dominant={max(t, key=t.get)}  "
            f"args/device={out['memory']['argument_bytes']/2**30:.2f}GiB"
        )
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--keep-going", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_NAMES if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            for multi_pod in meshes:
                mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
                fname = os.path.join(
                    args.out, f"{arch}__{shape}__{mesh_name}.json"
                )
                try:
                    out = run_cell(arch, shape, multi_pod)
                except Exception as e:  # noqa: BLE001
                    traceback.print_exc()
                    failures.append((arch, shape, mesh_name, str(e)))
                    if not args.keep_going:
                        raise
                    continue
                with open(fname, "w") as f:
                    json.dump(out, f, indent=1, default=str)
    if failures:
        print(f"\n{len(failures)} FAILED CELLS:")
        for f4 in failures:
            print("  ", *f4[:3], "->", f4[3][:200])
        raise SystemExit(1)
    print("\nDRY-RUN COMPLETE: all requested cells counted.")


if __name__ == "__main__":
    main()
