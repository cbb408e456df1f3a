"""gloo worlds of a few processes for the port's distributed tests (CPU).

``run_world(target, n, tmp_path, *args)`` spawns ``n`` processes; each
joins a gloo process group through a ``FileStore`` under ``tmp_path`` (no
TCP port: several test workers run at once), runs ``target(rank, world,
*args)`` with one intra-op thread, and leaves its return value (anything
``torch.save`` takes) in ``tmp_path``.  The parent waits at most
``timeout`` seconds for all of them, kills the rest and fails if any is
still running or failed (the child's traceback in the message), and
returns the ranks' values in rank order.

This module imports torch, numpy and the port only: the children never
load JAX.
"""

from __future__ import annotations

import multiprocessing
import os
import time
import traceback

import numpy as np
import torch


def _entry(target, rank: int, world: int, root: str, args) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        store = dist.FileStore(os.path.join(root, "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
        try:
            out = target(rank, world, *args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        torch.save(out, os.path.join(root, f"out_{rank}.pt"))
    except BaseException:
        with open(os.path.join(root, f"err_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_world(target, n: int, tmp_path, *args, timeout: float = 240.0) -> list:
    root = str(tmp_path)
    os.makedirs(root, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(target, r, n, root, args)) for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.1))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = []
    for r, p in enumerate(procs):
        err = os.path.join(root, f"err_{r}.txt")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {r}:\n{f.read()}")
    assert not hung, f"ranks {hung} still running after the timeout\n" + "\n".join(errors)
    assert all(p.exitcode == 0 for p in procs), (
        f"exit codes {[p.exitcode for p in procs]}\n" + "\n".join(errors))
    return [torch.load(os.path.join(root, f"out_{r}.pt"), weights_only=False)
            for r in range(n)]


# ------------------------------------------------------------ collectives
def collective_inputs(seed: int, world: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-rank gradients and residuals ``(world, 8, 32)`` on a 2^-10 grid
    (every float32 sum of them is exact)."""
    rng = np.random.default_rng(seed)
    g = np.round(rng.normal(0, 1, (world, 8, 32)) * 1024) / 1024
    r = np.round(rng.normal(0, 0.01, (world, 8, 32)) * 1024) / 1024
    return g.astype(np.float32), r.astype(np.float32)


def collectives_world(rank: int, world: int, seed: int) -> dict:
    import torch.distributed as dist

    from repro_torch.distributed import collectives as C

    g, r = collective_inputs(seed, world)
    x, res = torch.from_numpy(g[rank]), torch.from_numpy(r[rank])
    out = {"none": C.tree_psum_compressed({"a": x.clone()}, None, None, "none")[0]["a"],
           "bf16": C.psum_bf16(x),
           "int8": C.psum_int8_ef(x, res)}
    tree = {"a": x.clone(), "b": {"c": 2 * x.clone()}}
    out["tree_bf16"] = C.tree_psum_compressed(tree, None, dist.group.WORLD, "bf16")[0]
    out["tree_int8"] = C.tree_psum_compressed(
        tree, {"a": res, "b": {"c": res}}, None, "int8_ef")
    return out


# ---------------------------------------------------------- sharded train
def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _gathered(state) -> dict:
    """Every leaf's full tensor (a collective: every rank calls it)."""
    if isinstance(state, dict):
        return {k: _gathered(v) for k, v in state.items()}
    return state.full_tensor().detach().clone()


def local_shape_errors(state, mesh) -> tuple[list, int]:
    """Leaves whose local shape is not the global shape cut by the spec's
    axis sizes, and how many leaves are split at all."""
    from repro_torch.distributed.partitioning import mesh_axis_rules, mesh_shape
    from repro_torch.train.step import train_state_specs

    sizes = mesh_shape(mesh)
    with mesh_axis_rules(mesh):
        specs = train_state_specs({k: v.shape for k, v in state["params"].items()})
    bad, split = [], 0
    trees = [("params", state["params"], specs["params"]),
             ("mu", state["opt"]["mu"], specs["opt"]["mu"]),
             ("nu", state["opt"]["nu"], specs["opt"]["nu"])]
    for part, tree, spec_tree in trees:
        for k, leaf in tree.items():
            want = []
            for n, entry in zip(leaf.shape, tuple(spec_tree[k]) + (None,) * leaf.dim()):
                axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
                parts = int(np.prod([sizes[a] for a in axes])) if axes else 1
                want.append(n // parts)
            got = tuple(leaf.to_local().shape)
            if got != tuple(want):
                bad.append((part, k, got, tuple(want)))
            split += got != tuple(leaf.shape)
    return bad, split


SHARDED_CASES = (("2x2", (2, 2), 1, None), ("4x1", (4, 1), 1, None), ("1x4", (1, 4), 1, None),
                 ("2x2_accum2", (2, 2), 2, None), ("1x4_bf16", (1, 4), 1, "bfloat16"),
                 ("2x2_bf16", (2, 2), 1, "bfloat16"))


def sharded_train_world(rank: int, world: int, root: str, opt_kw: dict) -> dict:
    """The sharded step on the qwen3-8b smoke (float32) at each of
    ``SHARDED_CASES`` from the state and batch the parent saved, the local
    shapes, a checkpoint at (2, 2) restored at (4, 1), the refusals, GPipe,
    and the launcher at ``--model-axis 2`` with a restart."""
    import contextlib
    import dataclasses
    import io

    from repro_torch.ckpt import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch import train as launcher
    from repro_torch.launch.mesh import host_device_mesh, make_mesh
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig
    from repro_torch.train.sharded import (
        make_sharded_train_step,
        shard_train_state,
        train_state_shardings,
    )

    saved = torch.load(os.path.join(root, "inputs.pt"))
    state0, batch = saved["state"], saved["batch"]
    cfg = dataclasses.replace(get_smoke_config("qwen3-8b"), compute_dtype="float32")
    model = build_model(cfg, device="cpu", seed=None, param_dtype="float32")
    opt = AdamWConfig(**opt_kw)
    out: dict = {"steps": {}}
    ckpt = os.path.join(root, "elastic")
    for name, shape, accum, grad_dtype in SHARDED_CASES:
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        state = shard_train_state(_clone(state0), mesh)
        bad_before, split = local_shape_errors(state, mesh)
        step = make_sharded_train_step(model, opt, mesh, grad_accum=accum,
                                       grad_dtype=grad_dtype)
        state, metrics = step(state, batch)
        bad_after, _ = local_shape_errors(state, mesh)
        full = _gathered(state)
        out["steps"][name] = {"metrics": {k: float(v) for k, v in metrics.items()},
                              "bad_shapes": bad_before + bad_after, "split": split,
                              "state": full if rank == 0 else None}
        if name == "2x2":
            save_checkpoint(ckpt, 1, state)
            saved_full = full

    # the elastic restore: written at (2, 2), read at (4, 1)
    mesh = make_mesh((4, 1), ("data", "model"), "cpu")
    like = shard_train_state(_clone(state0), mesh)
    at, restored = restore_checkpoint(ckpt, like,
                                      shardings=train_state_shardings(mesh, state0["params"]))
    back = _gathered(restored)
    unequal = [(part, k) for part, a, b in (
        ("params", back["params"], saved_full["params"]),
        ("mu", back["opt"]["mu"], saved_full["opt"]["mu"]),
        ("nu", back["opt"]["nu"], saved_full["opt"]["nu"]))
        for k in a if not torch.equal(a[k], b[k])]
    bad, _ = local_shape_errors(restored, mesh)
    _, m = make_sharded_train_step(model, opt, mesh)(restored, batch)
    out["elastic"] = {"step": at, "unequal": unequal, "bad_shapes": bad,
                      "leaves": 3 * len(back["params"]), "loss": float(m["loss"]),
                      "count": int(back["opt"]["step"]),
                      "placements": str(restored["opt"]["mu"]["final_norm.scale"].placements)}

    # refusals
    refusals = {}
    try:
        host_device_mesh(3, "cpu")
    except ValueError as e:
        refusals["model_axis"] = str(e)
    moe_cfg = get_smoke_config("qwen3-moe-235b-a22b")
    moe = build_model(moe_cfg, device="cpu", seed=0, param_dtype="float32")
    try:
        make_sharded_train_step(moe, opt, make_mesh((2, 2), ("data", "model"), "cpu"))
    except ValueError as e:
        refusals["moe"] = str(e)
    make_sharded_train_step(moe, opt, make_mesh((1, 4), ("data", "model"), "cpu"))
    refusals["moe_one_data_rank"] = "accepted"
    out["refusals"] = refusals

    # GPipe: 4 stages, 8 microbatches, beside the sequential stack
    rng = np.random.default_rng(0)
    d, micro = 16, 8
    ws = torch.from_numpy(rng.normal(0, 0.3, (4, d, d)).astype(np.float32))
    x = torch.from_numpy(rng.normal(0, 1, (micro * 4, d)).astype(np.float32))
    pp = pipeline_apply(lambda w, h: torch.relu(h @ w), make_mesh((4, 1), ("pod", "data"), "cpu"),
                        n_microbatches=micro, axis="pod")
    ref = x
    for i in range(4):
        ref = torch.relu(ref @ ws[i])
    out["gpipe"] = {"y": pp(ws, x), "ref": ref}

    # the launcher in this world: 3 steps, then resumed to 5
    args = ["--arch", "qwen3-8b", "--smoke", "--device", "cpu", "--model-axis", "2",
            "--batch", "4", "--seq", "32", "--samples", "32",
            "--ckpt-dir", os.path.join(root, "launch"), "--ckpt-every", "2"]
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        first = launcher.main(args + ["--steps", "3"])
        second = launcher.main(args + ["--steps", "5"])
    try:
        launcher.main(["--arch", "qwen3-moe-235b-a22b", "--smoke", "--device", "cpu",
                       "--model-axis", "2", "--batch", "4", "--seq", "32", "--samples", "32",
                       "--ckpt-dir", os.path.join(root, "launch_moe")])
    except ValueError as e:
        refusals["launcher_moe"] = str(e)
    out["launcher"] = {"first": first, "second": second, "stdout": text.getvalue()}
    return out
