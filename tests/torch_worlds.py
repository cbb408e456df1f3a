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
    shapes, a checkpoint at (2, 2) restored at (4, 1), the refusal, GPipe,
    and the launcher at ``--model-axis 2`` with a restart, and on the MoE
    smoke for one step."""
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
    with contextlib.redirect_stdout(io.StringIO()):
        moe_run = launcher.main(["--arch", "qwen3-moe-235b-a22b", "--smoke", "--device", "cpu",
                                 "--model-axis", "2", "--batch", "4", "--seq", "32",
                                 "--samples", "32", "--steps", "1",
                                 "--ckpt-dir", os.path.join(root, "launch_moe")])
    out["launcher"] = {"first": first, "second": second, "stdout": text.getvalue(),
                       "moe": moe_run}
    return out


# -------------------------------------------------------------- decode-SP
SP_MESHES = ((2, 2), (1, 4))


def _changed_slots(before: torch.Tensor, after: torch.Tensor) -> list[int]:
    return (after != before).any(dim=3).any(dim=1).any(dim=0).nonzero().flatten().tolist()


def decode_sp_world(rank: int, world: int, root: str, meshes=SP_MESHES) -> dict:
    """Each case of ``sp_inputs.pt`` (a float32 smoke, its weights, a prompt
    and the tokens of its decode steps) prefilled whole, then decoded
    through decode-SP at each of ``meshes``: every rank's logits for its
    batch rows and, a step and a layer, the slots of its cache chunk the
    step wrote; at a mesh of one rank also the one-device decode's logits
    (``"one_device"``), in the same process."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.partitioning import local_slices, mesh_axis_rules
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model

    saved = torch.load(os.path.join(root, "sp_inputs.pt"))
    out = {}
    for case in saved:
        cfg = dataclasses.replace(get_smoke_config(case["arch"]), compute_dtype="float32")
        model = build_model(cfg, device="cpu", seed=None)
        model.load_state_dict(case["state"])
        _, cache = model.prefill({"tokens": case["tokens"]}, case["max_len"])
        for shape in meshes:
            mesh = make_mesh(shape, ("data", "model"), "cpu")
            part = S.shard_cache(mesh, [{k: v.clone() for k, v in c.items()} for c in cache])
            plain = [{k: v.clone() for k, v in c.items()} for c in cache]
            logits, writes, one_device = [], [], []
            for i, tok in enumerate(case["steps"]):
                rows = S.shard_inputs(mesh, {"tokens": tok})["tokens"]
                before = [c["k"].to_local().clone() for c in part]
                with mesh_axis_rules(mesh):
                    lg, _ = model.decode_step(part, rows, torch.tensor(case["pos"] + i))
                logits.append(lg)
                writes.append([_changed_slots(b, c["k"].to_local()) for b, c in zip(before, part)])
                if mesh.size() == 1:
                    one_device.append(model.decode_step(plain, tok, case["pos"] + i)[0])
            sl = local_slices(tuple(case["steps"][0].shape), mesh,
                              S.batch_shardings(mesh, case["steps"][0]).placements)[0]
            out[case["name"], shape] = {
                "one_device": torch.stack(one_device) if one_device else None,
                "logits": torch.stack(logits), "rows": (sl.start, sl.stop),
                "writes": writes, "coord": tuple(mesh.get_coordinate()),
                "chunks": [c["k"].to_local().shape[2] for c in part],
                "slots": [c["k"].shape[2] for c in part]}
    return out


# ---------------------------------------------------------------- MoE EP
MOE_BLOCK_CASES = (("gather", (2, 2)), ("stationary", (2, 2)), ("gather", (4, 1)))
# (name, mesh, batch, capacity factor): at NO_DROP every slot is kept, so
# the sharded forms compute the one-device block's function exactly; at
# the config's own capacity (None) slots drop — the "_lean" batches draw
# each data half's rows from 3 tokens of its own —, local_gather's by each
# data rank's own tokens
MOE_NO_DROP = 8.0
MOE_TRAIN_CASES = (("2x2_gather", (2, 2), "big", MOE_NO_DROP),
                   ("2x2_stationary", (2, 2), "small", MOE_NO_DROP),
                   ("4x1", (4, 1), "big", None),
                   ("4x1_lean", (4, 1), "big_lean", None),
                   ("2x2_gather_cap", (2, 2), "big_lean", None),
                   ("2x2_stationary_cap", (2, 2), "small_lean", None))


def _forms():
    """Wrap the MoE block's sharded forms so a run records which it took."""
    from repro_torch.models import layers as L

    taken = []
    for name in ("_moe_local_gather", "_moe_local_stationary", "_moe_global_order"):
        fn = getattr(L, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            taken.append(_name)
            return _fn(*a, **kw)

        setattr(L, name, wrapped)
    return taken


def moe_parallel_world(rank: int, world: int, root: str, opt_kw: dict) -> dict:
    """The MoE block's sharded forms and the MoE smoke's sharded train step
    (float32) from ``moe_inputs.pt``: for each of ``MOE_BLOCK_CASES`` the
    block's output on this rank's rows and which form ran, the aux loss, and
    at ``MOE_NO_DROP`` the gradients of ``sum(y · w)`` as the sharded step
    reduces them (the data ranks' sum; the router's also summed over the
    expert group by the form); on the "_lean" tokens, where slots drop at
    the config's capacity, the output, the form and those gradients; for
    each of ``MOE_TRAIN_CASES`` one sharded step's metrics, forms and full
    state."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.partitioning import axis_group, axis_index, mesh_axis_rules
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.train import AdamWConfig
    from repro_torch.train.sharded import make_sharded_train_step, shard_train_state

    saved = torch.load(os.path.join(root, "moe_inputs.pt"))
    taken = _forms()
    cfg = dataclasses.replace(get_smoke_config("qwen3-moe-235b-a22b"), compute_dtype="float32")
    out: dict = {"block": {}, "train": {}}
    for tokens, shape in MOE_BLOCK_CASES:
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        n_rows = saved["x"][tokens].shape[0]
        got = {}
        for run, inputs, cf in (("cap", tokens, cfg.capacity_factor),
                                ("no_drop", tokens, MOE_NO_DROP),
                                ("lean", tokens + "_lean", cfg.capacity_factor)):
            x = S.shard_inputs(mesh, {"x": saved["x"][inputs]})["x"]
            w = S.shard_inputs(mesh, {"w": saved["w"][inputs]})["w"]
            got["rows"] = axis_index(mesh, "data") if x.shape[0] < n_rows else None
            spec = L.MoESpec(cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k, cf)
            moe = L.MoE(spec, torch.float32)
            moe.load_state_dict(saved["moe"])
            params = dict(moe.named_parameters())
            for p in params.values():
                p.requires_grad_(True)
            xg = x.clone().requires_grad_(True)
            del taken[:]
            with mesh_axis_rules(mesh):
                y = L.moe_block(moe, spec, xg)
                aux = L.moe_aux_loss(moe, spec, x)
            (y * w).sum().backward()
            grads = {k: p.grad.clone() for k, p in params.items()}
            for g in grads.values():  # the data ranks' sum, as the sharded step's
                dist.all_reduce(g, group=axis_group(mesh, "data"))
            e_local = cfg.n_experts // mesh.size(1)
            shard = axis_index(mesh, "model") * e_local
            got["experts"] = (shard, shard + e_local)
            if run == "cap":
                got.update(y=y.detach(), form=list(taken), aux=float(aux.detach()))
            elif run == "no_drop":
                got.update(no_drop_form=list(taken), x_grad=xg.grad, grads=grads)
            else:  # slots drop at the config's capacity
                got.update(lean_y=y.detach(), lean_form=list(taken), lean_x_grad=xg.grad,
                           lean_grads=grads)
        out["block"][tokens, shape] = got

    opt = AdamWConfig(**opt_kw)
    for name, shape, which, cf in MOE_TRAIN_CASES:
        mcfg = cfg if cf is None else dataclasses.replace(cfg, capacity_factor=cf)
        model = build_model(mcfg, device="cpu", seed=None, param_dtype="float32")
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        state = shard_train_state(_clone(saved["state"]), mesh)
        del taken[:]
        state, metrics = make_sharded_train_step(model, opt, mesh)(state, saved["batches"][which])
        full = _gathered(state)  # a collective: every rank calls it
        out["train"][name] = {"metrics": {k: float(v) for k, v in metrics.items()},
                              "forms": sorted(set(taken)),
                              "state": full if rank == 0 else None}
    return out


# ------------------------------------------------------------- roofline
def roofline_world(rank: int, world: int) -> dict:
    """Wire bytes the port's own collectives report in a gloo world of 4:
    an all-reduce of 1,024 float32 (4,096 bytes), and GPipe over 4 stages
    and 2 microbatches of 256 bf16 each (one stage's sends and the final
    broadcast)."""
    import torch.distributed as dist

    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.roofline.analysis import count_step

    x = torch.ones(1024)
    _, ar = count_step(C.all_reduce, x, dist.group.WORLD)
    ws = torch.ones((4, 16, 16), dtype=torch.bfloat16)
    xs = torch.ones((2, 16, 16), dtype=torch.bfloat16)
    pp = pipeline_apply(lambda w, h: h @ w, make_mesh((4, 1), ("pod", "data"), "cpu"),
                        n_microbatches=2, axis="pod")
    _, cp = count_step(pp, ws, xs)
    return {"all_reduce": ar, "pipeline": cp, "all_reduce_value": float(x[0])}
