"""The MoE block's sharded forms and the MoE smoke's sharded train step
against the JAX package's, on the CPU.

One gloo world of 4 processes (``tests/torch_worlds.py``
``moe_parallel_world``, a ``FileStore`` and a deadline) runs the port; the
JAX package's sharded forms run in a child with 4 forced host devices (as
``tests/test_distributed.py`` ``run_child``), at the same time; its
one-device forms in-process.  Everything is float32, made from a seed with
numpy (the train state is the JAX package's after one step, carried over).

* ``moe_block`` at mesh (2, 2) with two token counts, chosen so that each
  expert-parallel form is taken (``local_gather``: 8 × 64 tokens,
  ``t·k = 1,024 ≥ 3·e_local·f = 384``; ``local_stationary``: 4 × 8 tokens,
  ``t·k = 64``), against the JAX package's ``moe_block`` under
  ``axis_rules`` on the (2, 2) child, slots dropped at each form's own
  capacity; and at mesh (4, 1), where the expert axis is one rank and the
  batch spans four, against the JAX one-device block (the reference runs
  its single-device branch under GSPMD there, capacity and drops over the
  global batch): outputs within ``BLOCK_TOL`` (rtol and atol 1e-5: float32
  sums in another order), the form the reference's mode choice takes;
* ``moe_aux_loss`` on each rank's rows within 1e-6 of the reference's over
  the whole batch (the global mean);
* the gradients of ``sum(y · w)`` as the sharded step reduces them (the
  data ranks' sum): each rank's own experts' rows of every expert tensor,
  the router and the rank's rows of ``x`` within ``GRAD_TOL`` (rtol 1e-4,
  atol 1e-5) of ``jax.grad`` of a JAX one-device reference, at two
  capacities.  At a capacity factor of 8 (``MOE_NO_DROP``) no slot drops
  and every form computes the one-device block's function exactly.  At
  the config's own capacity slots drop: ``local_gather`` at (2, 2) takes
  its capacity from each data rank's own tokens, so it is held to the
  one-device block run on each data rank's rows alone (``per_data_rank``:
  the reference's ``local_gather`` summed over its expert shards); the
  stationary form and the (4, 1) form take the global batch's, and are
  held to the one-device block.  The same comparison made on the port's
  gradient times 2 (the group size) fails, so a gradient handed on
  through an autograd all-reduce of the expert group, or summed once too
  often, fails these tests.  A test checks that the per-rank reference
  differs from the global one there, so the two capacities are told apart;
* the gradients are held to one-device blocks and not to the JAX
  package's sharded forms: those run ``shard_map`` with
  ``check_rep=False`` (``repro/compat.py``), and with no slot dropped their
  ``x`` and router gradients differ from the one-device block's while
  their outputs (``BLOCK_TOL``) and expert gradients (``GRAD_TOL``) agree
  — a test reads this off the (2, 2) child and prints the differences;
* for the same reason, the sharded train step of the MoE smoke at (2, 2)
  with each form (8 × 64 tokens: ``local_gather``; 4 × 32:
  ``local_stationary``) is held, at capacity factor 8, to the JAX
  one-device step of that config; at the config's own capacity,
  ``local_gather``'s to the JAX one-device step whose MoE blocks run on
  each data rank's rows alone (``per_data_rank``), ``local_stationary``'s
  to the JAX one-device step; and at (4, 1), at the config's own
  capacity, to the JAX one-device step — at the reference test's
  tolerances (loss rtol 1e-4; params rtol 3e-3, atol 3e-4), ``grad_norm``
  rtol 1e-4.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch_worlds import (  # noqa: E402
    MOE_BLOCK_CASES,
    MOE_NO_DROP,
    MOE_TRAIN_CASES,
    moe_parallel_world,
    run_world,
)

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.train import AdamWConfig as JConfig  # noqa: E402
from repro.train import make_train_step as jmake_step  # noqa: E402
from repro.train.step import init_train_state as jinit_state  # noqa: E402
from repro_torch.configs import get_smoke_config as tget_smoke  # noqa: E402
from repro_torch.models.convert import train_state_from_reference  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen3-moe-235b-a22b"
OPT = dict(lr=1e-3, warmup_steps=0, decay_steps=100)
BLOCK_TOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LEAN = 3.0  # the router logit a half of the block's rows adds to its expert
AUX_TOL = 1e-6
TOKENS = {"gather": (8, 64), "stationary": (4, 8)}
_SMOKE = jget_smoke(ARCH)
SPEC_ARGS = (_SMOKE.d_model, _SMOKE.d_ff, _SMOKE.n_experts, _SMOKE.top_k)
BATCHES = {"big": (8, 64), "small": (4, 32)}
FORMS = {("gather", (2, 2)): "_moe_local_gather",
         ("stationary", (2, 2)): "_moe_local_stationary",
         ("gather", (4, 1)): "_moe_global_order",
         "2x2_gather": "_moe_local_gather", "2x2_stationary": "_moe_local_stationary",
         "4x1": "_moe_global_order", "4x1_lean": "_moe_global_order",
         "2x2_gather_cap": "_moe_local_gather", "2x2_stationary_cap": "_moe_local_stationary"}

CHILD = """
    import numpy as np, jax, jax.numpy as jnp, dataclasses
    from repro import compat
    from repro.configs import get_smoke_config
    from repro.distributed.partitioning import axis_rules, rules_for_mesh
    from repro.launch.mesh import make_mesh
    from repro.models import layers as L

    root = {root!r}
    inp = np.load(root + "/jax_inputs.npz")
    cfg = get_smoke_config({arch!r})
    spec = L.MoESpec(cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k, cfg.capacity_factor)
    moe = {{k: jnp.asarray(inp["moe_" + k]) for k in
           ("router", "expert_gate", "expert_up", "expert_down")}}
    no_drop = dataclasses.replace(spec, capacity_factor={no_drop!r})
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {{}}
    with axis_rules(rules_for_mesh(mesh), {{"data": 2, "model": 2}}), compat.set_mesh(mesh):
        for name in ("gather", "stationary"):
            x, w = jnp.asarray(inp["x_" + name]), jnp.asarray(inp["w_" + name])
            out["y_" + name] = jax.jit(lambda p, x: L.moe_block(p, spec, x))(moe, x)
            out["y_lean_" + name] = jax.jit(lambda p, x: L.moe_block(p, spec, x))(
                moe, jnp.asarray(inp["x_" + name + "_lean"]))
            # the sharded form's own gradient where no slot drops
            out["nd_y_" + name] = jax.jit(lambda p, x: L.moe_block(p, no_drop, x))(moe, x)
            gp, gx = jax.jit(jax.grad(lambda p, x: (L.moe_block(p, no_drop, x) * w).sum(),
                                      argnums=(0, 1)))(moe, x)
            out["nd_gx_" + name] = gx
            for k, g in gp.items():
                out["nd_g_" + k + "_" + name] = g
    np.savez(root + "/jax_out.npz", **{{k: np.asarray(v) for k, v in out.items()}})
    print("OK")
"""


def inputs(cfg):
    rng = np.random.default_rng(0)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    moe = {"router": rng.normal(0, d ** -0.5, (d, e)),
           "expert_gate": rng.normal(0, d ** -0.5, (e, d, f)),
           "expert_up": rng.normal(0, d ** -0.5, (e, d, f)),
           "expert_down": rng.normal(0, f ** -0.5, (e, f, d))}
    moe = {k: v.astype(np.float32) for k, v in moe.items()}
    x = {k: rng.normal(0, 1, (b, s, d)).astype(np.float32) for k, (b, s) in TOKENS.items()}
    w = {k: rng.normal(0, 1, (b, s, d)).astype(np.float32) for k, (b, s) in TOKENS.items()}
    batches = {k: {n: rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
                   for n in ("tokens", "labels")} for k, (b, s) in BATCHES.items()}
    # "…_lean": each half of the rows (a data rank's at (2, 2)) leans toward
    # an expert of its own — the block's rows by LEAN along its router
    # column, a batch's rows drawn from 3 tokens of their own —, so that
    # slots drop at the config's capacity, and drop otherwise by a rank's
    # own tokens than by the whole batch's
    lean = LEAN * moe["router"][:, :2] / np.linalg.norm(moe["router"][:, :2], axis=0)
    for k, (b, s) in TOKENS.items():
        z = rng.normal(0, 1, (b, s, d))
        z[:b // 2] += lean[:, 0]
        z[b // 2:] += lean[:, 1]
        x[k + "_lean"], w[k + "_lean"] = z.astype(np.float32), w[k]
    for k, (b, s) in BATCHES.items():
        toks = rng.integers(0, 3, (b, s))
        toks[b // 2:] += 3
        batches[k + "_lean"] = {"tokens": toks.astype(np.int32),
                                "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    return moe, x, w, batches


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("moe_parallel")
    jcfg = dataclasses.replace(jget_smoke(ARCH), compute_dtype="float32")
    tcfg = dataclasses.replace(tget_smoke(ARCH), compute_dtype="float32")
    moe, x, w, batches = inputs(jcfg)
    np.savez(root / "jax_inputs.npz", **{f"moe_{k}": v for k, v in moe.items()},
             **{f"x_{k}": v for k, v in x.items()}, **{f"w_{k}": v for k, v in w.items()})
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"))
    child = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(CHILD.format(root=str(root), arch=ARCH,
                                                        no_drop=MOE_NO_DROP))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        jmodel = jbuild(jcfg)
        state = jinit_state(jmodel, jax.random.PRNGKey(0))
        rng = np.random.default_rng(1)  # the carried step's batch
        b0 = {k: jnp.asarray(rng.integers(0, jcfg.vocab, (8, 64)), jnp.int32)
              for k in ("tokens", "labels")}
        state, _ = jax.jit(jmake_step(jmodel, JConfig(**OPT)))(state, b0)
        torch.save({"moe": {k: torch.from_numpy(v) for k, v in moe.items()},
                    "x": {k: torch.from_numpy(v) for k, v in x.items()},
                    "w": {k: torch.from_numpy(v) for k, v in w.items()},
                    "state": train_state_from_reference(tcfg, jax.tree.map(np.asarray, state)),
                    "batches": {k: {n: torch.from_numpy(a) for n, a in b.items()}
                                for k, b in batches.items()}},
                   root / "moe_inputs.pt")
        world = run_world(moe_parallel_world, 4, root, str(root), OPT, timeout=300)
        # the one-device references: the block, its gradients and aux, the steps
        jmoe = {k: jnp.asarray(v) for k, v in moe.items()}
        one = {"aux": {}, "grads": {}, "cap_grads": {}, "steps": {}}
        for cf in (jcfg.capacity_factor, MOE_NO_DROP):
            spec = JL.MoESpec(jcfg.d_model, jcfg.d_ff, jcfg.n_experts, jcfg.top_k, cf)
            for k in TOKENS:
                xa, wa = jnp.asarray(x[k]), jnp.asarray(w[k])
                xl = jnp.asarray(x[k + "_lean"])
                if cf == MOE_NO_DROP:
                    gp, gx = jax.jit(jax.grad(
                        lambda p, a: (JL.moe_block(p, spec, a) * wa).sum(),
                        argnums=(0, 1)))(jmoe, xa)
                    one["grads"][k] = (np.asarray(gx), {n: np.asarray(g) for n, g in gp.items()})
                    one["y_lean_no_drop_" + k] = jax.jit(
                        lambda p, a: JL.moe_block(p, spec, a))(jmoe, xl)
                    continue
                one["y_" + k] = jax.jit(lambda p, a: JL.moe_block(p, spec, a))(jmoe, xa)
                one["aux"][k] = float(JL.moe_aux_loss(jmoe, spec, xa))
                # where slots drop: the block, and local_gather's function at
                # (2, 2) — the block on each data rank's rows alone
                for block in ("one", "shards"):
                    fn = JL.moe_block if block == "one" else per_data_rank(JL.moe_block, 2)
                    one["y_lean_" + block + "_" + k] = jax.jit(
                        lambda p, a: fn(p, spec, a))(jmoe, xl)
                    gp, gx = jax.jit(jax.grad(lambda p, a: (fn(p, spec, a) * wa).sum(),
                                              argnums=(0, 1)))(jmoe, xl)
                    one["cap_grads"][k, block] = (
                        np.asarray(gx), {n: np.asarray(g) for n, g in gp.items()})
        for name, _, which, cf in MOE_TRAIN_CASES:
            mcfg = jcfg if cf is None else dataclasses.replace(jcfg, capacity_factor=cf)
            block = JL.moe_block
            if name == "2x2_gather_cap":  # each data rank's capacity and drops
                JL.moe_block = per_data_rank(block, 2)
            try:
                jstate, jm = jax.jit(jmake_step(jbuild(mcfg), JConfig(**OPT)))(
                    state, {k: jnp.asarray(v) for k, v in batches[which].items()})
            finally:
                JL.moe_block = block
            one["steps"][name] = (
                train_state_from_reference(tcfg, jax.tree.map(np.asarray, jstate)),
                {k: float(v) for k, v in jm.items()})
        stdout, stderr = child.communicate(timeout=400)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    assert child.returncode == 0, f"STDOUT:\n{stdout}\nSTDERR:\n{stderr[-4000:]}"
    return {"world": world, "child": dict(np.load(root / "jax_out.npz")), "one": one,
            "moe": moe, "x": x}


def per_data_rank(block, n: int):
    """The JAX one-device ``block`` run on each of ``n`` data ranks' rows
    alone: the capacity and the drops of each rank's own tokens, which is
    the reference's ``local_gather`` — its expert shards' partial outputs
    summed are the block over all experts, since an expert's kept slots
    depend on that expert's slots alone."""
    def run(params, spec, x):
        return jnp.concatenate([block(params, spec, xs) for xs in jnp.split(x, n)], axis=0)

    return run


def rows_of(rank: dict, full: np.ndarray) -> np.ndarray:
    r, n = rank["rows"], rank["y"].shape[0]
    return full if r is None else full[r * n:(r + 1) * n]


@pytest.mark.parametrize("tokens,shape", MOE_BLOCK_CASES, ids=lambda v: str(v))
def test_block_matches_the_reference(setup, tokens, shape):
    want = setup["one"]["y_" + tokens] if shape == (4, 1) else setup["child"]["y_" + tokens]
    for rank in setup["world"]:
        got = rank["block"][tokens, shape]
        assert got["form"] == got["no_drop_form"] == [FORMS[tokens, shape]]
        np.testing.assert_allclose(got["y"].numpy(), rows_of(got, np.asarray(want)),
                                   rtol=BLOCK_TOL, atol=BLOCK_TOL)


@pytest.mark.parametrize("tokens,shape", MOE_BLOCK_CASES, ids=lambda v: str(v))
def test_block_gradients_match_and_a_group_factor_fails(setup, tokens, shape):
    gx_want, gp_want = setup["one"]["grads"][tokens]
    for rank in setup["world"]:
        got = rank["block"][tokens, shape]
        np.testing.assert_allclose(got["x_grad"].numpy(), rows_of(got, gx_want), **GRAD_TOL)
        lo, hi = got["experts"]
        for k, want in gp_want.items():
            g = got["grads"][k].numpy()
            if k.startswith("expert_"):
                g, want = g[lo:hi], want[lo:hi]
            np.testing.assert_allclose(g, want, err_msg=k, **GRAD_TOL)
            assert not np.allclose(2 * g, want, **GRAD_TOL), k  # off by the group size


def dropping_reference(tokens, shape) -> str:
    """The one-device reference of a form where slots drop: ``local_gather``
    at (2, 2) drops by each data rank's own tokens (the block on each data
    rank's rows), the others by the whole batch's (the block)."""
    return "shards" if (tokens, shape) == ("gather", (2, 2)) else "one"


@pytest.mark.parametrize("tokens,shape", MOE_BLOCK_CASES, ids=lambda v: str(v))
def test_block_where_slots_drop(setup, tokens, shape):
    """The "_lean" tokens at the config's capacity: the output against the
    JAX package's sharded block on the (2, 2) child (the one-device block
    at (4, 1)) and against the one-device reference of the form, within
    ``BLOCK_TOL``; the gradients against ``jax.grad`` of that reference,
    within ``GRAD_TOL``, and not at twice the port's."""
    one, block = setup["one"], dropping_reference(tokens, shape)
    sharded = one["y_lean_one_" + tokens] if shape == (4, 1) else setup["child"][
        "y_lean_" + tokens]
    gx_want, gp_want = one["cap_grads"][tokens, block]
    for rank in setup["world"]:
        got = rank["block"][tokens, shape]
        assert got["lean_form"] == [FORMS[tokens, shape]]
        for want in (sharded, one["y_lean_" + block + "_" + tokens]):
            np.testing.assert_allclose(got["lean_y"].numpy(), rows_of(got, np.asarray(want)),
                                       rtol=BLOCK_TOL, atol=BLOCK_TOL)
        np.testing.assert_allclose(got["lean_x_grad"].numpy(), rows_of(got, gx_want),
                                   **GRAD_TOL)
        lo, hi = got["experts"]
        for k, want in gp_want.items():
            g = got["lean_grads"][k].numpy()
            if k.startswith("expert_"):
                g, want = g[lo:hi], want[lo:hi]
            np.testing.assert_allclose(g, want, err_msg=k, **GRAD_TOL)
            assert not np.allclose(2 * g, want, **GRAD_TOL), k  # off by the group size


def test_slots_drop_by_the_form_s_own_tokens(setup):
    """The "_lean" inputs tell the capacities apart: at the config's
    capacity the block drops slots (its output is not the no-drop
    block's), and the block on each data rank's rows is not the block on
    the whole batch — nor is the MoE smoke's step on the "big_lean" batch
    with each data rank's capacity (``2x2_gather_cap``) the step with the
    whole batch's (``4x1_lean``)."""
    one = setup["one"]
    for tokens in TOKENS:
        assert not np.allclose(one["y_lean_one_" + tokens], one["y_lean_no_drop_" + tokens],
                               rtol=BLOCK_TOL, atol=BLOCK_TOL), tokens
    assert not np.allclose(one["y_lean_shards_gather"], one["y_lean_one_gather"],
                           rtol=BLOCK_TOL, atol=BLOCK_TOL)
    shards, whole = one["steps"]["2x2_gather_cap"][1], one["steps"]["4x1_lean"][1]
    assert not np.isclose(shards["loss"], whole["loss"], rtol=1e-4, atol=0)


@pytest.mark.parametrize("tokens", ["gather", "stationary"])
def test_reference_sharded_gradient_is_not_its_output_s(setup, tokens):
    """Why the gradients above are held to one-device blocks: at
    ``MOE_NO_DROP`` the JAX package's sharded forms at (2, 2) give the
    one-device block's output and expert gradients, but not its ``x`` and
    router gradients (``shard_map`` with ``check_rep=False``).  Prints the
    readings."""
    child = setup["child"]
    gx_want, gp_want = setup["one"]["grads"][tokens]
    x = setup["x"][tokens]
    y_one = np.asarray(JL.moe_block({k: jnp.asarray(v) for k, v in setup["moe"].items()},
                                    JL.MoESpec(*SPEC_ARGS, MOE_NO_DROP), jnp.asarray(x)))
    np.testing.assert_allclose(child["nd_y_" + tokens], y_one, rtol=BLOCK_TOL, atol=BLOCK_TOL)
    for k in ("expert_gate", "expert_up", "expert_down"):
        np.testing.assert_allclose(child[f"nd_g_{k}_{tokens}"], gp_want[k], err_msg=k,
                                   **GRAD_TOL)
    readings = {"x": (child["nd_gx_" + tokens], gx_want),
                "router": (child[f"nd_g_router_{tokens}"], gp_want["router"])}
    for name, (got, want) in readings.items():
        print(f"{tokens} {name}: max |sharded - one-device| "
              f"{float(np.abs(got - want).max()):.6g}, max |one-device| "
              f"{float(np.abs(want).max()):.6g}")
        assert not np.allclose(got, want, **GRAD_TOL), name


@pytest.mark.parametrize("tokens,shape", MOE_BLOCK_CASES, ids=lambda v: str(v))
def test_aux_is_the_global_mean(setup, tokens, shape):
    want = setup["one"]["aux"][tokens]
    for rank in setup["world"]:
        assert abs(rank["block"][tokens, shape]["aux"] - want) <= AUX_TOL


@pytest.mark.parametrize("case", [c[0] for c in MOE_TRAIN_CASES])
def test_sharded_step_matches_the_reference(setup, case):
    want_state, want_m = setup["one"]["steps"][case]
    lead = setup["world"][0]["train"][case]
    for rank in setup["world"]:
        got = rank["train"][case]
        assert got["forms"] == [FORMS[case]]
        assert got["metrics"] == lead["metrics"]  # every rank reports the same
    np.testing.assert_allclose(lead["metrics"]["loss"], want_m["loss"], rtol=1e-4)
    np.testing.assert_allclose(lead["metrics"]["grad_norm"], want_m["grad_norm"], rtol=1e-4)
    for k, w in want_state["params"].items():
        np.testing.assert_allclose(lead["state"]["params"][k].numpy(), w.numpy(),
                                   rtol=3e-3, atol=3e-4, err_msg=k)
    assert int(lead["state"]["opt"]["step"]) == int(want_state["opt"]["step"]) == 2
