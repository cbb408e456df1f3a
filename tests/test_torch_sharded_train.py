"""The port's sharded train step against the JAX package's, on the CPU.

One gloo world of 4 processes (``tests/torch_worlds.py``
``sharded_train_world``, a ``FileStore`` and a deadline) runs the qwen3-8b
smoke in float32 from a state the JAX package made and stepped once
(carried by ``train_state_from_reference``, so the moments and the step
count are not zero):

* the sharded step at meshes (2, 2), (4, 1) and (1, 4), and (2, 2) with
  two microbatches, against the JAX package's one-device ``make_train_step``
  on the same state and batch, at the reference test's tolerances
  (``tests/test_distributed.py``
  ``test_sharded_train_step_runs_and_matches_single_device``: loss rtol
  1e-4; params rtol 3e-3, atol 3e-4);
* against the port's own unsharded ``make_train_step`` (both on one
  intra-op thread: the CPU's embedding backward sums in another order on
  several): bit-equal where there is one data rank (1, 4), float32 and
  bf16 gradients; with several,
  the sums are re-associated (each rank's share of a microbatch summed, then
  the ranks), so loss and ``grad_norm`` within ``REASSOC`` relative, the
  moments within ``REASSOC`` relative plus ``REASSOC`` of each leaf's
  largest magnitude, and the params within ``REASSOC`` times the step's lr
  where the gradient is resolved (|mu| above 1e-3 of its leaf's largest),
  within 2 lr elsewhere (Adam's first step moves a parameter by about
  ``sign(g) · lr``, and a gradient that is all summation noise may flip);
  with bf16 on the wire at (2, 2), each rank's sum rounded to bf16 (2^-8
  relative), ``grad_norm`` within 1e-2 relative and the loss finite;
* every rank's local shapes are the global shapes cut by the spec;
* a checkpoint written at (2, 2) restored at (4, 1): every leaf equal to the
  saved full tensor, then a finite step (after
  ``test_elastic_restore_across_mesh_shapes``);
* the refusal of a model axis that does not divide the world (the MoE
  configs train at every mesh now; ``tests/test_torch_moe_parallel.py``
  holds their sharded step against the JAX package);
* GPipe, 4 stages and 8 microbatches, against the sequential stack (rtol
  and atol 1e-5, after ``test_gpipe_pipeline_matches_sequential``);
* the launcher at ``--model-axis 2`` in the world of 4, with a restart,
  and on the MoE smoke for one finite step.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch_worlds import SHARDED_CASES, run_world, sharded_train_world  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.train import AdamWConfig as JConfig  # noqa: E402
from repro.train import make_train_step as jmake_step  # noqa: E402
from repro.train.step import init_train_state as jinit_state  # noqa: E402
from repro_torch.configs import get_smoke_config as tget_smoke  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models.convert import train_state_from_reference  # noqa: E402
from repro_torch.train import AdamWConfig, make_train_step  # noqa: E402

WORLD = 4
OPT = dict(lr=1e-3, warmup_steps=0, decay_steps=100)
REASSOC = 1e-4
CASES = {name: (shape, accum, grad_dtype) for name, shape, accum, grad_dtype in SHARDED_CASES}
JAX_CASES = ("2x2", "4x1", "1x4", "2x2_accum2")


def batches(vocab: int) -> list[dict]:
    rng = np.random.default_rng(0)
    return [{k: rng.integers(0, vocab, (8, 64)).astype(np.int32) for k in ("tokens", "labels")}
            for _ in range(2)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX state after one step, carried over; the batch of the step
    under test; the JAX and port unsharded results of that step; and the
    world's results."""
    jcfg = dataclasses.replace(jget_smoke("qwen3-8b"), compute_dtype="float32")
    tcfg = dataclasses.replace(tget_smoke("qwen3-8b"), compute_dtype="float32")
    jmodel = jbuild(jcfg)
    b0, b1 = batches(jcfg.vocab)
    state = jinit_state(jmodel, jax.random.PRNGKey(0))
    state, _ = jax.jit(jmake_step(jmodel, JConfig(**OPT)))(
        state, {k: jnp.asarray(v) for k, v in b0.items()})
    tree = jax.tree.map(np.asarray, state)
    jax_out = {}
    for accum in (1, 2):
        jstate, jm = jax.jit(jmake_step(jmodel, JConfig(**OPT), grad_accum=accum))(
            state, {k: jnp.asarray(v) for k, v in b1.items()})
        jax_out[accum] = (train_state_from_reference(tcfg, jax.tree.map(np.asarray, jstate)),
                          {k: float(v) for k, v in jm.items()})
    carried = train_state_from_reference(tcfg, tree)
    batch = {k: torch.from_numpy(v) for k, v in b1.items()}
    model = tbuild(tcfg, device="cpu", seed=None, param_dtype="float32")
    port = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the world's ranks: the CPU's embedding
    try:                      # backward sums in another order on several
        for accum, grad_dtype in ((1, None), (2, None), (1, "bfloat16")):
            s = train_state_from_reference(tcfg, tree)
            s, m = make_train_step(model, AdamWConfig(**OPT), grad_accum=accum,
                                   grad_dtype=grad_dtype)(s, batch)
            port[accum, grad_dtype] = (
                {"params": {k: v.detach() for k, v in s["params"].items()}, "opt": s["opt"]},
                {k: float(v) for k, v in m.items()})
    finally:
        torch.set_num_threads(threads)
    root = tmp_path_factory.mktemp("sharded_train")
    torch.save({"state": carried, "batch": batch}, root / "inputs.pt")
    world = run_world(sharded_train_world, WORLD, root, str(root), OPT, timeout=420)
    return {"jax": jax_out, "port": port, "world": world}


def leaves(state) -> dict:
    return {**{("params", k): v for k, v in state["params"].items()},
            **{("mu", k): v for k, v in state["opt"]["mu"].items()},
            **{("nu", k): v for k, v in state["opt"]["nu"].items()}}


@pytest.mark.parametrize("case", JAX_CASES)
def test_sharded_step_matches_jax(setup, case):
    _, accum, _ = CASES[case]
    got = setup["world"][0]["steps"][case]
    want_state, want_m = setup["jax"][accum]
    np.testing.assert_allclose(got["metrics"]["loss"], want_m["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["metrics"]["grad_norm"], want_m["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose(got["metrics"]["lr"], want_m["lr"], rtol=1e-6)
    for k, w in want_state["params"].items():
        np.testing.assert_allclose(got["state"]["params"][k].numpy(), w.numpy(),
                                   rtol=3e-3, atol=3e-4, err_msg=k)
    assert int(got["state"]["opt"]["step"]) == int(want_state["opt"]["step"]) == 2


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_against_the_ports_own(setup, case):
    shape, accum, grad_dtype = CASES[case]
    got = setup["world"][0]["steps"][case]
    want_state, want_m = setup["port"][accum, grad_dtype]
    for r in setup["world"][1:]:  # every rank reports the same metrics
        assert r["steps"][case]["metrics"] == got["metrics"]
    if shape[0] == 1:  # one data rank: the same sums in the same order
        assert got["metrics"] == want_m
        for key, w in leaves(want_state).items():
            assert torch.equal(leaves(got["state"])[key], w), key
        return
    if grad_dtype is not None:  # bf16 sums over the wire: the rounding moves
        assert np.isfinite(got["metrics"]["loss"])
        assert abs(got["metrics"]["grad_norm"] - want_m["grad_norm"]) <= 1e-2 * want_m["grad_norm"]
        return
    for k in ("loss", "grad_norm"):
        assert abs(got["metrics"][k] - want_m[k]) <= REASSOC * abs(want_m[k]), k
    lr = want_m["lr"]
    mine = leaves(got["state"])
    for (part, k), w in leaves(want_state).items():
        g = mine[part, k]
        if part != "params":
            torch.testing.assert_close(g, w, rtol=REASSOC,
                                       atol=REASSOC * float(w.abs().max()), msg=(part, k))
            continue
        mu = want_state["opt"]["mu"][k].abs()
        resolved = mu > 1e-3 * float(mu.max())
        diff = (g - w).abs()
        assert float(torch.where(resolved, diff, 0.0).max()) <= REASSOC * lr, k
        assert float(diff.max()) <= 2 * lr, k


@pytest.mark.parametrize("case", sorted(CASES))
def test_local_shapes_follow_the_specs(setup, case):
    shape, _, _ = CASES[case]
    for rank in setup["world"]:
        step = rank["steps"][case]
        assert step["bad_shapes"] == []
        assert step["split"] > 0  # every mesh here splits some leaves


def test_elastic_restore_across_mesh_shapes(setup):
    for rank in setup["world"]:
        e = rank["elastic"]
        assert e["step"] == 1 and e["unequal"] == [] and e["bad_shapes"] == []
        assert e["leaves"] == 3 * len(setup["port"][1, None][0]["params"])
        assert e["count"] == 2 and np.isfinite(e["loss"])
        assert "Shard(dim=0)" in e["placements"]  # ZeRO-1 over data at (4, 1)


def test_refusals(setup):
    for rank in setup["world"]:
        r = rank["refusals"]
        assert "does not divide the world of 4" in r["model_axis"]


def test_gpipe_matches_sequential(setup):
    for rank in setup["world"]:
        g = rank["gpipe"]
        torch.testing.assert_close(g["y"], g["ref"], rtol=1e-5, atol=1e-5)


def test_launcher_in_a_world_of_four_resumes(setup):
    runs = [rank["launcher"] for rank in setup["world"]]
    lead = runs[0]
    assert [h["step"] for h in lead["first"]] == [1]
    assert np.isfinite(lead["first"][0]["loss"])
    out = lead["stdout"]
    assert "mesh {'data': 2, 'model': 2}" in out
    assert "resumed from step 3" in out and "done at step 5" in out
    assert all(r["stdout"] == "" for r in runs[1:])  # rank 0 alone prints
    for r in runs[1:]:  # every rank trained the same steps
        assert [h["loss"] for h in r["first"]] == [h["loss"] for h in lead["first"]]
    moe = [r["moe"] for r in runs]  # the MoE smoke: a finite step, alike everywhere
    assert [h["step"] for h in moe[0]] == [1] and np.isfinite(moe[0][0]["loss"])
    assert all([h["loss"] for h in m] == [h["loss"] for h in moe[0]] for m in moe)
