"""The port's training substrate against the JAX package's, on the CPU.

* ``schedule``, ``global_norm`` and ``adamw_update`` on the same inputs
  within 1e-6 relative (float32; the two round the same terms in other
  fused orders); the reference's own optimizer tests, on the port;
* gradient accumulation equal to the full batch (the reference's direct
  gradient compare: ``rtol 1e-3``, ``atol 1e-5 * ||g||``);
* ``make_train_step`` from a state carried across with
  ``train_state_from_reference`` (after one reference step, so the moments
  are not zero), with and without accumulation: loss within 1e-5,
  ``grad_norm`` within 1e-4 relative, params and moments after the step
  within ``rtol 1e-3`` plus ``1e-5`` of each leaf's largest magnitude;
* the trainer end to end with a restart (the restored state bit-equal to
  the saved one, the batch stream after the seek equal to the unbroken
  one), and the straggler watchdog;
* the flash kernel's plain version and the layers' blockwise attention
  differentiated against ``jax.grad`` of the reference's
  ``blockwise_attention``, and the scan's gradient against ``jax.grad`` of
  ``lax.associative_scan`` (float32, 1e-4 of the largest gradient);
* the training launcher on the CPU, with a restart, and its refusals (a
  model axis that does not divide the world of one raises in
  ``host_device_mesh``).
"""

import dataclasses
import tempfile
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.train import AdamWConfig as JConfig  # noqa: E402
from repro.train import adamw_update as jupdate  # noqa: E402
from repro.train import make_train_step as jmake_step  # noqa: E402
from repro.train.optimizer import global_norm as jnorm  # noqa: E402
from repro.train.optimizer import schedule as jschedule  # noqa: E402
from repro.train.step import init_train_state as jinit_state  # noqa: E402
from repro_torch.configs import get_smoke_config as tget_smoke  # noqa: E402
from repro_torch.data import RecordStore, TrainPipeline, synthetic_corpus  # noqa: E402
from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.kernels import flash_attention as TF  # noqa: E402
from repro_torch.kernels import rglru_scan as RS  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.convert import params_from_reference, train_state_from_reference  # noqa: E402
from repro_torch.train import AdamWConfig, adamw_init, adamw_update, make_train_step  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.train.optimizer import global_norm, schedule  # noqa: E402
from repro_torch.train.step import init_train_state  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

CONFIGS = [dict(), dict(lr=1e-3, warmup_steps=10, decay_steps=100, min_lr_ratio=0.1),
           dict(lr=0.1, warmup_steps=0, decay_steps=1000, weight_decay=0.0, clip_norm=100.0),
           dict(lr=1.0, warmup_steps=3, decay_steps=3, clip_norm=0.5)]


def rel_close(got, want, rtol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= rtol * np.abs(want) + 1e-30), (got, want)


# --------------------------------------------------------------- optimizer
@pytest.mark.parametrize("kw", CONFIGS)
def test_schedule_matches_reference(kw):
    for s in list(range(0, 130, 5)) + [1, 2, 3, 99, 100, 101]:
        rel_close(float(schedule(AdamWConfig(**kw), s)),
                  float(jschedule(JConfig(**kw), jnp.asarray(s))))


def optimizer_inputs(seed, bf16_moments=False, scale=1.0):
    """params, grads and moments as numpy trees, one tree of leaves of every
    rank the update treats apart (vectors take no weight decay)."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (8, 5), "b": (5,), "emb": {"table": (12, 4)}, "s": ()}

    def draw(f):
        return {k: draw(f) if isinstance(v, dict) else None for k, v in []} or {
            k: ({kk: f(vv) for kk, vv in v.items()} if isinstance(v, dict) else f(v))
            for k, v in shapes.items()}

    def rand(shape):
        return rng.standard_normal(shape).astype(np.float32) * scale

    return draw(rand), draw(rand), draw(lambda s: rng.standard_normal(s).astype(np.float32)), \
        draw(lambda s: np.abs(rng.standard_normal(s)).astype(np.float32))


def to_torch(tree, dtype=None):
    if isinstance(tree, dict):
        return {k: to_torch(v, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree))
    return t.to(dtype) if dtype is not None else t


def to_jax(tree, dtype=None):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype), tree)


@pytest.mark.parametrize("kw", CONFIGS)
@pytest.mark.parametrize("step", [0, 3, 150])
def test_adamw_update_matches_reference(kw, step):
    params, grads, mu, nu = optimizer_inputs(step + len(kw), scale=1.0 + step)
    jp, js, jm = jupdate(to_jax(params), to_jax(grads),
                         {"mu": to_jax(mu), "nu": to_jax(nu),
                          "step": jnp.asarray(step, jnp.int32)}, JConfig(**kw))
    tstate = {"mu": to_torch(mu), "nu": to_torch(nu), "step": torch.tensor(step, dtype=torch.int32)}
    tp, ts, tm = adamw_update(to_torch(params), to_torch(grads), tstate, AdamWConfig(**kw))
    assert int(ts["step"]) == int(js["step"]) == step + 1
    for k in ("grad_norm", "lr"):
        rel_close(float(tm[k]), float(jm[k]))
    for got, want in ((tp, jp), (ts["mu"], js["mu"]), (ts["nu"], js["nu"])):
        for g, w in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got)),
                        jax.tree.leaves(want)):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-7)


def test_adamw_update_keeps_bf16_moments_bf16():
    """Moment math in float32, stored back in the moment's dtype (the MoE
    giants' bf16 state), as the reference's."""
    params, grads, mu, nu = optimizer_inputs(5)
    jp, js, _ = jupdate(to_jax(params), to_jax(grads),
                        {"mu": to_jax(mu, jnp.bfloat16), "nu": to_jax(nu, jnp.bfloat16),
                         "step": jnp.asarray(2, jnp.int32)}, JConfig())
    state = {"mu": to_torch(mu, torch.bfloat16), "nu": to_torch(nu, torch.bfloat16),
             "step": torch.tensor(2, dtype=torch.int32)}
    tp, ts, _ = adamw_update(to_torch(params), to_torch(grads), state, AdamWConfig())
    assert ts["mu"]["w"].dtype == torch.bfloat16
    for g, w in zip(jax.tree.leaves(jax.tree.map(lambda t: t.float().numpy(), ts["mu"])),
                    jax.tree.leaves(js["mu"])):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), rtol=2 ** -7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_global_norm_matches_reference(seed):
    params, grads, _, _ = optimizer_inputs(seed, scale=10.0 ** seed)
    rel_close(float(global_norm(to_torch(grads))), float(jnorm(to_jax(grads))))
    rel_close(float(global_norm(to_torch(params, torch.bfloat16))),
              float(jnorm(to_jax(params, jnp.bfloat16))))


def test_adamw_descends_quadratic():
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, decay_steps=1000, weight_decay=0.0,
                      clip_norm=100.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw_init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = adamw_update(params, grads, state, cfg)
    assert float(params["w"].abs().max()) < 1e-2


def test_grad_clipping_bounds_update():
    cfg = AdamWConfig(lr=1.0, warmup_steps=0, clip_norm=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    state = adamw_init(params)
    _, state, m = adamw_update(params, {"w": torch.full((4,), 1e6)}, state, cfg)
    assert float(m["grad_norm"]) > 1e5  # raw norm reported
    assert float(global_norm(state["mu"])) <= 0.11


def test_lr_schedule_shape():
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, decay_steps=100, min_lr_ratio=0.1)
    lrs = [float(schedule(cfg, s)) for s in range(0, 120, 5)]
    assert lrs[0] < lrs[1] <= 1e-3
    assert abs(lrs[2] - 1e-3) < 1e-9
    assert lrs[-1] >= 1e-4 - 1e-12


# -------------------------------------------------------------- train step
def smoke(arch="qwen3-8b"):
    jcfg = dataclasses.replace(jget_smoke(arch), compute_dtype="float32")
    tcfg = dataclasses.replace(tget_smoke(arch), compute_dtype="float32")
    return jcfg, tcfg


def test_grad_accum_matches_full_batch(monkeypatch):
    """The gradients ``make_train_step`` hands the update with
    ``grad_accum=4`` equal the full batch's (direct compare: comparing
    post-Adam params would amplify summation noise through the ~sign()
    update of step 1)."""
    _, cfg = smoke()
    model = tbuild(cfg, device="cpu", seed=0, param_dtype="float32")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (8, 64)).astype(np.int32))
             for k in ("tokens", "labels")}
    full = {k: v.clone().requires_grad_() for k, v in model.state_dict().items()}
    model.loss(full, batch)[0].backward()
    seen = {}

    def capture(params, grads, state, cfg):
        seen.update({k: g.clone() for k, g in grads.items()})
        return params, state, {"grad_norm": torch.zeros(()), "lr": torch.zeros(())}

    monkeypatch.setattr(tstep, "adamw_update", capture)
    make_train_step(model, AdamWConfig(), grad_accum=4)(init_train_state(model), batch)
    norm = float(torch.sqrt(sum((p.grad.double() ** 2).sum() for p in full.values())))
    assert set(seen) == set(full)
    for k, p in full.items():
        assert seen[k].dtype == torch.float32
        torch.testing.assert_close(seen[k], p.grad, rtol=1e-3, atol=1e-5 * norm)


@pytest.mark.parametrize("arch,grad_accum", [("qwen3-8b", 1), ("qwen3-8b", 2),
                                             ("recurrentgemma-9b", 2)])
def test_train_step_from_a_carried_state(arch, grad_accum):
    jcfg, tcfg = smoke(arch)
    jmodel = jbuild(jcfg)
    opt = dict(lr=1e-3, warmup_steps=2, decay_steps=4)
    jstep = jax.jit(jmake_step(jmodel, JConfig(**opt), grad_accum=grad_accum))
    rng = np.random.default_rng(1)
    batches = [{k: rng.integers(0, jcfg.vocab, (4, 64)).astype(np.int32)
                for k in ("tokens", "labels")} for _ in range(2)]
    state = jinit_state(jmodel, jax.random.PRNGKey(0))
    state, _ = jstep(state, {k: jnp.asarray(v) for k, v in batches[0].items()})
    carried = train_state_from_reference(tcfg, jax.tree.map(np.asarray, state))
    assert int(carried["opt"]["step"]) == 1
    jstate, jm = jstep(state, {k: jnp.asarray(v) for k, v in batches[1].items()})
    model = tbuild(tcfg, device="cpu", seed=None, param_dtype="float32")
    tstate, tm = make_train_step(model, AdamWConfig(**opt), grad_accum=grad_accum)(
        carried, {k: torch.from_numpy(v) for k, v in batches[1].items()})
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-4 * float(jm["grad_norm"])
    assert set(tm) == set(jm)
    assert int(tstate["opt"]["step"]) == 2
    # the moments against the reference's, at the gradients' limit (mu is
    # (1 - b1) g plus the carried moment, nu (1 - b2) g² plus the carried);
    # the params where the update is resolved — |mu| well above that limit —
    # within 1e-3 of the step's lr, elsewhere (a gradient that is all noise,
    # whose update Adam scales to ~lr) within the update's bound, 3 lr
    want = train_state_from_reference(tcfg, jax.tree.map(np.asarray, jstate))
    gnorm, lr = float(jm["grad_norm"]), float(jm["lr"])
    for k, w in want["opt"]["mu"].items():
        torch.testing.assert_close(tstate["opt"]["mu"][k], w, rtol=1e-3, atol=1e-5 * gnorm,
                                   msg=k)
        g_max = float(w.abs().max()) / 0.1 + 1e-30
        torch.testing.assert_close(tstate["opt"]["nu"][k], want["opt"]["nu"][k], rtol=1e-3,
                                   atol=2e-5 * gnorm * g_max, msg=k)
        resolved = w.abs() > 100 * 1e-5 * gnorm
        diff = (tstate["params"][k].detach() - want["params"][k]).abs()
        assert float(torch.where(resolved, diff, 0.0).max()) <= 1e-3 * lr, k
        assert float(diff.max()) <= 3 * lr, k


def test_train_state_from_reference_maps_every_leaf():
    jcfg, tcfg = smoke("recurrentgemma-9b")
    jmodel = jbuild(jcfg)
    tree = jax.tree.map(np.asarray, jinit_state(jmodel, jax.random.PRNGKey(0)))
    state = train_state_from_reference(tcfg, tree)
    model = tbuild(tcfg, device="cpu", seed=None, param_dtype="float32")
    names = set(model.state_dict())
    assert set(state["params"]) == set(state["opt"]["mu"]) == set(state["opt"]["nu"]) == names
    assert state["opt"]["step"].dtype == torch.int32 and state["opt"]["step"].shape == ()
    assert all(float(t.abs().sum()) == 0 for t in state["opt"]["mu"].values())
    want = params_from_reference(tcfg, tree["params"])
    assert all(torch.equal(state["params"][k], want[k]) for k in names)


# ----------------------------------------------------------------- trainer
def test_trainer_end_to_end_with_restart(tmp_path):
    cfg = tget_smoke("qwen3-8b")
    model = tbuild(cfg, device="cpu", seed=0, param_dtype=cfg.param_dtype)
    step_fn = make_train_step(model, AdamWConfig(lr=3e-3, warmup_steps=5))
    S = 64
    store = RecordStore(seq_len=S, device="cpu")
    store.ingest(*synthetic_corpus(128, S, cfg.vocab, seed=1))
    pipe = TrainPipeline(store, batch_size=8, seed=0)
    tcfg = TrainerConfig(total_steps=12, ckpt_dir=str(tmp_path), ckpt_every=5, log_every=4)
    tr = Trainer(step_fn, init_train_state(model), pipe.batches(), tcfg)
    hist = tr.run()
    assert tr.step == 12 and [h["step"] for h in hist] == [1, 4, 8, 12]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000005", "step_00000010", "step_00000012"]
    saved = {k: v.detach().clone() for k, v in tr.state["params"].items()}
    # restart: a fresh state from another seed, restored, continues to 16
    fresh = tbuild(cfg, device="cpu", seed=99, param_dtype=cfg.param_dtype)
    tr2 = Trainer(make_train_step(fresh, AdamWConfig(lr=3e-3, warmup_steps=5)),
                  init_train_state(fresh), pipe.batches(start_step=12),
                  dataclasses.replace(tcfg, total_steps=16))
    assert tr2.try_restore() and tr2.step == 12
    assert all(torch.equal(tr2.state["params"][k], saved[k]) for k in saved)
    assert int(tr2.state["opt"]["step"]) == 12
    unbroken = pipe.batches()
    for _ in range(12):
        next(unbroken)
    for a, b in zip([next(unbroken) for _ in range(2)], pipe.batches(start_step=12)):
        assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["labels"], b["labels"])
    tr2.run()
    assert tr2.step == 16


def test_straggler_watchdog_flags_slow_steps():
    calls = {"n": 0}

    def slow_step(state, batch):
        calls["n"] += 1
        if calls["n"] == 20:
            time.sleep(0.25)
        return state, {"loss": torch.zeros(())}

    flagged = []
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(slow_step, {"x": torch.zeros(())}, iter([{"t": torch.zeros(())}] * 30),
                     TrainerConfig(total_steps=30, ckpt_dir=d, ckpt_every=1000,
                                   straggler_factor=3.0),
                     on_straggler=lambda s, dt, med: flagged.append(s))
        tr.run()
    assert 20 in flagged and tr.straggler_steps == flagged


# ------------------------------------------------------------- backwards
ATTN_CASES = [(2, 64, 4, 2, 16, True, None, 16), (1, 48, 8, 2, 32, True, 20, 32),
              (2, 40, 4, 4, 16, False, None, 16), (1, 96, 8, 1, 32, False, 30, 64)]


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_attention_backwards_match_jax_grad(case):
    """dq, dk, dv of the layers' blockwise attention (checkpointed chunk
    steps) and of the flash kernel's plain version (the card's backward)
    against ``jax.grad`` of the reference's ``blockwise_attention``."""
    b, s, h, kh, d, causal, window, chunk = case
    rng = np.random.default_rng(sum(case[:5]))
    q, k, v = (rng.standard_normal((b, s, n, d)).astype(np.float32) for n in (h, kh, kh))
    dout = rng.standard_normal((b, s, h, d)).astype(np.float32)
    jspec = JL.AttnSpec(d_model=h * d, n_heads=h, n_kv_heads=kh, head_dim=d, window=window,
                        causal=causal)
    want = jax.grad(lambda *a: jnp.sum(JL.blockwise_attention(*a, jspec, chunk=chunk) * dout),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tspec = TL.AttnSpec(d_model=h * d, n_heads=h, n_kv_heads=kh, head_dim=d, window=window,
                        causal=causal)
    for fn in (lambda a, bb, c: TL.blockwise_attention(a, bb, c, tspec, chunk=chunk),
               lambda a, bb, c: TF.flash_attention_torch(a, bb, c, causal, window,
                                                         block_k=chunk)):
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        got = torch.autograd.grad(fn(*leaves), leaves, torch.from_numpy(dout))
        for g, w in zip(got, want):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("shape", [(2, 1, 3), (2, 37, 16), (1, 300, 8),
                                   (2, _cuda.RGLRU_BWD_STEPS + 1, 12)])
def test_scan_backward_matches_jax_grad(shape):
    """The scan's gradient (the reverse recurrence through the plain loop)
    against ``jax.grad`` of ``lax.associative_scan``; the last case's S is
    one step past a stage of the card's gradient kernel."""
    rng = np.random.default_rng(shape[1])
    a = rng.uniform(0.5, 1.0, shape).astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    dh = rng.standard_normal(shape).astype(np.float32)

    def combine(e1, e2):
        return e1[0] * e2[0], e2[0] * e1[1] + e2[1]

    def ref(a, x):
        return jnp.sum(jax.lax.associative_scan(combine, (a, x), axis=1)[1] * dh)

    want = jax.grad(ref, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(x))
    ta, tx = (torch.from_numpy(t).requires_grad_() for t in (a, x))
    got = torch.autograd.grad(RS.rglru_scan(ta, tx), (ta, tx), torch.from_numpy(dh))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())
    da, dx = RS.rglru_scan_backward_torch(ta.detach(), RS.rglru_scan_torch(ta.detach(),
                                                                           tx.detach()),
                                          torch.from_numpy(dh))
    assert torch.equal(da, got[0]) and torch.equal(dx, got[1])


# ---------------------------------------------------------------- launcher
def test_train_launcher_on_the_cpu_with_a_restart(tmp_path, capsys):
    from repro_torch.launch.train import main

    args = ["--arch", "qwen3-8b", "--smoke", "--device", "cpu", "--batch", "4", "--seq", "32",
            "--samples", "32", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    hist = main(args + ["--steps", "3"])
    assert [h["step"] for h in hist] == [1] and np.isfinite(hist[0]["loss"])
    main(args + ["--steps", "5"])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "done at step 5" in out


@pytest.mark.parametrize("arch,extra,error,match", [
    ("qwen2-vl-72b", [], SystemExit, "token-input"),
    ("seamless-m4t-medium", [], SystemExit, "token-input"),
    ("qwen3-8b", ["--model-axis", "2"], ValueError, "does not divide the world of 1")])
def test_train_launcher_refusals(arch, extra, error, match):
    from repro_torch.launch.train import main

    with pytest.raises(error, match=match):
        main(["--arch", arch, "--smoke", "--device", "cpu", *extra])
