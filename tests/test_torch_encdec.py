"""The port's encoder-decoder (``seamless-m4t-medium``) against the JAX
package's, on the CPU.

The reference's ``EncDecLM(cfg).init(PRNGKey(0))`` goes to numpy and,
through ``params_from_reference`` (``enc_units`` unstacked into
``enc_layers``, ``units`` into ``layers``), into the port.  Both packages
then take the same seeded numpy inputs: 70 encoder frames drawn as
``normal(0, 0.5)`` (two 64-key chunks of the blockwise bidirectional
attention, the second padded) and a 48-token decoder prompt, then six
greedy decode steps fed the reference's tokens.

* the encoder's output within 1e-4 (float32) / 5e-2 (bf16);
* prefill logits, and every layer's cache — the port's flat ``{"k", "v",
  "cross_k", "cross_v"}`` mapped onto the reference's ``{"self": {"k",
  "v"}, "cross_k", "cross_v"}`` —, then six decode steps: float32 within
  1e-4; bf16 prefill logits within 5e-2, decode logits and caches within
  1e-1 (``tests/test_torch_lm.py``'s limits and their reasons);
* a second admission (new frames, a prompt of another length) decoded as
  the reference decodes it (float32, 1e-4);
* a decode step writes its token's ``k`` / ``v`` slot in place and leaves
  the cross K/V as it was, bit for bit;
* the reference's ``test_decode_matches_forward`` on the port alone (2e-3);
* the port's parameters are the reference's names and count plus
  ``enc_norm`` (which ``param_count`` leaves out: ``param_count() +
  d_model``); the converter refuses a tree with a leaf missing, left over,
  misshapen or stacked over the wrong depth;
* a tree the reference's ``quantize_for_serving`` made serves alike
  (float32, 1e-4): int8 serving covers the encoder-decoder;
* the launcher refuses the architecture with the reference's message.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch.configs import get_smoke_config as tget_smoke  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.encdec import EncDecLM  # noqa: E402

ARCH = "seamless-m4t-medium"
BATCH = 2
FRAMES = 70  # two 64-key chunks, the second padded
PROMPT = 48
DECODE_STEPS = 6
TOL = {"float32": 1e-4, "bfloat16": 5e-2}  # prefill logits, the encoder's output
DECODE_TOL = {"float32": 1e-4, "bfloat16": 1e-1}  # decode logits, caches


def configs(dtype: str):
    return (dataclasses.replace(jget_smoke(ARCH), compute_dtype=dtype),
            dataclasses.replace(tget_smoke(ARCH), compute_dtype=dtype))


def reference(dtype: str):
    jcfg, tcfg = configs(dtype)
    jmodel = jbuild(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    tmodel = EncDecLM(tcfg, device="cpu", seed=None)
    tmodel.load_state_dict(params_from_reference(tcfg, tree))
    return jmodel, params, tree, tmodel


def close(got: torch.Tensor, want, tol: float) -> None:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def ref_cache_layer(cache, idx: int) -> dict:
    """Layer ``idx``'s cache out of the reference's stacked, nested tree, as
    the port's flat dict."""
    units = cache["units"]
    return {"k": units["self"]["k"][idx], "v": units["self"]["v"][idx],
            "cross_k": units["cross_k"][idx], "cross_v": units["cross_v"][idx]}


def same_cache(got: dict, want: dict, tol: float) -> None:
    assert set(got) == set(want) == {"k", "v", "cross_k", "cross_v"}
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape, name
        assert str(t.dtype).removeprefix("torch.") == str(want[name].dtype), name
        close(t, want[name], tol)


def inputs(rng, d: int, vocab: int, frames: int, prompt: int) -> dict:
    return {"enc_embeds": rng.normal(0, 0.5, (BATCH, frames, d)).astype(np.float32),
            "tokens": rng.integers(0, vocab, (BATCH, prompt)).astype(np.int32)}


def run_both(jmodel, params, tmodel, batch: dict, steps: int, max_len: int):
    """Prefill ``batch`` and decode ``steps`` greedy tokens (the reference's)
    in both packages: each step's (reference logits, port logits, reference
    cache, port cache copy)."""
    jl, jc = jax.jit(jmodel.prefill, static_argnums=2)(
        params, jax.tree.map(jnp.asarray, batch), max_len)
    tl, tc = tmodel.prefill(jax.tree.map(torch.from_numpy, batch), max_len)

    def snap(cache):  # the port writes decode tokens into its cache in place
        return [{n: t.clone() for n, t in c.items()} for c in cache]

    out = [(jl, tl, jc, snap(tc))]
    jdecode = jax.jit(jmodel.decode_step)
    s0 = batch["tokens"].shape[1]
    for t in range(steps):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jc = jdecode(params, jc, jnp.asarray(nxt), jnp.asarray(s0 + t, jnp.int32))
        tl, tc = tmodel.decode_step(tc, torch.from_numpy(nxt), s0 + t)
        out.append((jl, tl, jc, snap(tc)))
    return out


@pytest.fixture(scope="module", params=list(TOL))
def served(request):
    dtype = request.param
    jmodel, params, tree, tmodel = reference(dtype)
    batch = inputs(np.random.default_rng(5), tmodel.cfg.d_model, tmodel.cfg.vocab,
                   FRAMES, PROMPT)
    out = run_both(jmodel, params, tmodel, batch, DECODE_STEPS,
                   PROMPT + DECODE_STEPS + 2)
    enc = (jmodel.encode(params, jnp.asarray(batch["enc_embeds"])),
           tmodel.encode(torch.from_numpy(batch["enc_embeds"])))
    return {"dtype": dtype, "cfg": tmodel.cfg, "steps": out, "tree": tree, "encoded": enc}


def test_encoder_output_matches(served):
    want, got = served["encoded"]
    assert got.dtype == getattr(torch, served["dtype"])
    assert tuple(got.shape) == want.shape == (BATCH, FRAMES, served["cfg"].d_model)
    close(got, want, TOL[served["dtype"]])


def test_prefill_logits_match(served):
    jl, tl, _, _ = served["steps"][0]
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    close(tl, jl, TOL[served["dtype"]])


def test_prefill_cache_matches(served):
    cfg = served["cfg"]
    _, _, jc, tc = served["steps"][0]
    assert len(tc) == cfg.n_layers
    for idx in range(cfg.n_layers):
        same_cache(tc[idx], ref_cache_layer(jc, idx), DECODE_TOL[served["dtype"]])
        assert tc[idx]["cross_k"].shape[2] == FRAMES


def test_decode_steps_match(served):
    cfg = served["cfg"]
    tol = DECODE_TOL[served["dtype"]]
    assert len(served["steps"]) == DECODE_STEPS + 1
    for jl, tl, jc, tc in served["steps"][1:]:
        close(tl, jl, tol)
        for idx in range(cfg.n_layers):
            same_cache(tc[idx], ref_cache_layer(jc, idx), tol)


def test_second_admission_decodes_as_the_reference():
    """New frames and a prompt of another length, prefilled into a new cache
    after the first batch's decode steps, decode as in the reference."""
    jmodel, params, _, tmodel = reference("float32")
    rng = np.random.default_rng(8)
    for frames, prompt in ((8, 40), (8, 56)):  # two admissions, one after the other
        batch = inputs(rng, tmodel.cfg.d_model, tmodel.cfg.vocab, frames, prompt)
        for jl, tl, _, _ in run_both(jmodel, params, tmodel, batch, 3, 64):
            close(tl, jl, 1e-4)


def test_decode_step_writes_its_slot_and_reads_the_cross_kv():
    cfg = dataclasses.replace(tget_smoke(ARCH), compute_dtype="float32")
    model = tbuild(cfg, device="cpu", seed=2)
    assert isinstance(model, EncDecLM)
    batch = inputs(np.random.default_rng(6), cfg.d_model, cfg.vocab, 8, 20)
    _, cache = model.prefill(jax.tree.map(torch.from_numpy, batch), 32)
    before = [{n: t.clone() for n, t in c.items()} for c in cache]
    _, after = model.decode_step(cache, torch.zeros((BATCH, 1), dtype=torch.long), 20)
    assert after is cache
    for old, new in zip(before, cache):
        assert torch.equal(old["cross_k"], new["cross_k"])
        assert torch.equal(old["cross_v"], new["cross_v"])
        for n in ("k", "v"):
            changed = (old[n] != new[n]).any(dim=(0, 1, 3)).nonzero().flatten().tolist()
            assert changed == [20]
    empty = model.init_cache(BATCH, 32)
    assert [{n: tuple(t.shape) for n, t in c.items()} for c in empty] == [
        {"k": (BATCH, 4, 32, 16), "v": (BATCH, 4, 32, 16),
         "cross_k": (BATCH, 4, 32 // cfg.enc_subsample, 16),
         "cross_v": (BATCH, 4, 32 // cfg.enc_subsample, 16)}] * cfg.n_layers


def test_port_decode_matches_forward():
    cfg = dataclasses.replace(tget_smoke(ARCH), compute_dtype="float32")
    model = tbuild(cfg, device="cpu", seed=1)
    s, extra = 64, 4
    batch = jax.tree.map(torch.from_numpy, inputs(np.random.default_rng(3), cfg.d_model,
                                                  cfg.vocab, 8, s + extra))
    want, _ = model.prefill(batch, s + 16)
    toks = batch["tokens"]
    logits, cache = model.prefill({"enc_embeds": batch["enc_embeds"], "tokens": toks[:, :s]},
                                  s + 16)
    for t in range(s, s + extra):
        logits, cache = model.decode_step(cache, toks[:, t:t + 1], t)
    err = float((logits - want).abs().max())
    assert err / (float(want.abs().max()) + 1e-9) < 2e-3, err


def test_param_count_and_names(served):
    cfg = served["cfg"]
    model = EncDecLM(cfg, device="cpu", seed=None)
    model.load_state_dict(params_from_reference(cfg, served["tree"]))
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count() + cfg.d_model
    assert not any(p.requires_grad for p in model.parameters())
    assert len(model.enc_layers) == cfg.n_enc_layers and len(model.layers) == cfg.n_layers
    assert set(model.layers[0].state_dict()) == {
        "ln1.scale", "ln_x.scale", "ln2.scale", "mlp.w_in", "mlp.w_down",
        *(f"{m}.{w}" for m in ("mixer", "cross") for w in ("wq", "wk", "wv", "wo"))}
    assert set(model.enc_layers[0].state_dict()) == {
        "ln1.scale", "ln2.scale", "mlp.w_in", "mlp.w_down",
        *(f"mixer.{w}" for w in ("wq", "wk", "wv", "wo"))}
    state = params_from_reference(cfg, served["tree"])
    for i in range(cfg.n_enc_layers):
        np.testing.assert_array_equal(state[f"enc_layers.{i}.mlp.w_in"].numpy(),
                                      served["tree"]["enc_units"]["mlp"]["w_in"][i])
    assert {"token_embedding", "enc_norm.scale", "final_norm.scale", "lm_head"} <= set(state)


def test_reference_quantized_tree_serves_alike():
    """int8 serving covers the encoder-decoder: a tree the reference's
    ``quantize_for_serving`` made (its stacked ``enc_units`` and ``units``
    records unstacked), carried into a port model that
    ``quantize_for_serving`` quantized (encoder, self-, cross-attention and
    FFN products records), prefills and decodes within 1e-4 of the
    reference at float32."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL

    jcfg, tcfg = configs("float32")
    jmodel = jbuild(jcfg)
    params = JL.quantize_for_serving(jmodel.init(jax.random.PRNGKey(0)))
    tmodel = EncDecLM(tcfg, device="cpu", seed=0)
    TL.quantize_for_serving(tmodel)
    tmodel.load_state_dict(params_from_reference(tcfg, jax.tree.map(np.asarray, params)))
    records = [m for m in tmodel.modules() if isinstance(m, TL.QuantizedWeight)]
    assert len(records) == 6 * tcfg.n_enc_layers + 10 * tcfg.n_layers
    batch = inputs(np.random.default_rng(6), tcfg.d_model, tcfg.vocab, 8, 40)
    for jl, tl, _, _ in run_both(jmodel, params, tmodel, batch, 3, 48):
        close(tl, jl, 1e-4)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "depth", "enc_norm"])
def test_converter_refuses_an_encdec_tree_that_does_not_match(fault):
    jcfg, tcfg = configs("float32")
    tree = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))
    params_from_reference(tcfg, tree)  # the tree as it comes is accepted
    if fault == "missing":
        del tree["units"]["cross"]["wv"]
    elif fault == "extra":  # an encoder layer has no cross-attention norm
        tree["enc_units"]["ln_x"] = tree["enc_units"]["ln1"]
    elif fault == "shape":
        tree["units"]["cross"]["wo"] = tree["units"]["cross"]["wo"][:, :, :-1]
    elif fault == "depth":  # stacked over one encoder layer fewer
        tree["enc_units"]["ln2"]["scale"] = tree["enc_units"]["ln2"]["scale"][1:]
    else:
        del tree["enc_norm"]
    with pytest.raises(ValueError):
        params_from_reference(tcfg, tree)


def test_launcher_refuses_the_encdec():
    from repro_torch.launch.serve import main

    with pytest.raises(SystemExit, match="token-input decoder archs only"):
        main(["--arch", ARCH, "--smoke", "--device", "cpu"])
