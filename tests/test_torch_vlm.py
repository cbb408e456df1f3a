"""The port's VLM backbone (``qwen2-vl-72b``: M-RoPE, precomputed input
embeddings, QKV bias) against the JAX package's, on the CPU.

The reference's ``DecoderLM(cfg).init(PRNGKey(0))`` (its zero QKV biases
redrawn nonzero from a seed) goes to numpy and, through
``params_from_reference``, into the port.  Both packages then take the same
seeded numpy inputs: ``embeds`` (B, S, D) drawn as ``normal(0, 0.5)`` (the
reference's ``make_batch``) and M-RoPE ``positions`` (B, 3, S) of an image
and text prompt, whose three components differ — a text prefix at ``(p,
p, p)``, a grid of patches at ``(P, P + row, P + col)``, text after it one
past the largest position.  With the three equal, M-RoPE is plain RoPE and
a section error could not show.

* ``mrope_sections`` equals the reference's (16/24/24 at head_dim 128);
* the M-RoPE tables select, bit for bit, each frequency's component of the
  plain RoPE tables (the reference's one-hot einsum multiplies by 1 and adds
  0, so its tables are the same selection, also checked bit for bit); the
  two packages' tables then differ by the plain tables' float32 rounding
  alone (``pow`` and ``cos`` of the two libraries, at most one ulp each),
  held within 1e-4;
* prefill logits and every layer's KV cache, then six decode steps fed
  seeded (B, 1, D) embeddings at the reference's ``pos``: float32 within
  1e-4; bf16 prefill logits within 5e-2, decode logits and caches within
  1e-1 (``tests/test_torch_lm.py``'s limits and their reasons);
* a second admission (a new prompt batch of another length, prefilled into
  a new cache) decoded as the reference decodes it (float32, 1e-4);
* the reference's ``test_decode_matches_forward`` on the port alone: a
  prefill of S embeddings and four decode steps end at the logits of a
  prefill of all S + 4 (the four at ``(t, t, t)``, as a decode step
  places them), within 2e-3 of the largest logit;
* the port has no ``token_embedding`` (``param_count`` counts one: the
  port's count is ``param_count() - padded_vocab * d_model``), and the
  converter refuses a tree with a leaf missing, left over or misshapen;
* a tree the reference's ``quantize_for_serving`` made serves alike
  (float32, 1e-4): int8 serving covers the backbone;
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
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import get_smoke_config as tget_smoke  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.lm import DecoderLM  # noqa: E402

ARCH = "qwen2-vl-72b"
BATCH = 2
PROMPT = 80  # two 64-key chunks, the second padded
DECODE_STEPS = 6
TOL = {"float32": 1e-4, "bfloat16": 5e-2}  # prefill logits
DECODE_TOL = {"float32": 1e-4, "bfloat16": 1e-1}  # decode logits, caches


def mrope_positions(batch: int, s: int, prefix: int, grid: int) -> np.ndarray:
    """M-RoPE ids (B, 3, S) of a ``prefix``-token text prefix, a ``grid`` ×
    ``grid`` image of merged patches and text after it: ``(p, p, p)``, then
    ``(prefix, prefix + row, prefix + col)``, then one more in all three
    components per token from ``prefix + grid``."""
    pos = np.zeros((3, s), np.int64)
    pos[:, :prefix] = np.arange(prefix)
    n = min(grid * grid, s - prefix)
    r, c = np.divmod(np.arange(n), grid)
    pos[0, prefix:prefix + n] = prefix
    pos[1, prefix:prefix + n] = prefix + r
    pos[2, prefix:prefix + n] = prefix + c
    pos[:, prefix + n:] = prefix + grid + np.arange(s - prefix - n)
    return np.broadcast_to(pos, (batch, 3, s)).copy()


def configs(dtype: str):
    return (dataclasses.replace(jget_smoke(ARCH), compute_dtype=dtype),
            dataclasses.replace(tget_smoke(ARCH), compute_dtype=dtype))


def with_biases(params: dict) -> dict:
    """The reference initialises QKV biases at zero; draw them nonzero."""
    rng = np.random.default_rng(3)
    for blk in params["units"].values():
        for name in ("bq", "bk", "bv"):
            shape = blk["mixer"][name].shape
            blk["mixer"][name] = jnp.asarray(rng.normal(0, 0.5, shape), jnp.float32)
    return params


def reference(dtype: str):
    jcfg, tcfg = configs(dtype)
    jmodel = jbuild(jcfg)
    params = with_biases(jmodel.init(jax.random.PRNGKey(0)))
    tree = jax.tree.map(np.asarray, params)
    tmodel = DecoderLM(tcfg, device="cpu", seed=None)
    tmodel.load_state_dict(params_from_reference(tcfg, tree))
    return jmodel, params, tree, tmodel


def close(got: torch.Tensor, want, tol: float) -> None:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def same_cache(got: dict, want: dict, tol: float) -> None:
    assert set(got) == set(want) == {"k", "v"}
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape, name
        assert str(t.dtype).removeprefix("torch.") == str(want[name].dtype), name
        close(t, want[name], tol)


def run_both(jmodel, params, tmodel, embeds, positions, steps, s0, max_len):
    """Prefill ``embeds`` at ``positions`` and decode ``steps`` (B, 1, D)
    embeddings from position ``s0`` in both packages: each step's
    (reference logits, port logits, reference cache, port cache copy)."""
    batch = {"embeds": embeds, "positions": positions}
    jl, jc = jax.jit(jmodel.prefill, static_argnums=2)(
        params, jax.tree.map(jnp.asarray, batch), max_len)
    tl, tc = tmodel.prefill(jax.tree.map(torch.from_numpy, batch), max_len)

    def snap(cache):  # the port writes decode tokens into its cache in place
        return [{n: t.clone() for n, t in c.items()} for c in cache]

    out = [(jl, tl, jc, snap(tc))]
    jdecode = jax.jit(jmodel.decode_step)
    for t, x in enumerate(steps):
        jl, jc = jdecode(params, jc, jnp.asarray(x), jnp.asarray(s0 + t, jnp.int32))
        tl, tc = tmodel.decode_step(tc, torch.from_numpy(x), s0 + t)
        out.append((jl, tl, jc, snap(tc)))
    return out


@pytest.fixture(scope="module", params=list(TOL))
def served(request):
    dtype = request.param
    jmodel, params, tree, tmodel = reference(dtype)
    rng = np.random.default_rng(5)
    d = tmodel.cfg.d_model
    embeds = rng.normal(0, 0.5, (BATCH, PROMPT, d)).astype(np.float32)
    positions = mrope_positions(BATCH, PROMPT, 16, 6)
    steps = [rng.normal(0, 0.5, (BATCH, 1, d)).astype(np.float32)
             for _ in range(DECODE_STEPS)]
    out = run_both(jmodel, params, tmodel, embeds, positions, steps, PROMPT,
                   PROMPT + DECODE_STEPS + 2)
    return {"dtype": dtype, "cfg": tmodel.cfg, "steps": out, "tree": tree}


def ref_cache_layer(cache, idx: int) -> dict:
    return {n: a[idx] for n, a in cache["units"]["b0"].items()}


@pytest.mark.parametrize("head_dim", [16, 32, 64, 96, 128, 256])
def test_mrope_sections_match_the_reference(head_dim):
    assert TL.mrope_sections(head_dim) == JL.mrope_sections(head_dim)
    assert sum(TL.mrope_sections(head_dim)) == head_dim // 2
    if head_dim == 128:
        assert TL.mrope_sections(128) == (16, 24, 24)  # Qwen2-VL's published split
    if head_dim == 16:
        assert TL.mrope_sections(16) == (2, 3, 3)  # the smoke's head dim


@pytest.mark.parametrize("head_dim,theta", [(16, 1e4), (128, 1e6)])
def test_mrope_tables_select_each_frequencys_component(head_dim, theta):
    positions = mrope_positions(BATCH, 300, 64, 16)
    assert (positions[:, 0] != positions[:, 1]).any() and (positions[:, 1] != positions[:, 2]).any()
    comp = np.repeat([0, 1, 2], TL.mrope_sections(head_dim))  # (half,)
    cols = np.arange(head_dim // 2)
    tc, ts = TL.rope_cos_sin(torch.from_numpy(positions), head_dim, theta, mrope=True)
    jc, js = (np.asarray(a) for a in JL.rope_cos_sin(jnp.asarray(positions), head_dim,
                                                        theta, mrope=True))
    for pkg, (cos, sin), plain in (
            ("port", (tc.numpy(), ts.numpy()),
             [[t.numpy() for t in TL.rope_cos_sin(torch.from_numpy(positions[:, i]),
                                                  head_dim, theta)] for i in range(3)]),
            ("reference", (jc, js),
             [[np.asarray(a) for a in JL.rope_cos_sin(jnp.asarray(positions[:, i]),
                                                      head_dim, theta)] for i in range(3)])):
        for which, table in enumerate((cos, sin)):
            want = np.stack([plain[i][which] for i in range(3)])[comp, :, :, cols]
            np.testing.assert_array_equal(table, np.moveaxis(want, 0, -1), err_msg=pkg)
    assert not np.array_equal(tc.numpy(), TL.rope_cos_sin(
        torch.from_numpy(positions[:, 0]), head_dim, theta)[0].numpy())
    np.testing.assert_allclose(tc.numpy(), jc, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), js, rtol=0, atol=1e-4)


def test_mrope_refuses_positions_of_another_rank():
    with pytest.raises(ValueError, match="M-RoPE"):
        TL.rope_cos_sin(torch.zeros((2, 7), dtype=torch.long), 16, 1e4, mrope=True)


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


def test_decode_steps_match(served):
    cfg = served["cfg"]
    tol = DECODE_TOL[served["dtype"]]
    assert len(served["steps"]) == DECODE_STEPS + 1
    for jl, tl, jc, tc in served["steps"][1:]:
        close(tl, jl, tol)
        for idx in range(cfg.n_layers):
            same_cache(tc[idx], ref_cache_layer(jc, idx), tol)


def test_second_admission_decodes_as_the_reference():
    """A new prompt batch of another length, prefilled into a new cache after
    the first batch's decode steps, decodes as in the reference."""
    jmodel, params, _, tmodel = reference("float32")
    rng = np.random.default_rng(8)
    d = tmodel.cfg.d_model
    for s in (40, 56):  # two admissions, one after the other
        embeds = rng.normal(0, 0.5, (BATCH, s, d)).astype(np.float32)
        steps = [rng.normal(0, 0.5, (BATCH, 1, d)).astype(np.float32) for _ in range(3)]
        for jl, tl, _, _ in run_both(jmodel, params, tmodel, embeds,
                                     mrope_positions(BATCH, s, 8, 4), steps, s, 64):
            close(tl, jl, 1e-4)


def test_port_decode_matches_forward():
    cfg = dataclasses.replace(tget_smoke(ARCH), compute_dtype="float32")
    model = tbuild(cfg, device="cpu", seed=1)
    b, s, extra = 2, 64, 4
    rng = np.random.default_rng(3)
    embeds = torch.from_numpy(rng.normal(0, 0.5, (b, s + extra, cfg.d_model)).astype(np.float32))
    positions = mrope_positions(b, s + extra, 16, 6)
    positions[:, :, s:] = np.arange(s, s + extra)  # where a decode step places them
    positions = torch.from_numpy(positions)
    want, _ = model.prefill({"embeds": embeds, "positions": positions}, s + 16)
    logits, cache = model.prefill({"embeds": embeds[:, :s], "positions": positions[..., :s]},
                                  s + 16)
    for t in range(s, s + extra):
        logits, cache = model.decode_step(cache, embeds[:, t:t + 1], t)
    err = float((logits - want).abs().max())
    assert err / (float(want.abs().max()) + 1e-9) < 2e-3, err


def test_default_positions_are_the_references():
    """Without ``positions`` the batch takes ``arange(S)`` in all three
    components, as the reference's ``_embed`` does: the same logits as
    passing them."""
    jmodel, params, _, tmodel = reference("float32")
    s = 24
    embeds = np.random.default_rng(4).normal(0, 0.5, (BATCH, s, tmodel.cfg.d_model))
    embeds = embeds.astype(np.float32)
    jl, _ = jmodel.prefill(params, {"embeds": jnp.asarray(embeds)}, 32)
    tl, _ = tmodel.prefill({"embeds": torch.from_numpy(embeds)}, 32)
    close(tl, jl, 1e-4)
    pos = torch.arange(s).expand(BATCH, 3, s)
    again, _ = tmodel.prefill({"embeds": torch.from_numpy(embeds), "positions": pos}, 32)
    assert torch.equal(again, tl)


def test_param_count_and_names(served):
    cfg = served["cfg"]
    model = DecoderLM(cfg, device="cpu", seed=None)
    model.load_state_dict(params_from_reference(cfg, served["tree"]))
    assert not hasattr(model, "token_embedding")
    assert "token_embedding" not in model.state_dict()
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.param_count() - cfg.padded_vocab * cfg.d_model
    assert {"mixer.bq", "mixer.bk", "mixer.bv"} <= set(model.layers[0].state_dict())


def test_reference_quantized_tree_serves_alike():
    """int8 serving covers the backbone: a tree the reference's
    ``quantize_for_serving`` made, carried into a port model that
    ``quantize_for_serving`` quantized (every attention and FFN product a
    record, the biases bf16 values), prefills and decodes within 1e-4 of
    the reference at float32 (the decode products on ``w8_matmul``)."""
    jcfg, tcfg = configs("float32")
    jmodel = jbuild(jcfg)
    params = JL.quantize_for_serving(with_biases(jmodel.init(jax.random.PRNGKey(0))))
    tmodel = DecoderLM(tcfg, device="cpu", seed=0)
    TL.quantize_for_serving(tmodel)
    tmodel.load_state_dict(params_from_reference(tcfg, jax.tree.map(np.asarray, params)))
    assert isinstance(tmodel.layers[0].mixer.wq, TL.QuantizedWeight)
    rng = np.random.default_rng(6)
    d = tcfg.d_model
    embeds = rng.normal(0, 0.5, (BATCH, 40, d)).astype(np.float32)
    steps = [rng.normal(0, 0.5, (BATCH, 1, d)).astype(np.float32) for _ in range(3)]
    for jl, tl, _, _ in run_both(jmodel, params, tmodel, embeds,
                                 mrope_positions(BATCH, 40, 8, 4), steps, 40, 48):
        close(tl, jl, 1e-4)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "embedding"])
def test_converter_refuses_a_vlm_tree_that_does_not_match(fault):
    jcfg, tcfg = configs("float32")
    tree = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))
    params_from_reference(tcfg, tree)  # the tree as it comes is accepted
    mixer = tree["units"]["b0"]["mixer"]
    if fault == "missing":
        del mixer["bq"]
    elif fault == "extra":
        mixer["q_norm"] = {"scale": np.zeros(16, np.float32)}
    elif fault == "shape":
        mixer["bk"] = mixer["bk"][:, :-1]
    else:  # a token embedding the backbone does not have
        tree["token_embedding"] = np.zeros((tcfg.padded_vocab, tcfg.d_model), np.float32)
    with pytest.raises(ValueError):
        params_from_reference(tcfg, tree)


def test_launcher_refuses_the_vlm():
    from repro_torch.launch.serve import main

    with pytest.raises(SystemExit, match="token-input decoder archs only"):
        main(["--arch", ARCH, "--smoke", "--device", "cpu"])
