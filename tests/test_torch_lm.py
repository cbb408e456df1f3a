"""The port's decoder against the JAX package's, on the CPU.

The reference's ``DecoderLM(cfg).init(PRNGKey(0))`` goes to numpy and,
through ``params_from_reference``, into the port; both packages then serve
the same tokens:

* float32 compute: prefill logits and every layer's cache (every key, in
  the reference's dtype: the KV caches, and the recurrent layers' ``conv``
  and ``ssm`` / ``h`` states) within 1e-4, then six ``decode_step``s (fed
  the reference's greedy tokens) within 1e-4 — the two sum in other orders
  (einsum vs matmul, a loop vs ``lax.scan``, a sequential recurrence vs
  ``lax.associative_scan``);
* bfloat16 compute: prefill logits within 5e-2, decode logits within 1e-1
  — the two frameworks round bf16 activations at other places (XLA on the
  CPU rounds after each elementwise op, PyTorch once per fused op), and
  decode adds the bf16 KV cache those roundings wrote: on these models the
  largest decode difference measured 0.073 on logits up to 4.8 in size.
  The bf16 caches, written from activations that already differ by those
  roundings, are held within 1e-1 too (largest measured: 0.078);
* models: ``qwen3-8b-smoke`` (global attention, qk-norm, SwiGLU; an 80-token
  prompt, two 64-key chunks with a padded tail), ``gemma3-27b-smoke``
  (one 5-local + 1-global unit and a 2-layer tail, window 32, GeGLU; a
  40-token prompt, longer than the window, so the ring buffer wraps), the
  two QKV-bias decoders, ``qwen1.5-110b-smoke`` (4 layers, 8 / 2 heads;
  a 72-token prompt) and ``internlm2-20b-smoke`` (3 layers, 6 / 3 heads; a
  48-token prompt), and the two MoE decoders at float32 only,
  ``qwen3-moe-smoke`` (2 ``moe`` layers, 8 experts, top-2, qk-norm; an
  80-token prompt: a prefill capacity of 50 rows an expert, with drops, on
  the dense form, decode steps of 4 rows on the expert-FFN path) and
  ``llama4-maverick-smoke`` (top-1, expert width 96; a 64-token prompt),
  and the recurrent families at both dtypes: ``mamba2-smoke`` (3 ``ssd``
  layers, chunk 32; a 72-token prompt, so the last chunk is padded) and
  ``recurrentgemma-smoke`` (one ``(rglru, rglru, local)`` unit and an
  ``(rglru, rglru)`` tail, window 32; a 40-token prompt, longer than the
  window, so the ring wraps).  At
  bf16 an MoE decoder's routing follows the router's bf16 logits, which the
  two frameworks' other rounding upstream can flip between experts, so its
  bf16 parity is held at the layer, on equal inputs (``test_torch_moe.py``);
* every decoder's own decode matches its own forward (the reference's
  ``test_decode_matches_forward``: drop-free MoE capacity, float32);
* an ``("attn", "moe")`` pattern (llama4's) carries unit ``u``'s ``b1`` to
  layer ``2u + 1``, and recurrentgemma's units and tail land at their
  layers;
* the converter refuses a tree with a leaf missing or left over, dense,
  MoE or recurrent.
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
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.lm import DecoderLM, layer_kinds  # noqa: E402

MODELS = {"qwen3-8b": 80, "gemma3-27b": 40, "qwen1.5-110b": 72,
          "internlm2-20b": 48, "qwen3-moe-235b-a22b": 80,
          "llama4-maverick-400b-a17b": 64, "mamba2-1.3b": 72,
          "recurrentgemma-9b": 40}  # arch -> prompt length
MOE = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b")
BATCH = 2
DECODE_STEPS = 6
TOL = {"float32": 1e-4, "bfloat16": 5e-2}  # prefill logits
DECODE_TOL = {"float32": 1e-4, "bfloat16": 1e-1}  # decode logits, caches


def configs(arch: str, dtype: str):
    return (dataclasses.replace(jget_smoke(arch), compute_dtype=dtype),
            dataclasses.replace(tget_smoke(arch), compute_dtype=dtype))


def port_model(tcfg, tree) -> DecoderLM:
    model = DecoderLM(tcfg, device="cpu", seed=None)
    model.load_state_dict(params_from_reference(tcfg, tree))
    return model


def with_biases(params: dict) -> dict:
    """The reference initialises QKV biases at zero; give them values drawn
    from a seed (the same in both packages) so the bias adds are tested."""
    rng = np.random.default_rng(3)
    for blocks in (params.get("units", {}), params.get("tail", {})):
        for blk in blocks.values():
            for name in ("bq", "bk", "bv"):
                if name in blk["mixer"]:
                    shape = blk["mixer"][name].shape
                    blk["mixer"][name] = jnp.asarray(rng.normal(0, 0.5, shape), jnp.float32)
    return params


def ref_cache_layer(cache, cfg, idx: int) -> dict:
    """Layer ``idx``'s cache out of the reference's stacked tree."""
    width = len(cfg.block_pattern)
    if idx < cfg.n_units * width:
        u, i = divmod(idx, width)
        return {n: a[u] for n, a in cache["units"][f"b{i}"].items()}
    return cache["tail"][f"b{idx - cfg.n_units * width}"]


def close(got: torch.Tensor, want, tol: float) -> None:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def same_cache(got: dict, want: dict, tol: float) -> None:
    """Every key of a layer's cache, of the reference's shape and dtype, and
    within ``tol``."""
    assert set(got) == set(want)
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape, name
        assert str(t.dtype).removeprefix("torch.") == str(want[name].dtype), name
        close(t, want[name], tol)


@pytest.fixture(scope="module",
                params=[(a, d) for a in MODELS for d in TOL if a not in MOE or d == "float32"],
                ids=lambda p: f"{p[0]}-{p[1]}")
def served(request):
    """Prefill and decode through both packages; what each returned."""
    arch, dtype = request.param
    jcfg, tcfg = configs(arch, dtype)
    jmodel = jbuild(jcfg)
    params = with_biases(jmodel.init(jax.random.PRNGKey(0)))
    tree = jax.tree.map(np.asarray, params)
    tmodel = port_model(tcfg, tree)
    s = MODELS[arch]
    max_len = s + DECODE_STEPS + 2
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (BATCH, s)).astype(np.int32)
    jl, jc = jax.jit(jmodel.prefill, static_argnums=2)(
        params, {"tokens": jnp.asarray(toks)}, max_len)
    jdecode = jax.jit(jmodel.decode_step)
    tl, tc = tmodel.prefill({"tokens": torch.from_numpy(toks)}, max_len)

    def snap(cache):  # the port writes decode tokens into its cache in place
        return [{n: t.clone() for n, t in c.items()} for c in cache]

    steps = [(jl, tl, jc, snap(tc))]
    for t in range(DECODE_STEPS):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jc = jdecode(params, jc, jnp.asarray(nxt), jnp.asarray(s + t, jnp.int32))
        tl, tc = tmodel.decode_step(tc, torch.from_numpy(nxt), s + t)
        steps.append((jl, tl, jc, snap(tc)))
    return {"arch": arch, "dtype": dtype, "cfg": tcfg, "steps": steps,
            "tree": tree}


def test_prefill_logits_match(served):
    jl, tl, _, _ = served["steps"][0]
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    close(tl, jl, TOL[served["dtype"]])


def test_prefill_cache_matches(served):
    cfg = served["cfg"]
    tol = DECODE_TOL[served["dtype"]]
    _, _, jc, tc = served["steps"][0]
    assert len(tc) == cfg.n_layers
    for idx in range(cfg.n_layers):
        same_cache(tc[idx], ref_cache_layer(jc, cfg, idx), tol)
        if "k" in tc[idx]:
            assert tc[idx]["k"].dtype == getattr(torch, served["dtype"])


def test_decode_steps_match(served):
    cfg = served["cfg"]
    tol = DECODE_TOL[served["dtype"]]
    for jl, tl, jc, tc in served["steps"][1:]:
        close(tl, jl, tol)
        if served["dtype"] == "float32":
            for idx in range(cfg.n_layers):
                same_cache(tc[idx], ref_cache_layer(jc, cfg, idx), 1e-4)


def test_param_count_and_names(served):
    cfg = served["cfg"]
    model = port_model(cfg, served["tree"])
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    assert not any(p.requires_grad for p in model.parameters())
    kinds = {layer.kind for layer in model.layers}
    assert kinds == set(cfg.block_pattern)
    assert [layer.kind for layer in model.layers] == layer_kinds(cfg)


def test_ring_buffer_wraps_as_the_reference():
    """gemma3 smoke: a 40-token prompt leaves positions 8..39 in the
    32-slot ring buffer at slots 0..31, and the first decode (pos 40) writes
    slot 40 % 32 = 8 — the slot of position 16, not of the oldest position
    8.  The port copies this property of the reference (ROADMAP §3)."""
    jcfg, tcfg = configs("gemma3-27b", "float32")
    model = tbuild(tcfg, device="cpu", seed=1)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 512, (1, 40)))
    _, cache = model.prefill({"tokens": toks}, 48)
    local = cache[0]
    assert local["k"].shape[2] == tcfg.window == 32
    before = local["k"].clone()
    model.decode_step(cache, toks[:, -1:], 40)
    changed = (local["k"] != before).any(dim=(0, 1, 3)).nonzero().flatten().tolist()
    assert changed == [40 % 32]


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "stack"])
def test_converter_refuses_a_tree_that_does_not_match(fault):
    jcfg, tcfg = configs("qwen3-8b", "float32")
    tree = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))
    params_from_reference(tcfg, tree)  # the tree as it comes is accepted
    if fault == "missing":
        del tree["units"]["b0"]["mlp"]["w_up"]
    elif fault == "extra":
        tree["units"]["b0"]["mixer"]["bq"] = np.zeros((3, 96), np.float32)
    elif fault == "shape":
        tree["lm_head"] = tree["lm_head"][:, :100]
    else:
        tree["units"]["b0"]["ln1"]["scale"] = tree["units"]["b0"]["ln1"]["scale"][:2]
    with pytest.raises(ValueError):
        params_from_reference(tcfg, tree)


def test_mrope_kind_is_ported():
    """Item 8.6's M-RoPE is ported: a decoder with ``mrope`` builds, takes
    ``positions`` (B, 3, S) in a prefill (and ``arange(S)`` in all three
    components without them) and decodes; positions of another rank are
    refused."""
    cfg = dataclasses.replace(tget_smoke("qwen3-8b"), mrope=True)
    assert isinstance(cfg, ArchConfig)
    model = tbuild(cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (1, 5)))
    pos = torch.stack([torch.arange(5), torch.arange(5) // 2, torch.arange(5) % 2])[None]
    logits, cache = model.prefill({"tokens": toks, "positions": pos}, 8)
    plain, _ = model.prefill({"tokens": toks}, 8)
    assert not torch.equal(logits, plain)  # the components differ: other angles
    logits, _ = model.decode_step(cache, toks[:, :1], 5)
    assert bool(torch.isfinite(logits).all())
    with pytest.raises(ValueError, match="M-RoPE"):
        model.prefill({"tokens": toks, "positions": pos[:, 0]}, 8)


def test_embed_inputs_kind_is_ported():
    """Item 8.6's precomputed inputs are ported: with ``embed_inputs=False``
    the decoder has no ``token_embedding`` and takes ``embeds`` (B, S, D)
    in a prefill and (B, 1, D) in a decode step."""
    cfg = dataclasses.replace(tget_smoke("qwen3-8b"), embed_inputs=False)
    model = tbuild(cfg, device="cpu")
    assert not hasattr(model, "token_embedding")
    assert sum(p.numel() for p in model.parameters()) == (
        cfg.param_count() - cfg.padded_vocab * cfg.d_model)
    x = torch.randn((1, 5, cfg.d_model), generator=torch.Generator().manual_seed(0))
    logits, cache = model.prefill({"embeds": x}, 8)
    logits, _ = model.decode_step(cache, x[:, -1:], 5)
    assert bool(torch.isfinite(logits).all())


def test_encdec_kind_is_ported():
    """Item 8.7 is ported: an encoder-decoder config builds an ``EncDecLM``
    (the decoder alone refuses it), which encodes frames, prefills and
    decodes over one flat cache a layer."""
    from repro_torch.models.encdec import EncDecLM

    cfg = dataclasses.replace(tget_smoke("qwen3-8b"), n_enc_layers=2, qk_norm=False,
                              mlp_kind="gelu")
    model = tbuild(cfg, device="cpu")
    assert isinstance(model, EncDecLM) and len(model.enc_layers) == 2
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count() + cfg.d_model
    batch = {"enc_embeds": torch.zeros((1, 3, cfg.d_model)),
             "tokens": torch.zeros((1, 5), dtype=torch.long)}
    logits, cache = model.prefill(batch, 8)
    assert set(cache[0]) == {"k", "v", "cross_k", "cross_v"}
    logits, _ = model.decode_step(cache, torch.zeros((1, 1), dtype=torch.long), 5)
    assert bool(torch.isfinite(logits).all())
    with pytest.raises(ValueError, match="encoder-decoder"):
        DecoderLM(cfg, device="cpu")


def test_moe_kind_is_ported():
    """Item 8.3 is ported: the ``moe`` kind builds (MoE in place of the
    FFN, the reference's parameter names) and serves, and a ``moe`` layer
    without experts is refused."""
    cfg = dataclasses.replace(tget_smoke("qwen3-8b"), block_pattern=("moe",), n_experts=4,
                              top_k=2)
    model = tbuild(cfg, device="cpu")
    assert [layer.kind for layer in model.layers] == ["moe"] * cfg.n_layers
    assert not hasattr(model.layers[0], "mlp")
    names = set(model.layers[0].state_dict())
    assert {"moe.router", "moe.expert_gate", "moe.expert_up", "moe.expert_down"} <= names
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    logits, cache = model.prefill({"tokens": torch.zeros((1, 5), dtype=torch.long)}, 8)
    logits, _ = model.decode_step(cache, torch.zeros((1, 1), dtype=torch.long), 5)
    assert bool(torch.isfinite(logits).all())
    with pytest.raises(ValueError, match="top_k"):
        tbuild(dataclasses.replace(cfg, n_experts=0), device="cpu")


def test_ssd_kind_is_ported():
    """Item 8.4 is ported: the ``ssd`` kind builds (the Mamba-2 mixer, no
    ``ln2`` and no FFN, the reference's parameter names, its constants
    float32 at bf16 compute) and serves; its cache is the recurrent state."""
    cfg = dataclasses.replace(tget_smoke("qwen3-8b"), block_pattern=("ssd",), ssm_state=8,
                              ssm_head_dim=16, ssm_chunk=4)
    model = tbuild(cfg, device="cpu")
    assert [layer.kind for layer in model.layers] == ["ssd"] * cfg.n_layers
    assert not hasattr(model.layers[0], "mlp") and not hasattr(model.layers[0], "ln2")
    names = set(model.layers[0].state_dict())
    assert names == {"ln1.scale", "mixer.w_zx", "mixer.conv_kernel", "mixer.a_log",
                     "mixer.dt_bias", "mixer.d_skip", "mixer.norm.scale", "mixer.w_out"}
    assert model.layers[0].mixer.a_log.dtype == torch.float32
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    logits, cache = model.prefill({"tokens": torch.zeros((1, 5), dtype=torch.long)}, 8)
    assert set(cache[0]) == {"conv", "ssm"}
    logits, _ = model.decode_step(cache, torch.zeros((1, 1), dtype=torch.long), 5)
    assert bool(torch.isfinite(logits).all())
    assert {n: t.dtype for n, t in model.init_cache(1, 8)[0].items()} == {
        "conv": torch.bfloat16, "ssm": torch.float32}


def test_rglru_kind_is_ported():
    """Item 8.5 is ported: the ``rglru`` kind builds (the RG-LRU mixer and an
    FFN, the reference's parameter names, the gates and ``lambda_`` float32
    at bf16 compute) and serves; its cache is the recurrent state."""
    cfg = dataclasses.replace(tget_smoke("qwen3-8b"), block_pattern=("rglru",), lru_width=64)
    model = tbuild(cfg, device="cpu")
    assert [layer.kind for layer in model.layers] == ["rglru"] * cfg.n_layers
    names = set(model.layers[0].state_dict())
    assert {"mixer.w_branch", "mixer.conv_kernel", "mixer.w_a", "mixer.b_a", "mixer.w_x",
            "mixer.b_x", "mixer.lambda_", "mixer.w_out", "ln2.scale",
            "mlp.w_gate"} <= names
    assert all(getattr(model.layers[0].mixer, n).dtype == torch.float32
               for n in ("w_a", "b_a", "w_x", "b_x", "lambda_"))
    assert model.layers[0].mixer.w_branch.dtype == torch.bfloat16
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    logits, cache = model.prefill({"tokens": torch.zeros((1, 5), dtype=torch.long)}, 8)
    assert set(cache[0]) == {"conv", "h"}
    logits, _ = model.decode_step(cache, torch.zeros((1, 1), dtype=torch.long), 5)
    assert bool(torch.isfinite(logits).all())


def test_all_ten_architectures_resolve_and_build():
    """Every one of the ten architectures resolves, full and smoke, and its
    smoke builds; an unknown name raises."""
    from repro_torch.configs import ARCH_NAMES, get_config
    from repro_torch.models.encdec import EncDecLM

    for name in ARCH_NAMES:
        assert get_config(name).name == name
        smoke = tbuild(tget_smoke(name), device="cpu")
        assert isinstance(smoke, EncDecLM) == get_config(name).is_encdec
    with pytest.raises(KeyError):
        get_config("gpt-2")


@pytest.mark.parametrize("arch", list(MODELS))
def test_port_decode_matches_forward(arch):
    """The reference's ``test_decode_matches_forward`` on the port alone: a
    prefill of S tokens and four decode steps end at the logits of a prefill
    of all S + 4 (float32; MoE at drop-free capacity, so both paths route
    alike), within 2e-3 of the largest logit."""
    cfg = dataclasses.replace(tget_smoke(arch), compute_dtype="float32")
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts / cfg.top_k))
    model = tbuild(cfg, device="cpu", seed=1)
    b, s, extra = 2, 64, 4
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (b, s + extra)))
    want, _ = model.prefill({"tokens": toks}, s + 16)
    logits, cache = model.prefill({"tokens": toks[:, :s]}, s + 16)
    for t in range(s, s + extra):
        logits, cache = model.decode_step(cache, toks[:, t:t + 1], t)
    err = float((logits - want).abs().max())
    assert err / (float(want.abs().max()) + 1e-9) < 2e-3, (arch, err)


def test_attn_moe_pattern_maps_units_to_layers():
    """llama4's ``("attn", "moe")`` pattern, two units and an ``attn`` tail:
    unit ``u``'s ``b1`` (the MoE layer) lands at layer ``2u + 1``, and the
    port's float32 prefill and a decode step match the reference's."""
    jcfg, tcfg = configs("llama4-maverick-400b-a17b", "float32")
    change = dict(block_pattern=("attn", "moe"), n_layers=5)
    jcfg, tcfg = dataclasses.replace(jcfg, **change), dataclasses.replace(tcfg, **change)
    jmodel = jbuild(jcfg)
    params = jmodel.init(jax.random.PRNGKey(2))
    tree = jax.tree.map(np.asarray, params)
    state = params_from_reference(tcfg, tree)
    assert layer_kinds(tcfg) == ["attn", "moe", "attn", "moe", "attn"]
    for u in range(2):
        np.testing.assert_array_equal(state[f"layers.{2 * u + 1}.moe.expert_up"].numpy(),
                                      tree["units"]["b1"]["moe"]["expert_up"][u])
        assert f"layers.{2 * u}.mlp.w_up" in state
    model = port_model(tcfg, tree)
    toks = np.random.default_rng(8).integers(0, jcfg.vocab, (2, 24)).astype(np.int32)
    jl, jc = jmodel.prefill(params, {"tokens": jnp.asarray(toks)}, 32)
    tl, tc = model.prefill({"tokens": torch.from_numpy(toks)}, 32)
    close(tl, jl, 1e-4)
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    jl, _ = jmodel.decode_step(params, jc, jnp.asarray(nxt), jnp.asarray(24, jnp.int32))
    tl, _ = model.decode_step(tc, torch.from_numpy(nxt), 24)
    close(tl, jl, 1e-4)


def test_hybrid_pattern_maps_units_and_tail_to_layers():
    """recurrentgemma's ``("rglru", "rglru", "local")`` unit and its
    ``("rglru", "rglru")`` tail: unit ``u``'s ``b{i}`` lands at layer ``3u +
    i`` and the tail's ``b{i}`` after the units, each float32 leaf
    (``w_a``, ``lambda_``, …) carried bit for bit and kept float32 by the
    bf16 model."""
    jcfg, tcfg = configs("recurrentgemma-9b", "bfloat16")
    change = dict(n_layers=8)  # two units and a two-layer tail
    jcfg, tcfg = dataclasses.replace(jcfg, **change), dataclasses.replace(tcfg, **change)
    tree = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(4)))
    state = params_from_reference(tcfg, tree)
    assert layer_kinds(tcfg) == ["rglru", "rglru", "local"] * 2 + ["rglru", "rglru"]
    for u in range(2):
        for i in range(2):
            np.testing.assert_array_equal(state[f"layers.{3 * u + i}.mixer.lambda_"].numpy(),
                                          tree["units"][f"b{i}"]["mixer"]["lambda_"][u])
        assert f"layers.{3 * u + 2}.mixer.wq" in state
    for i in range(2):
        np.testing.assert_array_equal(state[f"layers.{6 + i}.mixer.w_a"].numpy(),
                                      tree["tail"][f"b{i}"]["mixer"]["w_a"])
    model = port_model(tcfg, tree)
    mixer = model.layers[7].mixer
    assert mixer.w_a.dtype == torch.float32 and mixer.w_branch.dtype == torch.bfloat16
    assert torch.equal(mixer.w_a, state["layers.7.mixer.w_a"])


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "ln2"])
def test_converter_refuses_a_recurrent_tree_that_does_not_match(fault):
    jcfg, tcfg = configs("mamba2-1.3b", "float32")
    tree = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))
    params_from_reference(tcfg, tree)  # the tree as it comes is accepted
    mixer = tree["units"]["b0"]["mixer"]
    if fault == "missing":
        del mixer["dt_bias"]
    elif fault == "extra":
        mixer["d_skip_2"] = mixer["d_skip"]
    elif fault == "shape":
        mixer["conv_kernel"] = mixer["conv_kernel"][:, 1:]
    else:  # an ssd layer has no ln2
        tree["units"]["b0"]["ln2"] = {"scale": tree["units"]["b0"]["ln1"]["scale"]}
    with pytest.raises(ValueError):
        params_from_reference(tcfg, tree)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "experts"])
def test_converter_refuses_a_moe_tree_that_does_not_match(fault):
    jcfg, tcfg = configs("qwen3-moe-235b-a22b", "float32")
    tree = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))
    params_from_reference(tcfg, tree)  # the tree as it comes is accepted
    moe = tree["units"]["b0"]["moe"]
    if fault == "missing":
        del moe["expert_up"]
    elif fault == "extra":
        moe["shared_expert"] = moe["expert_up"]
    elif fault == "shape":
        moe["expert_down"] = moe["expert_down"][:, :, :, :-1]
    else:  # one expert fewer
        moe["expert_gate"] = moe["expert_gate"][:, 1:]
    with pytest.raises(ValueError):
        params_from_reference(tcfg, tree)
