"""The port's decoder against the JAX package's, on the CPU.

The reference's ``DecoderLM(cfg).init(PRNGKey(0))`` goes to numpy and,
through ``params_from_reference``, into the port; both packages then serve
the same tokens:

* float32 compute: prefill logits and every layer's KV cache within 1e-4,
  then six ``decode_step``s (fed the reference's greedy tokens) within 1e-4
  — the two sum in other orders (einsum vs matmul, a loop vs ``lax.scan``);
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
  40-token prompt, longer than the window, so the ring buffer wraps) and
  the two QKV-bias decoders, ``qwen1.5-110b-smoke`` (4 layers, 8 / 2 heads;
  a 72-token prompt) and ``internlm2-20b-smoke`` (3 layers, 6 / 3 heads; a
  48-token prompt);
* the converter refuses a tree with a leaf missing or left over.
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
          "internlm2-20b": 48}  # arch -> prompt length
BATCH = 2
DECODE_STEPS = 6
TOL = {"float32": 1e-4, "bfloat16": 5e-2}  # prefill logits
DECODE_TOL = {"float32": 1e-4, "bfloat16": 1e-1}  # decode logits, KV caches


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
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module", params=[(a, d) for a in MODELS for d in TOL],
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
        want = ref_cache_layer(jc, cfg, idx)
        for name in ("k", "v"):
            assert tuple(tc[idx][name].shape) == want[name].shape, (idx, name)
            assert tc[idx][name].dtype == getattr(torch, served["dtype"])
            close(tc[idx][name], want[name], tol)


def test_decode_steps_match(served):
    cfg = served["cfg"]
    tol = DECODE_TOL[served["dtype"]]
    for jl, tl, jc, tc in served["steps"][1:]:
        close(tl, jl, tol)
        if served["dtype"] == "float32":
            for idx in range(cfg.n_layers):
                want = ref_cache_layer(jc, cfg, idx)
                close(tc[idx]["k"], want["k"], 1e-4)
                close(tc[idx]["v"], want["v"], 1e-4)


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


@pytest.mark.parametrize("change,item", [
    (dict(block_pattern=("moe",), n_experts=4, top_k=2), "8.3"),
    (dict(block_pattern=("ssd",)), "8.4"),
    (dict(block_pattern=("rglru",)), "8.5"),
    (dict(mrope=True), "8.6"),
    (dict(embed_inputs=False), "8.6"),
    (dict(n_enc_layers=2), "8.7"),
])
def test_unported_kinds_raise_naming_their_item(change, item):
    cfg = dataclasses.replace(tget_smoke("qwen3-8b"), **change)
    assert isinstance(cfg, ArchConfig)
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        tbuild(cfg, device="cpu")


def test_loss_and_other_architectures_raise():
    from repro_torch.configs import ARCH_NAMES, get_config

    model = tbuild(tget_smoke("qwen3-8b"), device="cpu")
    with pytest.raises(NotImplementedError, match="8.9"):
        model.loss({})
    for name in ARCH_NAMES:
        if name in MODELS:
            assert get_config(name).name == name
            continue
        with pytest.raises(NotImplementedError, match="item 8"):
            get_config(name)
