"""int8 serving weights of the port against the JAX package's, on the CPU.

* ``quantize_weight`` is bit-equal to the reference's (``q`` int8 and ``s``
  bf16 bits) on seeded weights, on a weight with an all-zero column (its
  scale is the 1e-12 floor) and on exact ``.5`` ties (``round`` half to
  even in both);
* ``quantize_for_serving`` quantizes the same leaves as the reference's and
  rounds every other float weight to bf16 values: the port's state after
  quantizing equals the reference's quantized tree carried across by
  ``params_from_reference``, bit for bit — an MoE layer's router and expert
  tensors too, which stay float weights (rounded to bf16 values), not
  records, as in the reference, and the RG-LRU's gates (``w_a``, ``w_x``,
  ``b_a``, ``b_x``: float32 of bf16 values), while ``a_log``, ``dt_bias``,
  ``d_skip`` and ``lambda_`` stay exact;
* the reference's three ``tests/test_quantized_serving.py`` tests side by
  side: ``qwen3-8b``, ``recurrentgemma-9b`` and ``mamba2-1.3b`` int8 close
  to bf16, and the tree-size one on ``qwen1.5-110b``;
* a tree the reference quantized, carried across: float32 prefill logits,
  every layer's cache and six decode steps within 1e-4 of the reference's
  (the two sum in other orders), for ``qwen3-8b``, ``qwen1.5-110b``,
  ``internlm2-20b``, the two MoE decoders and the two recurrent ones;
* ``decode_step`` with a 0-d tensor ``pos`` gives what an int ``pos`` gives;
  the decode products take ``w8_matmul`` (on the CPU its plain version),
  the prefill's the cast;
* the converter refuses an int8 tree with a record missing, left over or of
  the wrong shape.
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
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.lm import DecoderLM  # noqa: E402

ARCHS = ("qwen3-8b", "gemma3-27b", "qwen1.5-110b", "internlm2-20b", "qwen3-moe-235b-a22b",
         "llama4-maverick-400b-a17b", "mamba2-1.3b", "recurrentgemma-9b")
PARITY = {"qwen3-8b": 80, "qwen1.5-110b": 72, "internlm2-20b": 48,
          "qwen3-moe-235b-a22b": 80, "llama4-maverick-400b-a17b": 64,
          "mamba2-1.3b": 72, "recurrentgemma-9b": 40}  # prompt lengths
MOE_NAMES = ("router", "expert_gate", "expert_up", "expert_down")
GATE_NAMES = ("w_a", "w_x", "b_a", "b_x")  # float32 leaves of bf16 values once quantized
EXACT_NAMES = ("a_log", "dt_bias", "d_skip", "lambda_")  # float32, never rounded
BATCH, DECODE_STEPS = 2, 6


def bf16_bits(x) -> np.ndarray:
    """The 16 bits of bf16 values, from a torch or a JAX array."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def assert_same_record(got: TL.QuantizedWeight, want: dict) -> None:
    assert got.q.dtype == torch.int8 and got.s.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(bf16_bits(got.s), bf16_bits(want["s"]))


def weights(case: str) -> np.ndarray:
    rng = np.random.default_rng(0)
    if case == "seeded":
        return rng.normal(0, 0.05, (256, 128)).astype(np.float32)
    if case == "zero_column":
        w = rng.normal(0, 0.05, (64, 48)).astype(np.float32)
        w[:, 7] = 0.0
        return w
    # ties: a column whose absmax is 127 has the scale 1.0 exactly, so
    # w / s lands on .5 (and on -.5, 2.5, -3.5) and round goes to even
    w = np.array([[127.0, 0.5, -0.5, 1.5, 2.5, -2.5, -3.5, 126.5]], np.float32).T
    return np.concatenate([w, -2 * w, w / 4], axis=1)


@pytest.mark.parametrize("case", ["seeded", "zero_column", "ties"])
def test_quantize_weight_is_bit_equal(case):
    w = weights(case)
    got = TL.quantize_weight(torch.from_numpy(w))
    want = JL.quantize_weight(jnp.asarray(w))
    assert_same_record(got, want)
    if case == "zero_column":
        assert float(got.s[0, 7]) > 0 and not got.q[:, 7].any()
    if case == "ties":
        assert got.q[1:7, 0].tolist() == [0, 0, 2, 2, -2, -4]


def test_quantize_weight_roundtrip_error():
    """The reference's grid bound, on the port: |cast(q) - w| <= max|w| / 127
    per column, and the dequant equal to the reference's."""
    w = weights("seeded")
    rec = TL.quantize_weight(torch.from_numpy(w))
    deq = TL.cast(rec, torch.float32).numpy()
    col_scale = np.abs(w).max(axis=0)
    assert (np.abs(deq - w) <= col_scale / 127.0 + 1e-7).all()
    want = np.asarray(JL.cast(JL.quantize_weight(jnp.asarray(w)), jnp.float32))
    np.testing.assert_array_equal(deq, want)
    bf = TL.cast(rec, torch.bfloat16)
    np.testing.assert_array_equal(
        bf16_bits(bf), bf16_bits(JL.cast(JL.quantize_weight(jnp.asarray(w)), jnp.bfloat16)))


def reference(arch: str, dtype: str = "float32", key: int = 0):
    jcfg = dataclasses.replace(jget_smoke(arch), compute_dtype=dtype)
    tcfg = dataclasses.replace(tget_smoke(arch), compute_dtype=dtype)
    jmodel = jbuild(jcfg)
    return jcfg, tcfg, jmodel, jmodel.init(jax.random.PRNGKey(key))


def port_model(tcfg, tree, quantized: bool) -> DecoderLM:
    model = DecoderLM(tcfg, device="cpu", seed=0)
    if quantized:
        TL.quantize_for_serving(model)
    model.load_state_dict(params_from_reference(tcfg, tree))
    return model


def numpy_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_for_serving_matches_the_reference(arch):
    """Quantizing the port's model gives, leaf for leaf and bit for bit, the
    reference's quantized tree: the same weights as records, every other
    float weight (embeddings, lm_head, biases, norm scales) rounded to
    bf16."""
    _, tcfg, _, params = reference(arch)
    state = params_from_reference(tcfg, numpy_tree(params))
    model = port_model(tcfg, numpy_tree(params), quantized=False)
    TL.quantize_for_serving(model)
    want = params_from_reference(tcfg, numpy_tree(JL.quantize_for_serving(params)))
    got = model.state_dict()
    assert set(got) == set(want)
    records = [k for k in got if k.endswith(".q")]
    ffn = {"moe": 0, "gelu": 2}.get("moe" if tcfg.n_experts else tcfg.mlp_kind, 3)
    # wq, wk, wv, wo and the FFN's; w_zx and w_out (ssd); w_branch, w_out and
    # the FFN's (rglru)
    per_kind = {"attn": 4 + ffn, "local": 4 + ffn, "moe": 4, "ssd": 2, "rglru": 2 + ffn}
    assert len(records) == sum(per_kind[layer.kind] for layer in model.layers)
    moe = [k for k in got if k.rpartition(".")[2] in MOE_NAMES]
    assert len(moe) == (4 * tcfg.n_layers if tcfg.n_experts else 0)
    for name in moe:  # float weights of bf16 values, not records
        assert got[name].dtype == torch.float32 and got[name].dim() in (2, 3), name
    for name, t in got.items():
        w = want[name].to(t.dtype)
        assert torch.equal(t, w), name
        leaf = name.rpartition(".")[2]
        if leaf in GATE_NAMES + EXACT_NAMES:
            assert t.dtype == torch.float32, name
        if t.is_floating_point() and not name.endswith(".s") and leaf not in EXACT_NAMES:
            assert torch.equal(t, t.to(torch.bfloat16).to(t.dtype)), name  # bf16 values
    for name in (k for k in got if k.rpartition(".")[2] in EXACT_NAMES):
        assert torch.equal(got[name], state[name]), name  # never rounded
    layer = model.layers[0]
    big = {"ssd": "w_zx", "rglru": "w_branch"}.get(layer.kind, "wq")
    assert isinstance(getattr(layer.mixer, big), TL.QuantizedWeight)
    assert layer.ln1.scale.dtype == torch.float32  # the port keeps its dtypes


def test_quantized_decode_close_to_bf16():
    """The reference's test on qwen3-8b, in both packages: int8 prefill
    logits close to bf16 ones (within a quarter of the largest logit, top-1
    agreeing on at least half the rows), and a decode step finite."""
    quantized_close_to_bf16("qwen3-8b")


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-1.3b"])
def test_quantized_recurrent_decode_close_to_bf16(arch):
    """The reference's test on its two recurrent cases, in both packages."""
    quantized_close_to_bf16(arch)


def quantized_close_to_bf16(arch: str) -> None:
    cfg = tget_smoke(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    max_len = 40
    bf16 = DecoderLM(cfg, device="cpu", seed=0)
    l_ref, _ = bf16.prefill({"tokens": torch.from_numpy(toks)}, max_len)
    int8 = TL.quantize_for_serving(DecoderLM(cfg, device="cpu", seed=0))
    l_q, c_q = int8.prefill({"tokens": torch.from_numpy(toks)}, max_len)
    jcfg = jget_smoke(arch)
    jmodel = jbuild(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    jl_ref, _ = jmodel.prefill(params, {"tokens": jnp.asarray(toks)}, max_len)
    jl_q, _ = jmodel.prefill(JL.quantize_for_serving(params), {"tokens": jnp.asarray(toks)},
                             max_len)
    for ref, qd in ((l_ref.numpy(), l_q.numpy()),
                    (np.asarray(jl_ref, np.float32), np.asarray(jl_q, np.float32))):
        assert np.abs(ref - qd).max() / (np.abs(ref).max() + 1e-9) < 0.25
        assert (ref.argmax(-1) == qd.argmax(-1)).mean() >= 0.5
    l2, _ = int8.decode_step(c_q, l_q.argmax(-1)[:, None], torch.tensor(32))
    assert torch.isfinite(l2).all()


def state_bytes(model) -> int:
    return sum(t.numel() * t.element_size() for t in model.state_dict().values())


def test_quantized_tree_is_smaller():
    """The reference's test on qwen1.5-110b: the quantized weights under
    0.45 of the float32 ones, in both packages (the port's float32 model is
    its compute-dtype copy of the reference's master tree)."""
    _, tcfg, _, params = reference("qwen1.5-110b")
    model = port_model(tcfg, numpy_tree(params), quantized=False)
    before = state_bytes(model)
    after = state_bytes(TL.quantize_for_serving(model))
    assert after < 0.45 * before
    size = lambda t: sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(t))  # noqa: E731
    assert size(JL.quantize_for_serving(params)) < 0.45 * size(params)


def ref_cache_layer(cache, cfg, idx: int) -> dict:
    width = len(cfg.block_pattern)
    if idx < cfg.n_units * width:
        u, i = divmod(idx, width)
        return {n: a[u] for n, a in cache["units"][f"b{i}"].items()}
    return cache["tail"][f"b{idx - cfg.n_units * width}"]


def close(got: torch.Tensor, want, tol: float = 1e-4) -> None:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def same_cache(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for name, t in got.items():
        close(t, want[name])


@pytest.mark.parametrize("arch", list(PARITY))
def test_reference_quantized_tree_serves_alike(arch):
    """A tree the reference quantized, carried across: at float32 compute the
    port's prefill logits and caches, then six decode steps (fed the
    reference's greedy tokens) within 1e-4 of the reference's."""
    jcfg, tcfg, jmodel, params = reference(arch)
    qparams = JL.quantize_for_serving(params)
    model = port_model(tcfg, numpy_tree(qparams), quantized=True)
    s = PARITY[arch]
    max_len = s + DECODE_STEPS + 2
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (BATCH, s)).astype(np.int32)
    jl, jc = jax.jit(jmodel.prefill, static_argnums=2)(
        qparams, {"tokens": jnp.asarray(toks)}, max_len)
    tl, tc = model.prefill({"tokens": torch.from_numpy(toks)}, max_len)
    close(tl, jl)
    for idx in range(tcfg.n_layers):
        same_cache(tc[idx], ref_cache_layer(jc, tcfg, idx))
    jdecode = jax.jit(jmodel.decode_step)
    for t in range(DECODE_STEPS):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jc = jdecode(qparams, jc, jnp.asarray(nxt), jnp.asarray(s + t, jnp.int32))
        tl, tc = model.decode_step(tc, torch.from_numpy(nxt), torch.tensor(s + t))
        close(tl, jl)
    for idx in range(tcfg.n_layers):
        same_cache(tc[idx], ref_cache_layer(jc, tcfg, idx))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_decode_step_with_a_tensor_pos_equals_an_int_pos(int8, monkeypatch):
    cfg = tget_smoke("gemma3-27b")  # a ring buffer too: the slot is pos % window
    model = DecoderLM(cfg, device="cpu", seed=2)
    if int8:
        TL.quantize_for_serving(model)
    calls = []
    real = TL.w8_matmul
    monkeypatch.setattr(TL, "w8_matmul", lambda *a: calls.append(a[0].shape) or real(*a))
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (2, 40)))
    _, cache = model.prefill({"tokens": toks}, 48)
    assert not calls  # 80 rows: above W8_DECODE_ROWS, the prefill casts
    twin = [{n: t.clone() for n, t in c.items()} for c in cache]
    for t in range(3):
        a, _ = model.decode_step(cache, toks[:, -1:], 40 + t)
        b, _ = model.decode_step(twin, toks[:, -1:], torch.tensor(40 + t))
        assert torch.equal(a, b)
    for x, y in zip(cache, twin):
        assert torch.equal(x["k"], y["k"]) and torch.equal(x["v"], y["v"])
    assert len(calls) == (2 * 3 * 7 * cfg.n_layers if int8 else 0)
    assert all(shape == (2, shape[1]) for shape in calls)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_converter_refuses_an_int8_tree_that_does_not_match(fault):
    _, tcfg, _, params = reference("qwen3-8b")
    tree = numpy_tree(JL.quantize_for_serving(params))
    params_from_reference(tcfg, tree)  # the tree as it comes is accepted
    rec = tree["units"]["b0"]["mlp"]["w_up"]
    if fault == "missing":
        del rec["s"]
    elif fault == "extra":
        rec["z"] = rec["s"]
    else:
        rec["s"] = rec["s"][:, :, :-1]
    with pytest.raises(ValueError):
        params_from_reference(tcfg, tree)


def per_product(x, ws):
    """What every grouped call site did before groups: a product a weight."""
    return [TL.linear(x, w) for w in ws]


@pytest.mark.parametrize("rows", [8, 80], ids=["decode", "prefill"])  # both sides of 64
@pytest.mark.parametrize("arch", ["qwen3-8b", "qwen1.5-110b"], ids=["no-bias", "qkv-bias"])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_linear_group_equals_its_products(int8, arch, rows, monkeypatch):
    """``linear_group`` against ``[linear(x, w) for w in ws]``, bit for bit on
    the CPU: the group alone (q / k / v and gate / up), then attention's
    projections with their QKV biases (drawn nonzero) and RoPE, and the
    gated FFN, each against the same code with the group replaced by the
    products one at a time."""
    cfg = dataclasses.replace(tget_smoke(arch), compute_dtype="bfloat16")
    model = DecoderLM(cfg, device="cpu", seed=7)
    block = model.layers[0]
    rng = np.random.default_rng(rows)
    with torch.no_grad():
        for name in ("bq", "bk", "bv"):
            if hasattr(block.mixer, name):
                b = getattr(block.mixer, name)
                b.copy_(torch.from_numpy(rng.normal(0, 0.5, b.shape)).to(b.dtype))
    if int8:
        TL.quantize_for_serving(model)
    x = torch.from_numpy(rng.normal(0, 1, (rows // 4, 4, cfg.d_model))).to(torch.bfloat16)
    for ws in ([block.mixer.wq, block.mixer.wk, block.mixer.wv],
               [block.mlp.w_gate, block.mlp.w_up]):
        got, want = TL.linear_group(x, ws), per_product(x, ws)
        assert len(got) == len(want)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    cos, sin = TL.rope_cos_sin(torch.arange(4)[None].expand(rows // 4, 4), block.spec.head_dim,
                               block.spec.rope_theta)
    grouped = (TL._qkv(block.mixer, block.spec, x, cos, sin),
               TL.mlp(block.mlp, x, cfg.mlp_kind))
    monkeypatch.setattr(TL, "linear_group", per_product)
    alone = (TL._qkv(block.mixer, block.spec, x, cos, sin), TL.mlp(block.mlp, x, cfg.mlp_kind))
    assert all(torch.equal(a, b) for a, b in zip(grouped[0], alone[0]))
    assert torch.equal(grouped[1], alone[1])


@pytest.mark.parametrize("records", [0, 5], ids=["empty", "five"])
def test_w8_group_refuses_an_empty_or_oversized_group(records):
    from repro_torch.kernels.w8_matmul import w8_matmul_group

    rec = TL.quantize_weight(torch.ones((16, 16)))
    with pytest.raises(ValueError, match="records"):
        w8_matmul_group(torch.ones((2, 16)), [(rec.q, rec.s)] * records)
