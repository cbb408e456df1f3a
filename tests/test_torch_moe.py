"""The port's MoE block against the JAX package's, on the CPU.

The same weights (the reference's ``init_moe``, carried as numpy) and the
same numpy-seeded inputs go through ``repro.models.layers`` and
``repro_torch.models.layers``:

* ``moe_block`` at float32, drop-free (``capacity_factor = E / k``) and with
  drops (1.0 and 1.25, sized so that slots are dropped): the routing — top-k
  indices, keep mask, destinations — equal exactly to the reference's steps
  (``repro/models/layers.py:560-578``, run here in JAX), the outputs within
  1e-5 of the largest output (the two sum the products in other orders);
* ``moe_block`` at bfloat16: the same routing exactly, the outputs within
  2^-6 of the largest output.  The two frameworks round bf16 at other
  places (XLA on the CPU rounds ``sigmoid(x)`` before ``x * sigmoid(x)``,
  PyTorch rounds ``silu`` once): about one bf16 step (2^-8 relative) on the
  hidden values, which the down product and the sum of a token's ``k``
  rows carry into outputs that cancel towards 0, so the bound is on the
  outputs' scale (largest measured: 2^-6.9 of it);
* the combine alone, bit for bit at bf16 against the reference's
  ``zeros.at[st].add(...)``: a token's rows are added in increasing expert
  order, the order of XLA's scatter-add on the CPU;
* ties: probabilities with exact ties, and a router with equal columns,
  pick the lower expert index, as ``lax.top_k`` does;
* ``moe_aux_loss`` within 1e-6;
* the dense-oracle conservation check of ``tests/test_models.py`` on the
  port (drop-free: the block equals routing every token through its top-k
  experts by hand in numpy, float32 within 1e-5);
* the expert FFN's plain version (``kernels/moe_ffn.py``) against the dense
  einsum in numpy, with counts of 0, 1, cap and mixed: rows past an
  expert's count come out zero, and the two stages compose to the whole.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import moe_ffn as MF  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

D, F_, E = 32, 16, 8


def specs(top_k: int, cf: float):
    return (JL.MoESpec(d_model=D, d_ff=F_, n_experts=E, top_k=top_k, capacity_factor=cf),
            TL.MoESpec(D, F_, E, top_k, cf))


def port_moe(params, dtype=torch.float32) -> TL.MoE:
    e, d, f = np.shape(params["expert_gate"])
    m = TL.MoE(TL.MoESpec(d, f, e, 1), torch.float32)
    with torch.no_grad():
        for name in ("router", "expert_gate", "expert_up", "expert_down"):
            getattr(m, name).copy_(torch.from_numpy(np.array(params[name], np.float32)))
    return m.to(dtype)


def ref_routing(probs, k: int, n_experts: int, cap: int) -> dict:
    """The reference's routing steps (layers.py:560-578, one device: every
    expert is local), in JAX."""
    t = probs.shape[0]
    gate, idx = lax.top_k(probs, k)
    slot_expert = idx.reshape(t * k)
    order = jnp.argsort(slot_expert, stable=True)
    se = slot_expert[order]
    seg_start = jnp.searchsorted(se, jnp.arange(n_experts))
    rank = jnp.arange(t * k) - seg_start[jnp.minimum(se, n_experts - 1)]
    keep = (rank < cap) & (se < n_experts)
    dest = jnp.where(keep, se * cap + rank, n_experts * cap)
    return {"idx": np.asarray(idx), "keep": np.asarray(keep), "dest": np.asarray(dest),
            "order": np.asarray(order)}


def both(top_k: int, cf: float, dtype: str, shape=(4, 32), seed=0, params=None):
    """One MoE layer through both packages: the reference's and the port's
    outputs, the port's routing and the reference's."""
    jspec, tspec = specs(top_k, cf)
    if params is None:
        params = JL.init_moe(jax.random.PRNGKey(seed), jspec)
    model = port_moe(params, getattr(torch, dtype))
    x = np.random.default_rng(seed).normal(0, 1, (*shape, D)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(JL.moe_block(params, jspec, jx).astype(jnp.float32))
    got = TL.moe_block(model, tspec, tx).float().numpy()
    t = shape[0] * shape[1]
    cap = TL.moe_capacity(tspec, t)
    assert cap == max(math.ceil(cf * top_k * t / E), 4)
    jlogits = (jx.reshape(t, D) @ JL.cast(params["router"], jx.dtype)).astype(jnp.float32)
    ref = ref_routing(jax.nn.softmax(jlogits, axis=-1), top_k, E, cap)
    probs = torch.softmax(TL.linear(tx.reshape(t, D), model.router).float(), dim=-1)
    return want, got, TL.moe_route(tspec, probs, E, 0, cap), ref, cap


def assert_same_routing(r: TL.Routing, ref: dict, cap: int) -> None:
    np.testing.assert_array_equal(r.idx.numpy(), ref["idx"])
    np.testing.assert_array_equal(r.order.numpy(), ref["order"])
    np.testing.assert_array_equal(r.keep.numpy(), ref["keep"])
    np.testing.assert_array_equal(r.dest.numpy(), ref["dest"])
    # the kernel's counts: the kept slots of each expert
    kept = np.bincount(ref["dest"][ref["keep"]] // cap, minlength=E)
    np.testing.assert_array_equal(r.count.numpy(), kept)


CAPACITY = {"drop_free": E / 2, "cf1.0": 1.0, "cf1.25": 1.25}


@pytest.mark.parametrize("case", list(CAPACITY))
def test_moe_block_matches_reference_float32(case):
    cf = CAPACITY[case]
    want, got, r, ref, cap = both(2, cf, "float32")
    assert_same_routing(r, ref, cap)
    dropped = int((~r.keep).sum())
    assert (dropped == 0) if case == "drop_free" else (dropped > 0), (case, dropped)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("case", list(CAPACITY))
def test_moe_block_matches_reference_bfloat16(case):
    want, got, r, ref, cap = both(2, CAPACITY[case], "bfloat16")
    assert_same_routing(r, ref, cap)
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -6 * np.abs(want).max())


@pytest.mark.parametrize("top_k", [1, 4])
def test_moe_block_other_top_k(top_k):
    """top-1 (llama4's) and top-4 with drops, float32."""
    want, got, r, ref, cap = both(top_k, 1.0, "float32", shape=(2, 40), seed=3)
    assert_same_routing(r, ref, cap)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_is_the_reference_scatter_add(dtype):
    """The combine alone, on the same rows and routing: bit-equal to the
    reference's ``zeros.at[st].add(where(keep, out[dest], 0) * sg)``."""
    rng = np.random.default_rng(1)
    t, k, cap = 64, 4, 20
    probs = rng.random((t, E)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    r = TL.moe_route(TL.MoESpec(D, F_, E, k, 1.0), torch.from_numpy(probs), E, 0, cap)
    assert 0 < int(r.keep.sum()) < t * k  # some slots dropped
    out = rng.normal(0, 1, (E * cap, D)).astype(np.float32)
    got = TL.moe_combine(torch.from_numpy(out).to(getattr(torch, dtype)), r, t)
    jo = jnp.asarray(out).astype(dtype)
    dest, keep = jnp.asarray(r.dest.numpy()), jnp.asarray(r.keep.numpy())
    gathered = jnp.where(keep[:, None], jo.at[dest].get(mode="fill", fill_value=0), 0)
    want = jnp.zeros((t, D), jo.dtype).at[jnp.asarray(r.st.numpy())].add(
        gathered * jnp.asarray(r.sg.numpy())[:, None].astype(jo.dtype))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_exact_ties_pick_the_lower_expert():
    """Probabilities with exact ties across the k-th place: the port's top-k
    is ``lax.top_k``'s, lower index first."""
    probs = np.full((6, E), 0.05, np.float32)
    probs[:, [2, 5, 6]] = 0.2  # three tied leaders for two places
    probs[3, 7] = 0.3
    probs[4] = 0.125  # all eight tied
    ref = ref_routing(jnp.asarray(probs), 2, E, 4)
    r = TL.moe_route(TL.MoESpec(D, F_, E, 2), torch.from_numpy(probs), E, 0, 4)
    assert_same_routing(r, ref, 4)
    assert r.idx[0].tolist() == [2, 5] and r.idx[3].tolist() == [7, 2]
    assert r.idx[4].tolist() == [0, 1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_with_equal_columns_routes_alike(dtype):
    """A router whose columns 2, 5 and 6 are equal (and large, so they lead
    for most tokens): both packages choose 2 and 5, never 6."""
    jspec, _ = specs(2, 1.25)
    params = JL.init_moe(jax.random.PRNGKey(4), jspec)
    router = np.array(params["router"])
    router[:, [5, 6]] = router[:, [2]]
    router[:, [2, 5, 6]] *= 4.0
    params = {**params, "router": jnp.asarray(router)}
    want, got, r, ref, cap = both(2, 1.25, dtype, params=params)
    assert_same_routing(r, ref, cap)
    assert not (r.idx == 6).any() and (r.idx == 5).any()
    atol = (1e-5 if dtype == "float32" else 2.0 ** -6) * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_moe_aux_loss_matches_reference():
    jspec, tspec = specs(2, 1.25)
    params = JL.init_moe(jax.random.PRNGKey(2), jspec)
    x = np.random.default_rng(2).normal(0, 1, (3, 16, D)).astype(np.float32)
    want = float(JL.moe_aux_loss(params, jspec, jnp.asarray(x)))
    got = TL.moe_aux_loss(port_moe(params), tspec, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= 1e-6 * abs(want)


def test_moe_dispatch_conservation():
    """tests/test_models.py's check on the port: with drop-free capacity the
    block equals the dense oracle, every token routed through its top-k
    experts by hand (float32 within 1e-5 of the largest output)."""
    spec = TL.MoESpec(d_model=32, d_ff=16, n_experts=4, top_k=2, capacity_factor=2.0)
    gen = torch.Generator().manual_seed(0)
    params = TL.init_moe(gen, TL.MoE(spec, torch.float32))
    x = np.random.default_rng(0).normal(0, 1, (2, 8, 32)).astype(np.float32)
    out = TL.moe_block(params, spec, torch.from_numpy(x)).numpy()
    xt = x.reshape(16, 32)
    router, wg, wu, wd = (getattr(params, n).numpy() for n in (
        "router", "expert_gate", "expert_up", "expert_down"))
    logits = xt @ router
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    idx = np.argsort(-probs, axis=-1)[:, :2]
    expect = np.zeros_like(xt)
    for t in range(16):
        g = probs[t, idx[t]]
        g = g / g.sum()
        for j, e in enumerate(idx[t]):
            h = xt[t] @ wg[e]
            h = h / (1 + np.exp(-h)) * (xt[t] @ wu[e])
            expect[t] += g[j] * (h @ wd[e])
    np.testing.assert_allclose(out.reshape(16, 32), expect, rtol=0,
                               atol=1e-5 * np.abs(expect).max())


def test_init_moe_draws_the_reference_scales():
    spec = TL.MoESpec(d_model=64, d_ff=96, n_experts=20, top_k=2)  # 20: two init slices
    m = TL.init_moe(torch.Generator().manual_seed(1), TL.MoE(spec, torch.float32))
    for name, fan_in in (("router", 64), ("expert_gate", 64), ("expert_up", 64),
                         ("expert_down", 96)):
        std = float(getattr(m, name).std())
        assert abs(std * math.sqrt(fan_in) - 1) < 0.05, (name, std)
    assert not torch.equal(m.expert_gate[0], m.expert_gate[16])  # slices drawn apart
    assert tuple(m.expert_down.shape) == (20, 96, 64)


def ffn_inputs(e=5, cap=6, d=24, f=16, seed=0):
    rng = np.random.default_rng(seed)
    buf = rng.normal(0, 1, (e, cap, d)).astype(np.float32)
    ws = [rng.normal(0, s, shape).astype(np.float32)
          for s, shape in ((d ** -0.5, (e, d, f)), (d ** -0.5, (e, d, f)), (f ** -0.5, (e, f, d)))]
    return buf, ws


COUNTS = {"zero": [0] * 5, "one": [1] * 5, "cap": [6] * 5, "mixed": [0, 1, 6, 3, 0]}


@pytest.mark.parametrize("counts", list(COUNTS))
def test_plain_expert_ffn_matches_the_dense_einsum(counts):
    """``moe_ffn`` on CPU tensors (the plain version) against numpy's dense
    einsum on each expert's kept rows; rows past the count are zero whatever
    ``buf`` holds there, and the stages compose to the whole."""
    buf, (wg, wu, wd) = ffn_inputs()
    count = np.array(COUNTS[counts], np.int64)
    t = [torch.from_numpy(a) for a in (buf, wg, wu, wd)]
    got = MF.moe_ffn(t[0], torch.from_numpy(count), *t[1:])
    kept = buf * (np.arange(buf.shape[1])[None, :] < count[:, None])[..., None]
    g = np.einsum("ecd,edf->ecf", kept, wg)
    h = g / (1 + np.exp(-g)) * np.einsum("ecd,edf->ecf", kept, wu)
    want = np.einsum("ecf,efd->ecd", h, wd)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * max(np.abs(want).max(), 1))
    for e, n in enumerate(count):
        assert not got[e, n:].any()
    staged = MF.moe_down(MF.moe_gate_up(t[0], torch.from_numpy(count), t[1], t[2]),
                         torch.from_numpy(count), t[3])
    assert torch.equal(staged, got)


def test_dispatch_takes_the_ffn_path_by_capacity(monkeypatch):
    """A capacity up to ``MOE_DECODE_ROWS`` goes to ``moe_ffn`` (the kernel on
    the card), a larger one to the dense form; on the same buffer the two
    give the same outputs bit for bit."""
    spec = TL.MoESpec(D, F_, E, 2, capacity_factor=1.25)
    model = TL.init_moe(torch.Generator().manual_seed(5), TL.MoE(spec, torch.float32))
    calls = []
    real = TL.moe_ffn
    monkeypatch.setattr(TL, "moe_ffn", lambda *a: calls.append(a[0].shape[1]) or real(*a))
    x = torch.from_numpy(np.random.default_rng(5).normal(0, 1, (2, 27, D)).astype(np.float32))
    caps = [TL.moe_capacity(spec, 2 * s) for s in (2, 20, 27)]
    assert caps == [4, 13, 17] and caps[-1] > TL.MOE_DECODE_ROWS
    ffn = [TL.moe_block(model, spec, x[:, :s]) for s in (2, 20, 27)]
    assert calls == caps[:2]  # 17 rows an expert: the dense form
    monkeypatch.setattr(TL, "MOE_DECODE_ROWS", 0)  # everything dense
    for s, want in zip((2, 20), ffn):
        assert torch.equal(TL.moe_block(model, spec, x[:, :s]), want)
    assert calls == caps[:2]
