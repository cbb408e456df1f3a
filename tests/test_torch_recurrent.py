"""The port's recurrent layers against the JAX package's, on the CPU.

The same seeded numpy inputs and the reference's own weights
(``repro.models.layers.init_ssd`` / ``init_rglru``, carried into the
port's modules) go through both packages:

* ``causal_conv1d`` with and without a state;
* ``ssd_block`` (S a chunk multiple and not one, so the last chunk is
  padded; with ``return_state``: the conv state of the last valid inputs
  and the SSM state) and ``ssd_decode``;
* ``rglru_block`` (with its state) and ``rglru_decode``;

at float32 within 1e-4, and at bf16 compute within ``BF16_TOL`` of the
largest output (2^-5: a few bf16 steps, since the two frameworks round bf16
activations at other places — XLA on the CPU after each elementwise op,
PyTorch once a fused op; largest measured 2^-6.3 of the largest output).
Then each package's own chunked form against its sequential decode (the
reference's ``test_ssd_matches_sequential_recurrence`` and
``test_rglru_matches_sequential_recurrence``, 2e-3), the scan's plain
version against ``jax.lax.associative_scan`` (the reference's association;
largest difference measured 4.8e-7), the init constants, the decode writing its state in
place, and the refusal of a conv state the step cannot write in place.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_torch  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

SSD_SPEC = dict(d_model=32, d_state=8, head_dim=8, expand=2, chunk=16)
RGLRU_SPEC = dict(d_model=32, lru_width=48)
DTYPES = {"float32": 1e-4, "bfloat16": None}
BF16_TOL = 2.0 ** -5  # of the largest output: see the module docstring
SEQ_TOL = 2e-3  # chunked against sequential: the reference's tolerance


def to_torch(tree, dtype):
    """The reference's parameter dict as a ``state_dict``: float32 leaves as
    numpy-made float32 tensors (``load_state_dict`` casts the compute-dtype
    ones)."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update({f"{name}.{k}": v for k, v in to_torch(leaf, dtype).items()})
        else:
            out[name] = torch.from_numpy(np.array(leaf, np.float32))
    return out


def ssd_pair(dtype="float32", key=2):
    jspec, tspec = JL.SSDSpec(**SSD_SPEC), TL.SSDSpec(**SSD_SPEC)
    jparams = JL.init_ssd(jax.random.PRNGKey(key), jspec)
    module = TL.SSD(tspec, getattr(torch, dtype))
    module.load_state_dict(to_torch(jparams, dtype))
    return jspec, jparams, tspec, module


def rglru_pair(dtype="float32", key=3):
    jspec, tspec = JL.RGLRUSpec(**RGLRU_SPEC), TL.RGLRUSpec(**RGLRU_SPEC)
    jparams = JL.init_rglru(jax.random.PRNGKey(key), jspec)
    module = TL.RGLRU(tspec, getattr(torch, dtype))
    module.load_state_dict(to_torch(jparams, dtype))
    return jspec, jparams, tspec, module


def inputs(shape, dtype, seed=0, scale=0.5):
    x = np.random.default_rng(seed).normal(0, scale, shape).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    return jx, torch.from_numpy(x).to(getattr(torch, dtype))


def close(got, want, dtype) -> float:
    """``got`` within the dtype's tolerance of ``want``; the largest error."""
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    tol = DTYPES[dtype] or BF16_TOL * float(np.abs(want).max())
    assert err <= tol, (err, tol)
    return err


# ------------------------------------------------------------- the conv
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("with_state", [False, True], ids=["no_state", "state"])
def test_causal_conv1d_matches_reference(dtype, with_state):
    jx, tx = inputs((2, 9, 12), dtype, seed=1)
    jk, tk = inputs((4, 12), "float32", seed=2)
    js = ts = None
    if with_state:
        js, ts = inputs((2, 3, 12), dtype, seed=3)
    jy, jstate = JL.causal_conv1d(jx, jk, js)
    ty, tstate = TL.causal_conv1d(tx, tk.to(tx.dtype), ts)
    assert ty.dtype == tx.dtype and tstate.dtype == tx.dtype
    close(ty, jy, dtype)
    close(tstate, jstate, dtype)


def test_causal_conv1d_promotes_as_concatenate():
    """A bf16 state and a float32 input concatenate to float32 in both."""
    jx, tx = inputs((2, 1, 12), "float32", seed=1)
    jk, tk = inputs((4, 12), "float32", seed=2)
    js, ts = inputs((2, 3, 12), "bfloat16", seed=3)
    jy, jstate = JL.causal_conv1d(jx, jk, js)
    ty, tstate = TL.causal_conv1d(tx, tk, ts)
    assert tstate.dtype == torch.float32 and jstate.dtype == jnp.float32
    close(ty, jy, "float32")


# ---------------------------------------------------------------- Mamba-2
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("seq", [48, 41], ids=["chunks", "padded"])
def test_ssd_block_matches_reference(dtype, seq):
    jspec, jparams, tspec, module = ssd_pair(dtype)
    jx, tx = inputs((2, seq, 32), dtype)
    jout, jstate = JL.ssd_block(jparams, jspec, jx, return_state=True)
    tout, tstate = TL.ssd_block(module, tspec, tx, return_state=True)
    assert tout.dtype == tx.dtype
    close(tout, jout, dtype)
    assert set(tstate) == set(jstate) == {"conv", "ssm"}
    for name in tstate:
        assert str(tstate[name].dtype)[6:] == str(jstate[name].dtype), name
        close(tstate[name], jstate[name], dtype)
    close(TL.ssd_block(module, tspec, tx), jout, dtype)  # without return_state


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssd_decode_matches_reference(dtype):
    jspec, jparams, tspec, module = ssd_pair(dtype)
    jx, tx = inputs((2, 20, 32), dtype)
    _, jstate = JL.ssd_block(jparams, jspec, jx, return_state=True)
    _, tstate = TL.ssd_block(module, tspec, tx, return_state=True)
    for t in range(3):
        jstep, tstep = inputs((2, 1, 32), dtype, seed=10 + t)
        jout, jstate = JL.ssd_decode(jparams, jspec, jstep, jstate)
        tout, tstate = TL.ssd_decode(module, tspec, tstep, tstate)
        close(tout, jout, dtype)
        for name in ("conv", "ssm"):
            close(tstate[name], jstate[name], dtype)


def test_port_ssd_chunked_matches_sequential():
    """The reference's ``test_ssd_matches_sequential_recurrence`` on the
    port: the chunked block against ``ssd_decode`` step by step from the
    zero state (its conv cast to float32 first, as the reference's test
    does), within 2e-3."""
    _, _, tspec, module = ssd_pair()
    _, x = inputs((2, 48, 32), "float32", seed=2)
    chunked = TL.ssd_block(module, tspec, x)
    state = TL.init_ssd_state(tspec, 2)
    state["conv"] = state["conv"].float()
    outs = [TL.ssd_decode(module, tspec, x[:, t:t + 1], state)[0] for t in range(48)]
    torch.testing.assert_close(chunked, torch.cat(outs, dim=1), rtol=SEQ_TOL, atol=SEQ_TOL)


# ----------------------------------------------------------------- RG-LRU
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rglru_block_matches_reference(dtype):
    jspec, jparams, tspec, module = rglru_pair(dtype)
    jx, tx = inputs((2, 40, 32), dtype)
    jout, jstate = JL.rglru_block(jparams, jspec, jx, return_state=True)
    tout, tstate = TL.rglru_block(module, tspec, tx, return_state=True)
    assert tout.dtype == tx.dtype
    close(tout, jout, dtype)
    assert set(tstate) == set(jstate) == {"conv", "h"}
    for name in tstate:
        assert str(tstate[name].dtype)[6:] == str(jstate[name].dtype), name
        close(tstate[name], jstate[name], dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rglru_decode_matches_reference(dtype):
    jspec, jparams, tspec, module = rglru_pair(dtype)
    jx, tx = inputs((2, 12, 32), dtype)
    _, jstate = JL.rglru_block(jparams, jspec, jx, return_state=True)
    _, tstate = TL.rglru_block(module, tspec, tx, return_state=True)
    for t in range(3):
        jstep, tstep = inputs((2, 1, 32), dtype, seed=10 + t)
        jout, jstate = JL.rglru_decode(jparams, jspec, jstep, jstate)
        tout, tstate = TL.rglru_decode(module, tspec, tstep, tstate)
        close(tout, jout, dtype)
        for name in ("conv", "h"):
            close(tstate[name], jstate[name], dtype)


def test_port_rglru_scan_matches_sequential():
    """The reference's ``test_rglru_matches_sequential_recurrence`` on the
    port: the block (the scan) against ``rglru_decode`` step by step, within
    2e-3."""
    _, _, tspec, module = rglru_pair()
    _, x = inputs((2, 40, 32), "float32", seed=3)
    scanned = TL.rglru_block(module, tspec, x)
    state = TL.init_rglru_state(tspec, 2)
    state["conv"] = state["conv"].float()
    outs = [TL.rglru_decode(module, tspec, x[:, t:t + 1], state)[0] for t in range(40)]
    torch.testing.assert_close(scanned, torch.cat(outs, dim=1), rtol=SEQ_TOL, atol=SEQ_TOL)


def scan_inputs(b, s, w, seed=4):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 1.0, (b, s, w)).astype(np.float32)
    x = rng.normal(0, 1, (b, s, w)).astype(np.float32)
    return a, x


@pytest.mark.parametrize("shape", [(2, 1, 5), (3, 64, 33), (1, 257, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_scan_matches_associative_scan(shape):
    """The plain version against the reference's ``lax.associative_scan``
    of the same combine: equal to float32 rounding (the association
    differs), and bit-equal to a numpy float32 loop in the same order."""
    a, x = scan_inputs(*shape)

    def combine(e1, e2):
        return e1[0] * e2[0], e2[0] * e1[1] + e2[1]

    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(x)), axis=1)
    got = rglru_scan(torch.from_numpy(a), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    h, loop = np.zeros_like(a[:, 0]), np.empty_like(a)
    for t in range(a.shape[1]):
        h = (a[:, t] * h).astype(np.float32) + x[:, t]
        loop[:, t] = h
    np.testing.assert_array_equal(got.numpy(), loop)


def test_scan_refuses_what_the_kernel_refuses():
    a, x = (torch.from_numpy(t) for t in scan_inputs(1, 4, 3))
    with pytest.raises(ValueError, match="float32"):
        rglru_scan_torch(a.double(), x)
    with pytest.raises(ValueError, match="one shape"):
        rglru_scan(a, x[:, :2])


# ---------------------------------------------------- init and the state
def test_init_constants_match_the_reference():
    """``init_ssd`` sets the reference's constants (``a_log``, ``dt_bias``,
    ``d_skip``, the norm) and scales; ``init_rglru`` draws ``lambda_`` as
    the reference does, ``sigmoid(Λ)^c = u`` in [0.9², 0.999²] (what the
    reference's draw gives; its comment says [0.9, 0.999]), with zero biases;
    the constant and gate leaves are float32 at bf16 compute."""
    jspec = JL.SSDSpec(d_model=64, d_state=16, head_dim=16)
    jssd = JL.init_ssd(jax.random.PRNGKey(0), jspec)
    gen = torch.Generator().manual_seed(0)
    ssd = TL.init_ssd(gen, TL.SSD(TL.SSDSpec(d_model=64, d_state=16, head_dim=16),
                                  torch.bfloat16))
    for name in ("a_log", "dt_bias", "d_skip"):
        got = getattr(ssd, name)
        assert got.dtype == torch.float32, name
        np.testing.assert_allclose(got.numpy(), np.asarray(jssd[name]), rtol=1e-6, atol=0)
    assert not ssd.norm.scale.any()
    conv_ch = jspec.d_inner + 2 * jspec.d_state
    for got, scale in ((ssd.conv_kernel, conv_ch ** -0.5), (ssd.w_zx, 64 ** -0.5),
                       (ssd.w_out, jspec.d_inner ** -0.5)):
        assert abs(float(got.float().std()) / scale - 1) < 0.15

    jrg = JL.init_rglru(jax.random.PRNGKey(0), JL.RGLRUSpec(d_model=64, lru_width=256))
    rg = TL.init_rglru(gen, TL.RGLRU(TL.RGLRUSpec(d_model=64, lru_width=256),
                                     torch.bfloat16))
    for lam in (torch.from_numpy(np.array(jrg["lambda_"])), rg.lambda_):
        a = torch.sigmoid(lam.double()) ** 8.0
        assert float(a.min()) >= 0.9**2 - 1e-5 and float(a.max()) <= 0.999**2 + 1e-5
        assert float(a.max()) > 0.95 and float(a.min()) < 0.85  # the whole range
    for name in ("w_a", "b_a", "w_x", "b_x", "lambda_"):
        assert getattr(rg, name).dtype == torch.float32, name
    assert rg.w_branch.dtype == rg.w_out.dtype == rg.conv_kernel.dtype == torch.bfloat16
    assert not rg.b_a.any() and not rg.b_x.any()
    for got, scale in ((rg.conv_kernel, 256 ** -0.5), (rg.w_a, 256 ** -0.5),
                       (rg.w_branch, 64 ** -0.5)):
        assert abs(float(got.float().std()) / scale - 1) < 0.15


@pytest.mark.parametrize("kind", ["ssd", "rglru"])
def test_decode_writes_its_state_in_place(kind):
    """A decode step writes the new state into the tensors it was handed
    (the same ``data_ptr``, a CUDA graph's addresses) and returns that
    dict; the values are the step's."""
    if kind == "ssd":
        _, _, spec, module = ssd_pair()
        block, decode, width = TL.ssd_block, TL.ssd_decode, 32
    else:
        _, _, spec, module = rglru_pair()
        block, decode, width = TL.rglru_block, TL.rglru_decode, 32
    _, x = inputs((2, 10, width), "float32")
    _, state = block(module, spec, x, return_state=True)
    ptrs = {n: t.data_ptr() for n, t in state.items()}
    before = {n: t.clone() for n, t in state.items()}
    twin = {n: t.clone() for n, t in state.items()}
    _, step = inputs((2, 1, width), "float32", seed=9)
    out, new = decode(module, spec, step, state)
    assert new is state
    assert {n: t.data_ptr() for n, t in state.items()} == ptrs
    assert all(not torch.equal(state[n], before[n]) for n in state)
    again, twin = decode(module, spec, step, twin)
    assert torch.equal(out, again)
    assert all(torch.equal(state[n], twin[n]) for n in state)


@pytest.mark.parametrize("kind", ["ssd", "rglru"])
def test_decode_refuses_a_conv_state_it_cannot_write(kind):
    """At float32 compute the zero state's bf16 ``conv`` would have to
    become float32 (the reference returns a new float32 array): the
    in-place step refuses it rather than round, and serves it once cast."""
    if kind == "ssd":
        _, _, spec, module = ssd_pair()
        state, decode = TL.init_ssd_state(spec, 2), TL.ssd_decode
    else:
        _, _, spec, module = rglru_pair()
        state, decode = TL.init_rglru_state(spec, 2), TL.rglru_decode
    assert state["conv"].dtype == torch.bfloat16
    _, step = inputs((2, 1, 32), "float32")
    with pytest.raises(ValueError, match="conv state"):
        decode(module, spec, step, state)
    state["conv"] = state["conv"].float()
    out, _ = decode(module, spec, step, state)
    assert bool(torch.isfinite(out).all())
