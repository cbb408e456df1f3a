"""The port's flash attention against the JAX package's, on the CPU.

* ``flash_attention_torch`` (the CUDA kernel's plain version) against the
  reference's Pallas ``flash_attention`` in interpret mode, over the seven
  cases of ``tests/test_flash_attention.py`` and both types;
* the port's ``blockwise_attention`` (the model's CPU path) against the
  reference's on the same cases;
* ``attention_hbm_bytes`` equal; a CPU call launches no kernel; bad shapes,
  types and tensors that require grad raise.

Inputs are drawn with numpy from a seed, rounded once to the working type,
and handed to both packages.  Tolerances are the reference file's: float32
2e-5 (the two walk the keys in the same tiles but sum in another order),
bfloat16 2e-2 (one bf16 rounding of the output, and of p before PV).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as JF  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.kernels import flash_attention as TF  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

CASES = [
    # (B, S, H, KH, D, causal, window, block_q, block_k)
    (2, 128, 4, 4, 32, True, None, 64, 64),
    (2, 128, 8, 2, 32, True, None, 64, 32),  # GQA group 4
    (1, 256, 4, 1, 64, True, None, 128, 128),  # MQA
    (2, 96, 4, 2, 32, True, None, 64, 64),  # padded tail (96 % 64 != 0)
    (2, 128, 4, 4, 32, True, 48, 64, 64),  # sliding window
    (2, 128, 4, 4, 32, False, None, 64, 64),  # bidirectional (encoder)
    (1, 64, 2, 2, 128, True, None, 32, 32),  # MXU-wide head dim
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def inputs(case, dtype: str, seed: int = 0):
    """q, k, v for both packages, equal element for element."""
    b, s, h, kh, d = case[:5]
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed + sum(case[:5]))
    out = []
    for heads in (h, kh, kh):
        x = jnp.asarray(rng.normal(0, 1, (b, s, heads, d)).astype(np.float32)).astype(jdt)
        out.append((x, torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)))
    return out


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_version_matches_pallas_interpret(case, dtype):
    _, _, _, _, _, causal, window, bq, bk = case
    (jq, tq), (jk, tk), (jv, tv) = inputs(case, dtype)
    want = JF.flash_attention(jq, jk, jv, causal=causal, window=window,
                              block_q=bq, block_k=bk, interpret=True)
    got = TF.flash_attention_torch(tq, tk, tv, causal=causal, window=window,
                                   block_q=bq, block_k=bk)
    assert got.dtype == tq.dtype and tuple(got.shape) == tuple(want.shape)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_blockwise_attention_matches_reference(case, dtype):
    b, s, h, kh, d, causal, window, _, _ = case
    (jq, tq), (jk, tk), (jv, tv) = inputs(case, dtype, seed=1)
    kw = dict(d_model=h * d, n_heads=h, n_kv_heads=kh, head_dim=d,
              window=window, causal=causal)
    chunk = max(s // 2, 1)
    want = JL.blockwise_attention(jq, jk, jv, JL.AttnSpec(**kw), chunk=chunk)
    got = TL.blockwise_attention(tq, tk, tv, TL.AttnSpec(**kw), chunk=chunk)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=tol, atol=tol)
    # and the public entry point on a CPU tensor is the plain version
    np.testing.assert_allclose(
        to_np(TF.flash_attention(tq, tk, tv, causal=causal, window=window)),
        to_np(got), rtol=tol, atol=tol)


@pytest.mark.parametrize("args", [(2, 128, 8, 2, 32, 64), (1, 2048, 32, 8, 128, 1024),
                                  (8, 4096, 40, 8, 128, 512)])
def test_attention_hbm_bytes_matches_reference(args):
    for dtype_bytes in (2, 4):
        assert TF.attention_hbm_bytes(*args, dtype_bytes) == \
            JF.attention_hbm_bytes(*args, dtype_bytes)


def test_cpu_call_launches_no_kernel():
    (_, q), (_, k), (_, v) = inputs(CASES[1], "float32")
    _cuda.reset_launches()
    TF.flash_attention(q, k, v)
    TL._attend(q, k, v, TL.AttnSpec(256, 8, 2, 32), chunk=64)
    assert _cuda.LAUNCHES["flash_attention"] == 0


def test_window_and_tail_edges_match_reference():
    """A window of 1 (each query sees only itself) and one wider than S."""
    case = (1, 40, 4, 2, 16, True, None, 16, 16)
    (jq, tq), (jk, tk), (jv, tv) = inputs(case, "float32", seed=3)
    for causal in (True, False):
        for window in (1, 100):
            want = JF.flash_attention(jq, jk, jv, causal=causal, window=window,
                                      block_q=16, block_k=16, interpret=True)
            got = TF.flash_attention_torch(tq, tk, tv, causal=causal, window=window,
                                           block_k=16)
            np.testing.assert_allclose(to_np(got), to_np(want), rtol=2e-5, atol=2e-5)
    got = TF.flash_attention_torch(tq, tk, tv, window=1)
    np.testing.assert_array_equal(  # one key: softmax weight 1, out = v of that key
        got.numpy(), tv.repeat_interleave(2, dim=2).numpy())


@pytest.mark.parametrize("window", [0, -3])
def test_window_below_one_is_refused_on_the_cpu(window):
    """A window below 1 masks every key; the card's kernel refuses it, and
    the plain version does too, with the same error (the reference returns a
    value that depends on its padding of S to block_k)."""
    (_, q), (_, k), (_, v) = inputs((1, 5, 2, 1, 16, True, None, 4, 4), "float32")
    for fn in (TF.flash_attention, TF.flash_attention_torch):
        with pytest.raises(ValueError, match="window must be positive"):
            fn(q, k, v, causal=True, window=window)


@pytest.mark.parametrize("bad", ["rank", "kv_shape", "groups", "dtype", "int"])
def test_bad_inputs_raise(bad):
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    v = torch.zeros(1, 8, 2, 16)
    if bad == "rank":
        q = q[0]
    elif bad == "kv_shape":
        k = torch.zeros(1, 8, 2, 32)
    elif bad == "groups":
        k = v = torch.zeros(1, 8, 3, 16)
    elif bad == "dtype":
        k = k.double()
    else:
        q, k, v = (t.long() for t in (q, k, v))
    with pytest.raises(ValueError):
        TF.flash_attention(q, k, v)


def test_requires_grad_raises():
    q = torch.zeros(1, 8, 2, 16, requires_grad=True)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(NotImplementedError, match="backward"):
        TF.flash_attention(q, k, k)


@pytest.mark.parametrize("bad,match", [("cpu", "CUDA tensors"), ("float16", "bfloat16"),
                                       ("head_dim", "head_dim"), ("stride", "unit stride"),
                                       ("base", "16-byte aligned"), ("row", "16 bytes")])
def test_cuda_launcher_refuses_what_the_kernel_does_not_take(bad, match):
    """``run_flash`` checks before it builds or launches anything, so its
    refusals show here, without a card.  The last two are TMA's (bf16 only):
    a base that is not 16-byte aligned, a head stride of 34 bytes."""
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    if bad == "float16":
        q, k = q.half(), k.half()
    elif bad == "head_dim":
        q, k = torch.zeros(1, 8, 4, 24), torch.zeros(1, 8, 2, 24)
    elif bad == "stride":
        q = torch.zeros(1, 8, 4, 32)[..., ::2]
    elif bad == "base":
        q = torch.zeros(8 * 4 * 16 + 1, dtype=torch.bfloat16)[1:].view(1, 8, 4, 16)
        k = k.bfloat16()
    elif bad == "row":
        q = torch.zeros(1, 8, 4, 17, dtype=torch.bfloat16)[..., :16]
        k = k.bfloat16()
    with pytest.raises(ValueError, match=match):
        _cuda.run_flash(q, k, k, True, None)


@pytest.mark.parametrize("shape,strides,ptr,match", [
    ((2, 64, 8, 128), (65536, 1024, 128, 1), 256, None),  # contiguous
    ((2, 64, 2, 64), (98304, 1536, 64, 1), 1024, None),  # a view of a fused qkv
    ((1, 64, 1, 16), (7, 16, 3, 1), 0, None),  # size-1 dimensions: any stride
    ((2, 64, 8, 128), (65536, 1024, 128, 1), 8, "16-byte aligned"),
    ((2, 64, 8, 16), (8704, 136, 17, 1), 0, "dimension 2"),  # 34-byte head stride
    ((2, 64, 8, 16), (8192, 4, 16, 1), 0, "dimension 1"),  # 8-byte row stride
    ((2, 64, 8, 16), (0, 128, 16, 1), 0, "dimension 0"),  # broadcast batch
])
def test_flash_tma_check(shape, strides, ptr, match):
    """The bf16 kernel's layout check, a pure function of shape, strides,
    element size and base address."""
    if match is None:
        _cuda.check_flash_tma("q", shape, strides, 2, ptr)
    else:
        with pytest.raises(ValueError, match=match):
            _cuda.check_flash_tma("q", shape, strides, 2, ptr)
