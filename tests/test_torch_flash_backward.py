"""The flash-attention backward's plain version, on the CPU.

``flash_attention_backward_torch`` is the arithmetic of the card's kernel
(``csrc/rm_flash_bwd.cu``): P rebuilt from the forward's log-sum-exp, the
row sums ``D = sum(dout * out)``, P and dS rounded to the input type before
the products that take them.  Here it is held

* against ``torch.autograd.grad`` of ``flash_attention_torch`` (float32:
  within 1e-5 of each gradient's largest magnitude — the two sum in other
  orders, one through the online softmax, one from the lse);
* against ``jax.grad`` of the reference's ``blockwise_attention`` on the
  same numpy inputs (float32, the same limit);
* in bf16, its distance from the float32 gradients at most twice that of
  the bf16 autograd recompute;

and the ``lse`` that ``flash_attention_torch`` returns against
``torch.logsumexp`` of the masked, scaled logits.  ``run_flash_backward``'s
refusals show without a card: it checks before it builds or launches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import _cuda
from repro_torch.kernels import flash_attention as TF

SHAPES = [
    # (B, S, H, KH, D)
    (2, 40, 4, 2, 16),
    (2, 64, 4, 1, 32),
    (2, 40, 4, 1, 32),
    (2, 64, 4, 2, 16),
]
MASKS = [(True, None), (True, 7), (False, None)]  # causal, window 7, bidirectional
F32_TOL = 1e-5  # of each gradient's largest magnitude


def draw(shape, seed: int = 0):
    """q, k, v and dout as float32 numpy arrays, from a seed."""
    b, s, h, kh, d = shape
    rng = np.random.default_rng(seed + sum(shape))
    return [rng.standard_normal((b, s, n, d)).astype(np.float32) for n in (h, kh, kh, h)]


def grads_autograd(q, k, v, dout, causal, window, block_k=16):
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = TF.flash_attention_torch(*leaves, causal=causal, window=window, block_k=block_k)
    return torch.autograd.grad(out, leaves, dout)


def grads_plain(q, k, v, dout, causal, window, block_k=16):
    out, lse = TF.flash_attention_torch(q, k, v, causal=causal, window=window,
                                        block_k=block_k, return_lse=True)
    return TF.flash_attention_backward_torch(q, k, v, out, lse, dout, causal, window,
                                             block_k=block_k)


def rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.parametrize("mask", MASKS, ids=lambda m: f"causal{m[0]}-w{m[1]}")
@pytest.mark.parametrize("shape", SHAPES, ids=lambda c: "x".join(map(str, c)))
def test_plain_backward_matches_autograd(shape, mask):
    q, k, v, dout = (torch.from_numpy(a) for a in draw(shape))
    got = grads_plain(q, k, v, dout, *mask)
    want = grads_autograd(q, k, v, dout, *mask)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert rel(g, w) <= F32_TOL


@pytest.mark.parametrize("mask", MASKS, ids=lambda m: f"causal{m[0]}-w{m[1]}")
@pytest.mark.parametrize("shape", SHAPES[:2], ids=lambda c: "x".join(map(str, c)))
def test_plain_backward_matches_jax_grad(shape, mask):
    """The reference's gradient: ``jax.grad`` of ``blockwise_attention``
    (its checkpointed step differentiated by XLA) on the same inputs."""
    causal, window = mask
    arrays = draw(shape, seed=1)
    d = shape[4]
    spec = JL.AttnSpec(d_model=shape[2] * d, n_heads=shape[2], n_kv_heads=shape[3],
                       head_dim=d, window=window, causal=causal)

    def loss(q, k, v):
        return jnp.sum(JL.blockwise_attention(q, k, v, spec, chunk=16) * arrays[3])

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrays[:3]))
    got = grads_plain(*(torch.from_numpy(a) for a in arrays), causal, window)
    for g, w in zip(got, want):
        assert rel(g, torch.from_numpy(np.array(w))) <= F32_TOL


@pytest.mark.parametrize("mask", MASKS, ids=lambda m: f"causal{m[0]}-w{m[1]}")
@pytest.mark.parametrize("shape", SHAPES, ids=lambda c: "x".join(map(str, c)))
def test_bf16_plain_backward_is_no_further_from_float32_than_the_recompute(shape, mask):
    """Rounding P and dS to bf16 where the kernel does costs no more than
    the bf16 autograd recompute's own roundings: each gradient at most
    twice as far from the float32 one."""
    arrays = [torch.from_numpy(a).bfloat16() for a in draw(shape, seed=2)]
    exact = grads_autograd(*(t.float() for t in arrays), *mask)
    got = grads_plain(*arrays, *mask)
    recompute = grads_autograd(*arrays, *mask)
    for g, r, x in zip(got, recompute, exact):
        assert g.dtype == torch.bfloat16
        assert float((g.float() - x).abs().max()) <= 2 * float((r.float() - x).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("mask", MASKS, ids=lambda m: f"causal{m[0]}-w{m[1]}")
@pytest.mark.parametrize("shape", SHAPES[:2], ids=lambda c: "x".join(map(str, c)))
def test_lse_is_the_log_sum_exp_of_the_masked_logits(shape, mask, dtype):
    causal, window = mask
    q, k, v, _ = (torch.from_numpy(a).to(dtype) for a in draw(shape, seed=3))
    out, lse = TF.flash_attention_torch(q, k, v, causal=causal, window=window, block_k=16,
                                        return_lse=True)
    assert torch.equal(out, TF.flash_attention_torch(q, k, v, causal=causal, window=window,
                                                     block_k=16))
    b, s, h, d = q.shape
    g = h // k.shape[2]
    kk = k.float().repeat_interleave(g, dim=2)
    logits = torch.einsum("bihd,bjhd->bhij", q.float() * d ** -0.5, kk)
    dist = torch.arange(s)[:, None] - torch.arange(s)[None, :]
    win = s if window is None else window
    allowed = (dist >= 0) & (dist < win) if causal else dist.abs() < win
    want = torch.logsumexp(logits.masked_fill(~allowed, float("-inf")), dim=-1)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    assert float((lse - want).abs().max()) <= 1e-5


def test_plain_backward_refuses_bad_inputs():
    q, k, v, dout = (torch.from_numpy(a) for a in draw(SHAPES[0]))
    out, lse = TF.flash_attention_torch(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="window"):
        TF.flash_attention_backward_torch(q, k, v, out, lse, dout, True, 0)
    with pytest.raises(ValueError, match="groups"):
        TF.flash_attention_backward_torch(q, k[:, :, :1].expand(-1, -1, 3, -1),
                                          v[:, :, :1].expand(-1, -1, 3, -1), out, lse, dout)


def backward_args(bad: str):
    """Inputs of ``run_flash_backward``, one of them made ``bad``."""
    dt = torch.float16 if bad == "float16" else torch.bfloat16
    b, s, h, kh, d = 1, 8, 4, 2, 16
    if bad == "head_dim":
        d = 24
    q, out, dout = (torch.zeros(b, s, h, d, dtype=dt) for _ in range(3))
    k, v = (torch.zeros(b, s, kh, d, dtype=dt) for _ in range(2))
    lse = torch.zeros(b, h, s)
    if bad == "groups":
        k, v = (torch.zeros(b, s, 3, d, dtype=dt) for _ in range(2))
    elif bad == "dout_shape":
        dout = torch.zeros(b, s, h - 1, d, dtype=dt)
    elif bad == "lse":
        lse = torch.zeros(b, s, h)
    elif bad == "lse_type":
        lse = lse.bfloat16()
    elif bad == "out_type":
        out = out.float()
    elif bad == "stride":
        q = torch.zeros(b, s, h, 2 * d, dtype=dt)[..., ::2]
    elif bad == "dout_type":
        dout = dout.float()
    elif bad == "base":
        q = torch.zeros(b * s * h * d + 1, dtype=dt)[1:].view(b, s, h, d)
    elif bad == "row":
        k = torch.zeros(b, s, kh, d + 1, dtype=dt)[..., :d]
    elif bad == "window":
        return (q, k, v, out, lse, dout, True, 0)
    return (q, k, v, out, lse, dout, True, None)


@pytest.mark.parametrize("bad,match", [
    ("cpu", "CUDA tensors"), ("float16", "bfloat16"), ("head_dim", "head_dim"),
    ("groups", "groups"), ("dout_shape", "q's shape"), ("lse", "lse"), ("lse_type", "lse"),
    ("out_type", "out"), ("dout_type", "dout"), ("stride", "unit stride"),
    ("base", "16-byte aligned"), ("row", "16 bytes"), ("window", "CUDA tensors"),
])
def test_backward_launcher_refuses_what_the_kernel_does_not_take(bad, match):
    """``run_flash_backward`` checks before it builds or launches anything,
    so its refusals show here, without a card: the type, head width, head
    split, shapes, lse, a D stride, TMA's base and row strides of q, k and v
    (bf16) — and CPU tensors, last (a window below 1 is refused after the
    device, as the forward orders it).  A ``dout`` of any layout is taken
    (copied where the kernel cannot read it; see below)."""
    with pytest.raises(ValueError, match=match):
        _cuda.run_flash_backward(*backward_args(bad))


@pytest.mark.parametrize("form", ["tensor", "cuda_cores"])
@pytest.mark.parametrize("layout,copied", [
    ("contiguous", {"tensor": False, "cuda_cores": False}),
    ("head_stride_34_bytes", {"tensor": True, "cuda_cores": False}),
    ("offset_base", {"tensor": True, "cuda_cores": False}),
    ("d_stride_2", {"tensor": True, "cuda_cores": True}),
    ("broadcast", {"tensor": True, "cuda_cores": True}),  # the gradient of out.sum()
])
def test_dout_the_kernel_cannot_read_is_copied_and_counted(layout, copied, form):
    """A ``dout`` from autograd may have any layout: the wrapper copies one
    the kernel cannot read (a D stride other than 1; in the tensor-core
    form also what TMA cannot describe) and counts it, and takes any other
    as it is."""
    b, s, h, d = 2, 8, 4, 16
    dt = torch.bfloat16
    if layout == "contiguous":
        dout = torch.zeros(b, s, h, d, dtype=dt)
    elif layout == "head_stride_34_bytes":
        dout = torch.zeros(b, s, h, d + 1, dtype=dt)[..., :d]
    elif layout == "offset_base":
        dout = torch.zeros(b * s * h * d + 1, dtype=dt)[1:].view(b, s, h, d)
    elif layout == "d_stride_2":
        dout = torch.zeros(b, s, h, 2 * d, dtype=dt)[..., ::2]
    else:
        dout = torch.ones((), dtype=dt).expand(b, s, h, d)
    _cuda.reset_launches()
    got = _cuda.flash_dout(dout, form)
    assert _cuda.FLASH_DOUT_COPIES["copies"] == int(copied[form])
    assert (got is not dout) == copied[form] and torch.equal(got, dout)
    assert got.stride(3) == 1
    if form == "tensor":
        _cuda.check_flash_tma("dout", got.shape, got.stride(), 2, got.data_ptr())


@pytest.mark.parametrize("dtype,d,form", [
    (torch.bfloat16, 16, "tensor"), (torch.bfloat16, 64, "tensor"),
    (torch.bfloat16, 128, "tensor"), (torch.bfloat16, 256, "cuda_cores"),
    (torch.float32, 64, "cuda_cores"), (torch.float32, 256, "cuda_cores")])
def test_backward_form_follows_dtype_and_width(dtype, d, form):
    assert _cuda.flash_backward_form(dtype, d) == form


def test_cpu_gradient_is_the_plain_autograd():
    """On the CPU ``flash_attention`` differentiates the plain version (no
    kernel, no launch): the CPU train-loss parity with JAX rests on it."""
    q, k, v, dout = (torch.from_numpy(a) for a in draw(SHAPES[0], seed=4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    _cuda.reset_launches()
    out = TF.flash_attention(*leaves, block_k=16)
    got = torch.autograd.grad(out, leaves, dout)
    assert not any(_cuda.LAUNCHES.values())
    for g, w in zip(got, grads_autograd(q, k, v, dout, True, None)):
        assert torch.equal(g, w)
