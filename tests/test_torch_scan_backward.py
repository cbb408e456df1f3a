"""The RG-LRU scan gradient's launch, checked without a card.

On the card the scan's gradient (``RGLRUScan.backward``) is one launch of
``rm_rglru_scan_backward_kernel`` (``csrc/rm_rglru.cu``): a block is one
warp of lanes of one batch row; ``a``, ``h`` and ``dh`` come through a ring
of TMA stages, each a box of steps × lanes of the three operands, taken
from the last step down at multiples of the stage's steps, with zero fill
past S and past W; each lane walks its chain ``g = a[t + 1] * g + dh[t]``
down to step 0, carrying ``a[t + 1]`` from the step before and storing
``da[t + 1] = g[t + 1] * h[t]`` a step late.  Here:

* the plan (``_cuda.rglru_backward_plan``): enough blocks for every SM at
  ``train_rg``'s microbatch (B 2, S 2,048, W 4,096), a ring of at least two
  stages inside a block's shared memory, four blocks an SM and at least
  16 KB of loads in flight an SM;
* a numpy float32 model of the launch — blocks, the ring's slots filled and
  refilled in the kernel's order, the boxes' zero fill, the carries across
  box edges, every store — writes each element of ``da`` and ``dx`` once and
  equals the plain reverse loop bit for bit at ragged S and W;
* the wrapper's refusals (what the kernel does not take) and its ``meta``
  path, and the roofline counter's report of the gradient's own work.

Everything is exact: float32 arithmetic step by step, no tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.kernels import rglru_scan as RS  # noqa: E402
from repro_torch.roofline import analysis as A  # noqa: E402

SMS = 132  # the H100 SXM's streaming multiprocessors
BLOCK_RESERVED = 1024  # shared memory the card keeps back a resident block
SM_SMEM = 228 * 1024  # an SM's shared memory
STEPS = _cuda.RGLRU_BWD_STEPS
# (B, S, W): one step; ragged S and W; S one past a stage and a full stage;
# W below a block's lanes; several blocks a batch row; a few stages
MODEL_CASES = [(2, 1, 64), (2, 37, 100), (1, 300, 96), (1, STEPS + 1, 64), (2, STEPS, 32),
               (3, 65, 36), (1, 5 * STEPS - 3, 132), (2, 2 * STEPS + 1, 8)]


def resident(plan) -> int:
    """Blocks of ``plan`` an SM holds at once, by shared memory."""
    return min(32, SM_SMEM // (plan.smem + BLOCK_RESERVED))


@pytest.mark.parametrize("shape", [(2, 2048, 4096), (8, 2048, 4096), (1, 1, 4), (3, 37, 100),
                                   (2, 33, 4100), (1, 4096, 64)])
def test_plan_shape(shape):
    b, s, w = shape
    plan = _cuda.rglru_backward_plan(b, s, w)
    assert plan.lanes == 32  # one warp a block
    assert plan.blocks == b * -(-w // plan.lanes)
    assert (plan.boxes - 1) * plan.steps < s <= plan.boxes * plan.steps
    ring = plan.stages * 3 * plan.steps * plan.lanes * 4
    assert plan.smem == ring + 8 * plan.stages + 128  # the ring, its mbarriers, alignment
    assert 2 <= plan.stages and plan.smem <= _cuda.SMEM_MAX
    assert 4 * plan.lanes <= 256 and plan.steps <= 256  # a TMA box's rows and bytes


def test_plan_fills_the_card_at_the_training_microbatch():
    """B 2 × W 4,096 (8,192 lanes): 256 blocks, every SM holds them all at
    once, and more than 16 KB of loads are in flight an SM while a stage
    is consumed."""
    plan = _cuda.rglru_backward_plan(2, 2048, 4096)
    assert plan.blocks >= SMS and plan.blocks == 256
    assert resident(plan) >= 4 and resident(plan) * SMS >= plan.blocks
    in_flight = (plan.stages - 1) * 3 * plan.steps * plan.lanes * 4
    assert in_flight * (plan.blocks // SMS) >= 16 * 1024
    assert plan.boxes == 64


def box(x: np.ndarray, b: int, t0: int, w0: int, steps: int, lanes: int) -> np.ndarray:
    """The TMA box of ``x (B, S, W)`` at ``(w0, t0, b)``: ``steps`` × ``lanes``
    of batch row ``b``, zeros outside ``x``."""
    _, s, w = x.shape
    out = np.zeros((steps, lanes), np.float32)
    t1, w1 = min(t0 + steps, s), min(w0 + lanes, w)
    out[:t1 - t0, :w1 - w0] = x[b, t0:t1, w0:w1]
    return out


def model_backward(a: np.ndarray, h: np.ndarray, dh: np.ndarray):
    """The launch in numpy float32: each block's ring of stages filled and
    refilled in the kernel's order, its warp's chains walked from the top
    box's last step down; returns ``da``, ``dx`` and how often each element
    of each was written."""
    bsz, s, w = a.shape
    plan = _cuda.rglru_backward_plan(bsz, s, w)
    groups = -(-w // plan.lanes)
    da, dx = np.full(a.shape, np.nan, np.float32), np.full(a.shape, np.nan, np.float32)
    writes = {"da": np.zeros(a.shape, int), "dx": np.zeros(a.shape, int)}
    for block in range(plan.blocks):
        b, grp = divmod(block, groups)
        w0 = grp * plan.lanes
        live = w0 + np.arange(plan.lanes) < w
        cols = np.arange(w0, w0 + plan.lanes)[live]

        def load(k):
            t0 = (plan.boxes - 1 - k) * plan.steps
            return k, [box(x, b, t0, w0, plan.steps, plan.lanes) for x in (a, h, dh)]

        slots = [load(k) for k in range(min(plan.stages, plan.boxes))]
        g = np.zeros(plan.lanes, np.float32)  # g[t + 1]
        a_next = np.zeros(plan.lanes, np.float32)  # a[t + 1]
        for k in range(plan.boxes):
            held, (sa, sh, sdh) = slots[k % plan.stages]
            assert held == k  # the slot holds this stage, not a later one
            t0 = (plan.boxes - 1 - k) * plan.steps
            for u in range(plan.steps - 1, -1, -1):
                t = t0 + u
                gt = (a_next * g) + sdh[u]
                if t + 1 < s:
                    da[b, t + 1, cols] = (g * sh[u])[live]
                    writes["da"][b, t + 1, cols] += 1
                if t < s:
                    dx[b, t, cols] = gt[live]
                    writes["dx"][b, t, cols] += 1
                g, a_next = gt, sa[u]
            if k + plan.stages < plan.boxes:  # the slot read, refilled
                slots[k % plan.stages] = load(k + plan.stages)
        with np.errstate(invalid="ignore"):  # an infinite g times h[-1] = 0: NaN, as torch's
            da[b, 0, cols] = (g * np.float32(0.0))[live]
        writes["da"][b, 0, cols] += 1
    return da, dx, writes


def inputs(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    h = rng.standard_normal(shape).astype(np.float32)
    dh = rng.standard_normal(shape).astype(np.float32)
    return a, h, dh


@pytest.mark.parametrize("shape", MODEL_CASES, ids=lambda c: "x".join(map(str, c)))
def test_model_of_the_launch_is_the_plain_reverse_loop(shape):
    a, h, dh = inputs(shape, sum(shape))
    da, dx, writes = model_backward(a, h, dh)
    assert (writes["da"] == 1).all() and (writes["dx"] == 1).all()
    want_da, want_dx = RS.rglru_scan_backward_torch(*map(torch.from_numpy, (a, h, dh)))
    assert np.array_equal(da, want_da.numpy()) and np.array_equal(dx, want_dx.numpy())
    # bit for bit: the same signs of zero and NaNs too
    assert np.array_equal(da.view(np.int32), want_da.numpy().view(np.int32))
    assert np.array_equal(dx.view(np.int32), want_dx.numpy().view(np.int32))


@pytest.mark.parametrize("shape", [(1, STEPS + 1, 40), (2, 3, 8)], ids=lambda c: "x".join(
    map(str, c)))
def test_model_keeps_the_plain_loops_zeros_and_infinities(shape):
    """Signed zeros in ``dh`` at the last step (the zero fill's ``a[S] · 0``
    is +0, as the plain loop's), zeros in ``a``, a zero ``h``, and an
    infinite ``dh`` whose NaNs the multiply by ``h[-1] = 0`` keeps."""
    a, h, dh = inputs(shape, 7)
    dh[:, -1, ::2] = -0.0
    a[:, ::2, 1::3] = 0.0
    h[:, 1, :] = 0.0
    dh[0, 0, 3] = np.inf
    da, dx, _ = model_backward(a, h, dh)
    want_da, want_dx = RS.rglru_scan_backward_torch(*map(torch.from_numpy, (a, h, dh)))
    assert np.array_equal(da.view(np.int32), want_da.numpy().view(np.int32))
    assert np.array_equal(dx.view(np.int32), want_dx.numpy().view(np.int32))
    assert np.isnan(da[0, 0, 3]) and np.signbit(dx[:, -1, ::2]).sum() == 0


def meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_wrapper_on_meta_returns_shapes_and_launches_nothing():
    _cuda.reset_launches()
    da, dx = _cuda.run_rglru_scan_backward(meta((2, 64, 128)), meta((2, 64, 128)),
                                           meta((2, 64, 128)))
    assert da.shape == dx.shape == (2, 64, 128) and da.dtype == dx.dtype == torch.float32
    assert _cuda.LAUNCHES["rglru_scan_backward"] == 0


@pytest.mark.parametrize("case,match", [
    ("bf16", "float32"), ("transposed", "contiguous"), ("shapes", "one shape"),
    ("width", "multiple of 4"), ("cpu", "CUDA tensors"), ("mixed", "CUDA tensors"),
    ("flat", "one shape")])
def test_wrapper_refusals(case, match):
    shape = (2, 16, 64)
    a, h, dh = meta(shape), meta(shape), meta(shape)
    if case == "bf16":
        h = meta(shape, torch.bfloat16)
    elif case == "transposed":
        dh = meta((2, 64, 16)).transpose(1, 2)
    elif case == "shapes":
        dh = meta((2, 8, 64))
    elif case == "width":
        a, h, dh = meta((2, 16, 66)), meta((2, 16, 66)), meta((2, 16, 66))
    elif case == "cpu":
        a, h, dh = (torch.zeros(shape) for _ in range(3))
    elif case == "mixed":
        dh = torch.zeros(shape)
    else:
        a, h, dh = meta((32, 64)), meta((32, 64)), meta((32, 64))
    _cuda.reset_launches()
    with pytest.raises(ValueError, match=match):
        _cuda.run_rglru_scan_backward(a, h, dh)
    assert _cuda.LAUNCHES["rglru_scan_backward"] == 0


@pytest.mark.parametrize("shape", [(2, 64, 128), (2, 2048, 4096)])
def test_roofline_counts_the_gradient_kernel_with_its_own_work(shape):
    """Under autograd on ``meta``, the forward and the gradient each report
    one launch with their own work, and the backward moves no other bytes:
    no flip, copy or product around the kernel."""
    b, s, w = shape
    a, x = (meta(shape).requires_grad_() for _ in range(2))

    def step():
        h = RS.rglru_scan(a, x)
        return torch.autograd.grad(h, (a, x), torch.empty_like(h))

    (da, dx), counts = A.count_step(step)
    assert da.shape == dx.shape == shape
    kernels = counts["kernels"]
    assert kernels["rglru_scan"] == dict(zip(("flops", "bytes"), A.rglru_scan_work(b, s, w)),
                                         launches=1)
    assert kernels["rglru_scan_backward"] == dict(
        zip(("flops", "bytes"), A.rglru_scan_backward_work(b, s, w)), launches=1)
    assert A.rglru_scan_backward_work(b, s, w) == (3 * b * s * w, 20 * b * s * w)
    assert counts["hbm_bytes"] == 12 * b * s * w + 20 * b * s * w
