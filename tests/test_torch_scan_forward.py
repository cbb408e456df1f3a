"""The RG-LRU scan's forward launch, checked without a card.

On the card the scan (``rglru_scan``) is one launch of
``rm_rglru_scan_kernel`` (``csrc/rm_rglru.cu``): a block is one warp of
lanes of one batch row; ``a`` and ``x`` come through a ring of stages in
shared memory, each a box of steps × lanes of both operands taken from step
0 up at multiples of the stage's steps, with zero fill past S and past W —
by TMA where W is a multiple of 4, both bases are 16-byte aligned and the
grid at most four blocks an SM, else by a 4-byte ``cp.async`` copy a lane a
step — and each lane runs its chain
``h = a[t] * h + x[t]`` up the boxes, storing the steps below S.  Here:

* the plan (``_cuda.rglru_forward_plan``): its fill form by width,
  alignment and grid size; at ``train_rg``'s microbatch (B 2, S 2,048, W 4,096) 256
  blocks, all resident at once, with at least 2 MB of loads in flight over
  the card; at the hybrid prefill's B 8 its 1,024 blocks in one wave;
* a numpy float32 model of the launch — blocks, the ring's slots and their
  mbarriers' phases filled and refilled in the kernel's order, each fill
  form's zero fill, every store — writes each element of ``h`` once and
  equals the plain loop bit for bit at ragged S and W, one step, W below a
  block's lanes, S one past a stage, more boxes than stages, and zeros and
  infinities; and agrees with the JAX reference's ``lax.associative_scan``
  of the same combine to float32 rounding;
* the wrapper on ``meta`` (shapes, no launch, every width taken) and its
  refusals, and the roofline counter's report of the forward's work.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.kernels import rglru_scan as RS  # noqa: E402
from repro_torch.roofline import analysis as A  # noqa: E402

SMS = 132  # the H100 SXM's streaming multiprocessors
BLOCK_RESERVED = 1024  # shared memory the card keeps back a resident block
SM_SMEM = 228 * 1024  # an SM's shared memory
STEPS = _cuda.RGLRU_FWD_STEPS
LANES = _cuda.RGLRU_FWD_LANES
MiB = 1 << 20
# (B, S, W): one step; ragged S and W; W below a block's lanes; S one past a
# stage and a full stage; several blocks a batch row; more boxes than the
# ring's stages (its mbarriers' parity wraps); W not a multiple of 4
MODEL_CASES = [(2, 1, 64), (2, 37, 100), (1, 300, 96), (3, 5, 8), (1, STEPS + 1, 64),
               (2, STEPS, 32), (3, 65, 36), (1, 11 * STEPS - 3, 132), (2, 2 * STEPS + 1, 66),
               (1, 40, 7)]
PLAN_SHAPES = [(2, 2048, 4096), (8, 2048, 4096), (1, 1, 4), (3, 37, 100), (2, 33, 4100),
               (2, 16, 66)]


def resident(smem: int) -> int:
    """Blocks of one warp and ``smem`` dynamic shared bytes an SM holds."""
    return min(32, SM_SMEM // (smem + BLOCK_RESERVED))


def ring_smem(stages: int) -> int:
    """Dynamic shared bytes of a ring of ``stages``: the stages' a and x, an
    mbarrier each, and 128 bytes to align the ring."""
    return stages * (2 * STEPS * LANES * 4 + 8) + 128


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda c: "x".join(map(str, c)))
def test_plan_shape(shape):
    b, s, w = shape
    plan = _cuda.rglru_forward_plan(b, s, w, aligned=True)
    assert plan.lanes == LANES == 32 and plan.steps == STEPS  # one warp a block
    assert plan.blocks == b * -(-w // plan.lanes)
    assert (plan.boxes - 1) * plan.steps < s <= plan.boxes * plan.steps
    assert plan.stages == _cuda.RGLRU_FWD_STAGES == 3
    ring = plan.stages * 2 * plan.steps * plan.lanes * 4
    assert plan.smem == ring + 8 * plan.stages + 128 == ring_smem(plan.stages)
    assert plan.smem <= 48 * 1024  # no cudaFuncSetAttribute: nothing but the launch
    assert 4 * plan.lanes <= 256 and plan.steps <= 256  # a TMA box's row bytes and rows
    assert plan.form == ("tma" if w % 4 == 0 and plan.blocks <= 4 * SMS else "async")


@pytest.mark.parametrize("shape", [(2, 16, 64), (2, 16, 66)])
def test_plan_takes_the_cp_async_form_for_an_unaligned_base(shape):
    """A base off 16 bytes takes the ``cp.async`` form whatever W is; the
    rest of the plan is the aligned one's."""
    plan = _cuda.rglru_forward_plan(*shape, aligned=False)
    aligned = _cuda.rglru_forward_plan(*shape, aligned=True)
    assert plan.form == "async"
    assert {**vars(plan), "form": aligned.form} == vars(aligned)


@pytest.mark.parametrize("offset,form", [((0, 0), "tma"), ((1, 0), "async"), ((0, 2), "async"),
                                         ((3, 3), "async"), ((4, 4), "tma")])
def test_plan_of_the_tensors_reads_their_alignment(offset, form):
    """``rglru_scan_plan`` — the plan the wrapper launches — takes the TMA
    form only where both a and x start 16-byte aligned (W a multiple of 4):
    ``offset`` floats into a fresh buffer each."""
    shape = (2, 16, 64)
    a, x = (torch.zeros(shape[0] * shape[1] * shape[2] + 8)[o:o + 2048].view(shape)
            for o in offset)
    assert a.data_ptr() % 16 == 4 * offset[0] % 16 and x.data_ptr() % 16 == 4 * offset[1] % 16
    plan = _cuda.rglru_scan_plan(a, x)
    assert plan.form == form
    assert plan == _cuda.rglru_forward_plan(*shape, aligned=form == "tma")


@pytest.mark.parametrize("b,form", [(1, "tma"), (2, "tma"), (4, "tma"), (5, "async"),
                                    (6, "async"), (8, "async")])
def test_plan_takes_tma_up_to_four_blocks_an_sm(b, form):
    """At W 4,096 (128 blocks a batch row) TMA fills the ring of a grid of
    at most four blocks an SM of the H100's 132 (B 4: 512); a fuller grid
    takes the warps' own ``cp.async`` copies, whatever the alignment."""
    plan = _cuda.rglru_forward_plan(b, 2048, 4096, aligned=True)
    assert plan.blocks == 128 * b and plan.form == form
    assert (plan.blocks <= 4 * SMS) == (form == "tma")
    assert _cuda.rglru_forward_plan(b, 2048, 4096, aligned=False).form == "async"


def test_plan_fills_the_card_at_the_training_microbatch():
    """B 2 × W 4,096 (8,192 lanes): 256 blocks, every SM holds them all at
    once, and at least 2 MB of loads are in flight over the card while each
    block consumes one stage."""
    plan = _cuda.rglru_forward_plan(2, 2048, 4096, aligned=True)
    assert plan.blocks == 256 and plan.form == "tma" and plan.boxes == 64
    assert resident(plan.smem) * SMS >= plan.blocks
    in_flight = (plan.stages - 1) * 2 * plan.steps * plan.lanes * 4
    assert in_flight * plan.blocks >= 2 * MiB


def test_plan_keeps_the_hybrid_prefill_in_one_wave():
    """B 8 × W 4,096: 1,024 blocks, eight or more an SM, so the card holds
    the grid at once; a ring one stage deeper would leave a second wave.
    A grid this full takes the ``cp.async`` form."""
    plan = _cuda.rglru_forward_plan(8, 2048, 4096, aligned=True)
    assert plan.blocks == 1024 and plan.form == "async"
    assert resident(plan.smem) >= 8 and resident(plan.smem) * SMS >= plan.blocks
    assert plan.smem <= 27 * 1024
    assert resident(ring_smem(plan.stages + 1)) * SMS < plan.blocks
    assert (plan.stages - 1) * 2 * STEPS * LANES * 4 * plan.blocks >= 2 * MiB


def fill(x: np.ndarray, b: int, t0: int, w0: int, form: str) -> np.ndarray:
    """One operand's part of a stage: ``STEPS`` × ``LANES`` of batch row ``b``
    from ``(t0, w0)``, zeros outside ``x`` — a TMA box at ``(w0, t0, b)``, or
    each lane's column of 4-byte ``cp.async`` copies (size 0 past S or W)."""
    _, s, w = x.shape
    out = np.full((STEPS, LANES), np.nan, np.float32)
    if form == "tma":
        out[:] = 0.0
        t1, w1 = min(t0 + STEPS, s), min(w0 + LANES, w)
        out[:t1 - t0, :w1 - w0] = x[b, t0:t1, w0:w1]
    else:
        for lane in range(LANES):
            for u in range(STEPS):
                inside = w0 + lane < w and t0 + u < s
                out[u, lane] = x[b, t0 + u, w0 + lane] if inside else np.float32(0.0)
    return out


def model_forward(a: np.ndarray, x: np.ndarray, form: str):
    """The launch in numpy float32: each block's ring of stages filled and
    refilled in the kernel's order (each slot's mbarrier completing one
    phase a fill, waited on at parity ``(k // stages) & 1``), its warp's
    chains run up the boxes; returns ``h`` and how often each element was
    written."""
    bsz, s, w = a.shape
    plan = _cuda.rglru_forward_plan(bsz, s, w, aligned=form == "tma")
    assert plan.form == form
    groups = -(-w // plan.lanes)
    h = np.full(a.shape, np.nan, np.float32)
    writes = np.zeros(a.shape, int)
    for block in range(plan.blocks):
        b, grp = divmod(block, groups)
        w0 = grp * plan.lanes
        live = w0 + np.arange(plan.lanes) < w
        cols = np.arange(w0, w0 + plan.lanes)[live]
        phases = [0] * plan.stages  # phases each slot's mbarrier completed

        def load(k):
            phases[k % plan.stages] += 1
            return k, fill(a, b, k * plan.steps, w0, form), fill(x, b, k * plan.steps, w0, form)

        slots = [load(k) for k in range(min(plan.stages, plan.boxes))]
        state = np.zeros(plan.lanes, np.float32)  # h[-1]
        for k in range(plan.boxes):
            slot = k % plan.stages
            # the wait at parity (k // stages) & 1 returns on this fill's phase
            assert phases[slot] == k // plan.stages + 1
            assert (phases[slot] - 1) & 1 == (k // plan.stages) & 1
            held, sa, sx = slots[slot]
            assert held == k  # the slot holds this stage, not a later one
            for u in range(plan.steps):
                t = k * plan.steps + u
                with np.errstate(invalid="ignore"):  # inf · 0 and the like: NaN, as torch's
                    state = (sa[u] * state) + sx[u]
                if t < s:
                    h[b, t, cols] = state[live]
                    writes[b, t, cols] += 1
            if k + plan.stages < plan.boxes:  # the slot read, refilled
                slots[slot] = load(k + plan.stages)
    return h, writes


def inputs(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    return a, x


def plain(a, x) -> np.ndarray:
    return RS.rglru_scan_torch(torch.from_numpy(a), torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("shape,form", [
    (shape, form) for shape in MODEL_CASES for form in ("tma", "async")
    if form == "async" or shape[2] % 4 == 0], ids=lambda c: "x".join(map(str, c))
    if isinstance(c, tuple) else c)
def test_model_of_the_launch_is_the_plain_loop(shape, form):
    a, x = inputs(shape, sum(shape))
    h, writes = model_forward(a, x, form)
    assert (writes == 1).all()
    # bit for bit: the same signs of zero too
    assert np.array_equal(h.view(np.int32), plain(a, x).view(np.int32))


@pytest.mark.parametrize("form", ["tma", "async"])
@pytest.mark.parametrize("shape", [(1, STEPS + 1, 40), (2, 3, 8)], ids=lambda c: "x".join(
    map(str, c)))
def test_model_keeps_the_plain_loops_zeros_and_infinities(shape, form):
    """Signed zeros at the first step (``-0.5 · 0 + -0``), zeros in
    ``a``, an infinite ``x`` and an infinite ``a`` whose NaNs and
    infinities run on as the plain loop's do; the zero fill past S never
    reaches a stored step, whatever the last stored state was."""
    a, x = inputs(shape, 7)
    a[:, ::2, 1::3] = 0.0
    a[:, 0, ::2] = -0.5
    x[:, 0, ::2] = -0.0
    x[0, 1, 3] = np.inf
    a[-1, -1, 5] = -np.inf
    x[-1, -2, 6] = np.inf
    a[0, 0, 7] = np.nan
    h, _ = model_forward(a, x, form)
    want = plain(a, x)
    assert np.array_equal(h.view(np.int32), want.view(np.int32))
    assert np.isinf(h[0, 1, 3]) and np.isnan(h[0, :, 7]).all()
    assert np.isnan(h[-1, -1, 6]) or np.isinf(h[-1, -1, 6])
    assert np.signbit(h[:, 0, ::2]).all() and (h[:, 0, ::2] == 0).all()


@pytest.mark.parametrize("shape", [(2, 1, 5), (3, 65, 36), (1, 257, 40)],
                         ids=lambda c: "x".join(map(str, c)))
def test_model_matches_the_reference_associative_scan(shape):
    """The model of the launch against the JAX reference's
    ``lax.associative_scan`` of the RG-LRU combine
    (``repro/models/layers.py``, ``rglru_block``): equal to float32
    rounding, since the tree associates the same terms otherwise (the
    tolerance of the plain version's own test)."""
    a, x = inputs(shape, 11)

    def combine(e1, e2):
        a1, b1 = e1
        a2, b2 = e2
        return a1 * a2, a2 * b1 + b2

    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(x)), axis=1)
    for form in ("tma", "async") if shape[2] % 4 == 0 else ("async",):
        h, _ = model_forward(a, x, form)
        np.testing.assert_allclose(h, np.asarray(want), rtol=1e-5, atol=1e-6)


def meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("shape", [(2, 64, 128), (2, 16, 66), (1, 1, 3), (3, 5, 4101)],
                         ids=lambda c: "x".join(map(str, c)))
def test_wrapper_on_meta_returns_shapes_and_launches_nothing(shape):
    """Every width, a multiple of 4 or not, as before the ring."""
    _cuda.reset_launches()
    h = _cuda.run_rglru_scan(meta(shape), meta(shape))
    assert h.shape == shape and h.dtype == torch.float32
    assert _cuda.LAUNCHES["rglru_scan"] == 0


@pytest.mark.parametrize("case,match", [
    ("bf16", "float32"), ("transposed", "contiguous"), ("shapes", "one shape"),
    ("cpu", "CUDA tensors"), ("mixed", "CUDA tensors"), ("flat", "one shape"),
    ("grid", "below 2"), ("empty", r"\[1, 2\^31\)")])
def test_wrapper_refusals(case, match):
    shape = (2, 16, 64)
    a, x = meta(shape), meta(shape)
    if case == "bf16":
        x = meta(shape, torch.bfloat16)
    elif case == "transposed":
        x = meta((2, 64, 16)).transpose(1, 2)
    elif case == "shapes":
        x = meta((2, 8, 64))
    elif case == "cpu":
        a, x = torch.zeros(shape), torch.zeros(shape)
    elif case == "mixed":
        x = torch.zeros(shape)
    elif case == "flat":
        a, x = meta((32, 64)), meta((32, 64))
    elif case == "grid":  # 2^16 rows × 2^26 blocks a row: a grid past 2^31
        a, x = meta((1 << 16, 1, 1 << 31 - 1)), meta((1 << 16, 1, 1 << 31 - 1))
    else:
        a, x = meta((2, 0, 64)), meta((2, 0, 64))
    _cuda.reset_launches()
    with pytest.raises(ValueError, match=match):
        _cuda.run_rglru_scan(a, x)
    assert _cuda.LAUNCHES["rglru_scan"] == 0


@pytest.mark.parametrize("shape", [(2, 64, 128), (2, 2048, 4096), (8, 2048, 4096)])
def test_roofline_counts_the_forward_kernel_with_its_own_work(shape):
    """One launch of the forward with its own work, unchanged by the ring:
    two float32 operations an element, a and x read and h written once."""
    b, s, w = shape
    a, x = meta(shape), meta(shape)
    h, counts = A.count_step(lambda: RS.rglru_scan(a, x))
    assert h.shape == shape
    assert A.rglru_scan_work(b, s, w) == (2 * b * s * w, 12 * b * s * w)
    assert counts["kernels"]["rglru_scan"] == dict(
        zip(("flops", "bytes"), A.rglru_scan_work(b, s, w)), launches=1)
    assert counts["hbm_bytes"] == 12 * b * s * w
