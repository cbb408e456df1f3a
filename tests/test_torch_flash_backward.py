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

import heapq

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
    (torch.bfloat16, 16, "one_pass"), (torch.bfloat16, 32, "one_pass"),
    (torch.bfloat16, 64, "one_pass"),
    (torch.bfloat16, 128, "one_pass"), (torch.bfloat16, 256, "tensor"),
    (torch.float32, 64, "cuda_cores"), (torch.float32, 256, "cuda_cores")])
def test_backward_form_follows_dtype_and_width(dtype, d, form):
    assert _cuda.flash_backward_form(dtype, d) == form


ONE_KEYS, ONE_Q = 128, 64  # the one-pass form's key block and query tile (one::kKeys, kQ)


def one_pass_contributors(s: int, causal: bool, window: int, qt: int) -> tuple[int, int]:
    """The one-pass form's key blocks whose partials make query tile ``qt``'s
    dQ, ``(lo, hi)``: summed in that order, the first stored, the last
    converted to bf16 (``one::tile_contributors`` in ``csrc/rm_flash_bwd.cu``)."""
    i0 = qt * ONE_Q
    i_last = min(i0 + ONE_Q, s) - 1
    j_lo = max(0, i0 - window + 1)
    j_hi = i_last if causal else min(s - 1, i_last + window - 1)
    return j_lo // ONE_KEYS, j_hi // ONE_KEYS


def one_pass_items(s: int, g: int, causal: bool, window: int, kb: int) -> list[tuple[int, int]]:
    """Key block ``kb``'s items in the order the kernel takes them: ``(query
    tile, head of the group)``, the query tiles any of its keys is seen by
    from the top down, the group's heads within a tile."""
    k0 = kb * ONE_KEYS
    k_last = min(k0 + ONE_KEYS, s) - 1
    qt_lo = (k0 if causal else max(0, k0 - window + 1)) // ONE_Q
    qt_hi = min(s - 1, k_last + window - 1) // ONE_Q
    return [(qt, hg) for qt in range(qt_hi, qt_lo - 1, -1) for hg in range(g)]


def one_pass_tickets(s: int, groups: int) -> list[tuple[int, int]]:
    """The work in ticket order: ``(key block, (b, kv head) pair)``, key
    blocks ascending, the pairs side by side (a block of the persistent grid
    takes the next ticket when it is free)."""
    return [(kb, grp) for kb in range(-(-s // ONE_KEYS)) for grp in range(groups)]


ONE_PASS_CASES = [
    # (S, causal, window): causal, a window inside S, bidirectional, its
    # window, ragged S
    (2048, True, 2048), (2048, True, 1024), (2048, False, 2048), (130, False, 48),
    (200, True, 200), (256, True, 100), (333, False, 333), (64, True, 1), (1000, True, 700),
]


def mask_pairs(s, causal, window):
    """The (key block, query tile) pairs holding an allowed pair, from the
    mask itself."""
    i = np.arange(s)[:, None]
    j = np.arange(s)[None, :]
    dist = i - j
    allowed = (dist >= 0) & (dist < window) if causal else np.abs(dist) < window
    qi, kj = np.nonzero(allowed)
    return set(zip((kj // ONE_KEYS).tolist(),
                   (qi // ONE_Q).tolist()))


@pytest.mark.parametrize("case", ONE_PASS_CASES, ids=lambda c: "-".join(map(str, c)))
def test_one_pass_items_are_the_pairs_the_mask_reaches(case):
    """The one-pass form's items (as the kernel walks a key block): each (key block, head, query tile) the mask reaches
    comes once, for every head of the group, the query tiles from the top
    down."""
    s, causal, window = case
    want = mask_pairs(s, causal, window)
    for g in (1, 4, 16):
        got = []
        for kb in range(-(-s // ONE_KEYS)):
            items = one_pass_items(s, g, causal, window, kb)
            assert [qt for qt, _ in items] == sorted((qt for qt, _ in items), reverse=True)
            got += [(kb, qt, hg) for qt, hg in items]
        assert len(got) == len(set(got))
        assert set(got) == {(kb, qt, hg) for kb, qt in want for hg in range(g)}


@pytest.mark.parametrize("case", ONE_PASS_CASES, ids=lambda c: "-".join(map(str, c)))
def test_one_pass_contributors_are_in_key_order(case):
    """A query tile's dQ partials come from the key blocks
    ``one_pass_contributors`` gives, ``lo`` to ``hi`` with none
    missing: summed in increasing key order (each waits for the count to
    reach its rank), the first stored, and the last — the highest key
    block the mask reaches — the one the kernel converts at."""
    s, causal, window = case
    pairs = mask_pairs(s, causal, window)
    n_qt = -(-s // ONE_Q)
    for qt in range(n_qt):
        lo, hi = one_pass_contributors(s, causal, window, qt)
        blocks = sorted(kb for kb, t in pairs if t == qt)
        assert blocks == list(range(lo, hi + 1))
        assert hi == max(blocks) and lo == min(blocks)


def simulate_one_pass(s, g, groups, causal, window, blocks, add=0.1):
    """The persistent grid in time units of one item: ``blocks`` blocks
    each take the next ticket when free (a key block costs 1 for its K and
    V, an item 1 and its add ``add``), and an item's add waits for the
    previous key block's add of the same tile and head.  A predecessor must
    have been handed out before (else KeyError).  Returns the makespan, the
    items' time and the time spent waiting."""
    done = {}
    free = [(0.0, i) for i in range(blocks)]
    busy = wait = 0.0
    for kb, grp in one_pass_tickets(s, groups):
        t, blk = heapq.heappop(free)
        t += 1.0
        for qt, hg in one_pass_items(s, g, causal, window, kb):
            lo, _ = one_pass_contributors(s, causal, window, qt)
            t += 1.0
            busy += 1.0
            if kb > lo:
                pred = done[(grp, hg, qt, kb - 1)]
                wait += max(0.0, pred - t)
                t = max(t, pred)
            t += add
            done[(grp, hg, qt, kb)] = t
        heapq.heappush(free, (t, blk))
    return max(f for f, _ in free), busy, wait


@pytest.mark.parametrize("case", ONE_PASS_CASES, ids=lambda c: "-".join(map(str, c)))
def test_one_pass_order_never_waits_on_later_work(case):
    """In ticket order (key blocks ascending, the (b, kv head) pairs side
    by side) every item's predecessor — the previous key block of its pair —
    was handed out earlier, whatever the grid; so a block never waits on
    work not yet handed out, and the persistent grid cannot deadlock."""
    s, causal, window = case
    tickets = one_pass_tickets(s, 3)
    at = {t: n for n, t in enumerate(tickets)}
    for kb, grp in tickets:
        for qt, _ in one_pass_items(s, 2, causal, window, kb):
            if kb > one_pass_contributors(s, causal, window, qt)[0]:
                assert at[(kb - 1, grp)] < at[(kb, grp)]
    for blocks in (1, 2, 5, 132):
        simulate_one_pass(s, 2, 3, causal, window, blocks)


@pytest.mark.parametrize("causal,window", [(True, 2048), (True, 1024), (False, 2048)])
def test_one_pass_waits_are_short_at_the_train_layer(causal, window):
    """qwen3-8b's training layer (S 2,048, 32 / 8 heads, B 2) on 132 SMs:
    key blocks of a pair walk their tiles from the top down in step, so
    their adds wait on one another for under 1% of the items' time (no
    wavefront stall), and the makespan stays within 1.5 times an even
    share of the items and adds."""
    makespan, busy, wait = simulate_one_pass(2048, 4, 16, causal, window, 132)
    assert wait <= 0.01 * busy
    assert makespan <= 1.5 * 1.1 * busy / 132


KEY_TILE_CASES = [
    # (S, causal, window)
    (64, True, 64), (100, True, 100), (1000, True, 700), (2048, True, 2048),
    (333, True, 65), (300, False, 100), (448, False, 448), (130, False, 48), (65, False, 1),
]


@pytest.mark.parametrize("case", KEY_TILE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_d256_key_items_are_the_query_tiles_the_mask_reaches(case):
    """The D 256 form's items of a 64-key tile (``flash_bwd_key_items``,
    mirrored by ``key_tile_queries`` in ``rm_flash_bwd.cu``): G times the
    64-query tiles holding an allowed (query, key) pair with a key of the
    tile — counted here from the mask itself."""
    s, causal, window = case
    i = np.arange(s)[:, None]
    j = np.arange(s)[None, :]
    dist = i - j
    allowed = (dist >= 0) & (dist < window) if causal else np.abs(dist) < window
    rows = _cuda.FLASH_BWD_WIDE_ROWS
    want = [len({int(q) // rows for q in np.nonzero(allowed[:, k0:k0 + rows].any(axis=1))[0]})
            for k0 in range(0, s, rows)]
    for g in (1, 16):
        assert _cuda.flash_bwd_key_items(s, g, causal, window) == [g * n for n in want]


@pytest.mark.parametrize("case", [(2048, 16, True, 2048, 2), (1000, 16, True, 700, 2),
                                  (333, 2, True, 333, 1), (300, 8, False, 100, 2),
                                  (64, 1, True, 64, 1)], ids=lambda c: "-".join(map(str, c)))
def test_d256_chunk_plan_covers_each_item_once(case):
    """The dK / dV blocks the chunk plan gives (``flash_bwd_kv_plan``,
    ``flash_bwd_chunks``, as the kernel cuts them): each key tile's items
    dealt once, in order, in near-equal chunks of at most the plan's size,
    a tile's blocks side by side and the low tiles first."""
    s, g, causal, window, groups = case
    items = _cuda.flash_bwd_key_items(s, g, causal, window)
    chunk, n_blocks = _cuda.flash_bwd_kv_plan(s, g, causal, window, groups, 132)
    assert 1 <= chunk <= max(items)
    blocks = _cuda.flash_bwd_chunks(items, chunk)
    assert len(blocks) == n_blocks
    assert [kt for kt, _, _ in blocks] == sorted(kt for kt, _, _ in blocks)
    for kt, n in enumerate(items):
        mine = [(lo, m) for t, lo, m in blocks if t == kt]
        assert len(mine) == -(-n // chunk)
        at = 0
        for lo, m in mine:
            assert lo == at and 1 <= m <= chunk
            at += m
        assert at == n
        assert max(m for _, m in mine) - min(m for _, m in mine) <= 1


def test_d256_chunk_plan_fills_the_card_at_recurrentgemma():
    """recurrentgemma-9b's local layer in training (B 2, S 2,048, 16 / 1
    heads, causal, window 2,048): 64 key tiles of 16-512 items would leave
    most of 132 SMs idle; the plan cuts the long tiles so that the blocks
    outnumber the SMs and no block holds more than a tenth of the tile 0's
    items, and its estimate stays within 1.5 times an even share."""
    s, g, groups, sms = 2048, 16, 2, 132
    items = _cuda.flash_bwd_key_items(s, g, True, 2048)
    assert max(items) == 512 and len(items) == 32
    chunk = _cuda.flash_bwd_kv_plan(s, g, True, 2048, groups, sms)[0]
    blocks = _cuda.flash_bwd_chunks(items, chunk)
    assert len(blocks) * groups > sms and chunk <= max(items) // 10
    costs = [m + _cuda.FLASH_BWD_BLOCK_COST + _cuda.FLASH_BWD_PARTIAL_COST * (m < items[kt])
             for kt, _, m in blocks] * groups
    free = [0] * sms
    for cost in costs:
        free[free.index(min(free))] += cost
    assert max(free) <= 1.5 * sum(items) * groups / sms


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
