"""The port's roofline counter (``repro_torch.roofline.analysis``) against
the reference analyzer's units (``tests/test_roofline.py``), on the CPU.

* product FLOPs by the reference's convention, ``2·|out|·contraction``:
  ``a @ b`` (64×256 by 256×32) exactly ``2·64·256·32``, a batched product
  (8 × 64×128 by 128×32) exactly ``2·(8·64·32)·128`` (after
  ``test_unscanned_matmul_baseline`` and ``test_dot_flops_parser_units``),
  on the CPU and on ``meta``;
* the ring wire model counted from the port's own collective calls, equal
  to ``test_wire_model_units``' numbers: an all-gather to bf16 (64, 512)
  over a group of 16 (a fake process group of 16 in this process), an
  all-reduce of 1,024 float32 over 4 and the point-to-point copies of 256
  bf16 of GPipe's stages (a gloo world of 4, ``tests/torch_worlds.py``
  ``roofline_world``);
* ``roofline_terms`` at the H100's data-sheet peaks gives 1.0 for each term
  (after ``test_roofline_terms_math``), and ``Hardware`` holds those
  figures, no TPU's;
* views and reshapes move no bytes; a copy moves its operand and output;
* the qwen3-8b smoke train step (float32, 8 × 64 tokens) counted on one
  device against the reference's ``hlo_stats(...)["flops"]`` of its jitted
  one-device step: the port's count is the reference's plus exactly two
  attention products (QK and PV) a layer.  That is the named gap: under
  grad the port checkpoints each key chunk's step inside each checkpointed
  layer group (``torch.utils.checkpoint``, as the reference nests
  ``jax.checkpoint``), so the backward runs the step's forward once more
  than the compiled HLO, where XLA computes the nested recompute once.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch_worlds import roofline_world, run_world  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.roofline.analysis import compiled_hlo_text, hlo_stats  # noqa: E402
from repro.train import AdamWConfig as JConfig  # noqa: E402
from repro.train import make_train_step as jmake_step  # noqa: E402
from repro.train.step import init_train_state as jinit_state  # noqa: E402
from repro_torch.configs import get_smoke_config as tget_smoke  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.roofline import analysis as A  # noqa: E402
from repro_torch.train import AdamWConfig, make_train_step  # noqa: E402
from repro_torch.train.step import init_train_state  # noqa: E402


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_product_flops_units(device):
    a, b = torch.empty((64, 256), device=device), torch.empty((256, 32), device=device)
    _, c = A.count_step(lambda: a @ b)
    assert c["flops"] == 2 * 64 * 256 * 32
    x, y = torch.empty((8, 64, 128), device=device), torch.empty((8, 128, 32), device=device)
    _, c = A.count_step(torch.bmm, x, y)
    assert c["flops"] == 2 * (8 * 64 * 32) * 128
    _, c = A.count_step(torch.einsum, "bmk,bkn->bmn", x, y)
    assert c["flops"] == 2 * (8 * 64 * 32) * 128


def test_views_move_no_bytes_and_a_copy_moves_two():
    x = torch.ones((64, 32))
    _, c = A.count_step(lambda: x.view(32, 64).t().reshape(64, 32)[:8].unsqueeze(0).detach())
    assert c["hbm_bytes"] == 0 and c["flops"] == 0 and c["aten_calls"] > 0
    _, c = A.count_step(lambda: x.t().contiguous())
    assert c["hbm_bytes"] == 2 * x.numel() * 4


def test_roofline_terms_at_the_h100_peaks():
    hw = A.HW
    assert (hw.name, hw.peak_flops, hw.hbm_bw, hw.link_bw, hw.hbm_bytes) == (
        "h100-sxm", 989e12, 3.35e12, 450e9, 80e9)
    t = A.roofline_terms(989e12, 3.35e12, 450e9)
    assert all(abs(v - 1.0) < 1e-9 for v in t.values()), t


def test_wire_model_units():
    assert A.wire_bytes("all-gather", 64 * 512 * 2, 16) == 64 * 512 * 2 * 15 // 16
    assert A.wire_bytes("all-reduce", 4096, 4) == 2 * 4096 * 3 // 4
    assert A.wire_bytes("collective-permute", 512, 2) == 512
    assert A.wire_bytes("reduce-scatter", 512, 4) == 512 * 3
    assert A.wire_bytes("all-gather", 512, 1) == 0


def test_all_gather_over_sixteen_counted_from_the_port():
    """``collectives.all_gather`` of bf16 (64, 32) pieces along dim 1 over a
    fake group of 16: its output is (64, 512)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.distributed import collectives as C

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
    try:
        x = torch.zeros((64, 32), dtype=torch.bfloat16)
        y, c = A.count_step(C.all_gather, x, dist.group.WORLD, 1)
    finally:
        dist.destroy_process_group()
    assert tuple(y.shape) == (64, 512)
    assert c["collectives"]["all-gather"] == 64 * 512 * 2 * 15 // 16
    assert c["op_counts"]["all-gather"] == 1 and c["collectives"]["total"] == 64 * 512 * 2 * 15 // 16


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(roofline_world, 4, tmp_path_factory.mktemp("roofline"), timeout=120)


def test_all_reduce_over_four_counted_from_the_port(world):
    for rank in world:
        assert rank["all_reduce"]["collectives"]["all-reduce"] == 2 * 4096 * 3 // 4
        assert rank["all_reduce_value"] == 4.0  # the sum really ran


def test_point_to_point_copies_counted_from_the_pipeline(world):
    """Each of 2 microbatches of 256 bf16 (512 bytes, a copy) goes from a
    stage to the next; the last stage's output (1,024 bytes) is broadcast."""
    for stage, rank in enumerate(world):
        sends = 2 if stage < 3 else 0
        cp = rank["pipeline"]["collectives"]["collective-permute"]
        assert cp == sends * 512 + 1024
        assert rank["pipeline"]["op_counts"]["collective-permute"] == sends + 1


def test_train_step_flops_against_the_reference_hlo():
    jcfg = dataclasses.replace(jget_smoke("qwen3-8b"), compute_dtype="float32")
    tcfg = dataclasses.replace(tget_smoke("qwen3-8b"), compute_dtype="float32")
    b, s = 8, 64
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, jcfg.vocab, (b, s)).astype(np.int32) for k in ("tokens", "labels")}
    model = jbuild(jcfg)
    like = jax.eval_shape(lambda: jinit_state(model, jax.random.PRNGKey(0)))
    compiled = jax.jit(jmake_step(model, JConfig())).lower(
        like, {k: jax.ShapeDtypeStruct(v.shape, jnp.int32) for k, v in batch.items()}).compile()
    want = hlo_stats(compiled_hlo_text(compiled))["flops"]
    port = tbuild(tcfg, device="cpu", seed=0, param_dtype="float32")
    _, c = A.count_step(make_train_step(port, AdamWConfig()), init_train_state(port),
                        {k: torch.from_numpy(v) for k, v in batch.items()})
    attn_product = 2 * b * tcfg.n_heads * s * s * tcfg.resolved_head_dim
    assert c["flops"] == want + 2 * tcfg.n_layers * attn_product, (c["flops"], want)
