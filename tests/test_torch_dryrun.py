"""The port's dry run, its specs and its cells against the JAX package's, on
the CPU.

* after ``tests/test_distributed.py`` ``test_dryrun_cell_on_tiny_mesh``: a
  gemma3 smoke train cell (``ShapeSpec("t", 128, 8, "train")``, two
  microbatches) counted by ``launch.dryrun.count_on_mesh`` as rank 0 of a
  fake process group of 8 at mesh (2, 2, 2) (``pod``, ``data``, ``model``)
  — all three roofline terms above 0 and collectives counted; and on the
  same mesh a smoke prefill cell, a decode cell (decode-SP: its all-reduces
  counted) and an MoE decode cell (the expert-parallel form
  ``local_stationary``, which gathers the tokens over the ``(pod, data)``
  group);
* ``make_production_mesh``: the reference's two shapes and axis names;
* ``cell_status`` and ``iter_cells`` equal to the reference's for all 40
  (arch, shape) pairs;
* ``launch.specs``: every arch's stand-ins (shapes and dtypes) equal to the
  reference's ``input_specs`` for every shape at full size and
  ``train_batch_shapes`` / ``decode_token_shapes`` at smoke size; every
  arch's decode caches — their shapes and their partition specs under both
  production rule sets — equal to the reference's with the stack
  dimension of its ``units`` leaves dropped (one port layer per stacked
  entry), at full size (``decode_32k``, and ``long_500k`` where it runs)
  and at smoke size.
"""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: E402

from repro.configs import cell_status as jcell_status  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.configs import iter_cells as jiter_cells  # noqa: E402
from repro.distributed import partitioning as JP  # noqa: E402
from repro.launch import specs as JS  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch.configs import ARCH_NAMES, SHAPES, ShapeSpec, cell_status, iter_cells  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.distributed import partitioning as TP  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch.dryrun import count_on_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

MESHES = {"single": ({"data": 16, "model": 16}, "SINGLE_POD_RULES"),
          "multi": ({"pod": 2, "data": 16, "model": 16}, "MULTI_POD_RULES")}
SMOKE_DECODE = ShapeSpec("d", 64, 8, "decode")


def test_production_meshes():
    """First in the file: the tiny mesh's fake group is set up after it."""
    from repro_torch.launch.mesh import make_production_mesh

    assert not dist.is_initialized()
    try:
        m = make_production_mesh()
        assert (m.mesh_dim_names, tuple(m.mesh.shape)) == (("data", "model"), (16, 16))
        m = make_production_mesh(multi_pod=True)
        assert (m.mesh_dim_names, tuple(m.mesh.shape)) == (
            ("pod", "data", "model"), (2, 16, 16))
        assert dist.get_world_size() == 512 and dist.get_backend() == "fake"
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def tiny_mesh():
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
    finally:
        dist.destroy_process_group()


def terms(counts) -> dict:
    from repro_torch.roofline.analysis import roofline_terms

    return roofline_terms(counts["flops"], counts["hbm_bytes"], counts["collectives"]["total"])


def test_dryrun_cell_on_tiny_mesh(tiny_mesh):
    cfg = get_smoke_config("gemma3-27b")
    counts, state_bytes, batch_bytes = count_on_mesh(
        cfg, ShapeSpec("t", 128, 8, "train"), tiny_mesh, grad_accum=2)
    t = terms(counts)
    assert all(v > 0 for v in t.values()), t
    assert counts["collectives"]["total"] > 0
    assert counts["op_counts"]["all-gather"] > 0 and counts["op_counts"]["all-reduce"] > 0
    assert counts["kernels"]["flash_attention"]["launches"] > 0  # meta reaches the kernel form
    assert counts["kernels"]["flash_attention_backward"]["launches"] > 0
    assert state_bytes > 0 and batch_bytes > 0


@pytest.mark.parametrize("arch,kind", [("qwen3-8b", "prefill"), ("qwen1.5-110b", "decode"),
                                       ("qwen3-moe-235b-a22b", "decode")])
def test_serve_cells_on_tiny_mesh(tiny_mesh, arch, kind, monkeypatch):
    from repro_torch.models import layers as L

    taken = []
    fn = L._moe_local_stationary
    monkeypatch.setattr(L, "_moe_local_stationary",
                        lambda *a, **k: taken.append("stationary") or fn(*a, **k))
    counts, _, _ = count_on_mesh(get_smoke_config(arch), ShapeSpec("c", 64, 8, kind), tiny_mesh)
    t = terms(counts)
    assert t["compute"] > 0 and t["memory"] > 0, t
    if kind == "decode":  # decode-SP's max and sums over the model axis
        assert counts["op_counts"]["all-reduce"] > 0 and t["collective"] > 0
        assert "w8_matmul" in counts["kernels"]  # int8 serving weights
    if arch.startswith("qwen3-moe"):
        assert taken and counts["op_counts"]["all-gather"] > 0
        assert "moe_ffn" not in counts["kernels"]  # stationary: its products apart
    else:
        assert not taken


def test_cells_match_the_reference():
    pairs = [(a, s) for a in ARCH_NAMES for s in SHAPES]
    assert len(pairs) == 40
    assert [cell_status(a, s) for a, s in pairs] == [jcell_status(a, s) for a, s in pairs]
    assert list(iter_cells()) == list(jiter_cells())


def shapes_of(tree) -> dict:
    if isinstance(tree, dict):
        return {k: shapes_of(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_stand_ins_match_the_reference(arch):
    for shape in SHAPES:
        assert shapes_of(S.input_specs(arch, shape)) == shapes_of(
            JS.input_specs(arch, shape)), shape
    jcfg, tcfg = jget_smoke(arch), get_smoke_config(arch)
    sh = ShapeSpec("t", 64, 8, "train")
    assert shapes_of(S.train_batch_shapes(tcfg, sh)) == shapes_of(
        JS.train_batch_shapes(jcfg, sh))
    assert shapes_of(S.decode_token_shapes(tcfg, SMOKE_DECODE)) == shapes_of(
        JS.decode_token_shapes(jcfg, SMOKE_DECODE))


def ref_cache_entries(jcfg, sh, mesh_shape, rules) -> list:
    model = jbuild(jcfg)
    tree = jax.eval_shape(lambda: model.init_cache(sh.global_batch, sh.seq_len))
    with JP.axis_rules(rules, mesh_shape):
        specs = JS.cache_partition_specs(tree)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, JP.P))
    out = []
    for (path, leaf), spec in zip(flat, spec_leaves):
        name = path[-1].key
        entries = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
        if path[0].key == "units":
            out += [(name, tuple(leaf.shape[1:]), entries[1:])] * leaf.shape[0]
        else:
            out.append((name, tuple(leaf.shape), entries))
    return sorted(out, key=repr)


def port_cache_entries(tcfg, sh, mesh_shape, rules) -> list:
    model = build_model(tcfg, device="meta", seed=None)
    cache = S.cache_shapes(model, tcfg, sh)
    with TP.axis_rules(rules, mesh_shape):
        specs = S.cache_partition_specs(cache)
    out = []
    for layer, spec in zip(cache, specs):
        for name, leaf in layer.items():
            entries = tuple(spec[name]) + (None,) * (leaf.dim() - len(spec[name]))
            out.append((name, tuple(leaf.shape), entries))
    return sorted(out, key=repr)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_shapes_and_specs_match_the_reference(arch):
    cases = [(jget_smoke(arch), get_smoke_config(arch), SMOKE_DECODE)]
    for shape in ("decode_32k", "long_500k"):
        if cell_status(arch, shape) == "run":
            cases.append((jget_config(arch), get_config(arch), SHAPES[shape]))
    seen = collections.Counter()
    for jcfg, tcfg, sh in cases:
        for mesh_shape, rules in MESHES.values():
            want = ref_cache_entries(jcfg, sh, mesh_shape, getattr(JP, rules))
            got = port_cache_entries(tcfg, sh, mesh_shape, getattr(TP, rules))
            assert got == want, (jcfg.name, sh.name, rules)
            seen.update(e[2] != (None,) * len(e[2]) for e in got)
    assert seen[True] > 0  # some leaves are split
    assert np.all([len(c) for c in cases])
