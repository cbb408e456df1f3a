"""The port's partition specs against the JAX package's, on the CPU.

No processes and no devices: JAX's rules are installed with
``axis_rules(rules, mesh_shape)``, which needs no mesh, and the port's the
same way.  For every ``ARCH_NAMES`` config at full width — the reference's
parameter tree from ``jax.eval_shape(model.init)``, the port's names and
shapes from ``expected_shapes`` — and for the int8 trees
(``quantize_for_serving`` / ``expected_shapes(quantized=True)``), under
``SINGLE_POD_RULES`` at mesh shapes (16, 16), (4, 2), (2, 4) and (1, 1)
and ``MULTI_POD_RULES`` at (2, 16, 16) and (2, 2, 2): every leaf's port
spec equals the reference's with its stack dimension dropped, and so do
the ZeRO-1 moment specs (``opt_state_specs``), ``logical_spec`` and
``batch_specs``.  ``placements`` and ``rules_for_mesh`` are checked on
stand-in meshes (only ``mesh_dim_names`` is read).
"""

import functools
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro.configs import ARCH_NAMES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.distributed import partitioning as JP  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models.layers import quantize_for_serving as jquantize  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.distributed import partitioning as TP  # noqa: E402
from repro_torch.models.convert import expected_shapes  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402

MESHES = [("single", (16, 16)), ("single", (4, 2)), ("single", (2, 4)), ("single", (1, 1)),
          ("multi", (2, 16, 16)), ("multi", (2, 2, 2))]
AXES = {"single": ("data", "model"), "multi": ("pod", "data", "model")}


def rules_of(kind: str, shape: tuple) -> tuple[dict, dict]:
    axes = AXES[kind]
    mesh = types.SimpleNamespace(mesh_dim_names=axes)
    return TP.rules_for_mesh(mesh), dict(zip(axes, shape))


@functools.lru_cache(maxsize=None)
def reference_shapes(arch: str, quantized: bool):
    model = jbuild(jget_config(arch))
    init = model.init
    if quantized:
        return jax.eval_shape(lambda k: jquantize(init(k)), jax.random.PRNGKey(0))
    return jax.eval_shape(init, jax.random.PRNGKey(0))


def by_port_name(cfg, tree, stack: bool = False) -> dict:
    """The reference's per-leaf specs keyed by the port's names: a stacked
    unit leaf's spec, its stack dimension dropped, for every layer it
    stands for (the inverse of ``params_from_reference``); ``stack``: the
    stack dimension's entry instead (``None`` for an unstacked leaf)."""
    width = len(cfg.block_pattern)
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP.P))[0]
    for kp, spec in flat:
        path = [p.key for p in kp]
        spec = tuple(spec)
        top = path[0]
        if cfg.is_encdec and top in ("enc_units", "units"):
            n, prefix = ((cfg.n_enc_layers, "enc_layers") if top == "enc_units"
                         else (cfg.n_layers, "layers"))
            for u in range(n):
                out[".".join([prefix, str(u), *path[1:]])] = spec[0] if stack else spec[1:]
        elif top == "units":
            i = int(path[1][1:])
            for u in range(cfg.n_units):
                out[".".join(["layers", str(u * width + i), *path[2:]])] = (
                    spec[0] if stack else spec[1:])
        elif top == "tail":
            out[".".join(["layers", str(cfg.n_units * width + int(path[1][1:])),
                          *path[2:]])] = None if stack else spec
        else:
            out[".".join(path)] = None if stack else spec
    return out


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("kind,shape", MESHES, ids=[f"{k}{'x'.join(map(str, s))}"
                                                     for k, s in MESHES])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_every_leaf_spec_matches_the_reference(arch, kind, shape, quantized):
    rules, sizes = rules_of(kind, shape)
    shapes = reference_shapes(arch, quantized)
    with JP.axis_rules(rules, sizes):
        want = JP.params_partition_specs(shapes)
        want_mu = JO.opt_state_specs(shapes)["mu"]
    tcfg = tget_config(arch)
    port_shapes = expected_shapes(tcfg, quantized)
    with TP.axis_rules(rules, sizes):
        got = TP.params_partition_specs(port_shapes)
        got_opt = TO.opt_state_specs(port_shapes)
        got_state = TS.train_state_specs(port_shapes)
    on_stack = by_port_name(tcfg, want_mu, stack=True)
    want, want_mu = by_port_name(tcfg, want), by_port_name(tcfg, want_mu)
    assert set(got) == set(want) == set(port_shapes)
    assert {k: tuple(v) for k, v in got.items()} == want
    # where the reference's ZeRO axis landed on the stack dimension (a
    # stacked vector whose layer count the data axes divide), the port's
    # leaf has no such dimension: it takes the reference's rule on the
    # unstacked leaf, as the reference places its unstacked tail layers
    with JP.axis_rules(rules, sizes):
        for k, entry in on_stack.items():
            if entry is not None:
                want_mu[k] = tuple(JO._with_zero_axis(JP.P(*want[k]), port_shapes[k]))
    assert {k: tuple(v) for k, v in got_opt["mu"].items()} == want_mu
    assert got_opt["nu"] == got_opt["mu"] and got_opt["step"] == TP.P()
    assert got_state == {"params": got, "opt": got_opt}
    # every shard a spec names is even
    for k, spec in got_opt["mu"].items():
        for n, entry in zip(port_shapes[k], spec):
            axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
            parts = 1
            for a in axes:
                parts *= sizes[a]
            assert n % parts == 0, (k, spec)


LOGICAL = [(("batch", None, "heads", None), (256, 2048, 32, 128)),
           (("batch", "kv_heads", "kv_seq", None), (8, 8, 4096, 128)),
           (("batch", "kv_heads", "kv_seq", None), (6, 2, 30, 16)),
           (("batch", None, "mlp"), (2, 4, 12288)),
           (("vocab", "embed"), (151936, 4096)),
           ((None, "expert", "expert_ff"), (3, 128, 1536)),
           (("batch", "batch", "model"), (64, 64, 64))]


@pytest.mark.parametrize("kind,shape", MESHES)
def test_logical_and_batch_specs_match_the_reference(kind, shape):
    rules, sizes = rules_of(kind, shape)
    batches = [{"tokens": (b, 128), "labels": (b, 128)} for b in (1, 6, 8, 256, 512)]
    batches.append({"embeds": (32, 64, 96), "positions": (32, 3, 64), "labels": (32, 64)})
    with JP.axis_rules(rules, sizes):
        want = [tuple(JP.logical_spec(*n, shape=s)) for n, s in LOGICAL]
        want += [tuple(JP.logical_spec(*n)) for n, _ in LOGICAL]
        want_b = [{k: tuple(v) for k, v in JS.batch_specs(
            {k: jax.ShapeDtypeStruct(s, "int32") for k, s in b.items()}).items()}
            for b in batches]
    with TP.axis_rules(rules, sizes):
        got = [tuple(TP.logical_spec(*n, shape=s)) for n, s in LOGICAL]
        got += [tuple(TP.logical_spec(*n)) for n, _ in LOGICAL]
        got_b = [{k: tuple(v) for k, v in TS.batch_specs(b).items()} for b in batches]
    assert got == want and got_b == want_b


def test_no_rules_means_no_constraint():
    assert TP.current_rules() is None
    assert TP.logical_spec("batch", None) == TP.P()
    assert TP.param_partition_spec("layers.0.mixer.wq", (96, 96)) == TP.P()
    assert TO.opt_state_specs({"lm_head": (96, 512)})["mu"] == {"lm_head": TP.P()}
    x = torch.ones(4, 4)
    assert TP.lsc(x, "batch", None) is x
    with TP.axis_rules(TP.SINGLE_POD_RULES, {"data": 2, "model": 2}):
        assert TP.lsc(x, "batch", None) is x  # a plain tensor is left alone


def test_rules_and_placements_on_stand_in_meshes():
    single = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    multi = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert TP.rules_for_mesh(single) == JP.SINGLE_POD_RULES
    assert TP.rules_for_mesh(multi) == JP.MULTI_POD_RULES
    data_only = TP.rules_for_mesh(types.SimpleNamespace(mesh_dim_names=("data",)))
    assert data_only["model"] == () and data_only["batch"] == ("data",)
    assert TP.placements(single, TP.P("data", "model")) == (Shard(0), Shard(1))
    assert TP.placements(single, TP.P(None, "data")) == (Shard(1), Replicate())
    assert TP.placements(single, TP.P()) == (Replicate(), Replicate())
    assert TP.placements(multi, TP.P(("pod", "data"), "model")) == (Shard(0), Shard(0),
                                                                     Shard(1))
    with pytest.raises(ValueError, match="order"):
        TP.placements(multi, TP.P(("data", "pod"), None))
    assert repr(TP.P(None, "data")) == "PartitionSpec(None, 'data')"
    assert tuple(TP.P(None, ("pod", "data"))) == tuple(JP.P(None, ("pod", "data")))
