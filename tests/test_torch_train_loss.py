"""The port's training loss against the JAX package's, on the CPU, for each
of the ten smoke configs.

The reference's ``model.init(PRNGKey(0))`` goes to numpy and, through
``params_from_reference``, into a port model holding float32 master weights
(``param_dtype="float32"``); a batch of 2 × 128 positions drawn from a
seed with numpy (two ``loss_chunk`` chunks of the cross entropy, padded SSD
and attention chunks where the smoke's chunk is smaller) goes through both
``loss``es:

* float32 compute: the loss within 1e-5, and every gradient — the
  reference's ``jax.grad`` tree mapped through ``params_from_reference`` —
  within ``rtol 1e-3`` plus ``1e-5 * ||g||`` (the global norm): the two sum
  in other orders (XLA's fusions, a loop for ``lax.scan``, the sequential
  RG-LRU recurrence for ``associative_scan``), and a gradient near zero
  carries the absolute part of that noise;
* bfloat16 compute: the loss within 1e-2 relative (the two frameworks round
  bf16 activations at other places).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_NAMES  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch.configs import get_smoke_config as tget_smoke  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

B, S = 2, 128


def loss_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.is_encdec:
        batch["enc_embeds"] = rng.standard_normal((B, 16, cfg.d_model)).astype(np.float32)
    if cfg.embed_inputs:
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    else:
        batch["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        if cfg.mrope:  # distinct t / h / w components
            pos = np.broadcast_to(np.arange(S), (B, 3, S)).copy()
            pos[:, 1] //= 2
            pos[:, 2] %= 7
            batch["positions"] = pos.astype(np.int32)
    return batch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_loss_and_gradients_match_reference(arch, dtype):
    jcfg = dataclasses.replace(jget_smoke(arch), compute_dtype=dtype)
    tcfg = dataclasses.replace(tget_smoke(arch), compute_dtype=dtype)
    jmodel = jbuild(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    batch = loss_batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    model = tbuild(tcfg, device="cpu", seed=None, param_dtype="float32")
    model.load_state_dict(params_from_reference(tcfg, jax.tree.map(np.asarray, params)))
    if dtype == "bfloat16":
        want = float(jax.jit(lambda p: jmodel.loss(p, jb)[0])(params))
        with torch.no_grad():
            got = float(model.loss(dict(model.state_dict()), tb)[0])
        assert abs(got - want) <= 1e-2 * abs(want), (got, want)
        return
    (want, wm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jb), has_aux=True))(params)
    leaves = {k: v.clone().requires_grad_() for k, v in model.state_dict().items()}
    loss, metrics = model.loss(leaves, tb)
    loss.backward()
    assert abs(float(loss.detach()) - float(want)) <= 1e-5
    assert abs(float(metrics["aux"].detach()) - float(wm["aux"])) <= 1e-5
    want_g = params_from_reference(tcfg, jax.tree.map(lambda g: np.asarray(g, np.float32),
                                                      jgrads))
    assert set(want_g) == set(leaves)
    norm = float(np.sqrt(sum(float((g.double() ** 2).sum()) for g in want_g.values())))
    for name, w in want_g.items():
        g = leaves[name].grad
        assert g is not None and g.shape == w.shape, name
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-5 * norm, msg=name)
