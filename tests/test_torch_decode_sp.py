"""Decode-SP (the sequence-parallel cached attention) against the JAX
package's one-device decode, on the CPU — after ``tests/test_distributed.py``
``test_sp_decode_matches_single_device``.

One gloo world of 4 processes (``tests/torch_worlds.py``
``decode_sp_world``, a ``FileStore`` and a deadline) prefills each case
whole, cuts each rank's part of the cache (``launch.specs.shard_cache``:
``k`` and ``v`` as DTensors, the rank's batch rows and its chunk of ring
slots) and decodes through decode-SP at meshes (2, 2) and (1, 4), with the
JAX weights (``models.convert.params_from_reference``) and the JAX greedy
tokens, all float32:

* qwen1.5-110b smoke, B 4, S 32, ``max_len`` 64, two decode steps (the
  reference test's case);
* gemma3-27b smoke, B 4, a 24-token prompt, ``max_len`` 64, twelve decode
  steps (positions 24–35): its local layers' 32-slot ring wraps at
  position 32, so a local layer is decoded past its window.

Each rank's logits for its batch rows are held against the JAX package's
one-device ``decode_step`` at the reference test's rtol and atol 2e-3, and
against the port's own one-device step at ``OWN_TOL`` (rtol and atol 1e-5:
the SP form attends over each chunk as the one-device form does and
combines the chunks' float32 results with their weights, another order of
float32 sums).  A world of one process decodes the same cases at mesh
(1, 1): there the SP form's logits equal the one-device form's bit for
bit.  A step writes the new token into the cache only on the rank that
owns its slot ``pos % s_cache``: there at that slot's place in the chunk,
and nowhere on the others.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch_worlds import SP_MESHES, decode_sp_world, run_world  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch.configs import get_smoke_config as tget_smoke  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

REF_TOL = 2e-3
OWN_TOL = 1e-5
CASES = (("qwen", "qwen1.5-110b", 4, 32, 64, 2), ("gemma", "gemma3-27b", 4, 24, 64, 12))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    saved, want = [], {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name, arch, b, s, max_len, steps in CASES:
            jcfg = dataclasses.replace(jget_smoke(arch), compute_dtype="float32")
            tcfg = dataclasses.replace(tget_smoke(arch), compute_dtype="float32")
            model = jbuild(jcfg)
            params = model.init(jax.random.PRNGKey(1))
            toks = np.random.default_rng(0).integers(0, jcfg.vocab, (b, s)).astype(np.int32)
            logits, cache = jax.jit(lambda p, t: model.prefill(p, {"tokens": t}, max_len))(
                params, jnp.asarray(toks))
            step = jax.jit(model.decode_step)
            ref, fed = [], []
            for i in range(steps):
                tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
                fed.append(torch.from_numpy(np.asarray(tok)))
                logits, cache = step(params, cache, tok, jnp.asarray(s + i, jnp.int32))
                ref.append(np.asarray(logits))
            state = params_from_reference(tcfg, jax.tree.map(np.asarray, params))
            port = tbuild(tcfg, device="cpu", seed=None)
            port.load_state_dict(state)
            _, pcache = port.prefill({"tokens": torch.from_numpy(toks)}, max_len)
            own = [port.decode_step(pcache, tok, s + i)[0] for i, tok in enumerate(fed)]
            want[name] = (np.stack(ref), torch.stack(own).numpy())
            saved.append({"name": name, "arch": arch, "state": state,
                          "tokens": torch.from_numpy(toks), "max_len": max_len, "pos": s,
                          "steps": fed})
    finally:
        torch.set_num_threads(threads)
    root = tmp_path_factory.mktemp("decode_sp")
    torch.save(saved, root / "sp_inputs.pt")
    world = run_world(decode_sp_world, 4, root, str(root), timeout=240)
    one = run_world(decode_sp_world, 1, root / "one", str(root), ((1, 1),), timeout=240)
    return {"want": want, "world": world, "one": one[0]}


PAIRS = [(c[0], m) for c in CASES for m in SP_MESHES]


@pytest.mark.parametrize("name,shape", PAIRS, ids=lambda v: str(v))
def test_sp_logits_match_the_one_device_decode(setup, name, shape):
    ref, own = setup["want"][name]
    for rank in setup["world"]:
        got = rank[name, shape]
        lo, hi = got["rows"]
        np.testing.assert_allclose(got["logits"].numpy(), ref[:, lo:hi], rtol=REF_TOL,
                                   atol=REF_TOL)
        np.testing.assert_allclose(got["logits"].numpy(), own[:, lo:hi], rtol=OWN_TOL,
                                   atol=OWN_TOL)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_sp_at_one_rank_is_the_one_device_decode(setup, name):
    """At a mesh of one rank the SP form gives the one-device form's bits
    (its combine's weight is ``l / l = 1``; no collective is called), and
    both are held to the JAX decode."""
    got = setup["one"][name, (1, 1)]
    assert torch.equal(got["logits"], got["one_device"])
    np.testing.assert_allclose(got["logits"].numpy(), setup["want"][name][0], rtol=REF_TOL,
                               atol=REF_TOL)


@pytest.mark.parametrize("name,shape", PAIRS, ids=lambda v: str(v))
def test_the_new_token_lands_only_on_the_owning_rank(setup, name, shape):
    case = next(c for c in CASES if c[0] == name)
    pos0 = case[3]
    for rank in setup["world"]:
        got = rank[name, shape]
        idx = got["coord"][1]
        for i, writes in enumerate(got["writes"]):
            for layer, (chunk, slots) in enumerate(zip(got["chunks"], got["slots"])):
                assert chunk * shape[1] == slots
                slot = (pos0 + i) % slots
                owner = slot // chunk == idx
                assert writes[layer] == ([slot - idx * chunk] if owner else []), (i, layer)


def test_a_local_layer_wraps_in_the_sp_form(setup):
    """gemma3's local layers hold 32 slots; positions 32–35 write slots
    0–3 again, in the chunk of the first model rank."""
    for rank in setup["world"]:
        got = rank["gemma", (1, 4)]
        assert got["slots"][0] == 32 and got["chunks"][0] == 8
        late = got["writes"][-1][0]  # position 35 -> slot 3
        assert late == ([3] if got["coord"][1] == 0 else [])
