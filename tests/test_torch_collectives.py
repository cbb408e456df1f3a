"""The port's compressed collectives against the JAX package's, on the CPU.

* ``quantize_int8`` / ``dequantize_int8`` bit-equal to JAX's on seeded
  inputs (ties at half a step, all zeros, wide ranges);
* in a gloo world of 4 (``tests/torch_worlds.py``), each rank holding one
  shard as the reference test's ``shard_map`` over ``data`` does
  (``tests/test_distributed.py`` ``test_compressed_collectives``): ``"none"``
  equals the exact sum (inputs on a 2^-10 grid, so every float32 sum is
  exact), ``"bf16"`` is within 0.05 of it and ``"int8_ef"`` within 0.5, as
  there; the int8 sum equals JAX's per-shard ``dequantize(quantize(x + r))``
  summed (the same float32 values in another order: within 4 ulp of the
  largest magnitude), each rank's new residual is bit-equal to JAX's
  ``comp - dequantize(quantize(comp))`` for its shard, and every rank holds
  the same sums; nested trees reduce leaf by leaf, and an unknown mode
  raises.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from torch_worlds import collectives_world, collective_inputs, run_world  # noqa: E402

from repro.distributed import collectives as JC  # noqa: E402
from repro_torch.distributed import collectives as TC  # noqa: E402

WORLD = 4


QUANT_CASES = {
    "normal": lambda rng: rng.normal(0, 1, (64, 48)),
    "wide": lambda rng: rng.normal(0, 1, (3, 5, 7)) * 10.0 ** rng.integers(-6, 6, (3, 5, 7)),
    "ties": lambda rng: rng.integers(-254, 255, (40,)) / 2.0,
    "zeros": lambda rng: np.zeros((5, 5)),
    "tiny": lambda rng: rng.normal(0, 1e-14, (16,)),
    "scalar_like": lambda rng: np.array([-3.5]),
}


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quantize_int8_bit_equal_to_jax(case):
    x = QUANT_CASES[case](np.random.default_rng(7)).astype(np.float32)
    if case == "ties":  # a max of 127 puts every half-integer on a tie
        x[0] = 127.0
    jq, js = JC.quantize_int8(jnp.asarray(x))
    tq, ts = TC.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == ()
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js, np.float32).tobytes()
    np.testing.assert_array_equal(TC.dequantize_int8(tq, ts).numpy(),
                                  np.asarray(JC.dequantize_int8(jq, js)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(collectives_world, WORLD, tmp_path_factory.mktemp("collectives"), 3,
                     timeout=180)


def test_exact_and_bf16_sums(world):
    g, _ = collective_inputs(3, WORLD)
    exact = g.sum(0)  # on the 2^-10 grid: exact in float32
    for out in world:
        np.testing.assert_array_equal(out["none"].numpy(), exact)
        assert float(np.abs(out["bf16"].numpy() - exact).max()) < 0.05
        assert out["bf16"].dtype == torch.float32
        assert torch.equal(out["bf16"], world[0]["bf16"])


def test_int8_ef_against_jax_per_shard(world):
    g, r = collective_inputs(3, WORLD)
    deq, res = [], []
    for x, e in zip(g, r):
        comp = jnp.asarray(x) + jnp.asarray(e)
        q, s = JC.quantize_int8(comp)
        deq.append(np.asarray(JC.dequantize_int8(q, s)))
        res.append(np.asarray(comp - JC.dequantize_int8(q, s)))
    want = np.sum(deq, axis=0, dtype=np.float32)
    ulp = 4 * np.finfo(np.float32).eps * float(np.abs(want).max())
    for rank, out in enumerate(world):
        reduced, new_res = out["int8"]
        np.testing.assert_allclose(reduced.numpy(), want, rtol=0, atol=ulp)
        assert float(np.abs(reduced.numpy() - g.sum(0)).max()) < 0.5
        np.testing.assert_array_equal(new_res.numpy(), res[rank])
        assert float(np.linalg.norm(new_res.numpy())) > 0  # error feedback captured
        assert torch.equal(reduced, world[0]["int8"][0])


def test_trees_reduce_leaf_by_leaf(world):
    g, r = collective_inputs(3, WORLD)
    for out in world:
        bf = out["tree_bf16"]
        assert set(bf) == {"a", "b"} and set(bf["b"]) == {"c"}
        assert torch.equal(bf["a"], world[0]["bf16"])
        assert float(np.abs(bf["b"]["c"].numpy() - 2 * g.sum(0)).max()) < 0.1
        reduced, res = out["tree_int8"]
        assert torch.equal(reduced["a"], out["int8"][0]) and torch.equal(res["a"], out["int8"][1])
        assert set(res["b"]) == {"c"} and float(np.abs(reduced["b"]["c"].numpy()
                                                       - 2 * g.sum(0)).max()) < 1.0


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown compression mode"):
        TC.tree_psum_compressed({"a": torch.zeros(2)}, None, None, "fp8")
