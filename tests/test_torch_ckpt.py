"""The port's checkpoints against the JAX package's, on the CPU.

The same tree (float32, int32, bf16 and 0-d leaves, nested dicts and a
list) saved by both packages gives the same file names, byte-equal
``.npy`` files (bf16 as raw ``uint16`` under the name ``"bfloat16"``, with
``ml_dtypes`` on the reference's side and torch's ``view`` on the port's)
and the same manifest apart from ``time``; each package restores the
other's checkpoint bit for bit; structure and shape mismatches raise
``ValueError``; the manager keeps its cadence and retention.
"""

import filecmp
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.ckpt import CheckpointManager as JManager  # noqa: E402
from repro.ckpt import restore_checkpoint as jrestore  # noqa: E402
from repro.ckpt import save_checkpoint as jsave  # noqa: E402
from repro_torch.ckpt import (  # noqa: E402
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

DTYPES = {"float32": (jnp.float32, torch.float32), "int32": (jnp.int32, torch.int32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def trees(kinds, seed=0):
    """The same tree for both packages: ``(jax tree, torch tree)``."""
    rng = np.random.default_rng(seed)
    jt, tt = {}, {}
    for i, kind in enumerate(kinds):
        jd, td = DTYPES[kind]
        a = (rng.integers(-50, 50, (3, 5 + i)) if kind == "int32"
             else rng.standard_normal((3, 5 + i)))
        ja = jnp.asarray(a, jd)
        jt[f"{kind}_{i}"] = {"w": ja, "v": [ja[0], ja[1:]]}
        ta = torch.from_numpy(np.array(ja.astype(jnp.float32) if kind == "bfloat16"
                                         else ja)).to(td)
        tt[f"{kind}_{i}"] = {"w": ta, "v": [ta[0], ta[1:]]}
    jt["step"] = jnp.asarray(7, jnp.int32)
    tt["step"] = torch.tensor(7, dtype=torch.int32)
    return jt, tt


def assert_same_files(p1, p2):
    names = sorted(os.listdir(p1))
    assert names == sorted(os.listdir(p2))
    for f in names:
        if f.endswith(".npy"):
            assert filecmp.cmp(os.path.join(p1, f), os.path.join(p2, f), shallow=False), f
    m1, m2 = (json.load(open(os.path.join(p, "manifest.json"))) for p in (p1, p2))
    m1.pop("time")
    m2.pop("time")
    assert m1 == m2 and list(m1["leaves"]) == list(m2["leaves"])


def assert_tree_equal(t, j):
    if isinstance(t, dict):
        assert set(t) == set(j)
        for k in t:
            assert_tree_equal(t[k], j[k])
    elif isinstance(t, list):
        for a, b in zip(t, j):
            assert_tree_equal(a, b)
    else:
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
        np.testing.assert_array_equal(t.float().numpy() if t.dtype == torch.bfloat16
                                      else t.numpy(), np.asarray(j, np.float32
                                                                 if t.dtype == torch.bfloat16
                                                                 else j.dtype))


@pytest.mark.parametrize("kinds", [("float32",), ("int32",), ("bfloat16",),
                                   ("float32", "int32", "bfloat16")], ids="-".join)
def test_files_byte_equal_and_cross_restore(tmp_path, kinds):
    jt, tt = trees(kinds)
    p1 = jsave(str(tmp_path / "ref"), 3, jt, extra={"note": "x"})
    p2 = save_checkpoint(str(tmp_path / "port"), 3, tt, extra={"note": "x"})
    assert_same_files(p1, p2)
    step, got = restore_checkpoint(str(tmp_path / "ref"), tt)
    assert step == 3
    assert_tree_equal(got, jt)
    step, got = jrestore(str(tmp_path / "port"), jt)
    assert step == 3
    assert_tree_equal(tt, got)


def test_restore_onto_the_like_dtype_and_a_step(tmp_path):
    """Each leaf takes the like leaf's dtype (and device); an explicit step
    picks that checkpoint."""
    _, tt = trees(("float32",))
    save_checkpoint(str(tmp_path), 1, tt)
    tt2 = {k: v for k, v in tt.items()}
    tt2["float32_0"] = {"w": tt["float32_0"]["w"] * 2, "v": tt["float32_0"]["v"]}
    save_checkpoint(str(tmp_path), 2, tt2)
    assert latest_step(str(tmp_path)) == 2
    like = {k: v for k, v in tt.items()}
    like["float32_0"] = {"w": tt["float32_0"]["w"].double(), "v": tt["float32_0"]["v"]}
    step, got = restore_checkpoint(str(tmp_path), like, step=1)
    assert step == 1 and got["float32_0"]["w"].dtype == torch.float64
    assert torch.equal(got["float32_0"]["w"].float(), tt["float32_0"]["w"])
    assert got["step"].shape == () and int(got["step"]) == 7


def test_structure_and_shape_mismatch_raise(tmp_path):
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.ones((3, 4), dtype=torch.bfloat16)}}
    save_checkpoint(str(tmp_path), 7, tree)
    step, restored = restore_checkpoint(str(tmp_path), tree)
    assert step == 7 and torch.equal(restored["a"], tree["a"])
    with pytest.raises(ValueError, match="structure"):
        restore_checkpoint(str(tmp_path), {"a": tree["a"]})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), {"a": tree["a"][:5], "b": tree["b"]})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), tree)


def test_manager_cadence_and_retention(tmp_path):
    """The manager's cadence and retention, side by side with the
    reference's."""
    tm, jm = CheckpointManager(str(tmp_path / "t"), keep=2, every_steps=3), \
        JManager(str(tmp_path / "j"), keep=2, every_steps=3)
    assert [tm.should_save(s) for s in range(8)] == [jm.should_save(s) for s in range(8)]
    for s in (3, 6, 9):
        tm.save(s, {"x": torch.tensor(float(s))})
        jm.save(s, {"x": jnp.asarray(float(s))})
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j")) == \
        ["step_00000006", "step_00000009"]
    step, got = tm.restore({"x": torch.tensor(0.0)})
    assert step == 9 and float(got["x"]) == 9.0
