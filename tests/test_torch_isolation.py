"""The port stands alone: no JAX, nothing of the JAX package, no silent CPU.

* importing every ``repro_torch`` module loads neither ``jax`` nor ``repro``;
* no source line of the port or of ``chip_smoke.py`` imports them;
* without a card, the default device of the engine (the sharded one and
  its server too) and of the LM entry
  points (``DecoderLM``, ``build_model``, hence ``ServeSession``, and the
  serving launcher) raises, and ``chip_smoke.py``
  exits non-zero without printing a result (also when it stands alone in a
  directory).  Those checks skip where a card is present.

``launch.mesh.make_production_mesh`` and the dry run (``launch.dryrun``)
run on ``meta`` tensors in a fake process group by design: they count a
step's operations and allocate and compute nothing, as the reference's dry
run lowers its step for placeholder host devices.  A model on ``meta``
(``device="meta"``) is the one device besides the card and the CPU that a
caller may name; nothing falls back to it.
"""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|from\s+repro(\.|\s))",
    re.M)


def port_modules() -> list[str]:
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages([str(PORT)], prefix="repro_torch.")]


def test_port_modules_load_no_jax_and_no_reference_package():
    mods = port_modules()
    assert "repro_torch.core.engine" in mods and "repro_torch.kernels._cuda" in mods
    assert {"repro_torch.configs.base", "repro_torch.core.distributed",
            "repro_torch.kernels.flash_attention", "repro_torch.kernels.moe_ffn",
            "repro_torch.kernels.rglru_scan", "repro_torch.configs.mamba2_1_3b",
            "repro_torch.configs.recurrentgemma_9b",
            "repro_torch.models.layers", "repro_torch.models.lm",
            "repro_torch.models.convert", "repro_torch.models.registry",
            "repro_torch.serve.engine", "repro_torch.launch.serve",
            "repro_torch.data.pipeline", "repro_torch.ckpt.checkpoint",
            "repro_torch.train.optimizer", "repro_torch.train.step",
            "repro_torch.train.trainer", "repro_torch.launch.train",
            "repro_torch.distributed", "repro_torch.distributed.partitioning",
            "repro_torch.distributed.collectives", "repro_torch.distributed.pipeline",
            "repro_torch.launch.mesh", "repro_torch.train.sharded",
            "repro_torch.launch.specs", "repro_torch.launch.dryrun",
            "repro_torch.roofline", "repro_torch.roofline.analysis",
            "repro_torch.roofline.report"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_line_imports_jax_or_the_reference_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    hits = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
            for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert not hits, hits
    # the pattern does catch what it must
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("from repro.core import engine")
    assert not FORBIDDEN.search("from repro_torch.core import engine")


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.core import RelationalMemoryEngine

    with pytest.raises(RuntimeError, match="no CUDA device"):
        RelationalMemoryEngine()


@pytest.mark.parametrize("entry", ["ShardedEngine", "mesh", "QueryServer"])
def test_sharded_backend_defaults_to_the_card(entry):
    """The sharded engine, its mesh entries and the sharded server resolve
    their devices as the engine does: the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.core import ShardedEngine
    from repro_torch.serve import QueryServer

    calls = {"ShardedEngine": lambda: ShardedEngine(num_shards=4),
             "mesh": lambda: ShardedEngine(mesh=[None, None]),
             "QueryServer": lambda: QueryServer(num_shards=4)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    assert ShardedEngine(num_shards=4, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("entry", ["DecoderLM", "build_model", "ServeSession", "launcher"])
def test_lm_entry_points_default_to_the_card(entry):
    """Without a card each LM entry point raises unless asked for the CPU.
    A ``ServeSession`` runs where its model lives, so a session on the
    default device needs a model built on it — which raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import main
    from repro_torch.models import build_model
    from repro_torch.models.lm import DecoderLM
    from repro_torch.serve import ServeSession

    cfg = get_smoke_config("qwen3-8b")
    calls = {
        "DecoderLM": lambda: DecoderLM(cfg),
        "build_model": lambda: build_model(cfg),
        "ServeSession": lambda: ServeSession(build_model(cfg), batch_slots=2, max_len=16),
        "launcher": lambda: main(["--arch", "qwen3-8b", "--smoke"]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    assert DecoderLM(cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("entry", ["RecordStore", "train_model", "launcher", "make_mesh",
                                   "host_device_mesh", "make_sharded_train_step",
                                   "make_sharded_train_step_moe"])
def test_train_entry_points_default_to_the_card(entry):
    """The training path's entry points resolve their device as the engine
    does: the record store (its engine), a model built with master weights,
    the training launcher, the mesh builders and the sharded step (its mesh,
    by default ``host_device_mesh()``; on a dense and on an MoE config) raise
    without a card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import RecordStore
    from repro_torch.launch.mesh import host_device_mesh, make_mesh
    from repro_torch.launch.train import main
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig
    from repro_torch.train.sharded import make_sharded_train_step

    cfg = get_smoke_config("qwen3-8b")
    moe = get_smoke_config("qwen3-moe-235b-a22b")
    calls = {
        "RecordStore": lambda: RecordStore(seq_len=8),
        "train_model": lambda: build_model(cfg, param_dtype=cfg.param_dtype),
        "launcher": lambda: main(["--arch", "qwen3-8b", "--smoke", "--steps", "1"]),
        "make_mesh": lambda: make_mesh((1, 1), ("data", "model")),
        "host_device_mesh": lambda: host_device_mesh(),
        "make_sharded_train_step": lambda: make_sharded_train_step(
            build_model(cfg, device="cpu", param_dtype=cfg.param_dtype), AdamWConfig()),
        "make_sharded_train_step_moe": lambda: make_sharded_train_step(
            build_model(moe, device="cpu", param_dtype=moe.param_dtype), AdamWConfig()),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    assert RecordStore(seq_len=8, device="cpu").engine.device.type == "cpu"


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = REPO / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    proc = subprocess.run([sys.executable, str(script), "--rows", "64"],
                          capture_output=True, text=True, timeout=120,
                          cwd=script.parent)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "kernels" not in proc.stdout
