"""The port stands alone: no JAX, nothing of the JAX package, no silent CPU.

* importing every ``repro_torch`` module loads neither ``jax`` nor ``repro``;
* no source line of the port or of ``chip_smoke.py`` imports them;
* without a card, the engine's default device raises, and ``chip_smoke.py``
  exits non-zero without printing a result (also when it stands alone in a
  directory).  Those checks skip where a card is present.
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
