"""The benchmark measures the port alone: no module under ``rmbench/``
imports JAX or the JAX package (top-level names compared whole, so
``repro_torch`` passes), and the references import nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path) -> set[str]:
    """Top-level names of every absolute import in ``path``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    hits = {f.relative_to(ROOT).as_posix(): imported(f) & FORBIDDEN for f in files}
    assert not any(hits.values()), hits
    assert "repro_torch" in set().union(*(imported(f) for f in files))


def test_the_references_import_nothing_of_the_program():
    for f in sorted((BENCH / "reference").glob("*.py")) + [BENCH / "inputs.py",
                                                           *sorted((BENCH / "work").glob("*.py"))]:
        assert not imported(f) & (FORBIDDEN | {"repro_torch"}), f


def test_loading_the_harness_and_the_program_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import rmbench\n"
        "from rmbench import manifest, run\n"
        "for m in pkgutil.walk_packages(rmbench.__path__, 'rmbench.'):\n"
        "    if not m.name.split('.')[-1].startswith('test_'):\n"
        "        importlib.import_module(m.name)\n"
        "man = manifest.Manifest()\n"
        "for name in man.cells:\n"
        "    cell = man.cell(name)\n"
        "    cell.driver(); cell.readers()\n"
        "run.use_program(man.root)\n"
        "import repro_torch.serve, repro_torch.train, repro_torch.data, repro_torch.models\n"
        "print(run.forbidden_modules())\n"
        "sys.exit(1 if run.forbidden_modules() else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=ROOT, env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_forbidden_names_are_compared_whole(monkeypatch):
    from rmbench import run

    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    monkeypatch.setitem(sys.modules, "repro.core", object())
    found = run.forbidden_modules()
    assert "repro.core" in found and "repro_torch_like" not in found
    assert all(name.split(".")[0] in FORBIDDEN for name in found)
