"""BENCHMARK.json keeps to its contract, every entry resolves by name, and a
new configuration, mix and metric are added as new files alone."""

import hashlib
import json
import re
from pathlib import Path

import pytest

from rmbench import manifest, tiny

ROOT = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DATA = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_has_the_contract_keys_and_limits():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert DATA["paths"] == ["rmbench"] and DATA["command"][:2] == ["python3", "-m"]
    assert 1 <= DATA["run_seconds"] <= 51 and isinstance(DATA["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in DATA[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in DATA["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in DATA["end_to_end"])
    chips = [w["chips"] for w in DATA["workloads"]]
    assert all(c in (1, 4) for c in chips) and chips.count(4) <= max(1, len(chips) // 4)
    for w in DATA["workloads"] + DATA["configs"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


@pytest.mark.parametrize("cell", sorted(w["name"] for w in DATA["workloads"]))
def test_every_cell_resolves_by_name(cell):
    c = manifest.Manifest().cell(cell)
    assert c.driver_path.is_file() and hasattr(c.driver(), "run")
    assert c.mix.get("driver", c.config["driver"]) == c.config["driver"]
    e2e = {m.name for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m.moves in e2e
    for name, read in c.readers().items():
        assert callable(read) and read({}) is None  # nothing to read: no value


def test_every_metric_file_and_config_file_is_named_by_the_manifest():
    bench = ROOT / "rmbench"
    readers = {p.stem for p in (bench / "metrics").glob("*.py")} - {"__init__"}
    assert readers == {m["name"] for m in DATA["per_layer"]}
    assert {Path(c["file"]) for c in DATA["configs"]} == {
        p.relative_to(ROOT) for p in (bench / "configs").glob("*.json")}
    for c in DATA["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert "limits" in cfg


def _digest(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_config_mix_and_metric_are_new_files_only(tmp_path):
    bench = tiny.make(tmp_path)
    before = _digest(ROOT / "rmbench")
    (bench / "metrics" / "rm.ticks.py").write_text(
        "def read(run):\n    c = run.get('counters')\n    return c and c['ticks']\n")
    data = json.loads((tmp_path / "BENCHMARK.json").read_text())
    data["per_layer"].append({"name": "rm.ticks", "unit": "ticks", "better": "higher",
                              "source": "program_counter",
                              "layer": "serve/query_server.py QueryServer",
                              "moves": "queries_per_s", "workloads": ["rm_tiny.scan_mix_tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    m = manifest.Manifest(bench)
    cell = m.cell("rm_tiny.scan_mix_tiny")
    assert cell.config["rows"] == 4096 and cell.mix["clients"] == 4
    assert cell.readers()["rm.ticks"]({"counters": {"ticks": 3}}) == 3
    assert "rm.ticks" not in m.cell("rm_tiny.single_tiny").readers()
    assert m.cell("qwen3-tiny.train_tiny").config["hidden_size"] == 64
    copied = _digest(bench)
    assert all(copied[k] == v for k, v in before.items())  # no file of the benchmark changed
    assert _digest(ROOT / "rmbench") == before


def test_an_unknown_cell_or_missing_file_is_refused(tmp_path):
    with pytest.raises(KeyError):
        manifest.Manifest().cell("no_such.cell")
    bench = tiny.make(tmp_path)
    (bench / "mixes" / "train_tiny.json").unlink()
    with pytest.raises(FileNotFoundError):
        manifest.Manifest(bench).cell("qwen3-tiny.train_tiny")
