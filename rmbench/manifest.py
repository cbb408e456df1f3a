"""``BENCHMARK.json`` and the files it names, resolved by name.

A cell (an entry of ``workloads``) finds its configuration through
``configs[].file``, its traffic mix as ``mixes/<traffic>.json``, the driver
its configuration names as ``drivers/<driver>.py`` and each per-layer
metric's reader as ``metrics/<metric>.py``, all under the benchmark's
directory.  Adding a configuration, a mix, a metric or a driver is adding
files and manifest entries; no existing file changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Metric:
    """What the harness reads of a metric's entry: its name and unit, the
    end-to-end metric it moves and the cells that report it."""

    name: str
    unit: str
    moves: str | None = None
    workloads: tuple[str, ...] | None = None

    @staticmethod
    def of(entry: dict) -> "Metric":
        cells = entry.get("workloads")
        return Metric(entry["name"], entry["unit"], entry.get("moves"),
                      tuple(cells) if cells is not None else None)


def _load_module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} (named by the manifest) does not exist")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list[Metric]
    per_layer: list[Metric]
    bench_dir: Path

    @property
    def driver_path(self) -> Path:
        return self.bench_dir / "drivers" / f"{self.config['driver']}.py"

    def driver(self):
        if self.mix.get("driver", self.config["driver"]) != self.config["driver"]:
            raise ValueError(f"mix {self.traffic!r} is for the {self.mix['driver']!r} "
                             f"driver, configuration {self.config_name!r} for "
                             f"{self.config['driver']!r}")
        return _load_module(self.driver_path, f"rmbench_driver_{self.config['driver']}")

    def reader_path(self, metric: str) -> Path:
        return self.bench_dir / "metrics" / f"{metric}.py"

    def readers(self) -> dict:
        """Each per-layer metric of this cell: its reader's ``read``."""
        return {m.name: _load_module(self.reader_path(m.name),
                                     "rmbench_metric_" + m.name.replace(".", "_")).read
                for m in self.per_layer}


class Manifest:
    def __init__(self, bench_dir: Path = BENCH_DIR):
        self.bench_dir = Path(bench_dir)
        self.root = self.bench_dir.parent
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.configs = {c["name"]: c for c in self.data["configs"]}
        self.cells = {w["name"]: w for w in self.data["workloads"]}
        self.end_to_end = [Metric.of(m) for m in self.data["end_to_end"]]
        self.per_layer = [Metric.of(m) for m in self.data["per_layer"]]

    def cell(self, name: str) -> Cell:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(self.cells)})")
        w = self.cells[name]
        entry = self.configs[w["config"]]
        config = json.loads((self.root / entry["file"]).read_text())
        mix_path = self.bench_dir / "mixes" / f"{w['traffic']}.json"
        if not mix_path.is_file():
            raise FileNotFoundError(f"{mix_path} (traffic {w['traffic']!r}) does not exist")
        e2e = [m for m in self.end_to_end if m.workloads is None or name in m.workloads]
        reported = {m.name for m in e2e}
        layer = [m for m in self.per_layer
                 if (name in m.workloads if m.workloads is not None else m.moves in reported)]
        return Cell(name, w["config"], w["traffic"], w["chips"], config,
                    json.loads(mix_path.read_text()), e2e, layer, self.bench_dir)
