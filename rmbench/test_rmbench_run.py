"""A run end to end at a size the CPU holds: the small cells that
``rmbench.tiny`` adds, through ``run.main`` with its look for a card
skipped; and the refusals of the command itself."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from rmbench import manifest, run, tiny

ROOT = Path(__file__).resolve().parents[1]
SEED = str(2 ** 31 + 11)  # larger than 32 signed bits hold


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


def one_run(bench, capsys, cell: str, trace: int, seconds: float = 0.5) -> dict:
    rc = run.main(["--workload", cell, "--seed", SEED, "--seconds", str(seconds),
                   "--trace", str(trace)], bench_dir=bench, device="cpu")
    out, err = capsys.readouterr()
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    checks = [x for x in err.strip().splitlines() if x.startswith("check ")]
    assert err.strip().splitlines()[-len(line["checks"]):] == checks
    return line


@pytest.mark.parametrize("cell", ["rm_tiny.scan_mix_tiny", "rm_tiny.single_tiny",
                                  "qwen3-tiny.train_tiny"])
@pytest.mark.parametrize("trace", [0, 1])
def test_small_cells_run_correct(bench, capsys, cell, trace):
    line = one_run(bench, capsys, cell, trace)
    c = manifest.Manifest(bench).cell(cell)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks" and line["checks"]
    assert all(v["value"] <= v["limit"] for v in line["checks"].values())
    assert line["device"]["platform"] == "cpu"  # a CPU run names no card
    if trace:
        assert set(line["metrics"]) <= {m.name for m in c.per_layer}
        assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
        if cell.startswith("rm_"):
            assert {"rm.reads_per_tick", "rm.compile_ms_per_read",
                    "rm.dram_bytes_per_read"} <= set(line["metrics"])
    else:
        assert set(line["metrics"]) == {m.name for m in c.end_to_end}
        assert all(v["value"] > 0 for v in line["metrics"].values())


def test_one_client_reads_one_query_a_tick(bench, capsys):
    line = one_run(bench, capsys, "rm_tiny.single_tiny", 1)
    assert line["metrics"]["rm.reads_per_tick"]["value"] == 1.0
    # four clients, each sending its next query once its own is complete:
    # ticks share reads, never more than the clients have out
    line = one_run(bench, capsys, "rm_tiny.scan_mix_tiny", 1)
    assert 1.0 < line["metrics"]["rm.reads_per_tick"]["value"] <= 4.0


def test_the_command_without_a_card_prints_no_result():
    proc = subprocess.run([sys.executable, "-m", "rmbench.run", "--workload",
                           "rm_paper_s.scan_mix", "--seed", "1", "--seconds", "1"],
                          capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert proc.returncode != 0 and not proc.stdout.strip()


def test_without_the_program_nothing_is_measured(tmp_path):
    (tmp_path / "rmbench").mkdir()
    with pytest.raises(SystemExit):
        run.use_program(tmp_path)
