"""The controls, at a size the CPU holds: the program's numbers stay inside
the limits while each control, put in its place, breaks at least one."""

import json

import pytest

from rmbench import control, tiny


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


def readings(bench, capsys, cell: str, seeds: str) -> list[dict]:
    assert control.main(["--workload", cell, "--seeds", seeds, "--seconds", "0.3"],
                        bench_dir=bench, device="cpu") == 0
    out, _ = capsys.readouterr()
    return [json.loads(x) for x in out.strip().splitlines()]


def over(numbers: dict, limits: dict) -> list[str]:
    return [k for k, v in numbers.items() if k in limits and v > limits[k]]


def test_train_controls_fail_and_the_program_passes(bench, capsys):
    limits = tiny.QWEN_TINY["limits"]
    for line in readings(bench, capsys, "qwen3-tiny.train_tiny", "31,32"):
        assert not over(line["program"], limits), line
        assert over(line["control_fp8"], limits), line
        assert over(line["half_batch"], limits), line
        assert over(line["state_unchanged"], limits), line


def test_relational_control_fails_and_the_program_passes(bench, capsys):
    limits = tiny.RM_TINY["limits"]
    for line in readings(bench, capsys, "rm_tiny.scan_mix_tiny", "33"):
        assert line["answers"] > 0
        assert not over(line["program"], limits), line
        assert set(over(line["control_bfloat16"], limits)) == {"sum_err", "avg_err",
                                                                "mismatches"}, line
