"""The readers of the program's spans: each reads a number from a traced
run of the small cells, none from a stretch without the spans (a program
that has none), and the idle-overlap helper gives the exact overlap of a
hand-built trace."""

import json

import pytest

from rmbench import manifest, run, spans, tiny
from rmbench.trace import DeviceTrace

SEED = str(2 ** 31 + 29)
NEW = {"rm_tiny.scan_mix_tiny": ("rm.tick_host_ms", "rm.wait_ms_per_tick",
                                 "rm.plan_ms_per_read", "rm.idle_in_server_share"),
       "rm_tiny.single_tiny": ("rm.tick_host_ms", "rm.wait_ms_per_tick",
                               "rm.plan_ms_per_read", "rm.idle_in_server_share"),
       "qwen3-tiny.train_tiny": ("train.batch_ms", "train.idle_in_step_share")}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", sorted(NEW))
def test_each_span_reader_reads_a_traced_run(bench, capsys, cell):
    rc = run.main(["--workload", cell, "--seed", SEED, "--seconds", "0.3", "--trace", "1"],
                  bench_dir=bench, device="cpu")
    out, err = capsys.readouterr()
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True
    got = {k: v["value"] for k, v in line["metrics"].items() if k in NEW[cell]}
    assert set(got) == set(NEW[cell]), line["metrics"]
    assert all(v >= 0 for v in got.values())
    if cell.startswith("rm_"):
        assert got["rm.tick_host_ms"] > 0 and got["rm.plan_ms_per_read"] > 0
        assert got["rm.idle_in_server_share"] <= 100.0
    else:
        assert got["train.batch_ms"] > 0 and 0 < got["train.idle_in_step_share"] <= 100.0


def test_the_span_metrics_are_entries_of_the_manifest():
    m = manifest.Manifest()
    names = {x.name for x in m.per_layer}
    assert {n for ns in NEW.values() for n in ns} <= names
    for cell in ("rm_paper_s.scan_mix", "rm_paper_s.single_client"):
        assert set(NEW["rm_tiny.scan_mix_tiny"]) <= {x.name for x in m.cell(cell).per_layer}
    assert set(NEW["qwen3-tiny.train_tiny"]) <= {
        x.name for x in m.cell("qwen3-8b-l8.train").per_layer}


def _trace(host, ops=(), start=0.0, end=100.0):
    return DeviceTrace(sorted(ops, key=lambda x: x[1]), sorted(host, key=lambda x: x[1]),
                       start, end)


def test_idle_overlap_is_exact_on_a_hand_built_trace():
    # the card busy over [10, 30) and [25, 40) and [70, 80): idle [0, 10),
    # [40, 70) and [80, 100)
    ops = [("k1", 10.0, 30.0), ("k2", 25.0, 40.0), ("k3", 70.0, 80.0)]
    host = [("rm::serve.tick", 5.0, 50.0), ("rm::wait", 20.0, 45.0),
            ("rm::serve.finish", 60.0, 90.0), ("rm::planner.compile_plan", 6.0, 8.0)]
    t = _trace(host, ops)
    assert spans.idle(t) == [(0.0, 10.0), (40.0, 70.0), (80.0, 100.0)]
    server = spans.named(t, spans.TICK, spans.FINISH)
    # idle inside the tick: [5, 10) and [40, 50); inside finish: [60, 70), [80, 90)
    assert spans.overlap(spans.idle(t), server) == 5.0 + 10.0 + 10.0 + 10.0
    assert spans.idle_share_in(t, server) == pytest.approx(35.0)
    assert spans.length(server) == 75.0
    assert spans.overlap(server, spans.named(t, spans.WAIT)) == 25.0
    assert spans.merged([(3, 5), (1, 2), (4, 9), (9, 10), (7, 7)]) == [(1, 2), (3, 10)]
    # the card busy the whole stretch, or nowhere
    assert spans.idle(_trace(host, [("k", -5.0, 120.0)])) == []
    assert spans.idle(_trace(host)) == [(0.0, 100.0)]


def test_the_readers_of_a_hand_built_trace():
    ops = [("k1", 10.0, 30.0), ("k2", 25.0, 40.0), ("k3", 70.0, 80.0)]
    host = [("rm::serve.tick", 5.0, 50.0), ("rm::serve.compile", 6.0, 9.0),
            ("rm::planner.compile_plan", 6.0, 7.0), ("rm::planner.compile_plan", 7.5, 8.5),
            ("rm::wait", 20.0, 45.0), ("rm::serve.finish", 60.0, 90.0),
            ("rm::serve.tick", 92.0, 98.0), ("rm::gc", 8.0, 8.5), ("rm::gc", 94.0, 96.0)]
    bench = manifest.Manifest().cell("rm_paper_s.scan_mix").readers()
    got = {k: bench[k]({"trace": _trace(host, ops)}) for k in NEW["rm_tiny.scan_mix_tiny"]}
    # 81 us in the server's spans less 25 us of waiting and 2.5 us of the
    # collector, over 2 ticks; 3 us of compile less 0.5 us of the collector
    assert got == pytest.approx({"rm.tick_host_ms": (81.0 - 25.0 - 2.5) * 1e-3 / 2,
                                 "rm.wait_ms_per_tick": 25.0 * 1e-3 / 2,
                                 "rm.plan_ms_per_read": 2.5 * 1e-3 / 2,
                                 "rm.idle_in_server_share": 35.0 + 6.0})
    train = manifest.Manifest().cell("qwen3-8b-l8.train").readers()
    step = [("rm::data.batch", 0.0, 4.0), ("rm::train.forward", 4.0, 20.0),
            ("rm::train.backward", 20.0, 60.0), ("rm::train.update", 60.0, 75.0)]
    run_ = {"trace": _trace(step, ops), "profile_steps": 2}
    assert train["train.batch_ms"](run_) == pytest.approx(4.0 * 1e-3 / 2)
    # idle inside the step's spans: [0, 10), [40, 70)
    assert train["train.idle_in_step_share"](run_) == pytest.approx(40.0)


@pytest.mark.parametrize("cell", ["rm_paper_s.scan_mix", "qwen3-8b-l8.train"])
def test_a_stretch_without_the_programs_spans_reads_nothing(cell):
    host = [("rmbench.tick", 0.0, 90.0), ("aten::copy_", 1.0, 2.0)]
    trace = _trace(host, [("k", 10.0, 30.0)])
    for name, read in manifest.Manifest().cell(cell).readers().items():
        if name in NEW["rm_tiny.scan_mix_tiny"] + NEW["qwen3-tiny.train_tiny"]:
            assert read({"trace": trace, "profile_steps": 2}) is None, name
