"""The statistics and the trace reduction the metrics rest on."""

import math
import random

import pytest

from rmbench.result import Check, Outcome, percentile, rate, result_line
from rmbench.trace import DeviceTrace


@pytest.mark.parametrize("n", [1, 2, 19, 20, 21, 1000, 4097, 10001])
def test_percentile_is_nearest_rank_over_every_value(n):
    rng = random.Random(n)
    values = [rng.random() for _ in range(n)]
    for q in (50, 95, 99):
        want = sorted(values)[math.ceil(q / 100 * n) - 1]
        got = percentile(values, q)
        assert got == want
        # no sampling: the tail is the tail of all values
        assert sum(v <= got for v in values) >= q / 100 * n


def test_percentile_and_rate_refuse_nothing_to_measure():
    with pytest.raises(ValueError):
        percentile([], 95)
    with pytest.raises(ValueError):
        rate(10, 0.0)
    assert rate(300, 12.0) == 25.0


def test_check_and_outcome():
    assert Check("x", 0.0, 0.0).ok and not Check("x", 1e-9, 0.0).ok
    assert not Check("x", float("nan"), 1.0).ok
    o = Outcome({}, {}, [Check("a", 0.1, 0.2)], 5, 0, 0)
    assert o.correct
    assert not Outcome({}, {}, [Check("a", 0.1, 0.2)], 5, 1, 0).correct


def _trace():
    ops = [("k_a", 10.0, 20.0), ("k_b", 15.0, 30.0), ("k_a", 50.0, 60.0),
           ("Memcpy HtoD", 90.0, 95.0)]
    host = [("rmbench.drain", 0.0, 80.0), ("aten::nonzero", 31.0, 49.0),
            ("rmbench.sync", 80.0, 100.0), ("cudaDeviceSynchronize", 81.0, 99.0)]
    return DeviceTrace(ops, host, 0.0, 100.0)


def test_trace_busy_time_is_the_union_of_operations():
    t = _trace()
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx((20 + 10 + 5) * 1e-6)
    assert t.seconds(lambda n: n == "k_a") == pytest.approx(20e-6)
    assert t.count(lambda n: n.startswith("k_")) == 3


def test_trace_breakdown_names_ops_and_gaps_by_host_activity():
    b = _trace().breakdown()
    assert b["device_ops"][0] == ["k_a", pytest.approx(20e-6)]
    gaps = b["idle_gaps"]
    assert gaps[0] == ["rmbench.drain", pytest.approx(30e-6)]
    assert gaps[1] == ["rmbench.drain > aten::nonzero", pytest.approx(20e-6)]
    assert len(gaps) <= 10 and all(g[1] > 0 for g in gaps)
    assert sum(g[1] for g in gaps) == pytest.approx(65e-6)


def test_partials_follow_their_launch():
    ops = [("rm_scan_multi_kernel", 0.0, 10.0), ("rm_reduce_partials_kernel", 10.0, 11.0),
           ("rm_filter_kernel", 20.0, 30.0), ("rm_reduce_partials_kernel", 30.0, 32.0)]
    t = DeviceTrace(ops, [], 0.0, 40.0)
    fused = t.seconds_with_followers(lambda n: "scan_multi" in n, "rm_reduce_partials_kernel")
    solo = t.seconds_with_followers(lambda n: "filter" in n, "rm_reduce_partials_kernel")
    assert fused == pytest.approx(11e-6) and solo == pytest.approx(12e-6)


def test_result_line_puts_the_checks_last():
    class Cell:
        end_to_end = [type("M", (), {"name": "setup_s", "unit": "s"})()]
        per_layer = [type("M", (), {"name": "rm.x", "unit": "%"})()]

    o = Outcome({"setup_s": 1.5}, {"trace": _trace()}, [Check("sum_err", 0.0, 1e-5)], 3, 0, 7)
    line = result_line(Cell, o, False, {"platform": "gpu"}, {})
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["metrics"] == {"setup_s": {"value": 1.5, "unit": "s"}}
    line = result_line(Cell, o, True, {"platform": "gpu"}, {"rm.x": None})
    assert line["metrics"] == {} and list(line)[-2:] == ["breakdown", "checks"]
