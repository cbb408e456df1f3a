"""The reader of the express lane's settle spans, ``rm.deferred_per_tick``:
a number from a hand-built stretch that holds them, nothing from one that
holds none (a program that defers nothing, or has no such span)."""

import pytest

from rmbench import manifest
from rmbench.trace import DeviceTrace

CELLS = ("rm_paper_s.scan_mix", "rm_paper_s.single_client")


def _trace(host):
    return DeviceTrace([("k", 10.0, 30.0)], sorted(host, key=lambda x: x[1]), 0.0, 100.0)


@pytest.mark.parametrize("cell", CELLS)
def test_deferred_reads_a_tick_of_a_hand_built_trace(cell):
    read = manifest.Manifest().cell(cell).readers()["rm.deferred_per_tick"]
    # four ticks; the first and the third leave two and one express reads to
    # their finish, each settled in a span of its own
    host = [("rm::serve.tick", 0.0, 10.0), ("rm::serve.finish", 12.0, 20.0),
            ("rm::serve.settle", 12.0, 14.0), ("rm::serve.settle", 14.0, 16.0),
            ("rm::serve.tick", 30.0, 40.0), ("rm::serve.tick", 50.0, 60.0),
            ("rm::serve.finish", 61.0, 70.0), ("rm::serve.settle", 61.0, 63.0),
            ("rm::serve.tick", 80.0, 90.0), ("rm::wait", 62.0, 63.0)]
    assert read({"trace": _trace(host)}) == pytest.approx(3 / 4)
    assert read({"trace": _trace([h for h in host if h[0] != "rm::serve.settle"])}) is None
    assert read({"trace": _trace([("rmbench.tick", 0.0, 90.0)])}) is None
    assert read({"trace": None}) is None
