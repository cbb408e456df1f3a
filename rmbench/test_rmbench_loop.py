"""The relational closed loop and the host copies of the answers kept for the
check: each client sends its next query once its own is complete, the
server's pipelined tick serves them, and the kept answers leave the card."""

import pytest
import torch

from rmbench import inputs, manifest, run, tiny, traffic
from rmbench.drivers import relational


def _server(clients: int):
    run.use_program(manifest.BENCH_DIR.parent)
    from repro_torch.core import RelationalMemoryEngine
    from repro_torch.serve import QueryServer

    cfg, mix = tiny.RM_TINY, tiny.relational_mix(clients)
    dev = torch.device("cpu")
    table = relational.build_table(cfg, inputs.table_columns(cfg, 5, dev))
    server = QueryServer(RelationalMemoryEngine(revision=cfg["revision"], device=dev),
                         **cfg["server"])
    loop = relational.Loop(server, table, traffic.stream(cfg, mix, 5), clients, dev)
    return server, loop


@pytest.mark.parametrize("clients", [1, 4])
def test_a_counted_run_sends_that_many_and_answers_each(clients):
    server, loop = _server(clients)
    seen = []
    loop.run(count=40, done=lambda q, r: seen.append(q.index))
    assert loop.attempted == 40 and loop.failed == 0
    assert len(loop.latencies) == 40 and sorted(seen) == list(range(40))
    assert all(x > 0 for x in loop.latencies)
    assert server.queue_depth == 0 and server._open_ticks == 0


def test_clients_do_not_wait_for_each_other():
    # a sum is answered in the tick that begins it, a projection a tick
    # later: with one barrier a round, 4 clients would take 40 / 4 ticks
    server, loop = _server(4)
    loop.run(count=40)
    assert server.stats.ticks > 40 / 4


def test_a_timed_run_closes_after_its_seconds():
    _, loop = _server(4)
    start, end = loop.run(seconds=0.2)
    assert end - start >= 0.2 and len(loop.latencies) == loop.attempted


def test_the_arena_holds_the_first_of_each_blocked_template_and_the_small():
    sizes = {("project", 1, None): 320, ("project", 2, None): 576,
             ("sum", None, None): 0, ("groupby_avg", None, 50): 64}
    firsts = {"blocked_share": 0, "max_blocked": 8, "max_small": 400}
    assert relational.arena_bytes(sizes, firsts) == 320 + 576 + 400 * 64
    shared = {**firsts, "blocked_share": 0.01, "max_blocked": 5}
    assert relational.arena_bytes(sizes, shared) == 320 + 576 + 3 * 576 + 400 * 64


def test_an_answer_takes_whole_64_byte_lines():
    packed = torch.zeros(5, 3, dtype=torch.int32)  # 60 bytes
    mask = torch.zeros(65, dtype=torch.bool)
    assert relational._nbytes(packed) == 64 and relational._nbytes((packed, mask)) == 64 + 128
    assert relational._nbytes(1.5) == 0


def test_host_copies_leave_host_answers_alone():
    copies = relational.HostCopies(torch.device("cpu"), 1 << 20)
    t = torch.arange(4)
    got = copies.take((t, 2.0))
    assert got[0] is t and got[1] == 2.0 and copies.used == 0
    copies.release()


@pytest.mark.cuda
def test_host_copies_of_answers_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    packed = torch.randint(-1000, 1000, (1000, 3), dtype=torch.int32, device=dev)
    mask = packed[:, 0] > 0
    copies = relational.HostCopies(dev, relational._nbytes((packed, mask)))
    got = copies.take((packed, mask))
    again = copies.take(packed)  # no room left: copied in place of the arena
    copies.release()
    assert got[0].device.type == "cpu" and copies.sync_copies == 1
    assert torch.equal(got[0], packed.cpu()) and torch.equal(got[1], mask.cpu())
    assert torch.equal(again, packed.cpu())
