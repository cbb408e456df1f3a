"""A run with its timed path broken underneath comes out not correct, once
for each fault the cells can have: an answer or a token altered where it
is produced, half of the batch left out (the mean over the rest), a step
that returns its state unchanged.  (No cell spans chips: there is no
exchange to leave out.)"""

import json

import pytest
import torch

from rmbench import run, tiny

SEED = "4242"


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


def outcome(bench, capsys, cell: str) -> dict:
    rc = run.main(["--workload", cell, "--seed", SEED, "--seconds", "0.3", "--trace", "0"],
                  bench_dir=bench, device="cpu")
    out, _ = capsys.readouterr()
    assert rc == 0
    return json.loads(out.strip().splitlines()[-1])


def _altered(outs):
    """Every scan output changed a little: sums off by one, a packed word
    flipped, a group's count off by one."""
    res = []
    for o in outs:
        if isinstance(o, tuple) and o[0].dtype == torch.int32:  # (packed, mask)
            packed = o[0].clone()
            packed.view(-1)[0] ^= 1
            res.append((packed, o[1]))
        elif isinstance(o, tuple):  # group-by (sums, counts)
            res.append((o[0], o[1] + 1))
        elif o.dtype == torch.int32:
            packed = o.clone()
            packed.view(-1)[0] ^= 1
            res.append(packed)
        else:  # [sum, count]
            res.append(o + torch.tensor([1.0, 0.0]))
    return res


@pytest.mark.parametrize("cell", ["rm_tiny.scan_mix_tiny", "rm_tiny.single_tiny"])
def test_an_answer_altered_where_it_is_produced(bench, capsys, monkeypatch, cell):
    from repro_torch.core.engine import RelationalMemoryEngine as E

    scan, solo = E._scan_chunk, E._solo_kernel
    monkeypatch.setattr(E, "_scan_chunk", lambda self, *a: _altered(scan(self, *a)))
    monkeypatch.setattr(E, "_solo_kernel", lambda self, *a: _altered([solo(self, *a)])[0])
    line = outcome(bench, capsys, cell)
    assert line["correct"] is False


@pytest.mark.parametrize("cell", ["rm_tiny.scan_mix_tiny", "rm_tiny.single_tiny"])
def test_half_of_the_rows_left_out(bench, capsys, monkeypatch, cell):
    from repro_torch.core.engine import RelationalMemoryEngine as E

    scan, solo = E._scan_chunk, E._solo_kernel
    monkeypatch.setattr(E, "_scan_chunk",
                        lambda self, chunk, *a: scan(self, chunk[: chunk.shape[0] // 2], *a))
    monkeypatch.setattr(E, "_solo_kernel",
                        lambda self, words, req: solo(self, words[: words.shape[0] // 2], req))
    assert outcome(bench, capsys, cell)["correct"] is False


def test_a_step_that_returns_its_state_unchanged(bench, capsys, monkeypatch):
    from repro_torch.train import step

    def unchanged(params, grads, state, cfg):
        return params, state, {"grad_norm": torch.zeros(()), "lr": torch.zeros(())}

    monkeypatch.setattr(step, "adamw_update", unchanged)
    line = outcome(bench, capsys, "qwen3-tiny.train_tiny")
    assert line["correct"] is False and line["checks"]["change_gap"]["value"] == 1.0


def test_half_of_the_batch_left_out(bench, capsys, monkeypatch):
    from repro_torch.train import step

    whole = step.microbatches
    monkeypatch.setattr(step, "microbatches",
                        lambda batch, n, *a: whole(batch, n, *a)[: max(n // 2, 1)])
    line = outcome(bench, capsys, "qwen3-tiny.train_tiny")
    assert line["correct"] is False
    assert line["checks"]["loss_gap"]["value"] > line["checks"]["loss_gap"]["limit"]


def test_a_token_altered_where_it_is_produced(bench, capsys, monkeypatch):
    from repro_torch.data.pipeline import RecordStore

    ids = RecordStore._ids_matrix

    def altered(self, view, name, rows):
        out = ids(self, view, name, rows).clone()
        out[0, 0] = (out[0, 0] + 1) % tiny.QWEN_TINY["vocab_size"]
        return out

    monkeypatch.setattr(RecordStore, "_ids_matrix", altered)
    line = outcome(bench, capsys, "qwen3-tiny.train_tiny")
    assert line["correct"] is False and line["checks"]["batch_mismatch"]["value"] > 0
