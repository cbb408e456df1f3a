"""The references agree with the port's CPU path at tiny sizes, and the
inputs are the frozen copies they claim to be."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from rmbench import inputs, tiny, traffic
from rmbench.reference import decoder
from rmbench.reference.relational import Oracle, gaps



def test_the_drivers_table_is_the_one_from_columns_builds():
    from repro_torch.core import RelationalTable, benchmark_schema
    from rmbench.drivers.relational import build_table

    cfg = dict(tiny.RM_TINY, rows=777)
    cols = inputs.table_columns(cfg, 2 ** 40 + 3, "cpu")
    assert set(cols) == {f"A{i}" for i in range(1, 17)}
    assert all(int(v.min()) >= -1000 and int(v.max()) < 1000 for k, v in cols.items() if k != "A2")
    assert 0 <= int(cols["A2"].min()) and int(cols["A2"].max()) < cfg["key_range"]
    got = build_table(cfg, cols)
    want = RelationalTable.from_columns(benchmark_schema(64, 4),
                                        {k: v.numpy() for k, v in cols.items()})
    assert np.array_equal(got.words(), want.words()) and got.now() == want.now()
    again = inputs.table_columns(cfg, 2 ** 40 + 3, "cpu")
    assert all(torch.equal(cols[k], again[k]) for k in cols)


def test_corpus_and_batches_are_the_pipelines():
    from repro_torch.data import RecordStore, TrainPipeline, synthetic_corpus

    tokens, labels = inputs.corpus(40, 16, 97, seed=3)
    want = synthetic_corpus(40, 16, 97, seed=3)
    assert np.array_equal(tokens, want[0]) and np.array_equal(labels, want[1])
    store = RecordStore(seq_len=16, device="cpu")
    store.ingest(tokens, labels)
    batches = TrainPipeline(store, batch_size=8, seed=4).batches()
    for step in range(7):  # across an epoch boundary (5 batches an epoch)
        b = next(batches)
        rows = inputs.batch_rows(40, 8, step, 4)
        assert np.array_equal(b["tokens"].numpy(), tokens[rows])
        assert np.array_equal(b["labels"].numpy(), labels[rows])


def test_relational_oracle_agrees_with_the_port_on_every_kind():
    from repro_torch.core import RelationalMemoryEngine, RelationalTable, benchmark_schema
    from rmbench.drivers.relational import build_plan

    cfg = dict(tiny.RM_TINY, rows=3000, setup_deletes=300)
    mix = tiny.relational_mix(4)
    cols = inputs.table_columns(cfg, 9, "cpu")
    deleted = inputs.deleted_rows(cfg, 9)
    table = RelationalTable.from_columns(benchmark_schema(64, 4),
                                         {k: v.numpy() for k, v in cols.items()})
    table.delete(deleted)
    engine = RelationalMemoryEngine(device="cpu")
    oracle = Oracle(cols, deleted, "cpu")
    seen = set()
    for q in itertools.islice(traffic.stream(cfg, mix, 9), 60):
        from repro_torch.core.planner import CompileOptions, compile_plan

        pq = compile_plan(build_plan(table, q), engine,
                          options=CompileOptions(snapshot_ts=table.now()))
        got = pq.run()
        for k, v in gaps(q, got, oracle.answer(q)).items():
            assert v <= (0 if k == "mismatches" else 1e-6), (q, k, v)
        seen.add(q.kind)
    assert seen == set(traffic.KINDS)
    # the control in the program's place does not agree
    bf16 = Oracle(cols, deleted, "cpu", precision="bfloat16")
    q = next(q for q in traffic.stream(cfg, mix, 9) if q.kind == "project")
    assert gaps(q, bf16.answer(q), oracle.answer(q))["mismatches"] > 0


def test_traffic_keeps_every_template_in_every_block():
    mix = tiny.relational_mix(8)
    n = sum(t.get("count", 1) for t in mix["block"])
    for seed in (1, 2 ** 31 + 5):
        qs = list(itertools.islice(traffic.stream(tiny.RM_TINY, mix, seed), 3 * n))
        for b in range(3):
            kinds = sorted(q.kind for q in qs[b * n:(b + 1) * n])
            assert kinds == sorted(t["kind"] for t in mix["block"]
                                   for _ in range(t.get("count", 1)))
        assert all(q.pred is None or q.pred[0] != "A2" for q in qs)
        assert all(len(set(q.columns)) == len(q.columns) for q in qs)
    a = list(itertools.islice(traffic.stream(tiny.RM_TINY, mix, 1), n))
    b = list(itertools.islice(traffic.stream(tiny.RM_TINY, mix, 1), n))
    assert a == b


def _tiny_model(compute: str):
    from repro_torch.models import build_model
    from rmbench.drivers.train import port_config

    m = dict(tiny.QWEN_TINY, compute_dtype=compute)
    cfg = port_config(m, 1)
    model = build_model(cfg, device="cpu", seed=None, param_dtype="float32")
    params = dict(model.state_dict(keep_vars=True))
    leaves = inputs.decoder_leaves(m)
    inputs.fill_weights(leaves, 21, params)
    for name, _, scale in leaves:  # norm gains away from 1, to test them
        if scale is None:
            params[name].copy_(0.1 * torch.randn(params[name].shape))
    return m, model, params


def test_decoder_reference_loss_and_gradients_are_the_ports_at_float32():
    from repro_torch.train.step import loss_and_grads

    m, model, params = _tiny_model("float32")
    tokens, labels = inputs.corpus(4, 32, m["vocab_size"], seed=5)
    tk, lb = torch.from_numpy(tokens), torch.from_numpy(labels)
    loss, _, grads = loss_and_grads(model, params, [{"tokens": tk, "labels": lb}])
    ref = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    want = decoder.Decoder(m, ref).loss(tk.long(), lb.long())
    want.backward()
    assert float(loss) == pytest.approx(float(want.detach()), rel=1e-5)
    for k in params:
        torch.testing.assert_close(grads[k], ref[k].grad, rtol=1e-4, atol=1e-6)


def test_reference_adamw_is_the_ports():
    from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update

    m, _, params = _tiny_model("float32")
    opt = dict(m["optimizer"], warmup_steps=2, decay_steps=5)
    prog = {k: v.detach().clone() for k, v in params.items()}
    ref = {k: v.detach().clone() for k, v in params.items()}
    state = adamw_init(prog)
    adam = decoder.AdamW(ref, opt)
    gen = torch.Generator().manual_seed(0)
    for step in range(4):
        grads = {k: torch.randn(v.shape, generator=gen) * 0.3 for k, v in prog.items()}
        prog, state, metrics = adamw_update(prog, grads, state, AdamWConfig(**opt))
        norms = adam.step(ref, {k: g.clone() for k, g in grads.items()})
        assert float(metrics["lr"]) == pytest.approx(adam.lr(step + 1), rel=1e-6)
        scale = min(1.0, opt["clip_norm"] / float(metrics["grad_norm"]))
        for k in prog:
            torch.testing.assert_close(prog[k], ref[k], rtol=1e-5, atol=1e-7)
            assert norms[k] == pytest.approx(
                float(torch.linalg.vector_norm(grads[k])) * scale, rel=1e-5)


def test_fp8_control_rounds_every_product():
    x = torch.linspace(-3, 3, 1001)
    q = decoder._fp8(x)
    assert 0 < float((q - x).abs().max()) <= 3 / 448 * 32
    d = decoder.Decoder(dict(tiny.QWEN_TINY), {}, matmul="fp8")
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    assert not torch.equal(d.mm(a, b), a @ b)
    with pytest.raises(ValueError):
        decoder.Decoder(dict(tiny.QWEN_TINY), {}, matmul="int4")
    assert dataclasses.is_dataclass(traffic.Query)
