"""The port's training-data pipeline against the JAX package's, on the CPU.

``repro_torch.data`` and ``repro.data`` get the same calls: the synthetic
corpus is bit-equal; record stores ingest the same samples; their
pipelines yield bit-equal batches over steps, after a seek and across an
ingest that lands after the snapshot; and the engines' ``EngineStats``
counters are equal field by field.  The reference's store runs the JAX
engine's ``"xla"`` revision, the port's its plain projection on the CPU:
the same charging rules either way.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import RecordStore as JStore  # noqa: E402
from repro.data import TrainPipeline as JPipe  # noqa: E402
from repro.data import synthetic_corpus as jcorpus  # noqa: E402
from repro.data.pipeline import _pack_ids as jpack  # noqa: E402
from repro_torch.data import RecordStore, TrainPipeline, record_schema, synthetic_corpus  # noqa: E402
from repro_torch.data.pipeline import _pack_ids  # noqa: E402


def stores(seq, n, vocab, seed=1):
    tok, lab = jcorpus(n, seq, vocab, seed=seed)
    js, ts = JStore(seq_len=seq), RecordStore(seq_len=seq, device="cpu")
    js.ingest(tok, lab)
    ts.ingest(tok, lab)
    return js, ts


def assert_batches_equal(jb, tb):
    assert set(jb) == set(tb)
    for k in jb:
        assert tb[k].dtype == {"weights": torch.float32}.get(k, torch.int32)
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


def assert_stats_equal(js, ts):
    assert dataclasses.asdict(ts.engine.stats) == dataclasses.asdict(js.engine.stats)


@pytest.mark.parametrize("n,seq,vocab,seed", [(4, 8, 50, 0), (64, 64, 512, 1),
                                              (3, 2048, 151936, 1), (17, 33, 7, 9)])
def test_synthetic_corpus_bit_equal(n, seq, vocab, seed):
    for a, b in zip(synthetic_corpus(n, seq, vocab, seed), jcorpus(n, seq, vocab, seed)):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_record_schema_and_packing_match():
    from repro.data.pipeline import record_schema as jschema

    t, j = record_schema(16), jschema(16)
    assert [(c.name, c.dtype, c.width) for c in t.columns] == \
        [(c.name, c.dtype, c.width) for c in j.columns]
    ids = np.random.default_rng(0).integers(-9, 2**31 - 1, (5, 16)).astype(np.int32)
    np.testing.assert_array_equal(_pack_ids(ids, 16), jpack(ids, 16))


@pytest.mark.parametrize("seq,batch", [(64, 8), (16, 4), (32, 5)])
def test_batches_equal_over_steps_and_after_a_seek(seq, batch):
    """Steps 0..k of both pipelines (past one epoch, so the second epoch's
    permutation is checked too), then a fresh iterator seeked to step 3."""
    js, ts = stores(seq, 40, 512)
    jp, tp = JPipe(js, batch_size=batch, seed=0), TrainPipeline(ts, batch_size=batch, seed=0)
    steps = 40 // batch + 3
    for _, jb, tb in zip(range(steps), jp.batches(), tp.batches()):
        assert_batches_equal(jb, tb)
    for _, jb, tb in zip(range(4), jp.batches(start_step=3), tp.batches(start_step=3)):
        assert_batches_equal(jb, tb)
    assert tp.snapshot_ts == jp.snapshot_ts
    assert_stats_equal(js, ts)


def test_batches_equal_across_an_ingest():
    """The reference's snapshot test: an ingest after the first batch does
    not change the pinned snapshot's stream, in either package."""
    js, ts = stores(16, 32, 100, seed=2)
    jp, tp = JPipe(js, batch_size=4, seed=0), TrainPipeline(ts, batch_size=4, seed=0)
    ji, ti = jp.batches(), tp.batches()
    assert_batches_equal(next(ji), next(ti))
    more = jcorpus(32, 16, 100, seed=3)
    js.ingest(*more)
    ts.ingest(*more)
    for _ in range(3):
        assert_batches_equal(next(ji), next(ti))
    for jb, tb in zip(jp.batches(start_step=0), tp.batches(start_step=0)):
        assert_batches_equal(jb, tb)
        break
    assert js.n_rows == ts.n_rows == 64
    assert_stats_equal(js, ts)


def test_weighted_batches_and_reweight():
    js, ts = stores(8, 24, 50)
    w = np.linspace(0.5, 2.0, 6).astype(np.float32)
    rows = np.arange(0, 12, 2)
    np.testing.assert_array_equal(js.reweight(rows, w), ts.reweight(rows, w))
    jp = JPipe(js, batch_size=6, seed=4, with_weights=True)
    tp = TrainPipeline(ts, batch_size=6, seed=4, with_weights=True)
    for _, jb, tb in zip(range(5), jp.batches(), tp.batches()):
        assert_batches_equal(jb, tb)
    assert_stats_equal(js, ts)


def test_projectivity_charges_equal():
    """The eval view (tokens) ships half the training view's bytes, and
    both packages charge the same bytes for each."""
    js, ts = stores(64, 64, 512)
    out = []
    for st in (js, ts):
        eng = st.engine
        eng.stats.reset()
        st.project(("tokens",)).packed()
        eval_bytes = eng.stats.bytes_to_cpu
        eng.stats.reset()
        st.project(("tokens", "labels")).packed()
        out.append((eval_bytes, eng.stats.bytes_to_cpu))
    assert out[0] == out[1] and out[1][1] == 2 * out[1][0]


def test_refusals():
    ts = RecordStore(seq_len=8, device="cpu")
    with pytest.raises(ValueError, match="seq_len"):
        ts.ingest(np.zeros((2, 9), np.int32), np.zeros((2, 9), np.int32))
    ts.ingest(*synthetic_corpus(3, 8, 10))
    with pytest.raises(ValueError, match="batch size"):
        next(TrainPipeline(ts, batch_size=4).batches())
