"""Selection with compaction: the port's ``select_compact`` and ``densify``
against the JAX package's (Pallas in interpret mode).

Blocks (zero-filled past each count) and counts must be bit-equal, as int32,
across predicates, dtypes, snapshots, block sizes and ragged tails.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.kernels import rme_select as JS  # noqa: E402
from repro_torch.kernels import rme_select as TS  # noqa: E402

I32 = np.iinfo(np.int32)


def make_words(n, seed=0):
    """18-word rows: words 0-11 int32 in [-1000, 1000) (word 2 with the
    int32 extremes), 12-15 float32 with a NaN every 7th row in word 13,
    16-17 the MVCC words."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-1000, 1000, (n, 18)).astype(np.int32)
    w[:, 12:16] = rng.normal(0, 100, (n, 4)).astype(np.float32).view(np.int32)
    w[::7, 13] = np.array(np.nan, np.float32).view(np.int32)
    w[: min(n, 2), 2] = [I32.min, I32.max][: min(n, 2)]
    w[:, 16] = rng.integers(0, 10, n)
    w[:, 17] = np.where(rng.random(n) < 0.3, rng.integers(3, 12, n), I32.max)
    return w


def geoms(cols):
    return (J.TableGeometry.from_schema(J.benchmark_schema(64, 4), cols, 0),
            T.TableGeometry.from_schema(T.benchmark_schema(64, 4), cols, 0))


def both(words, cols, **kw):
    jg, tg = geoms(cols)
    want = JS.select_compact(jnp.asarray(words), jg, **kw)
    got = TS.select_compact(torch.from_numpy(words), tg, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return got, want


PREDS = [
    dict(pred_word=2, pred_dtype="int32", pred_op="gt", pred_k=0),
    dict(pred_word=2, pred_dtype="int32", pred_op="lt", pred_k=-2.7),
    dict(pred_word=13, pred_dtype="float32", pred_op="gt", pred_k=-3.5),
    dict(pred_word=13, pred_dtype="float32", pred_op="lt", pred_k=20.25),
    dict(pred_word=5, pred_op="none"),
]


@pytest.mark.parametrize("block_rows", [64, 256, 512])
@pytest.mark.parametrize("pred", PREDS)
def test_select_compact_bit_equal(block_rows, pred):
    n = 1100  # not a multiple of any block size
    got, _ = both(make_words(n), ["A1", "A9"], block_rows=block_rows, **pred)
    assert got[0].shape == (-(-n // block_rows), block_rows, 2)


@pytest.mark.parametrize("pred", PREDS[:3])
def test_select_compact_snapshot(pred):
    words = make_words(700, seed=3)
    for ts in (0, 6, 11):
        both(words, ["A2", "A3", "A4"], ts=ts, ts_word=16, block_rows=64, **pred)


@pytest.mark.parametrize("k,kept", [(-(10**6), "all"), (10**6, "none")])
def test_select_compact_all_and_none_kept(k, kept):
    words = make_words(333, seed=4)
    words[:2, 2] = 0  # no extremes: every row or no row passes
    got, _ = both(words, ["A1"], pred_word=2, pred_op="gt", pred_k=k,
                  block_rows=64)
    counts = got[1].numpy()
    if kept == "all":
        assert counts.tolist() == [64] * 5 + [13]
    else:
        assert counts.sum() == 0 and not got[0].any()


def test_select_compact_one_row_and_odd_blocks():
    for n, block_rows in ((1, 64), (63, 64), (65, 64), (10, 3)):
        both(make_words(n, seed=n), ["A5", "A6"], pred_word=3, pred_op="gt",
             pred_k=-100, block_rows=block_rows)


@pytest.mark.parametrize("total", ["exact", "short", "long"])
def test_densify_bit_equal(total):
    words = make_words(900, seed=5)
    (blocks, counts), (jb, jc) = both(words, ["A1", "A9"], pred_word=2,
                                      pred_op="lt", pred_k=100, block_rows=128)
    n_sel = int(counts.sum())
    size = {"exact": n_sel, "short": n_sel - 17, "long": n_sel + 9}[total]
    got = TS.densify(blocks, counts, size)
    want = JS.densify(jb, jc, size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if total == "exact":  # the passing rows, packed, in original order
        m = words[:, 2] < 100
        np.testing.assert_array_equal(got.numpy(), words[m][:, [0, 8]])


def test_select_compact_refuses_bad_arguments():
    _, tg = geoms(["A1"])
    words = torch.from_numpy(make_words(10))
    with pytest.raises(ValueError, match="block_rows"):
        TS.select_compact(words, tg, pred_word=2, block_rows=0)
    with pytest.raises(ValueError):
        TS.select_compact(words, tg, pred_word=2, pred_op="ge")
