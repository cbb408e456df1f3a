"""Carrying a table across: ``RelationalTable.from_state`` rebuilds a JAX
package table in the port byte for byte, from a plain dict of builtins and
numpy arrays (the port itself never touches the JAX package)."""

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as J  # noqa: E402
from repro.core.compression import DeltaCodec, DictCodec  # noqa: E402
from repro_torch.core import RelationalTable  # noqa: E402


def state_of(t: J.RelationalTable) -> dict:
    """The state dict of a JAX table."""
    codecs = {}
    for name, c in t.codecs.items():
        if isinstance(c, DictCodec):
            codecs[name] = {"kind": "dict", "dictionary": c.dictionary.copy()}
        else:
            assert isinstance(c, DeltaCodec)
            codecs[name] = {"kind": "for", "references": c.references.copy(),
                            "frame_rows": c.frame_rows, "code_bits": c.code_bits}
    return {
        "columns": [(c.name, c.dtype, c.width, c.codec) for c in t.schema.columns],
        "words": t.words().copy(),
        "clock": t.now(),
        "codecs": codecs,
        "storage_epoch": t.storage_epoch,
    }


def assert_same_table(jt, tt):
    assert tt.words().dtype == np.int32
    assert jt.words().tobytes() == tt.words().tobytes()
    assert (jt.row_count, jt.now(), jt.storage_epoch) == (tt.row_count, tt.now(),
                                                           tt.storage_epoch)
    assert set(jt.codecs) == set(tt.codecs)
    for name in jt.schema.names:
        np.testing.assert_array_equal(tt.read_column(name), jt.read_column(name))


def test_from_state_round_trips_benchmark_table():
    rng = np.random.default_rng(0)
    schema = J.benchmark_schema(64, 4)
    jt = J.RelationalTable.from_columns(
        schema, {c.name: rng.integers(-9, 9, 300).astype(np.int32)
                 for c in schema.columns})
    jt.delete(np.arange(0, 300, 4))
    jt.update(np.array([1, 2]), {"A3": np.array([5, 6], np.int32)})
    tt = RelationalTable.from_state(state_of(jt))
    assert_same_table(jt, tt)
    assert tt.snapshot_mask(3).tolist() == jt.snapshot_mask(3).tolist()


def test_from_state_round_trips_encoded_columns_and_keeps_writing():
    rng = np.random.default_rng(1)
    schema = J.TableSchema.of(J.Column("k", "int32", codec="dict"),
                              J.Column("s", "str"),
                              J.Column("f", "int32", codec="for"),
                              J.Column("name", "char", 8),
                              J.Column("x", "float32"))
    cols = {"k": rng.integers(-5, 5, 200).astype(np.int32),
            "s": rng.choice(np.array(["red", "green", "blue"]), 200),
            "f": rng.integers(500, 600, 200).astype(np.int32),
            "name": np.array([b"row%04d" % i for i in range(200)]),
            "x": rng.normal(size=200).astype(np.float32)}
    jt = J.RelationalTable.from_columns(schema, cols)
    tt = RelationalTable.from_state(state_of(jt))
    assert_same_table(jt, tt)
    # the same writes keep both tables byte-identical, a codec re-fit included
    more = {k: v[:10] for k, v in cols.items()}
    more["k"] = np.arange(100, 110, dtype=np.int32)  # outside the dictionary
    for t in (jt, tt):
        t.append(more)
        t.delete(np.arange(0, 50, 7))
    assert_same_table(jt, tt)


def test_from_state_rejects_mismatched_words():
    rng = np.random.default_rng(2)
    schema = J.benchmark_schema(16, 4)
    jt = J.RelationalTable.from_columns(
        schema, {c.name: rng.integers(0, 5, 10).astype(np.int32)
                 for c in schema.columns})
    state = state_of(jt)
    state["words"] = state["words"][:, :-1]
    with pytest.raises(ValueError, match="MVCC"):
        RelationalTable.from_state(state)
