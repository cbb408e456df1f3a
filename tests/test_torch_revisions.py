"""The paper's §5.2 revisions and the multi-view projection: the port against
the JAX package.

The JAX side runs its Pallas kernels in interpret mode; the port runs on the
CPU (``device="cpu"``, the kernels' plain versions).  Packed blocks must be
bit-equal, and an engine of each revision must give the reference engine's
results and ``EngineStats`` under the same revision, field for field.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.kernels import ops as JK  # noqa: E402
from repro_torch.kernels import ops as TK  # noqa: E402

REVISIONS = ("bsl", "pck", "mlp")


def columns(schema, n, seed=0):
    rng = np.random.default_rng(seed)
    return {c.name: rng.integers(-1000, 1000, n).astype(np.int32)
            for c in schema.columns}


def both_words(row_bytes, n, seed=0):
    """The same benchmark table in both packages: (jax schema, port schema,
    the storage words)."""
    js, ts = J.benchmark_schema(row_bytes, 4), T.benchmark_schema(row_bytes, 4)
    cols = columns(js, n, seed)
    jt = J.RelationalTable.from_columns(js, cols)
    tt = T.RelationalTable.from_columns(ts, cols)
    np.testing.assert_array_equal(jt.words(), tt.words())
    return js, ts, jt.words()


GEOMS = [
    # (row_bytes, n_rows, projected columns)
    (64, 100, ["A1"]),
    (64, 1000, ["A1", "A7", "A13"]),
    (64, 555, ["A2", "A3", "A4"]),  # contiguous group
    (128, 257, ["A1", "A16", "A32"]),
    (32, 64, ["A8"]),
    (256, 100, [f"A{i}" for i in (1, 9, 17, 25, 33, 41, 49, 57, 64)]),
]


@pytest.mark.parametrize("row_bytes,n,cols", GEOMS)
@pytest.mark.parametrize("revision", REVISIONS)
def test_project_revisions_bit_equal_to_pallas(row_bytes, n, cols, revision):
    js, ts, words = both_words(row_bytes, n)
    want = JK.project_any(jnp.asarray(words), J.TableGeometry.from_schema(js, cols, n),
                          revision=revision, block_rows=128)
    got = TK.project_any(torch.from_numpy(words),
                         T.TableGeometry.from_schema(ts, cols, n), revision=revision)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("revision", REVISIONS)
def test_project_revisions_char_columns(revision):
    def schema(pkg):
        return pkg.TableSchema.of(
            pkg.Column("key", "int64"), pkg.Column("text", "char", 16),
            pkg.Column("num", "int32"), pkg.Column("pad", "char", 36))

    rng = np.random.default_rng(1)
    n = 97
    cols = {"key": rng.integers(0, 1 << 40, n),
            "text": [bytes(rng.integers(65, 90, 16).tolist()) for _ in range(n)],
            "num": rng.integers(-5, 5, n).astype(np.int32),
            "pad": [b"x" * 36] * n}
    jt = J.RelationalTable.from_columns(schema(J), cols)
    tt = T.RelationalTable.from_columns(schema(T), cols)
    sel = ["text", "num", "pad"]
    want = JK.project_any(jnp.asarray(jt.words()),
                          J.TableGeometry.from_schema(jt.schema, sel, n),
                          revision=revision, block_rows=64)
    got = TK.project_any(torch.from_numpy(tt.words()),
                         T.TableGeometry.from_schema(tt.schema, sel, n),
                         revision=revision)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [1, 7, 127, 129, 500])
def test_revisions_agree_under_odd_row_counts(n):
    js, ts, words = both_words(64, n, seed=n)
    jg = J.TableGeometry.from_schema(js, ["A3", "A11"], n)
    tg = T.TableGeometry.from_schema(ts, ["A3", "A11"], n)
    for r in REVISIONS:
        want = JK.project_any(jnp.asarray(words), jg, revision=r, block_rows=64)
        got = TK.project(torch.from_numpy(words), tg, r)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("views", [
    [["A1"], ["A2", "A3"], ["A1", "A5", "A9", "A13"]],
    [["A16"], ["A16"], ["A4", "A2"]],
    [[f"A{i}" for i in range(1, 12)]],
])
@pytest.mark.parametrize("n", [1, 300, 517])
def test_project_multi_bit_equal_to_pallas(views, n):
    js, ts, words = both_words(64, n, seed=2)
    jg = tuple(J.TableGeometry.from_schema(js, v, n) for v in views)
    tg = [T.TableGeometry.from_schema(ts, v, n) for v in views]
    want = JK.project_multi(jnp.asarray(words), jg, block_rows=128)
    got = TK.project_multi(torch.from_numpy(words), tg)
    plain = TK.project_multi_torch(torch.from_numpy(words), tg)
    assert len(got) == len(want) == len(views)
    for g, p, w in zip(got, plain, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(p.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="at least one"):
        TK.project_multi(torch.from_numpy(words), [])


# ------------------------------------------------------------------ engine
class Pair:
    """One table and one engine of ``revision`` in each package."""

    def __init__(self, revision, n=600, seed=0, **kw):
        cols = columns(J.benchmark_schema(64, 4), n, seed)
        self.jt = J.RelationalTable.from_columns(J.benchmark_schema(64, 4), cols)
        self.tt = T.RelationalTable.from_columns(T.benchmark_schema(64, 4), cols)
        self.je = J.RelationalMemoryEngine(revision=revision, **kw)
        self.te = T.RelationalMemoryEngine(revision=revision, device="cpu", **kw)

    def both(self, fn):
        return fn(J, self.je, self.jt), fn(T, self.te, self.tt)

    def check(self, pair):
        jres, tres = pair
        assert len(jres) == len(tres)
        for j, t in zip(jres, tres):
            for a, b in zip(j if isinstance(j, tuple) else (j,),
                            t if isinstance(t, tuple) else (t,)):
                np.testing.assert_array_equal(
                    b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b),
                    np.asarray(a))
        assert dataclasses.asdict(self.je.stats) == dataclasses.asdict(self.te.stats)


def mixed(pkg, e, t, ts=None):
    return e.execute_many([
        pkg.ProjectOp(e.register(t, ["A1", "A5", "A9", "A13"])),
        pkg.ProjectOp(e.register(t, ["A1", "A5"])),
        pkg.FilterOp(e.register(t, ["A2", "A3"]), "A4", "gt", 0, ts),
        pkg.AggregateOp(t, "A6", "A7", "lt", 100, ts),
        pkg.GroupByOp(t, "A16", "A8", 16, snapshot_ts=ts),
    ])


@pytest.mark.parametrize("revision", REVISIONS)
def test_engine_revision_matches_reference(revision):
    p = Pair(revision, cache_bytes=1 << 16)
    # a lone projection (the revision's kernel), then a hot hit
    for _ in range(2):
        p.check(p.both(lambda pkg, e, t: e.execute_many(
            [pkg.ProjectOp(e.register(t, ["A1", "A5", "A9", "A13"]))])))
    # a cold stream in chunks (the revision's kernel per chunk)
    p.check(p.both(lambda pkg, e, t: list(e.stream_project(
        e.register(t, ["A2", "A3", "A16"]), chunk_rows=128))))
    # a mixed batch (the fused pass, whatever the revision)
    p.check(p.both(lambda pkg, e, t: mixed(pkg, e, t)))

    def write(t):
        t.append(columns(t.schema, 77, seed=5))
        t.delete(np.arange(0, 600, 13))

    write(p.jt)
    write(p.tt)
    # an appended tail: delta serve of a cached view through the revision's
    # kernel, then the batch under a snapshot over base + tail chunks
    p.check(p.both(lambda pkg, e, t: e.execute_many(
        [pkg.ProjectOp(e.register(t, ["A1", "A5", "A9", "A13"]))])))
    p.check(p.both(lambda pkg, e, t: mixed(pkg, e, t, t.now())))
    s = p.te.stats
    assert s.hot_hits >= 1 and s.delta_hits >= 1 and s.shared_scans == 2


@pytest.mark.parametrize("revision", REVISIONS)
def test_engines_of_each_revision_keep_their_own_cache_entries(revision):
    cols = columns(J.benchmark_schema(64, 4), 300)
    t = T.RelationalTable.from_columns(T.benchmark_schema(64, 4), cols)
    engines = {r: T.RelationalMemoryEngine(revision=r, device="cpu") for r in REVISIONS}
    view = engines[revision].register(t, ["A1", "A2"])
    keys = {r: e.view_key(t, view.geometry) for r, e in engines.items()}
    assert len(set(keys.values())) == len(REVISIONS)
    assert keys[revision][2] == revision


@pytest.mark.parametrize("revision", REVISIONS)
def test_vmem_budget_equals_reference(revision):
    for cols, block_rows in ((["A1", "A7", "A13"], 256), (["A2"], 1024)):
        jg = J.TableGeometry.from_schema(J.benchmark_schema(64, 4), cols, 1 << 20)
        tg = T.TableGeometry.from_schema(T.benchmark_schema(64, 4), cols, 1 << 20)
        je = J.RelationalMemoryEngine(revision=revision, block_rows=block_rows)
        te = T.RelationalMemoryEngine(revision=revision, block_rows=block_rows,
                                      device="cpu")
        assert te.vmem_budget_bytes(tg) == je.vmem_budget_bytes(jg)


def test_xla_revision_raises():
    with pytest.raises(ValueError, match="plain PyTorch versions"):
        T.RelationalMemoryEngine(revision="xla", device="cpu")
    words = torch.zeros((4, 18), dtype=torch.int32)
    g = T.TableGeometry.from_schema(T.benchmark_schema(64, 4), ["A1"], 4)
    with pytest.raises(ValueError, match="xla"):
        TK.project_any(words, g, revision="xla")
    with pytest.raises(ValueError, match="unknown RME revision"):
        TK.project(words, g, "xla")
