"""Compressed execution on the port, single-device engine: the differential
harness of ``tests/test_compressed_execution.py`` side by side with the JAX
package (the sharded cases are in ``test_torch_compressed_sharded.py``, the
join cases of both backends in ``test_torch_compressed_join.py``).

Every case builds the JAX package's encoded table and its byte-aligned plain
twin (``tests/strategies.py``, seeded numpy) and carries both into the port
byte for byte.  The same logical plans run on a JAX engine (``"xla"`` or
``"mlp"``, Pallas in interpret mode) and on the port's CPU engine (its plain
versions play both revisions' part).  The port's results must pass the
reference's three-way check (encoded == plain twin == the ``repro.kernels.
ref`` oracle), equal the JAX engine's byte for byte, leave every
``EngineStats`` field equal (``bytes_saved_compression``, ``decodes`` and
``decode_cache_hits`` among them), and read no more ``bytes_from_dram``
encoded than plain.  The codec edge cases, re-fits and lowering guards run
on the port's own codecs and tables.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.serve as TS  # noqa: E402
import strategies  # noqa: E402
import test_compressed_execution as tce  # noqa: E402
from repro.core import distributed as JD  # noqa: E402
from repro.core import planner as JP  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro_torch.core import planner as TP  # noqa: E402
from repro_torch.core.compression import DeltaCodec, DictCodec  # noqa: E402
from test_torch_planner import port  # noqa: E402

I32 = np.iinfo(np.int32)

SINGLE_CASES = [c for c in tce.CASES if c[1] is None]

# the port's spelling of strategies.ENC_SCHEMA
ENC_SCHEMA = T.TableSchema((
    T.Column("K", "int32", codec="dict"),
    T.Column("F", "int32", codec="for"),
    T.Column("S", "str"),
    T.Column("V", "int32"),
    T.Column("P", "int32"),
))


@pytest.fixture(autouse=True)
def _fresh_build_caches():
    JP.clear_join_build_cache()
    TP.clear_join_build_cache()
    yield
    JP.clear_join_build_cache()
    TP.clear_join_build_cache()


# ------------------------------------------------------------------ helpers
def engines(revision, shards):
    """(JAX engine, port engine) of one backend."""
    if shards is None:
        return (J.RelationalMemoryEngine(revision=revision),
                T.RelationalMemoryEngine(device="cpu"))
    return (JD.ShardedEngine(num_shards=shards, revision=revision),
            T.ShardedEngine(num_shards=shards, device="cpu"))


def make_ops(pkg, engine, t, kind, params, ts):
    """``tce._make_ops`` in either package."""
    ts = ts if params["snapshot"] else None
    if kind == "project":
        view = engine.register(t, params["cols"], snapshot_ts=ts)
        if ts is None:
            return pkg.ProjectOp(view)
        return pkg.FilterOp(view, params["cols"][0], "none", 0, snapshot_ts=ts)
    if kind == "filter":
        view = engine.register(t, params["cols"], snapshot_ts=ts)
        return pkg.FilterOp(view, params["pred_col"], params["pred_op"],
                            params["pred_k"], snapshot_ts=ts)
    if kind == "aggregate":
        return pkg.AggregateOp(t, params["agg_col"], pred_col=params["pred_col"],
                               pred_op=params["pred_op"], pred_k=params["pred_k"],
                               snapshot_ts=ts)
    return pkg.GroupByOp(t, params["group_col"], params["agg_col"],
                         params["num_groups"], snapshot_ts=ts)


def flatten(result):
    if hasattr(result, "s_proj"):
        return [result.s_proj, result.r_proj, result.matched]
    if isinstance(result, (tuple, list)):
        return [x for r in result for x in flatten(r)]
    return [result]


def assert_same(want, got):
    a, b = flatten(want), flatten(got)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert isinstance(y, torch.Tensor)
        x = np.asarray(x)
        assert y.numpy().shape == x.shape
        np.testing.assert_array_equal(y.numpy(), x)


def assert_stats_equal(je, te):
    """Every field equal; a JAX ``"xla"`` engine's join probe models no row
    tile, so there ``last_block_rows`` is left out."""
    js, ts = dataclasses.asdict(je.stats), dataclasses.asdict(te.stats)
    skip = {"last_block_rows"} if je.revision == "xla" else set()
    diff = {k: (js[k], ts[k]) for k in js if k not in skip and js[k] != ts[k]}
    assert not diff, diff


def differential_mixed_tick(revision, shards, seed):
    """``tce.test_differential_mixed_tick`` on both packages: the port passes
    the three-way check and equals the JAX engines, stats included."""
    kinds = strategies.PLAN_KINDS
    params = {k: strategies.plan_params(seed, k) for k in kinds}
    enc_j, plain_j, ts = tce._build_twins(seed)
    enc_t, plain_t = port(enc_j), port(plain_j)
    (je_enc, te_enc), (je_plain, te_plain) = engines(revision, shards), engines(revision, shards)
    run = {}
    for name, pkg, eng, t in (("je", J, je_enc, enc_j), ("jp", J, je_plain, plain_j),
                              ("te", T, te_enc, enc_t), ("tp", T, te_plain, plain_t)):
        run[name] = eng.execute_many([make_ops(pkg, eng, t, k, params[k], ts)
                                      for k in kinds])
    for i, kind in enumerate(kinds):
        oracle = tce._oracle(plain_j, kind, params[kind], ts)
        tce._check_case(enc_j, kind, params[kind], run["te"][i], run["tp"][i], oracle)
        assert_same(run["je"][i], run["te"][i])
        assert_same(run["jp"][i], run["tp"][i])
    assert te_enc.stats.bytes_from_dram <= te_plain.stats.bytes_from_dram
    assert te_enc.stats.bytes_saved_compression >= 0
    assert_stats_equal(je_enc, te_enc)
    assert_stats_equal(je_plain, te_plain)


def differential_join(revision, shards, seed):
    """``tce.test_differential_join`` on both packages."""
    (enc_p, enc_b), (plain_p, plain_b), _ = strategies.build_tables(seed)
    ts = None
    if seed % 2 == 1:
        ts = enc_p.now()
        rng = np.random.default_rng(seed + 777)
        pool = enc_p.codecs["K"].dictionary.astype(np.int32)
        extra = {
            "K": rng.choice(pool, 9),
            "F": rng.integers(0, 100, 9).astype(np.int32),
            "S": rng.choice(strategies.STRING_POOL, 9),
            "V": rng.integers(-50, 50, 9).astype(np.int32),
            "P": rng.integers(-50, 50, 9).astype(np.int32),
        }
        enc_p.append(extra)
        plain_p.append(dict(extra, S=strategies.str_codes(extra["S"])))

    def run(pkg, eng, probe, build):
        op = pkg.JoinOp(eng.register(probe, ("V", "K"), snapshot_ts=ts),
                        "V", "K", build, "B", snapshot_ts=ts)
        return eng.execute_many([op])[0]

    (je_enc, te_enc), (je_plain, te_plain) = engines(revision, shards), engines(revision, shards)
    want = [run(J, je_enc, enc_p, enc_b), run(J, je_plain, plain_p, plain_b)]
    got = [run(T, te_enc, port(enc_p), port(enc_b)),
           run(T, te_plain, port(plain_p), port(plain_b))]

    pw = jnp.asarray(plain_p.words())
    s_valid = (ref.mvcc_mask_ref(pw, plain_p.ts_begin_word, ts)
               if ts is not None else None)
    bw = jnp.asarray(plain_b.words())
    oracle = ref.hash_join_ref(
        pw[:, plain_p.schema.word_offset("K")], pw[:, plain_p.schema.word_offset("V")],
        bw[:, plain_b.schema.word_offset("K")], bw[:, plain_b.schema.word_offset("B")],
        s_valid=s_valid)
    for w, g in zip(want, got):
        assert_same(oracle, g)
        assert_same(w, g)
    assert te_enc.stats.bytes_from_dram <= te_plain.stats.bytes_from_dram
    assert_stats_equal(je_enc, te_enc)
    assert_stats_equal(je_plain, te_plain)


def zero_decodes_in_fused_pass(monkeypatch, engine):
    """``tce.test_zero_decodes_in_fused_pass`` on a port engine."""
    (enc_p, enc_b), _, _ = strategies.build_tables(9)
    probe, build = port(enc_p), port(enc_b)
    calls = {"n": 0}
    for cls, name in ((DictCodec, "decode"), (DictCodec, "decode_np"),
                      (DeltaCodec, "decode"), (DeltaCodec, "decode_np")):
        orig = getattr(cls, name)

        def counting(self, *a, _orig=orig, **kw):
            calls["n"] += 1
            return _orig(self, *a, **kw)

        monkeypatch.setattr(cls, name, counting)
    view = engine.register(probe, ("K", "V"))
    results = engine.execute_many([
        T.FilterOp(view, "K", "gt", 0),
        T.AggregateOp(probe, "F", pred_col="K", pred_op="lt", pred_k=3),
        T.GroupByOp(probe, "K", "V", 16),
        T.GroupByOp(probe, "S", "V", len(strategies.STRING_POOL)),
        T.JoinOp(engine.register(probe, ("V", "K")), "V", "K", build, "B"),
    ])
    for r in results:
        for part in flatten(r):
            part.numpy()
    assert calls["n"] == 0, "fused pass decoded an encoded column"
    col = view.column("K")  # decode-on-finalize fires at the client read
    assert calls["n"] == 1 and engine.stats.decodes == 1
    np.testing.assert_array_equal(np.asarray(col), strategies.logical_columns(9)["K"])
    view.column("K")
    assert calls["n"] == 1, "second read must hit the decode cache"
    assert engine.stats.decode_cache_hits == 1


def string_column_tick(engine, shared_scans):
    """``tce.test_string_column_through_query_server_mixed_tick`` on a port
    server: a string filter, a string group-by and a shared-dictionary join
    in ``shared_scans`` shared scans, equal to the host oracle."""
    (enc_p, enc_b), _, (logical, build) = strategies.build_tables(21)
    probe, right = port(enc_p), port(enc_b)
    server = TS.QueryServer(engine)
    n_groups = len(strategies.STRING_POOL)
    t_filter = server.submit(T.plan(probe).filter("S", "gt", "cedar").project("S", "V"))
    t_gb = server.submit(T.plan(probe).groupby("S", "V", "sum", n_groups))
    t_join = server.submit(T.plan(probe).join(right, "K", "V", "B"))
    server.run_tick()
    assert engine.stats.shared_scans == shared_scans

    s, v, k = logical["S"], logical["V"], logical["K"]
    sdict = probe.codecs["S"]
    packed, mask = t_filter.result(timeout=5)
    np.testing.assert_array_equal(mask.numpy(), s > "cedar")
    live = mask.numpy()
    codes = packed.numpy()[:, 0]
    np.testing.assert_array_equal(sdict.decode_np(codes[live]), s[live])
    np.testing.assert_array_equal(packed.numpy()[live, 1], v[live])
    want = np.zeros(n_groups, np.float32)
    for code, val in zip(sdict.encode(s), v):
        want[code] += val
    np.testing.assert_array_equal(t_gb.result(timeout=5).numpy(), want)
    oracle = ref.hash_join_ref(jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(build["K"]), jnp.asarray(build["B"]))
    assert_same(oracle, t_join.result(timeout=5))
    snap = server.snapshot()
    assert snap["engine_bytes_saved_compression"] > 0
    assert "engine_decodes" in snap and "engine_decode_cache_hits" in snap
    return snap


# --------------------------------------------------------- differential suite
def test_case_count_floor():
    """The reference's census, both backends: >= 200 generated cases."""
    n = len(tce.CASES) * len(strategies.PLAN_KINDS) + len(tce.JOIN_CASES)
    assert n >= 200, n
    assert len(SINGLE_CASES) == 30


@pytest.mark.parametrize("revision,shards,seed", SINGLE_CASES)
def test_differential_mixed_tick(revision, shards, seed):
    differential_mixed_tick(revision, shards, seed)


def test_zero_decodes_in_fused_pass(monkeypatch):
    zero_decodes_in_fused_pass(monkeypatch, T.RelationalMemoryEngine(device="cpu"))


def test_string_column_through_query_server_mixed_tick():
    string_column_tick(T.RelationalMemoryEngine(device="cpu"), shared_scans=1)


# ---------------------------------------------------- codec edge regressions
class TestDictCodecEdges:
    def test_empty_fit_serves_empty_and_rejects_values(self):
        c = DictCodec.fit(np.zeros(0, np.int32))
        assert c.code_bits == 0 and c.code_bytes == 0
        assert c.encode(np.zeros(0, np.int32)).size == 0
        with pytest.raises(ValueError, match="outside the fitted dictionary"):
            c.encode(np.array([1], np.int32))

    def test_single_value_dictionary_is_zero_bits(self):
        c = DictCodec.fit(np.array([42, 42, 42], np.int32))
        assert c.code_bits == 0 and c.code_bytes == 0
        np.testing.assert_array_equal(c.encode(np.array([42, 42], np.int32)), [0, 0])
        assert c.translate_pred("gt", 41) == ("gt", -1)  # every code passes
        assert c.translate_pred("gt", 42) == ("gt", 0)  # none pass
        assert c.translate_pred("lt", 42) == ("lt", 0)  # none pass
        assert c.translate_pred("lt", 43) == ("lt", 1)  # every code passes

    def test_int32_extreme_values_roundtrip(self):
        vals = np.array([I32.min, -1, 0, I32.max], np.int32)
        c = DictCodec.fit(vals)
        np.testing.assert_array_equal(c.decode_np(c.encode(vals)), vals)
        np.testing.assert_array_equal(c.decode(torch.from_numpy(c.encode(vals))).numpy(),
                                      vals)
        assert c.translate_pred("gt", I32.max)[1] == c.dictionary.size - 1
        assert c.translate_pred("lt", I32.min)[1] == 0

    def test_out_of_dictionary_encode_raises(self):
        c = DictCodec.fit(np.array([1, 5, 9], np.int32))
        with pytest.raises(ValueError, match="outside the fitted dictionary"):
            c.encode(np.array([1, 7], np.int32))


class TestDeltaCodecEdges:
    def test_int32_min_reference(self):
        vals = np.array([I32.min, I32.min + 5, I32.min + 1], np.int32)
        c = DeltaCodec.fit_global(vals)
        assert c.base == I32.min
        np.testing.assert_array_equal(c.encode(vals), [0, 5, 1])
        np.testing.assert_array_equal(c.decode_np(c.encode(vals)), vals)
        np.testing.assert_array_equal(c.decode(torch.from_numpy(c.encode(vals))).numpy(),
                                      vals)
        assert c.translate_pred("gt", 0) == ("gt", I32.max)  # never pass
        assert c.translate_pred("lt", I32.min) == ("lt", 0)

    def test_full_range_delta_overflows_honestly(self):
        c = DeltaCodec.fit_global(np.array([I32.min], np.int32))
        with pytest.raises(ValueError, match="delta overflows int32"):
            c.encode(np.array([I32.max], np.int32))

    def test_fitted_width_claim_enforced_on_encode(self):
        c = DeltaCodec.fit_global(np.array([100, 110], np.int32))
        assert c.code_bits == 4
        with pytest.raises(ValueError, match="outside the fitted delta"):
            c.encode(np.array([90], np.int32))
        with pytest.raises(ValueError, match="outside the fitted delta"):
            c.encode(np.array([100 + 16], np.int32))

    def test_short_tail_frames_roundtrip(self):
        vals = np.random.default_rng(5).integers(-1000, 1000, 37).astype(np.int32)
        c = DeltaCodec.fit(vals, frame_rows=16)
        assert len(c.references) == 3 and not c.single_frame
        np.testing.assert_array_equal(c.decode_np(c.encode(vals)), vals)
        np.testing.assert_array_equal(c.decode(torch.from_numpy(c.encode(vals))).numpy(),
                                      vals)
        rows = np.array([0, 16, 36])
        np.testing.assert_array_equal(c.decode_np(c.encode(vals)[rows], rows), vals[rows])
        with pytest.raises(ValueError, match="single-frame"):
            c.translate_pred("gt", 0)

    def test_empty_fit_global(self):
        c = DeltaCodec.fit_global(np.zeros(0, np.int32))
        assert c.base == 0 and c.code_bits == 0 and c.single_frame
        assert c.encode(np.zeros(0, np.int32)).size == 0


class TestTableRefitHonesty:
    """Out-of-dictionary writes re-fit (rewriting stored code words and
    bumping the storage epoch) or drop the codec, on the port's tables,
    byte for byte as the JAX package's."""

    COLS = {"K": np.array([3, 7, 3], np.int32), "F": np.array([10, 11, 12], np.int32),
            "S": np.array(["fig", "iris", "fig"]), "V": np.arange(3, dtype=np.int32),
            "P": np.arange(3, dtype=np.int32)}

    def tables(self):
        return (J.RelationalTable.from_columns(strategies.ENC_SCHEMA, self.COLS),
                T.RelationalTable.from_columns(ENC_SCHEMA, self.COLS))

    def test_append_outside_dictionary_refits(self):
        jt, t = self.tables()
        epoch0 = t.storage_epoch
        old_codes = t.words()[:, 0].copy()
        row = {"K": np.array([5], np.int32), "F": np.array([13], np.int32),
               "S": np.array(["amber"]), "V": np.array([3], np.int32),
               "P": np.array([3], np.int32)}
        jt.append(row)
        t.append(row)
        assert t.storage_epoch > epoch0
        np.testing.assert_array_equal(t.codecs["K"].dictionary.astype(np.int64), [3, 5, 7])
        assert not np.array_equal(t.words()[:3, 0], old_codes)
        np.testing.assert_array_equal(t.codecs["K"].decode_np(t.words()[:4, 0]), [3, 7, 3, 5])
        np.testing.assert_array_equal(t.codecs["S"].decode_np(t.words()[:4, 2]),
                                      ["fig", "iris", "fig", "amber"])
        np.testing.assert_array_equal(t.words(), jt.words())

    def test_update_outside_dictionary_refits(self):
        jt, t = self.tables()
        epoch0 = t.storage_epoch
        for x in (jt, t):
            x.update(np.array([1]), {"K": np.array([-9], np.int32)})
        assert t.storage_epoch > epoch0
        np.testing.assert_array_equal(t.codecs["K"].dictionary.astype(np.int64), [-9, 3, 7])
        np.testing.assert_array_equal(np.sort(t.read_column("K")), [-9, 3, 3])
        np.testing.assert_array_equal(t.words(), jt.words())

    def test_for_overflow_drops_codec_to_plain(self):
        first = {"K": np.array([1], np.int32), "F": np.array([I32.min], np.int32),
                 "S": np.array(["fig"]), "V": np.array([0], np.int32),
                 "P": np.array([0], np.int32)}
        t = T.RelationalTable.from_columns(ENC_SCHEMA, first)
        assert "F" in t.codecs
        t.append(dict(first, F=np.array([I32.max], np.int32)))
        assert "F" not in t.codecs  # dropped honestly, values stay plain
        np.testing.assert_array_equal(t.words()[:2, 1], [I32.min, I32.max])

    def test_refit_resyncs_device_and_invalidates_caches(self):
        for eng in (T.RelationalMemoryEngine(device="cpu"),
                    T.ShardedEngine(num_shards=2, device="cpu")):
            _, t = self.tables()
            view = eng.register(t, ("K", "V"))
            before = view.packed().clone()
            k0 = np.asarray(view.column("K"))
            t.append({"K": np.array([4], np.int32), "F": np.array([13], np.int32),
                      "S": np.array(["cedar"]), "V": np.array([9], np.int32),
                      "P": np.array([9], np.int32)})
            after = eng.register(t, ("K", "V")).packed().numpy()
            # the re-encoded prefix reached the device (a full resync)
            np.testing.assert_array_equal(t.codecs["K"].decode_np(after[:, 0]), [3, 7, 3, 4])
            assert not np.array_equal(after[:3], before.numpy())
            np.testing.assert_array_equal(np.asarray(eng.register(t, ("K", "V")).column("K")),
                                          np.concatenate([k0, [4]]))

    def test_mismatched_dictionaries_fall_back_to_decode_join(self):
        """Independently fitted key dictionaries cannot join on raw codes:
        the device route refuses, the planner takes the shared-scan route
        (the one honest decode), and the result matches the oracle."""
        rng = np.random.default_rng(3)
        left_k = rng.integers(-20, 20, 64).astype(np.int32)
        left_v = rng.integers(-50, 50, 64).astype(np.int32)
        right_k = np.unique(rng.integers(-20, 20, 30).astype(np.int32))
        right_b = rng.integers(-50, 50, right_k.size).astype(np.int32)
        left = T.RelationalTable.from_columns(ENC_SCHEMA, {
            "K": left_k, "F": np.zeros(64, np.int32),
            "S": np.repeat(np.array(["fig"]), 64), "V": left_v,
            "P": np.zeros(64, np.int32)})
        rschema = T.TableSchema((T.Column("K", "int32", codec="dict"),
                                 T.Column("B", "int32")))
        right = T.RelationalTable.from_columns(rschema, {"K": right_k, "B": right_b})
        assert not np.array_equal(left.codecs["K"].dictionary,
                                  right.codecs["K"].dictionary)
        eng = T.RelationalMemoryEngine(device="cpu")
        with pytest.raises(ValueError, match="shared table-level dictionary"):
            T.JoinOp(eng.register(left, ("V", "K")), "V", "K", right, "B").lower()
        server = TS.QueryServer(eng)
        ticket = server.submit(T.plan(left).join(right, "K", "V", "B"))
        server.run_tick()
        assert ticket.route == "shared-scan-join"
        oracle = ref.hash_join_ref(jnp.asarray(left_k), jnp.asarray(left_v),
                                   jnp.asarray(right_k), jnp.asarray(right_b))
        assert_same(oracle, ticket.result(timeout=5))


class TestLoweringGuards:
    def test_dict_encoded_aggregate_rejected(self):
        t = port(strategies.case_tables(8)[0])
        with pytest.raises(ValueError, match="ranks, not"):
            T.AggregateOp(t, "K").lower()

    def test_string_groupby_needs_dictionary_coverage(self):
        t = port(strategies.case_tables(9)[0])
        n = t.codecs["S"].dictionary.size
        with pytest.raises(ValueError, match="cannot cover"):
            T.GroupByOp(t, "S", "V", n - 1).lower()

    def test_for_group_key_rejected(self):
        t = port(strategies.case_tables(9)[0])
        with pytest.raises(ValueError, match="dict codec"):
            T.GroupByOp(t, "F", "V", 8).lower()

    def test_encoded_join_payload_rejected(self):
        (enc_p, enc_b), _, _ = strategies.build_tables(9)
        eng = T.RelationalMemoryEngine(device="cpu")
        with pytest.raises(ValueError, match="payload"):
            T.JoinOp(eng.register(port(enc_p), ("F", "K")), "F", "K",
                     port(enc_b), "B").lower()
