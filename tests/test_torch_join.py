"""Hash-join parity: the port's build and probe against the JAX package's.

The same numpy inputs go through ``repro.kernels.rme_join`` (the Pallas
probe in interpret mode, and ``hash_join_xla``) and through the port's
``repro_torch.kernels.rme_join`` on the CPU (``hash_join`` dispatches a CPU
tensor to ``hash_join_torch``).  Tolerance: none — bucket indices, bucket
arrays and every probe output (``s_proj``, ``r_proj``, ``matched``) are
bit-equal, including the int32 wrap of duplicate-key payload sums.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (loads the reference in its import order)
from repro.kernels import rme_join as JK  # noqa: E402
from repro_torch.kernels import ops as TK  # noqa: E402
from repro_torch.kernels import rme_join as TJ  # noqa: E402

I32 = np.iinfo(np.int32)
EXTREMES = np.array([I32.min, I32.min + 1, -2, -1, 0, 1, 2, I32.max - 1, I32.max],
                    np.int32)


def build_side(n, seed, dup=0, extreme=False):
    """Build keys/vals/timestamps: unique keys, ``dup`` of them repeated
    (MVCC-style version pairs), optionally the int32 extremes."""
    rng = np.random.default_rng(seed)
    keys = rng.permutation(np.arange(-n, n, dtype=np.int32))[:n]
    if extreme:
        keys[: EXTREMES.size] = EXTREMES[: n]
    if dup:
        keys = np.concatenate([keys, keys[:dup]])
    m = keys.size
    vals = rng.integers(I32.min, I32.max, m, dtype=np.int64).astype(np.int32)
    begin = rng.integers(0, 6, m).astype(np.int32)
    end = np.where(rng.random(m) < 0.3, rng.integers(2, 9, m), I32.max).astype(np.int32)
    return keys, vals, begin, end


def probe_words(n, row_words, key_word, build_keys, seed, ts_word=-1):
    """Probe rows whose key word hits the build keys about half the time."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-1000, 1000, (n, row_words)).astype(np.int32)
    if n and build_keys.size:
        hit = rng.random(n) < 0.5
        w[:, key_word] = np.where(hit, rng.choice(build_keys, n),
                                  rng.integers(I32.min, I32.max, n, dtype=np.int64))
    w[: min(n, EXTREMES.size), key_word] = EXTREMES[: min(n, EXTREMES.size)]
    if ts_word >= 0:
        w[:, ts_word] = rng.integers(0, 6, n)
        w[:, ts_word + 1] = np.where(rng.random(n) < 0.3, rng.integers(2, 9, n), I32.max)
    return w


def jax_parts(keys, vals, begin, end):
    return JK.build_partitions(keys, vals, begin, end)


def torch_parts(keys, vals, begin, end):
    return TJ.build_partitions(keys, vals, begin, end, device="cpu")


def assert_probe_equal(want, got):
    for name, a, b in zip(("s_proj", "r_proj", "matched"), want, got):
        a = np.asarray(a)
        b = b.numpy()
        assert b.dtype == a.dtype, (name, b.dtype, a.dtype)
        np.testing.assert_array_equal(b, a, err_msg=name)


# ------------------------------------------------------------------ hashing
@pytest.mark.parametrize("p", [2, 4, 64, 1 << 16])
def test_bucket_hash_matches_numpy_and_reference(p):
    rng = np.random.default_rng(p)
    keys = np.concatenate([EXTREMES, rng.integers(I32.min, I32.max, 4000,
                                                  dtype=np.int64).astype(np.int32)])
    want = JK.bucket_of_np(keys, p)
    np.testing.assert_array_equal(TJ.bucket_of_np(keys, p), want)
    np.testing.assert_array_equal(TJ.bucket_of(torch.from_numpy(keys), p).numpy(), want)
    # the reference's traced spelling, as its kernels run it
    np.testing.assert_array_equal(np.asarray(JK._bucket_of(jnp.asarray(keys), p)), want)
    assert TJ.num_buckets_for(p * 16 + 1) == JK.num_buckets_for(p * 16 + 1)
    assert TJ.estimated_partition_bytes(p * 9) == JK.estimated_partition_bytes(p * 9)
    np.testing.assert_array_equal(TJ.bucket_fills(p), JK.bucket_fills(p))


@pytest.mark.parametrize("n,dup,extreme", [(0, 0, False), (1, 0, False),
                                           (30, 0, True), (500, 0, False),
                                           (500, 60, True), (3000, 400, False)])
def test_build_partitions_equal_the_reference(n, dup, extreme):
    side = build_side(n, seed=n + dup, dup=dup, extreme=extreme)
    want = jax_parts(*side)
    got = torch_parts(*side)
    assert isinstance(got, TK.JoinPartitions)
    assert (got.num_buckets, got.capacity, got.nbytes) == (
        want.num_buckets, want.capacity, want.nbytes)
    for a, b in zip(want, got):
        assert b.dtype == torch.int32 and b.is_contiguous()
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# ------------------------------------------------------------------- probing
PROBE_CASES = [
    # (name, n_probe, row_words, key_word, val_word, ts_word, build_ts,
    #  n_build, dup)
    ("rowstore_snapshot", 300, 18, 1, 0, 16, True, 200, 0),
    ("rowstore_plain", 300, 18, 1, 0, -1, False, 200, 0),
    ("rowstore_probe_ts_only", 513, 18, 5, 9, 16, False, 700, 0),
    ("packed_2", 300, 2, 1, 0, -1, False, 200, 0),
    ("packed_2_build_ts", 257, 2, 1, 0, -1, True, 200, 0),
    ("packed_3", 129, 3, 2, 0, -1, True, 64, 0),
    ("p2_tiny_build", 100, 2, 1, 0, -1, False, 5, 0),
    ("duplicates_wrap", 300, 2, 0, 1, -1, False, 150, 120),
    ("duplicates_snapshot", 300, 18, 1, 0, 16, True, 150, 120),
    ("zero_rows", 0, 18, 1, 0, 16, True, 50, 0),
    ("one_row", 1, 2, 1, 0, -1, True, 50, 0),
]


@pytest.mark.parametrize("case", PROBE_CASES, ids=[c[0] for c in PROBE_CASES])
def test_hash_join_bit_equal_to_pallas_and_xla(case):
    _, n, row_words, key_word, val_word, ts_word, build_ts, n_build, dup = case
    side = build_side(n_build, seed=n_build, dup=dup, extreme=True)
    words = probe_words(n, row_words, key_word, side[0], seed=n + row_words,
                        ts_word=ts_word)
    ts = 4
    kw = dict(ts_word=ts_word, ts=ts, build_ts=build_ts)
    jparts = jax_parts(*side)
    tparts = torch_parts(*side)
    t_words = torch.from_numpy(words)
    got = TK.hash_join(t_words, tparts, key_word, val_word, **kw)
    plain = TK.hash_join_torch(t_words, tparts, key_word, val_word, **kw)
    want_xla = JK.hash_join_xla(jnp.asarray(words), jparts, key_word, val_word, **kw)
    assert_probe_equal(want_xla, got)
    assert_probe_equal(want_xla, plain)
    if n:  # the Pallas grid needs at least one row
        want = JK.hash_join(jnp.asarray(words), jparts, key_word, val_word,
                            interpret=True, **kw)
        assert_probe_equal(want, got)
    assert got[0].shape == (n,)


def test_plain_version_walks_slices(monkeypatch):
    """The plain version's row slices concatenate to the one-shot answer."""
    side = build_side(300, seed=1, dup=40)
    words = torch.from_numpy(probe_words(1000, 18, 1, side[0], seed=2, ts_word=16))
    parts = torch_parts(*side)
    whole = TJ.hash_join_torch(words, parts, 1, 0, 16, 4, True)
    monkeypatch.setattr(TJ, "PLAIN_SLICE_WORDS", 7 * parts.capacity)
    sliced = TJ.hash_join_torch(words, parts, 1, 0, 16, 4, True)
    for a, b in zip(whole, sliced):
        assert torch.equal(a, b)


def test_unaligned_row_slice_of_a_chunk():
    """A row slice of a chunk (what stream slicing and chunk tails hand the
    probe) gives the rows of the whole answer."""
    side = build_side(300, seed=3)
    words = torch.from_numpy(probe_words(301, 18, 1, side[0], seed=4, ts_word=16))
    parts = torch_parts(*side)
    whole = TK.hash_join(words, parts, 1, 0, 16, 3, True)
    part = TK.hash_join(words[7:], parts, 1, 0, 16, 3, True)
    for a, b in zip(whole, part):
        assert torch.equal(a[7:], b)


def test_jax_built_partitions_carry_across():
    """A partition set built by the JAX package, carried over as four numpy
    arrays, probes exactly like one the port built."""
    side = build_side(400, seed=9, dup=30, extreme=True)
    jparts = jax_parts(*side)
    carried = TK.partitions_from_numpy(*(np.asarray(a) for a in jparts), device="cpu")
    words = probe_words(260, 18, 2, side[0], seed=5, ts_word=16)
    want = JK.hash_join(jnp.asarray(words), jparts, 2, 3, ts_word=16, ts=5,
                        build_ts=True, interpret=True)
    assert_probe_equal(want, TK.hash_join(torch.from_numpy(words), carried, 2, 3,
                                          ts_word=16, ts=5, build_ts=True))


def test_bad_inputs_raise():
    side = build_side(50, seed=0)
    parts = torch_parts(*side)
    words = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        TK.hash_join(words, parts, 3, 0)
    with pytest.raises(ValueError, match="ts_word"):
        TK.hash_join(words, parts, 0, 1, ts_word=2)
    with pytest.raises(ValueError, match="int32"):
        TK.hash_join(words.to(torch.int64), parts, 0, 1)
    with pytest.raises(ValueError, match="power of two"):
        TK.partitions_from_numpy(*(np.zeros((3, 2), np.int32),) * 4)
    with pytest.raises(ValueError, match="equal"):
        TK.partitions_from_numpy(np.zeros((2, 2), np.int32), np.zeros((2, 3), np.int32),
                                 np.zeros((2, 2), np.int32), np.zeros((2, 2), np.int32))


@pytest.mark.parametrize("builder", ["build_partitions", "partitions_from_numpy"])
def test_partition_builders_default_to_the_card(builder, monkeypatch):
    """Without ``device`` the buckets go to the card, as every other entry
    point of the port does; with no card that raises and names the CPU
    spelling instead of quietly building on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    side = build_side(60, seed=2)
    args = side if builder == "build_partitions" else [np.asarray(a) for a in jax_parts(*side)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(TK, builder)(*args)
    assert getattr(TK, builder)(*args, device="cpu").keys.device.type == "cpu"

