"""The port's descriptor model (the paper's Eq. (1)-(6)) against the JAX
package's, side by side; numpy only.

``repro_torch.core.descriptor`` is a copy of ``repro.core.descriptor`` (the
Requestor's descriptors, their vectorised form, the software Fetch-Unit
model and the bus-beat closed form) and ``paper_schema`` of
``repro.core.schema``'s.  On the same geometries and memory both packages
give equal descriptors, equal arrays, byte-equal reorganisation buffers and
equal beat counts; the port also passes ``tests/test_descriptor.py``'s and
``test_descriptor_basic.py``'s checks on its own.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import descriptor as jd
from repro.core import schema as js
from repro_torch.core import (
    TableGeometry,
    benchmark_schema,
    descriptor_arrays,
    descriptors,
    fetch_model,
    paper_schema,
)
from repro_torch.core import descriptor as td
from repro_torch.core.schema import WORD


def random_geometry(rng) -> TableGeometry:
    """A word-aligned geometry with non-overlapping enabled columns, drawn as
    ``tests/test_descriptor.py``'s strategy draws them."""
    row_words = int(rng.integers(2, 65))
    n_cols = int(rng.integers(1, min(11, row_words) + 1))
    starts = sorted(rng.choice(row_words, n_cols, replace=False).tolist())
    widths = []
    for i, s in enumerate(starts):
        limit = (starts[i + 1] if i + 1 < n_cols else row_words) - s
        widths.append(int(rng.integers(1, min(limit, 16) + 1)))
    rel = [starts[0] * WORD] + [(starts[i] - starts[i - 1]) * WORD for i in range(1, n_cols)]
    return TableGeometry(row_bytes=row_words * WORD, row_count=int(rng.integers(1, 201)),
                         col_widths=tuple(w * WORD for w in widths),
                         col_rel_offsets=tuple(rel))


def geometries():
    fixed = [TableGeometry.from_schema(benchmark_schema(64, 4), ["A1", "A7", "A13"], 100),
             TableGeometry(row_bytes=64, row_count=64, col_widths=(8,),
                           col_rel_offsets=(12,)),
             TableGeometry(row_bytes=72, row_count=33, col_widths=(4, 8, 12),
                           col_rel_offsets=(4, 12, 20))]
    rng = np.random.default_rng(7)
    return fixed + [random_geometry(rng) for _ in range(12)]


GEOMETRIES = geometries()


def reference(geom: TableGeometry) -> js.TableGeometry:
    return js.TableGeometry(**dataclasses.asdict(geom))


@pytest.mark.parametrize("bus_width", [8, 16, 32, 64])
@pytest.mark.parametrize("idx", range(len(GEOMETRIES)))
def test_descriptors_and_fetch_model_equal_the_reference(idx, bus_width):
    geom = GEOMETRIES[idx]
    ref = reference(geom)
    got = [dataclasses.astuple(d) for d in descriptors(geom, bus_width)]
    want = [dataclasses.astuple(d) for d in jd.descriptors(ref, bus_width)]
    assert got == want
    arrays, want_arrays = descriptor_arrays(geom, bus_width), jd.descriptor_arrays(ref, bus_width)
    assert arrays.keys() == want_arrays.keys()
    for name in arrays:
        np.testing.assert_array_equal(arrays[name], want_arrays[name])
    memory = np.random.default_rng(42).integers(0, 256, geom.row_bytes * geom.row_count,
                                                dtype=np.uint8)
    out, beats = fetch_model(memory, geom, bus_width)
    want_out, want_beats = jd.fetch_model(memory, ref, bus_width)
    np.testing.assert_array_equal(out, want_out)
    assert beats == want_beats
    assert td.bytes_moved(geom, bus_width) == jd.bytes_moved(ref, bus_width)
    # the closed form charges exactly the descriptors' beats
    assert td.bytes_moved(geom, bus_width)["rme"] == beats * bus_width


@pytest.mark.parametrize("idx", range(len(GEOMETRIES)))
def test_fetch_model_reconstructs_and_descriptors_hold_the_invariants(idx):
    """``test_descriptor.py``'s two properties on the port: the packed
    projection rebuilt byte-exactly, and Eq. (2)-(6)'s alignment, bounded
    burst and bounded over-fetch."""
    geom = GEOMETRIES[idx]
    memory = np.random.default_rng(42).integers(0, 256, geom.row_bytes * geom.row_count,
                                                dtype=np.uint8)
    out, beats = fetch_model(memory, geom, 16)
    expect = [memory[i * geom.row_bytes + off:i * geom.row_bytes + off + w]
              for i in range(geom.row_count)
              for off, w in zip(geom.abs_offsets, geom.col_widths)]
    np.testing.assert_array_equal(out, np.concatenate(expect))
    assert beats >= -(-geom.out_bytes_per_row * geom.row_count // 16)
    for bus_width in (8, 16, 32):
        for d in descriptors(geom, bus_width):
            width = geom.col_widths[d.j]
            p = geom.row_bytes * d.i + geom.abs_offsets[d.j]
            assert d.r_addr % bus_width == 0 and d.e_start < bus_width
            assert width <= d.r_burst * bus_width < width + 2 * bus_width
            assert d.e_start + width <= d.r_burst * bus_width
            assert d.r_addr <= p < d.r_addr + d.r_burst * bus_width


def test_vectorized_matches_scalar():
    geom = TableGeometry.from_schema(benchmark_schema(64, 4), ["A1", "A7", "A13"], 100)
    arrs = descriptor_arrays(geom)
    for d in descriptors(geom):
        assert arrs["r_addr"][d.i, d.j] == d.r_addr
        assert arrs["r_burst"][d.i, d.j] == d.r_burst
        assert arrs["w_addr"][d.i, d.j] == d.w_addr
        assert arrs["e_start"][d.i, d.j] == d.e_start
        assert arrs["e_end"][d.i, d.j] == d.e_end


def test_offset_insensitivity():
    """The paper's Fig. 6 spike: an 8-byte column costs two beats only where
    it straddles a 16-byte bus line (offset ≡ 12 mod 16), in both packages."""
    n = 64
    mem = np.random.default_rng(0).integers(0, 256, 64 * n, dtype=np.uint8)
    beats = {}
    for off_words in range(14):
        geom = TableGeometry(row_bytes=64, row_count=n, col_widths=(8,),
                             col_rel_offsets=(off_words * WORD,))
        beats[off_words * WORD] = fetch_model(mem, geom, bus_width=16)[1]
        assert beats[off_words * WORD] == jd.fetch_model(mem, reference(geom), 16)[1]
    for off, b in beats.items():
        assert b == (2 if off % 16 == 12 else 1) * beats[0], (off, b)


def test_paper_schema_equals_the_reference():
    got, want = paper_schema(), js.paper_schema()
    assert [dataclasses.astuple(c) for c in got.columns] == [
        dataclasses.astuple(c) for c in want.columns]
    assert got.row_bytes == want.row_bytes
    assert [got.byte_offset(n) for n in got.names] == [
        want.byte_offset(n) for n in want.names]
