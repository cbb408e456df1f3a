"""Column compression codecs the RME natively supports (paper §4) — the
port's copy of ``repro.core.compression``: fitting and encoding stay numpy,
the two ``decode`` methods run on torch tensors.

The paper: "Relational Memory natively supports dictionary and delta (frame of
reference) encoding ... both can be used in row-oriented data and hence, they
can benefit any groups of columns requested by ephemeral variables."  RLE is
explicitly *not* preferred (expensive decode, needs sorted data), so we follow
the paper and implement dictionary + delta/FOR only.

Encoded columns are stored in the row store as plain int32 code words, and the
execution stack operates on the **raw code words** wherever the codec's order
structure allows it (Lin et al., PAPERS.md — the win is *operating* on encoded
values, not just storing them):

* **Predicates** — the dictionary is sorted (``np.unique``), so it is
  order-preserving: ``value > k`` holds iff ``code > rank(k)``.
  :meth:`DictCodec.translate_pred` / :meth:`DeltaCodec.translate_pred` map a
  value-space ``(op, k)`` to the equivalent code-space constant at *compile
  time* (``requests._pred_fields``), and the fused kernels compare raw words —
  zero decode in-scan.
* **Group-by keys** — dictionary codes are dense ``[0, n)``, so the kernel
  groups by raw code and the planner remaps code-space partials to value
  groups from the dictionary alone (never ``decode()``).
* **Join keys** — two tables whose key columns share one table-level
  dictionary join directly on code words (equal codes ⟺ equal values).
* **FOR sums** — ``sum(values) = base * count + sum(deltas)``: the kernel
  sums raw delta words and the engine applies the affine fix-up on the
  2-scalar result.

Decoding happens only when a client *reads* a packed result
(``EphemeralView.column`` → ``RelationalMemoryEngine.decode_column``, cached
per table version) — the order the paper intends.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_I32 = np.iinfo(np.int32)

# the all-rows-pass spelling of a translated predicate: the kernels' "none"
# op applies no value test (MVCC visibility still applies when fused)
PASS_ALL = ("none", 0)


@dataclasses.dataclass(frozen=True)
class DictCodec:
    """Dictionary encoding: values -> dense int32 codes, decode via gather.

    The dictionary is kept sorted (``fit`` uses ``np.unique``), which makes
    the code assignment **order-preserving**: range predicates and sort-based
    join probes work on raw codes.  Values may be numeric *or* strings — a
    string column is stored as its int32 code word and only ever decoded on
    result materialization.
    """

    dictionary: np.ndarray  # (n_distinct,) original values, sorted

    @staticmethod
    def fit(values: np.ndarray) -> "DictCodec":
        return DictCodec(np.unique(np.asarray(values)))

    def encode(self, values: np.ndarray) -> np.ndarray:
        values = np.asarray(values)
        if values.size == 0:
            return np.zeros(0, dtype=np.int32)
        if self.dictionary.size == 0:
            raise ValueError("values outside the fitted dictionary")
        codes = np.searchsorted(self.dictionary, values)
        # searchsorted may return n for beyond-max values: clip before the
        # round-trip check so the probe never indexes out of bounds
        safe = np.minimum(codes, self.dictionary.size - 1)
        if not np.array_equal(self.dictionary[safe], values):
            raise ValueError("values outside the fitted dictionary")
        return safe.astype(np.int32)

    def decode(self, codes: torch.Tensor) -> torch.Tensor | np.ndarray:
        if self.dictionary.dtype.kind in ("U", "S", "O"):
            # string dictionaries decode host-side (no torch string dtype)
            return np.asarray(self.dictionary)[np.asarray(codes.cpu())]
        table = torch.as_tensor(self.dictionary, device=codes.device)
        return table[codes.long()]

    def decode_np(self, codes: np.ndarray, rows: np.ndarray | None = None) -> np.ndarray:
        """Host-side decode (table reads; ``rows`` ignored — codes are
        position-independent)."""
        return np.asarray(self.dictionary)[np.asarray(codes)]

    def translate_pred(self, op: str, k) -> tuple[str, int]:
        """Value-space ``col <op> k`` -> the equivalent code-space predicate.

        Order preservation makes both ops a rank lookup, with no op flip:

        * ``gt``: values ``> k`` are exactly codes ``>= rank_right(k)``,
          i.e. ``code > rank_right(k) - 1``.
        * ``lt``: values ``< k`` are exactly codes ``< rank_left(k)``.

        The translated constant always fits int32 (codes live in ``[0, n)``),
        so never-pass and all-pass cases need no special spelling.
        """
        n = self.dictionary.size
        if op == "gt":
            return "gt", int(np.searchsorted(self.dictionary, k, side="right")) - 1
        if op == "lt":
            return "lt", min(int(np.searchsorted(self.dictionary, k, side="left")), n)
        raise ValueError(f"untranslatable predicate op {op!r}")

    @property
    def code_bits(self) -> int:
        """Information width of one code word (0 for ≤1 distinct values)."""
        n = self.dictionary.size
        if n <= 1:
            return 0
        return int(np.ceil(np.log2(n)))

    @property
    def code_bytes(self) -> int:
        """The code word's *effective* byte budget in the union geometry —
        what the compressed stream would move per value."""
        return -(-self.code_bits // 8)



@dataclasses.dataclass(frozen=True)
class DeltaCodec:
    """Frame-of-reference: ``code = value - reference`` per frame of rows.

    ``code_bits`` records the widest delta the fit produced (32 when
    constructed directly) — the effective word budget of the encoded stream.
    A **single-frame** codec (one global reference — what
    :meth:`fit_global` builds and what tables attach) is additionally
    position-independent, which is what lets appended rows encode against the
    same reference and predicates translate to one affine shift.
    """

    references: np.ndarray  # (n_frames,) int64 frame minima
    frame_rows: int
    code_bits: int = 32

    @staticmethod
    def fit_global(values: np.ndarray) -> "DeltaCodec":
        """One reference for every row, past and future — the table-level
        FOR codec.  ``frame_rows`` is effectively infinite, so encode/decode
        are position-independent and appends reuse the fitted reference."""
        v = np.asarray(values, dtype=np.int64)
        ref = np.array([v.min() if v.size else 0], dtype=np.int64)
        bits = _delta_bits(v, np.broadcast_to(ref, v.shape)) if v.size else 0
        return DeltaCodec(ref, frame_rows=2**31 - 1, code_bits=bits)

    @property
    def single_frame(self) -> bool:
        return len(self.references) == 1

    @property
    def base(self) -> int:
        """The global reference of a single-frame codec — the ``base`` in the
        ``sum = base * count + sum(deltas)`` aggregation identity."""
        if not self.single_frame:
            raise ValueError("base is defined for single-frame codecs only")
        return int(self.references[0])

    @property
    def code_bytes(self) -> int:
        return -(-self.code_bits // 8)

    def encode(self, values: np.ndarray) -> np.ndarray:
        v = np.asarray(values, dtype=np.int64)
        frames = np.arange(len(v)) // self.frame_rows
        delta = v - self.references[frames]
        if delta.max(initial=0) > _I32.max or delta.min(initial=0) < _I32.min:
            raise ValueError("delta overflows int32 code word")
        if self.code_bits < 32 and v.size:
            # a *fitted* codec's narrow-width claim must stay honest: any
            # delta outside [0, 2^bits) (negative = below the reference)
            # forces the caller to re-fit, never a silent stale claim
            if delta.min() < 0 or delta.max() > (1 << self.code_bits) - 1:
                raise ValueError("values outside the fitted delta range")
        return delta.astype(np.int32)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        n = codes.shape[0]
        frames = torch.arange(n, device=codes.device) // self.frame_rows
        # references fold to the codes' int32 width, as in the reference
        # package; FOR frames always fit 32-bit deltas (checked at encode)
        refs = torch.as_tensor(self.references.astype(np.int32),
                               device=codes.device)
        return refs[frames] + codes

    def decode_np(self, codes: np.ndarray, rows: np.ndarray | None = None) -> np.ndarray:
        """Host-side decode; ``rows`` gives the codes' physical positions
        (needed by multi-frame codecs — a single-frame codec ignores it)."""
        codes = np.asarray(codes, dtype=np.int64)
        if rows is None:
            frames = np.arange(len(codes)) // self.frame_rows
        else:
            frames = np.asarray(rows) // self.frame_rows
        return (self.references[frames] + codes).astype(np.int32)

    def translate_pred(self, op: str, k) -> tuple[str, int]:
        """Value-space ``col <op> k`` -> delta-space (single-frame only).

        The shift is affine and monotone, so the op never flips: the bound
        becomes ``k - base`` in int64, and bounds that leave the int32 delta
        range collapse to the explicit never-pass / all-pass spellings.
        """
        if not self.single_frame:
            raise ValueError(
                "predicate translation needs a single-frame FOR codec"
            )
        bound = int(k) - self.base
        if op == "gt":
            if bound >= _I32.max:
                return "gt", _I32.max  # no int32 delta exceeds it: never pass
            if bound < _I32.min:
                return PASS_ALL  # every delta exceeds it
            return "gt", bound
        if op == "lt":
            if bound <= _I32.min:
                return "lt", _I32.min  # never pass
            if bound > _I32.max:
                return PASS_ALL
            return "lt", bound
        raise ValueError(f"untranslatable predicate op {op!r}")



def _delta_bits(values: np.ndarray, refs: np.ndarray) -> int:
    """Bits needed for the widest delta (0 when every delta is 0)."""
    if values.size == 0:
        return 0
    delta = values - refs
    widest = int(max(delta.max(initial=0), 0))
    if delta.min(initial=0) < 0:
        widest = 32  # out-of-fit negative deltas: no narrow claim
    return 0 if widest == 0 else int(widest).bit_length()


Codec = DictCodec | DeltaCodec


def fit_codec(kind: str, values: np.ndarray) -> Codec:
    """Fit the table-level codec for a column declared ``codec=kind``."""
    if kind == "dict":
        return DictCodec.fit(values)
    if kind == "for":
        return DeltaCodec.fit_global(values)
    raise ValueError(f"unknown codec kind {kind!r}; want 'dict' or 'for'")
