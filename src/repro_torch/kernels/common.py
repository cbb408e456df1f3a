"""Shared kernel utilities — the port's counterpart of ``repro.kernels.common``.

The geometry contract every kernel honors is the reference package's: a
kernel's input is one table's row store (or one resident chunk of it), an
``(N, row_words)`` int32 tensor whose row stride is the storage schema (user
columns back to back, then the hidden ``__ts_begin`` / ``__ts_end`` words).
Requests name word offsets into that stride; ``ts_word >= 0`` fuses the MVCC
snapshot test ``begin <= ts < end``.  Rows are position-local, so one request
runs unchanged over a whole table or any chunk of it.

Besides the conventions (word-granule column slices, 4-byte decoding, the
``gt`` / ``lt`` / ``none`` predicate, floored-modulo group ids), this module
holds the plain-PyTorch building blocks every kernel module's ``*_torch``
reference composes, and :func:`resolve_device`, the one rule for where the
port runs: on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.schema import TableGeometry

# the modeled row-tile height of the reference package's kernels; the engine
# keeps it (and its 2 MB VMEM guard) so EngineStats.last_block_rows matches.
# The CUDA kernels choose their own tile (see _cuda.tile_rows).
DEFAULT_BLOCK_ROWS = 256


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the card.  Asking for the card without one raises:
    nothing silently runs on the CPU unless the caller passes ``"cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; want 'cuda' or 'cpu'")
    if dev.type == "cuda" and dev.index is None:
        # name the card as its tensors do ("cuda:0", not "cuda"), so a
        # device kept as a cache key equals the device of what it caches
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_model_device(device: str | torch.device | None) -> torch.device:
    """:func:`resolve_device` for a model, which also takes ``"meta"`` (the
    dry run: nothing is allocated or computed, and the LM kernels'
    wrappers give their outputs' shapes)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def decode(x: torch.Tensor, dtype: str) -> torch.Tensor:
    """Reinterpret raw int32 storage words as the column's 4-byte dtype."""
    if dtype == "float32":
        return x.view(torch.float32)
    if dtype == "int32":
        return x
    raise ValueError(f"4-byte numeric column required, got {dtype}")


def pred_mask(vals: torch.Tensor, op: str, k: torch.Tensor) -> torch.Tensor:
    """The fused predicate every offload kernel evaluates in-scan."""
    if op == "gt":
        return vals > k
    if op == "lt":
        return vals < k
    if op == "none":
        return torch.ones(vals.shape, dtype=torch.bool, device=vals.device)
    raise ValueError(op)


def group_ids(raw: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Raw int32 group words -> ``[0, num_groups)`` by floored modulo.

    ``torch.remainder`` takes the divisor's sign, as ``jnp.remainder`` does,
    so negative keys and the int32 extremes land in range on every path
    (the CUDA kernels spell it ``((x % G) + G) % G``)."""
    return torch.remainder(raw, num_groups)


def column_slices(geom: TableGeometry):
    """(src_word_offset, dst_word_offset, word_width) per enabled column."""
    return tuple(
        zip(geom.col_word_offsets, geom.out_word_offsets, geom.col_word_widths)
    )


def geometry_words(geom: TableGeometry) -> list[int]:
    """Source word of every packed output word, in packed order."""
    out: list[int] = []
    for s, _, w in column_slices(geom):
        out.extend(range(s, s + w))
    return out


def pred_k_bits(pred_k, pred_dtype: str) -> int:
    """The predicate constant as int32 bits (how kernels take it as operand).

    The constant is converted to the column's dtype first (a float constant
    on an int32 column truncates toward zero, as the reference's
    ``jnp.asarray(k, int32)`` does), then its bits are taken."""
    dt = np.float32 if pred_dtype == "float32" else np.int32
    return int(np.asarray(pred_k, dtype=dt).reshape(()).view(np.int32))


# ----------------------------------------------- plain building blocks
def row_mask(words: torch.Tensor, pred_word: int, pred_dtype: str,
             pred_op: str, k_bits: int, ts_word: int, ts: int) -> torch.Tensor:
    """Predicate AND MVCC visibility of every row of ``words``, as bool."""
    if pred_op == "none":
        mask = torch.ones(words.shape[0], dtype=torch.bool, device=words.device)
    else:
        k = decode(torch.tensor(k_bits, dtype=torch.int32, device=words.device),
                   pred_dtype)
        mask = pred_mask(decode(words[:, pred_word], pred_dtype), pred_op, k)
    if ts_word >= 0:
        mask = mask & (words[:, ts_word] <= ts) & (ts < words[:, ts_word + 1])
    return mask


def masked_values(raw: torch.Tensor, dtype: str,
                  mask: torch.Tensor) -> torch.Tensor:
    """Column values as float32 where ``mask`` holds, 0 elsewhere.

    Sums stay float32, as on the reference's TPU path: widening them here
    would let this version drift from the kernels it checks."""
    vals = decode(raw, dtype).to(torch.float32)
    return torch.where(mask, vals, torch.zeros((), dtype=torch.float32,
                                                device=vals.device))


def sum_count(raw: torch.Tensor, dtype: str, mask: torch.Tensor) -> torch.Tensor:
    """float32 ``[sum, count]`` over the masked rows.  The count is taken as
    an integer and rounded to float32 once, so it is exact wherever float32
    can hold it (the kernels do the same)."""
    total = masked_values(raw, dtype, mask).sum()
    count = mask.sum().to(torch.float32)
    return torch.stack([total, count])


def group_sum_count(group_raw: torch.Tensor, raw: torch.Tensor, dtype: str,
                    mask: torch.Tensor, num_groups: int):
    """Per-group float32 ``(sums[G], counts[G])`` over the masked rows."""
    g = group_ids(group_raw, num_groups).long()
    sums = torch.zeros(num_groups, dtype=torch.float32, device=raw.device)
    sums.index_add_(0, g, masked_values(raw, dtype, mask))
    counts = torch.bincount(g[mask], minlength=num_groups).to(torch.float32)
    return sums, counts
