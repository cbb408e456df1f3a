"""The inputs every run makes from ``--seed`` and hands alike to the program
and to the reference: the relational table's columns and the rows set-up
deletes, the training corpus, and the model's weights.  Nothing here imports
the program."""

from __future__ import annotations

import numpy as np
import torch

SEED_MASK = (1 << 64) - 1
WEIGHT_CHUNK = 1 << 28  # elements a torch.randn call draws: 1 GiB of float32


def seed64(seed: int) -> int:
    """Any whole number as a non-negative 64-bit seed (numpy and torch)."""
    return seed & SEED_MASK


# ------------------------------------------------------------ relational
def column_names(n: int) -> list[str]:
    return [f"A{i + 1}" for i in range(n)]


def table_columns(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The fact table's columns, drawn on ``device`` from a ``torch.Generator``
    in two calls: every column uniform in ``value_range``, then the key
    column uniform in ``[0, key_range)`` in its place.  Each column is a
    contiguous int32 tensor."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed64(seed))
    lo, hi = cfg["value_range"]
    block = torch.randint(lo, hi, (cfg["columns"], cfg["rows"]), generator=gen,
                          dtype=torch.int32, device=device)
    names = column_names(cfg["columns"])
    block[names.index(cfg["key_column"])] = torch.randint(
        0, cfg["key_range"], (cfg["rows"],), generator=gen, dtype=torch.int32, device=device)
    return dict(zip(names, block.unbind(0)))


def deleted_rows(cfg: dict, seed: int) -> np.ndarray:
    """The distinct rows set-up deletes, so that a read's snapshot hides some."""
    rng = np.random.default_rng((seed64(seed), 1))
    return np.sort(rng.choice(cfg["rows"], size=cfg["setup_deletes"], replace=False))


# -------------------------------------------------------------- training
def corpus(samples: int, seq: int, vocab: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``(tokens, labels)``, ``(samples, seq)`` int32: uniform ids with each
    position's id added to the one before it (mod vocab), labels the next
    position's id."""
    rng = np.random.default_rng(seed64(seed))
    base = rng.integers(0, vocab, (samples, seq + 1), dtype=np.int64)
    base[:, 1:] = (base[:, 1:] + base[:, :-1]) % vocab
    return base[:, :-1].astype(np.int32), base[:, 1:].astype(np.int32)


def batch_rows(n_rows: int, batch: int, step: int, seed: int) -> np.ndarray:
    """The corpus rows of batch ``step`` (0-based): a permutation of the rows
    seeded by ``(seed, epoch)``, cut into batches in order."""
    per_epoch = max(n_rows // batch, 1)
    perm = np.random.default_rng((seed, step // per_epoch)).permutation(n_rows)
    i = step % per_epoch
    return perm[i * batch:(i + 1) * batch]


def decoder_leaves(m: dict) -> list[tuple[str, tuple[int, ...], float | None]]:
    """Every weight of a dense QK-norm SwiGLU decoder with an untied head,
    by name, sorted: ``(name, shape, scale)``, drawn as ``scale · N(0, 1)``
    (the embedding 1, a matrix 1 / sqrt(its first dimension), the head
    1 / sqrt(d)); a norm's scale (``None``) starts at zero."""
    d, h, kh, hd, f, v = (m["hidden_size"], m["num_attention_heads"],
                          m["num_key_value_heads"], m["head_dim"],
                          m["intermediate_size"], m["vocab_size"])
    out = [("token_embedding", (v, d), 1.0), ("lm_head", (d, v), d ** -0.5),
           ("final_norm.scale", (d,), None)]
    for i in range(m["num_hidden_layers"]):
        p = f"layers.{i}."
        out += [(p + "ln1.scale", (d,), None), (p + "ln2.scale", (d,), None),
                (p + "mixer.q_norm.scale", (hd,), None),
                (p + "mixer.k_norm.scale", (hd,), None)]
        for name, shape in (("mixer.wq", (d, h * hd)), ("mixer.wk", (d, kh * hd)),
                            ("mixer.wv", (d, kh * hd)), ("mixer.wo", (h * hd, d)),
                            ("mlp.w_gate", (d, f)), ("mlp.w_up", (d, f)),
                            ("mlp.w_down", (f, d))):
            out.append((p + name, shape, shape[0] ** -0.5))
    return sorted(out)


def weight_pieces(leaves, seed: int, device, chunk: int = WEIGHT_CHUNK):
    """Draw the drawn leaves' values as one stream of ``N(0, 1)`` from a
    ``torch.Generator`` on ``device``, ``chunk`` elements a call, and yield
    ``(name, start, values)``: leaf ``name``'s flat elements ``[start, start
    + len(values))``, scaled.  The same seed and leaves give the same
    pieces on every call."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed64(seed))
    drawn = [(name, int(np.prod(shape)), scale) for name, shape, scale in leaves
             if scale is not None]
    total = sum(n for _, n, _ in drawn)
    leaf, used = 0, 0
    for c0 in range(0, total, chunk):
        buf = torch.randn(min(chunk, total - c0), generator=gen, dtype=torch.float32,
                          device=device)
        pos = 0
        while pos < buf.numel():
            name, n, scale = drawn[leaf]
            take = min(n - used, buf.numel() - pos)
            yield name, used, buf[pos:pos + take].mul_(scale)
            pos += take
            used += take
            if used == n:
                leaf, used = leaf + 1, 0
        del buf


def fill_weights(leaves, seed: int, params: dict) -> None:
    """Write the seed's weights into ``params`` (name -> tensor of the
    leaf's shape): the drawn leaves from :func:`weight_pieces`, the norm
    scales zero."""
    with torch.no_grad():
        for name, _, scale in leaves:
            if scale is None:
                params[name].zero_()
        device = next(iter(params.values())).device
        for name, start, values in weight_pieces(leaves, seed, device):
            params[name].view(-1)[start:start + values.numel()].copy_(values)


def distance_from_start(leaves, seed: int, params: dict) -> dict[str, float]:
    """Each leaf's norm of ``params[name]`` minus its value as
    :func:`fill_weights` drew it, the start drawn again a chunk at a time."""
    with torch.no_grad():
        sq = {name: (0.0 if scale is not None
                     else float(torch.linalg.vector_norm(params[name], dtype=torch.float64)) ** 2)
              for name, _, scale in leaves}
        device = next(iter(params.values())).device
        for name, start, values in weight_pieces(leaves, seed, device):
            now = params[name].view(-1)[start:start + values.numel()]
            sq[name] += float(torch.linalg.vector_norm(now - values, dtype=torch.float64)) ** 2
    return {k: v ** 0.5 for k, v in sq.items()}
