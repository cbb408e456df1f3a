"""Training data as Relational Memory — the port of ``repro.data.pipeline``.

Sample records are ingested **row-major** into an MVCC row store (OLTP side:
appends are one row write; relabeling/filtering are in-place updates).  The
training loop consumes **ephemeral projections** of exactly the fields it
needs (OLAP side): ``(tokens, labels)`` for training, ``tokens`` for eval,
``+ weight`` for weighted runs.  No columnar copy of the corpus is ever
materialized, and any ingest during training silently invalidates hot views
through the engine's epoch/version machinery.

Record layout (one row per sample):
    doc_id   int32     source document
    split    int32     0=train 1=eval
    weight   float32   per-sample loss weight
    tokens   char[4S]  S int32 token ids
    labels   char[4S]  S int32 label ids
    (+ hidden MVCC ts_begin/ts_end)

The engine is the port's :class:`~repro_torch.core.RelationalMemoryEngine`
on the store's device (the card unless ``device="cpu"``), so on the card
every batch's view is packed by the projection kernel.  A batch's rows are
gathered from the packed view on the device; nothing of the view is copied
to the host, and the batch's tensors stay on the device.  The calls on the
engine are the reference's, so its ``EngineStats`` count the same.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.core import Column, RelationalMemoryEngine, RelationalTable, TableSchema
from repro_torch.tracing import span


def record_schema(seq_len: int) -> TableSchema:
    return TableSchema.of(
        Column("doc_id", "int32"),
        Column("split", "int32"),
        Column("weight", "float32"),
        Column("tokens", "char", 4 * seq_len),
        Column("labels", "char", 4 * seq_len),
    )


def _pack_ids(ids: np.ndarray, seq_len: int) -> np.ndarray:
    """(n, S) int32 -> (n,) byte-string column values."""
    ids = np.ascontiguousarray(ids.astype(np.int32))
    return ids.view(np.uint8).reshape(ids.shape[0], 4 * seq_len).view(
        np.dtype((np.bytes_, 4 * seq_len))
    ).reshape(-1)


class RecordStore:
    """Row-major sample store with OLTP ingest and RME-projected reads."""

    def __init__(self, seq_len: int, engine: RelationalMemoryEngine | None = None,
                 capacity: int = 1024, device=None):
        self.seq_len = seq_len
        self.schema = record_schema(seq_len)
        self.table = RelationalTable(self.schema, capacity=capacity)
        self.engine = engine or RelationalMemoryEngine(device=device)

    # ------------------------------------------------------------------ OLTP
    def ingest(
        self,
        tokens: np.ndarray,  # (n, S) int32
        labels: np.ndarray,  # (n, S) int32
        doc_ids: np.ndarray | None = None,
        split: int = 0,
        weights: np.ndarray | None = None,
    ) -> np.ndarray:
        n, s = tokens.shape
        if s != self.seq_len:
            raise ValueError(f"sample length {s} != store seq_len {self.seq_len}")
        return self.table.append({
            "doc_id": (doc_ids if doc_ids is not None
                       else np.arange(n)).astype(np.int32),
            "split": np.full(n, split, np.int32),
            "weight": (weights if weights is not None
                       else np.ones(n)).astype(np.float32),
            "tokens": _pack_ids(tokens, self.seq_len),
            "labels": _pack_ids(labels, self.seq_len),
        })

    def reweight(self, rows: np.ndarray, weights: np.ndarray) -> np.ndarray:
        """In-place OLTP update (MVCC: old versions end, new rows appended)."""
        return self.table.update(rows, {"weight": weights.astype(np.float32)})

    # ------------------------------------------------------------------ OLAP
    def _ids_matrix(self, view, name: str, rows: torch.Tensor) -> torch.Tensor:
        """``name``'s words of ``rows`` (a device index tensor), gathered from
        the packed view on its device."""
        off, w = view.column_words(name)
        return view.packed().index_select(0, rows)[:, off : off + w]

    def project(self, columns: tuple[str, ...], snapshot_ts: int | None = None):
        """Register an ephemeral column-group view (never materialized)."""
        return self.engine.register(self.table, columns, snapshot_ts)

    @property
    def n_rows(self) -> int:
        return int(self.table.snapshot_mask().sum())


@dataclasses.dataclass
class TrainPipeline:
    """Deterministic, restart-reproducible batch iterator over a RecordStore.

    The shuffle is a fixed permutation of the snapshot's live rows seeded by
    (seed, epoch): a restarted trainer that seeks to step N reproduces the
    exact batch stream (fault-tolerance requirement), independent of how many
    ingests happened after the snapshot was taken.  A batch is ``{"tokens",
    "labels"}`` (``(B, S)`` int32; ``+ "weights"`` float32) on the store's
    device.
    """

    store: RecordStore
    batch_size: int
    seed: int = 0
    drop_remainder: bool = True
    with_weights: bool = False
    snapshot_ts: int | None = None  # pinned at first use; checkpointable

    def batches(self, start_step: int = 0) -> Iterator[dict]:
        cols = ("tokens", "labels") + (("weight",) if self.with_weights else ())
        if self.snapshot_ts is None:
            # pin the MVCC snapshot on first use: every iterator from this
            # pipeline (including post-restart seeks) sees the same rows, no
            # matter how much OLTP ingest happens meanwhile
            self.snapshot_ts = self.store.table.now()
        view = self.store.project(cols, self.snapshot_ts)
        live = torch.nonzero(view.valid_mask())[:, 0]
        n = live.shape[0]
        if n < self.batch_size and self.drop_remainder:
            raise ValueError(f"{n} rows < batch size {self.batch_size}")
        per_epoch = n // self.batch_size
        step = start_step
        while True:
            with span("rm::data.batch"):
                batch = self._batch(view, live, step, per_epoch)
            yield batch
            step += 1

    def _batch(self, view, live: torch.Tensor, step: int, per_epoch: int) -> dict:
        """Step ``step``'s batch: its rows of the epoch's permutation of the
        ``live`` rows, gathered from the packed ``view``."""
        epoch = step // max(per_epoch, 1)
        rng = np.random.default_rng((self.seed, epoch))
        perm = rng.permutation(live.shape[0])
        i = step % max(per_epoch, 1)
        pick = torch.from_numpy(perm[i * self.batch_size : (i + 1) * self.batch_size])
        rows = live[pick.to(live.device)]
        tok = self.store._ids_matrix(view, "tokens", rows)
        lab = self.store._ids_matrix(view, "labels", rows)
        batch = {"tokens": tok, "labels": lab}
        if self.with_weights:
            off, _ = view.column_words("weight")
            batch["weights"] = view.packed().index_select(0, rows)[:, off].view(torch.float32)
        return batch


def synthetic_corpus(
    n_samples: int, seq_len: int, vocab: int, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Markov-ish synthetic token stream (shifted labels), reproducible."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, (n_samples, seq_len + 1), dtype=np.int64)
    # add local structure so the loss actually decreases during examples
    base[:, 1:] = (base[:, 1:] + base[:, :-1]) % vocab
    tokens = base[:, :-1].astype(np.int32)
    labels = base[:, 1:].astype(np.int32)
    return tokens, labels
