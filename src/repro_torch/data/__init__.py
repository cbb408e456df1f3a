"""HTAP data substrate: row-major record store + ephemeral-projection batches
(the port of ``repro.data``)."""

from .pipeline import RecordStore, TrainPipeline, record_schema, synthetic_corpus

__all__ = ["RecordStore", "TrainPipeline", "record_schema", "synthetic_corpus"]
