"""Serving substrate of the port: the relational ``QueryServer``.

The LM side of the reference's ``repro.serve`` (``ServeSession`` and the
prefill/decode steps) waits for the port of the LM stack.
"""

from .query_server import (
    DeadlineExceeded,
    LaneStats,
    LatencyReservoir,
    PoisonedPlanError,
    QueryServer,
    QueryTicket,
    ServerOverloaded,
    ServerStats,
    StreamingTicket,
)

__all__ = [
    "DeadlineExceeded",
    "LaneStats",
    "LatencyReservoir",
    "PoisonedPlanError",
    "QueryServer",
    "QueryTicket",
    "ServerOverloaded",
    "ServerStats",
    "StreamingTicket",
]
