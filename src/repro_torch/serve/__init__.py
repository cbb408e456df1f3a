"""Serving substrate of the port: the relational ``QueryServer`` and the LM
side's ``ServeSession`` (continuous-batching prefill and decode).
"""

from .engine import Request, ServeSession, make_decode_step, make_prefill
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
    "Request",
    "ServeSession",
    "ServerOverloaded",
    "ServerStats",
    "StreamingTicket",
    "make_decode_step",
    "make_prefill",
]
