"""Temporal graph-stream subsystem (DESIGN.md §9), port of
``repro.streams``.

Turns the update/epoch/serving machinery into a clock-driven streaming
system: timestamped edge arrivals (:mod:`repro_torch.streams.events`), a
TTL sliding window whose expiries stay bit-identical to a from-scratch
rebuild of the live window, a replay driver with freshness-SLO staleness
accounting (:mod:`repro_torch.streams.driver`), and pooled effectiveness
checkpoints under churn (:mod:`repro_torch.streams.churn`).
"""
from repro_torch.streams.churn import churn_checkpoint, frozen_window_handle
from repro_torch.streams.driver import (
    FreshnessSLO,
    ServiceTransport,
    SessionTransport,
    StreamCheckpoint,
    StreamDriver,
    StreamReport,
)
from repro_torch.streams.events import (
    EdgeEvent,
    EventStream,
    SlidingWindowExpirer,
    bursty_edge_stream,
    poisson_edge_stream,
    preferential_attachment_stream,
)

__all__ = [
    "EdgeEvent",
    "EventStream",
    "FreshnessSLO",
    "ServiceTransport",
    "SessionTransport",
    "SlidingWindowExpirer",
    "StreamCheckpoint",
    "StreamDriver",
    "StreamReport",
    "bursty_edge_stream",
    "churn_checkpoint",
    "frozen_window_handle",
    "poisson_edge_stream",
    "preferential_attachment_stream",
]
