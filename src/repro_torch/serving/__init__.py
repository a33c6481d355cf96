"""repro_torch.serving — the network serving subsystem (+ deprecated
engines), port of ``repro.serving``.

The serving stack is three layers, thin to thick:

* ``serving.protocol`` — the JSON wire schema (requests, responses,
  :class:`ProtocolError`); stdlib + numpy only, importable by clients.
* ``serving.service`` — :class:`SimRankService`: micro-batching window,
  admission control/backpressure, per-tenant sessions over shared graph
  state, serialized updates.  All policy, no sockets.
* ``serving.server`` — the threaded HTTP front end
  (:func:`start_server` / :class:`SimRankHTTPServer`) and the matching
  keep-alive :class:`ServiceClient`.

``serving.straggler`` (deadline/hedge/shed dispatch policies) remains the
canonical home for tail-latency mitigation around any query callable —
callers that track re-dispatches against a session report them through
``SimRankSession.record_retry()``.

``SimRankEngine`` and ``DynamicEngine`` are deprecated shims over
``repro_torch.api.SimRankSession``; new code should use the session
directly.
"""
from repro_torch.serving.dynamic_engine import (
    DynamicEngine,
    DynamicStats,
    EpochResult,
)
from repro_torch.serving.engine import EngineStats, QueryResult, SimRankEngine
from repro_torch.serving.protocol import (
    ProtocolError,
    QueryRequest,
    envelope_to_wire,
    parse_query_request,
    parse_update_request,
    update_report_to_wire,
)
from repro_torch.serving.server import (
    ServiceClient,
    SimRankHTTPServer,
    start_server,
    stop_server,
)
from repro_torch.serving.service import (
    AdmissionError,
    ServiceClosed,
    ServiceConfig,
    ServiceStats,
    SimRankService,
)

__all__ = [
    "SimRankEngine",
    "DynamicEngine",
    "QueryResult",
    "EpochResult",
    "EngineStats",
    "DynamicStats",
    "ProtocolError",
    "QueryRequest",
    "parse_query_request",
    "parse_update_request",
    "envelope_to_wire",
    "update_report_to_wire",
    "SimRankService",
    "ServiceConfig",
    "ServiceStats",
    "AdmissionError",
    "ServiceClosed",
    "SimRankHTTPServer",
    "ServiceClient",
    "start_server",
    "stop_server",
]
