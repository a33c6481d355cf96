"""repro_torch.api — the session surface over the live graph.

``GraphHandle`` owns the COO + ELL mirror pair (construction, updates,
regrow, snapshot metadata); ``QuerySpec`` / ``ResultEnvelope`` are the
typed request/response pair; ``SimRankSession`` serves one-shot queries,
queued fused batches (``submit`` -> ``QueryTicket``; ``drain``), immediate
updates (``update`` -> ``UpdateReport``) and fused update->query epochs
(``epoch`` -> ``EpochResult``) through ``LocalBackend`` or, over
destination row blocks on a ``ShardMesh``, ``ShardedBackend``; a spec with
``epsilon`` set escalates its walks until a certificate meets it.
"""
from repro_torch.api.backend import (
    Backend,
    LocalBackend,
    ShardedBackend,
    ShardedGraphState,
)
from repro_torch.api.handle import GraphHandle
from repro_torch.api.session import (
    EngineStats,
    EpochResult,
    QueryTicket,
    SimRankSession,
    UpdateReport,
)
from repro_torch.api.spec import QuerySpec, ResultEnvelope, as_spec
from repro_torch.core.params import abs_error_bound

__all__ = [
    "Backend",
    "EngineStats",
    "EpochResult",
    "GraphHandle",
    "LocalBackend",
    "QuerySpec",
    "QueryTicket",
    "ResultEnvelope",
    "ShardedBackend",
    "ShardedGraphState",
    "SimRankSession",
    "UpdateReport",
    "abs_error_bound",
    "as_spec",
]
