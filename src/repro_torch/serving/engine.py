"""DEPRECATED: ``SimRankEngine`` is a thin shim over ``repro_torch.api``
(port of ``repro.serving.engine``).

The session API (``GraphHandle`` + ``QuerySpec`` -> ``SimRankSession``)
unifies this engine, the dynamic epoch engine and the five legacy query
signatures behind one surface — see docs/api.md.  This module remains so
existing callers keep working; it delegates every operation to an owned
``SimRankSession`` and returns what the session returns under the same
seed (``tests/test_torch_service.py``).

Migration:

    eng = SimRankEngine(g, eg, top_k=10, batch_q=8)      # old
    sess = SimRankSession(GraphHandle(g=g, eg=eg),       # new
                          top_k=10, batch_q=8)
    sess.submit(u); sess.drain(budget_walks=512)
"""
from __future__ import annotations

import warnings

import numpy as np

from repro_torch.api.handle import GraphHandle
from repro_torch.api.session import EngineStats, SimRankSession
from repro_torch.api.spec import QuerySpec, ResultEnvelope
from repro_torch.graph.structs import EllGraph, Graph

def QueryResult(
    node=None,
    topk_nodes=None,
    topk_scores=None,
    walks_used=0,
    latency_s=0.0,
    version=-1,
    **kwargs,
) -> ResultEnvelope:
    """Legacy constructor shim: the OLD positional field order, returning a
    ``ResultEnvelope`` (its field-superset).  Kept as a function rather than
    an alias so pre-session positional construction keeps binding the right
    fields; isinstance checks should use ``ResultEnvelope``.
    """
    return ResultEnvelope(
        kind="topk", node=node, topk_nodes=topk_nodes,
        topk_scores=topk_scores, walks_used=walks_used,
        latency_s=latency_s, version=version, **kwargs,
    )


__all__ = ["SimRankEngine", "QueryResult", "EngineStats"]


class SimRankEngine:
    """Deprecated shim — use :class:`repro_torch.api.SimRankSession`.

    Same constructor and methods as the legacy engine; every call delegates
    to a session constructed over ``GraphHandle(g=g, eg=eg)`` (own-copied;
    the caller's arrays stay valid).  ``auto_regrow=False`` preserves the
    legacy behavior of surfacing capacity overflow via the sticky
    ``overflow`` flag instead of regrowing.
    """

    def __init__(
        self,
        g: Graph,
        eg: EllGraph,
        *,
        c: float = 0.6,
        eps_a: float = 0.1,
        delta: float = 0.01,
        walk_chunk: int = 256,
        top_k: int = 50,
        seed: int = 0,
        batch_q: int = 8,
    ):
        warnings.warn(
            "SimRankEngine is deprecated; use repro_torch.api.SimRankSession over "
            "a GraphHandle (see docs/api.md)",
            DeprecationWarning,
            stacklevel=2,
        )
        self._session = SimRankSession(
            GraphHandle(g=g, eg=eg),
            c=c, eps_a=eps_a, delta=delta, walk_chunk=walk_chunk,
            top_k=top_k, seed=seed, batch_q=batch_q, auto_regrow=False,
        )

    # -- delegated state -----------------------------------------------------

    @property
    def session(self) -> SimRankSession:
        """The underlying session (migration escape hatch)."""
        return self._session

    @property
    def g(self) -> Graph:
        return self._session.handle.g

    @g.setter
    def g(self, value: Graph) -> None:
        # own-copy + validate: the session writes its mirrors in place, so
        # it must never share tensors with the caller (legacy contract: the
        # caller's arrays stay valid)
        self._session.handle.set_mirrors(g=value)

    @property
    def eg(self) -> EllGraph:
        return self._session.handle.eg

    @eg.setter
    def eg(self, value: EllGraph) -> None:
        self._session.handle.set_mirrors(eg=value)

    @property
    def params(self):
        return self._session.params

    @property
    def stats(self) -> EngineStats:
        return self._session.stats

    # legacy engines exposed these as plain mutable attributes
    @property
    def walk_chunk(self) -> int:
        return self._session.walk_chunk

    @walk_chunk.setter
    def walk_chunk(self, value: int) -> None:
        self._session.walk_chunk = int(value)

    @property
    def top_k(self) -> int:
        return self._session.top_k

    @top_k.setter
    def top_k(self, value: int) -> None:
        self._session.top_k = int(value)

    @property
    def batch_q(self) -> int:
        return self._session.batch_q

    @batch_q.setter
    def batch_q(self, value: int) -> None:
        self._session.batch_q = int(value)

    @property
    def version(self) -> int:
        return self._session.version

    @property
    def overflow(self) -> bool:
        return self._session.overflow

    # -- updates -------------------------------------------------------------

    def insert(self, src: np.ndarray, dst: np.ndarray) -> None:
        """Insert edges into BOTH mirrors atomically (skip-on-overflow)."""
        self._session.update(inserts=(src, dst))

    def delete(self, src: np.ndarray, dst: np.ndarray) -> None:
        """Delete edges from BOTH mirrors atomically (absent edges: no-op)."""
        self._session.update(deletes=(src, dst))

    # -- queries -------------------------------------------------------------

    def submit(self, node: int) -> None:
        self._session.submit(int(node))

    def run_query(self, u: int, *, budget_walks: int | None = None) -> QueryResult:
        """Serve one query now (Q = 1 fused step), bypassing the queue."""
        sess = self._session
        spec = QuerySpec(kind="topk", node=int(u), k=sess.top_k,
                         variant="telescoped")
        res = sess._serve_fused([(spec, sess._query_seed())], budget_walks)[0]
        sess.stats.queries += 1
        return res

    def drain(self, *, budget_walks: int | None = None) -> list[QueryResult]:
        """Serve every queued query in fused batches of ``batch_q``."""
        return self._session.drain(budget_walks=budget_walks)
