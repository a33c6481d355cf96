"""DEPRECATED: ``DynamicEngine`` is a thin shim over ``repro_torch.api``
(port of ``repro.serving.dynamic_engine``).

The session API absorbs the fused update->query epoch path:
``epoch_step`` (``repro_torch.core.epoch``, re-exported here for legacy
importers) applies an update batch and serves a query batch on the
just-written mirrors, and the epoch loop (batch cutting, overflow requeue,
auto-regrow) lives in ``repro_torch.api.session``; ``SimRankSession.epoch``
is the one entrypoint.  This module remains so existing callers keep
working; it delegates to an owned session and returns what the session
returns under the same seed.  ``use_kernel`` defaults to True, as every
entry point of the port does (the reference's shim defaults to False).

Migration:

    eng = DynamicEngine(g, eg, top_k=10, batch_q=4, update_batch=64)  # old
    eng.insert(s, d); eng.submit(u); ep = eng.step()

    sess = SimRankSession(GraphHandle(g=g, eg=eg),                    # new
                          top_k=10, batch_q=4, update_batch=64)
    ep = sess.epoch(inserts=(s, d), queries=[u])
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass

from repro_torch.api.handle import GraphHandle
from repro_torch.api.session import EpochResult, SimRankSession
from repro_torch.core.epoch import epoch_step  # re-exported for legacy importers
from repro_torch.graph.structs import EllGraph, Graph

__all__ = ["DynamicEngine", "DynamicStats", "EpochResult", "epoch_step"]


@dataclass
class DynamicStats:
    """Legacy stats view (superseded by ``repro_torch.api.EngineStats``)."""

    epochs: int = 0
    queries: int = 0
    updates_applied: int = 0
    regrows: int = 0


class DynamicEngine:
    """Deprecated shim — use :class:`repro_torch.api.SimRankSession.epoch`.

    Same constructor and methods as the legacy engine; every call delegates
    to a session constructed over ``GraphHandle(g=g, eg=eg)`` (own-copied;
    the epoch step writes the session's mirrors in place, the caller's
    tensors stay valid).
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
        update_batch: int = 64,
        auto_regrow: bool = True,
        use_kernel: bool = True,
    ):
        warnings.warn(
            "DynamicEngine is deprecated; use repro_torch.api.SimRankSession.epoch "
            "over a GraphHandle (see docs/api.md)",
            DeprecationWarning,
            stacklevel=2,
        )
        if top_k < 1:
            # legacy contract: this engine always built top-k results
            raise ValueError("DynamicEngine requires top_k >= 1")
        self._session = SimRankSession(
            GraphHandle(g=g, eg=eg),
            c=c, eps_a=eps_a, delta=delta, walk_chunk=walk_chunk,
            top_k=top_k, seed=seed, batch_q=batch_q,
            update_batch=update_batch, auto_regrow=auto_regrow,
            use_kernel=use_kernel,
        )
        self._stats = DynamicStats()  # ONE live object (legacy contract)

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
        # own-copy + validate: epoch_step writes the session's mirrors in
        # place, so they must never be shared with the caller (legacy contract: the
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

    # legacy engines exposed these as plain mutable attributes
    @property
    def update_batch(self) -> int:
        return self._session.update_batch

    @update_batch.setter
    def update_batch(self, value: int) -> None:
        self._session.update_batch = int(value)

    @property
    def batch_q(self) -> int:
        return self._session.batch_q

    @batch_q.setter
    def batch_q(self, value: int) -> None:
        self._session.batch_q = int(value)

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
    def auto_regrow(self) -> bool:
        return self._session.auto_regrow

    @auto_regrow.setter
    def auto_regrow(self, value: bool) -> None:
        self._session.auto_regrow = bool(value)

    @property
    def use_kernel(self) -> bool:
        return self._session.use_kernel

    @use_kernel.setter
    def use_kernel(self, value: bool) -> None:
        self._session.use_kernel = bool(value)

    def _refresh_stats(self) -> None:
        s = self._session.stats
        self._stats.epochs = s.epochs
        self._stats.queries = s.queries
        self._stats.updates_applied = s.updates
        self._stats.regrows = s.regrows

    @property
    def stats(self) -> DynamicStats:
        # one persistent object, refreshed from the session counters — a
        # reference held across step()/drain() stays current, as with the
        # pre-session engine's mutable stats field
        self._refresh_stats()
        return self._stats

    @property
    def version(self) -> int:
        return self._session.version

    @property
    def overflow(self) -> bool:
        return self._session.overflow

    @property
    def pending(self) -> tuple[int, int]:
        """(queued updates, queued queries)."""
        return self._session.pending

    # -- enqueue -------------------------------------------------------------

    def insert(self, src, dst) -> None:
        """Enqueue edge insertions (applied by the next epoch step(s))."""
        self._session.queue_update(src, dst, insert=True)

    def delete(self, src, dst) -> None:
        """Enqueue edge deletions."""
        self._session.queue_update(src, dst, insert=False)

    def submit(self, node: int) -> None:
        """Enqueue a top-k query (PRNG stream fixed NOW: batch-invariant)."""
        self._session.submit(int(node))

    # -- the epoch loop ------------------------------------------------------

    def step(self, *, budget_walks: int | None = None) -> EpochResult:
        """Run ONE fused update->query epoch (see ``SimRankSession.epoch``)."""
        ep = self._session.epoch(budget_walks=budget_walks)
        self._refresh_stats()
        return ep

    def drain(self, *, budget_walks: int | None = None) -> list[EpochResult]:
        """Run epochs until both queues are empty."""
        out = self._session.drain_epochs(budget_walks=budget_walks)
        self._refresh_stats()
        return out
