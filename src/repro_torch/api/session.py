"""`SimRankSession` — the query surface over a live graph (port of
``repro.api.session``, local backend).

    h = GraphHandle.from_edges(src, dst, n, device="cuda")
    sess = SimRankSession(h, eps_a=0.1, top_k=10, batch_q=8)

    env = sess.query(QuerySpec(kind="topk", node=u))     # one-shot
    for u in nodes:
        sess.submit(u)                                   # queued ...
    results = sess.drain(budget_walks=512)               # ... fused batches

* ``query(spec)`` — one-shot, delegates to ``single_source``/``topk``/
  ``multi_source*``, so a spec with an explicit ``key`` (an int seed)
  reproduces those calls under that seed;
* ``submit``/``drain`` — the serving path: each query's seed is fixed at
  submit time, and fixed-size repeat-padded batches go through the fused
  multi-query step; ``submit`` returns a :class:`QueryTicket`.

The §4.4 switch lives in :meth:`plan`: ``variant='auto'`` takes the
prefix-tree probe when a single query's walk pool must share first-step
prefixes heavily (n_r >= 8 x in-degree(u)), the fused telescoped path
otherwise; batched specs always take the fused path.

Every result is a ``ResultEnvelope`` carrying the graph ``version`` it was
computed against, the walk budget spent and the Thm-1/2 error bound at
that budget.  Randomness: query ``seq`` of a session seeded ``seed`` draws
from ``derive_seed(seed, seq)``, so batch composition never changes an
answer.

Not ported yet: adaptive specs (``epsilon``; ROADMAP queue 1 item 9),
``update``/``queue_update``/``epoch``/``drain_epochs``/``regrow`` (item 8)
and ``backend="sharded"`` (item 12); each raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.api.backend import Backend, LocalBackend
from repro_torch.api.handle import GraphHandle
from repro_torch.api.spec import QuerySpec, ResultEnvelope, as_spec
from repro_torch.core.params import abs_error_bound, make_params
from repro_torch.core.walks import derive_seed


@dataclass
class EngineStats:
    """Dispatch counters: ``queries`` answered, fused serve ``steps``,
    dispatch-layer ``retries``; the update/epoch counters stay 0 until
    those paths are ported."""

    queries: int = 0
    updates: int = 0
    steps: int = 0
    retries: int = 0
    epochs: int = 0
    regrows: int = 0
    escalations: int = 0
    hub_hits: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclass
class QueryTicket:
    """Async handle for one submitted query.

    ``poll()`` is the non-blocking check (None while pending); ``result()``
    drains queued batches, in submission order, until this ticket is
    answered.
    """

    spec: QuerySpec
    seq: int  # session submission sequence number (the seed's stream id)
    _session: "SimRankSession" = field(repr=False, default=None)
    envelope: ResultEnvelope | None = field(default=None, repr=False)

    @property
    def done(self) -> bool:
        return self.envelope is not None

    def poll(self) -> ResultEnvelope | None:
        return self.envelope

    def result(self, *, budget_walks: int | None = None) -> ResultEnvelope:
        """Block until served: runs queued batches up to this ticket."""
        if self.envelope is None:
            self._session._drain_until(self, budget_walks=budget_walks)
        return self.envelope


def _not_ported(what: str, item: int):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP queue 1 item {item})"
    )


class SimRankSession:
    """SimRank serving session over a local :class:`Backend`.

    ``walk_chunk`` is the total lane-column width of the fused serve step;
    ``batch_q`` the fixed query width of ``drain()`` batches (short batches
    are repeat-padded); ``top_k`` the default k.  ``use_kernel`` (default
    True) runs every probe level through the lane-probe kernel on a CUDA
    handle; ``kernel_dtype`` picks its storage type.  The session copies its
    handle (``own_graph=True``).  One re-entrant lock serializes queue
    mutation, seed assignment and ticket fills.
    """

    def __init__(
        self,
        handle: GraphHandle | Backend,
        *,
        c: float = 0.6,
        eps_a: float = 0.1,
        delta: float = 0.01,
        walk_chunk: int = 256,
        top_k: int = 50,
        seed: int = 0,
        batch_q: int = 8,
        use_kernel: bool = True,
        kernel_dtype: str = "float32",
        own_graph: bool = True,
        backend: str | Backend = "local",
    ):
        if isinstance(handle, GraphHandle):
            if backend == "sharded":
                _not_ported("backend='sharded'", 12)
            if backend != "local":
                raise ValueError(
                    f"backend must be 'local' or a Backend instance, "
                    f"got {backend!r}"
                )
            self.handle = handle.copy() if own_graph else handle
            self.params = make_params(handle.n, c=c, eps_a=eps_a, delta=delta)
            self.backend: Backend = LocalBackend(
                self.handle, params=self.params, walk_chunk=walk_chunk,
                use_kernel=use_kernel, kernel_dtype=kernel_dtype,
            )
        elif isinstance(handle, Backend):
            self.backend = handle
            self.handle = getattr(handle, "handle", None)
            self.params = getattr(handle, "params", None) or make_params(
                handle.n, c=c, eps_a=eps_a, delta=delta
            )
        else:
            raise TypeError(
                "SimRankSession takes a GraphHandle — build one with "
                "GraphHandle.from_edges(src, dst, n, device=...)"
            )
        self._plan_deg: tuple[int, np.ndarray] | None = None
        self.walk_chunk = walk_chunk
        self.top_k = top_k
        self.batch_q = batch_q
        self.use_kernel = use_kernel
        self.seed = int(seed)
        self.query_queue: deque[tuple[QuerySpec, int, QueryTicket]] = deque()
        self.stats = EngineStats()
        self._seq = 0  # submission counter -> per-query seed stream
        self._lock = threading.RLock()

    # -- snapshot state ------------------------------------------------------

    @property
    def version(self) -> int:
        return self.backend.version

    @property
    def overflow(self) -> bool:
        return self.backend.overflow

    @property
    def pending(self) -> tuple[int, int]:
        """(queued update ops, queued queries)."""
        return 0, len(self.query_queue)

    def error_bound(self, n_r: int | None = None) -> float:
        """Thm 1+2 absolute-error bound at the effective walk count."""
        return abs_error_bound(self.params, n=self.backend.n, n_r=n_r)

    def record_retry(self, n: int = 1) -> None:
        """Public hook for dispatch-layer retries (straggler policies)."""
        if n < 0:
            raise ValueError(f"retry count must be >= 0, got {n}")
        self.stats.retries += n

    # -- seeds ---------------------------------------------------------------

    def _query_seed(self) -> int:
        with self._lock:
            s = derive_seed(self.seed, self._seq)
            self._seq += 1
            return s

    # -- planner -------------------------------------------------------------

    def plan(self, spec: QuerySpec) -> str:
        """Resolve ``variant='auto'`` — the §4.4 best-of-both-worlds switch."""
        if spec.variant != "auto":
            if spec.variant not in self.backend.variants:
                if spec.variant == "randomized":
                    _not_ported("variant='randomized'", 10)
                raise ValueError(
                    f"variant {spec.variant!r} is not available on the "
                    f"{self.backend.name!r} backend "
                    f"(supports {self.backend.variants})"
                )
            return spec.variant
        if spec.nodes is not None or "tree" not in self.backend.variants:
            return "telescoped"
        n_r = spec.budget_walks or self.params.n_r
        if self._plan_deg is None or self._plan_deg[0] != self.version:
            self._plan_deg = (self.version, self.backend.host_in_degrees())
        d = int(self._plan_deg[1][spec.node])
        if d > 0 and n_r >= 8 * d:
            return "tree"
        return "telescoped"

    # -- one-shot queries ----------------------------------------------------

    def query(
        self,
        spec: QuerySpec | int,
        *,
        budget_walks: int | None = None,
        deadline_s: float | None = None,
    ) -> ResultEnvelope:
        """Serve one spec now, bypassing the queue."""
        spec = as_spec(spec, default_k=self.top_k)
        if budget_walks is not None and spec.budget_walks is None:
            spec = dataclasses.replace(spec, budget_walks=budget_walks)
        if spec.epsilon is not None or deadline_s is not None:
            _not_ported("adaptive accuracy (epsilon / deadline_s)", 9)
        with self._lock:
            return self._query_flat(spec)

    def _query_flat(self, spec: QuerySpec) -> ResultEnvelope:
        variant = self.plan(spec)
        n_r = spec.budget_walks or self.params.n_r
        t0 = time.time()
        if spec.nodes is None:
            seed = spec.key if spec.key is not None else self._query_seed()
            out = self.backend.serve_one(spec, int(seed), variant=variant, n_r=n_r)
        else:
            if variant != "telescoped":
                raise ValueError(
                    f"batched specs require the fused telescoped path, "
                    f"got variant={variant!r}"
                )
            seed, seeds = self._multi_seeds(spec)
            est, idx, vals = self.backend.serve_batch(
                spec.kind, spec.nodes, seeds, seed=seed, k=spec.k or 0, n_r=n_r
            )
            out = (
                dict(scores=est)
                if spec.kind == "single_source"
                else dict(topk_nodes=idx, topk_scores=vals)
            )
        dt = time.time() - t0
        self.stats.steps += 1
        self.stats.queries += spec.q
        return ResultEnvelope(
            kind=spec.kind,
            node=spec.node,
            nodes=spec.nodes,
            walks_used=n_r,
            latency_s=dt,
            version=self.version,
            error_bound=self.error_bound(n_r),
            variant=self.backend.dispatch_label(variant),
            **out,
        )

    def _multi_seeds(self, spec: QuerySpec):
        """(seed, seeds) for a batched spec — exactly one of the two is set."""
        q = spec.q
        if spec.key is None:
            return None, [self._query_seed() for _ in range(q)]
        if np.ndim(spec.key) == 1:
            seeds = [int(s) for s in spec.key]
            if len(seeds) != q:
                raise ValueError(
                    f"per-query seeds have {len(seeds)} streams for {q} nodes"
                )
            return None, seeds
        return int(spec.key), None  # scalar seed: split into Q streams

    # -- queued serving (submit -> fused drain) ------------------------------

    def submit(self, spec: QuerySpec | int) -> QueryTicket:
        """Enqueue a single-node spec (seed fixed NOW: batch-invariant)."""
        spec = as_spec(spec, default_k=self.top_k)
        if spec.nodes is not None:
            raise ValueError("submit takes single-node specs; use query() "
                             "for an explicit batch")
        if spec.variant not in ("auto", "telescoped"):
            raise ValueError(
                "queued serving uses the fused telescoped path; "
                f"variant={spec.variant!r} is only available via query()"
            )
        if spec.epsilon is not None:
            _not_ported("adaptive accuracy (epsilon)", 9)
        with self._lock:
            if spec.key is not None:
                seed, seq = int(spec.key), -1  # caller-pinned stream
            else:
                seq = self._seq
                seed = self._query_seed()
            ticket = QueryTicket(spec=spec, seq=seq, _session=self)
            self.query_queue.append((spec, seed, ticket))
            return ticket

    def _batch_group(self, spec: QuerySpec):
        """Specs that can share one fused dispatch (same shapes/budget)."""
        return (spec.kind, spec.k, spec.budget_walks)

    def _pop_query_batch(self) -> tuple[list[tuple], int]:
        """Pop up to ``batch_q`` group-compatible specs; repeat-pad the rest."""
        gid = self._batch_group(self.query_queue[0][0])
        batch: list[tuple] = []
        while (
            self.query_queue
            and len(batch) < self.batch_q
            and self._batch_group(self.query_queue[0][0]) == gid
        ):
            batch.append(self.query_queue.popleft())
        live = len(batch)
        while len(batch) < self.batch_q:
            batch.append(batch[-1])  # pad with repeats: fixed batch width
        return batch, live

    def _serve_fused(
        self, batch: list[tuple], budget_walks: int | None
    ) -> list[ResultEnvelope]:
        """One fused dispatch for a (possibly repeat-padded) query batch."""
        spec0 = batch[0][0]
        n_r = spec0.budget_walks or budget_walks or self.params.n_r
        us = [item[0].node for item in batch]
        seeds = [item[1] for item in batch]
        t0 = time.time()
        est, idx, vals = self.backend.serve_batch(
            spec0.kind, us, seeds, k=spec0.k or 0, n_r=n_r
        )
        dt = time.time() - t0
        self.stats.steps += 1
        ver = self.version
        bound = self.error_bound(n_r)
        return [
            ResultEnvelope(
                kind=spec0.kind,
                node=item[0].node,
                scores=None if est is None else est[i],
                topk_nodes=None if est is not None else idx[i],
                topk_scores=None if est is not None else vals[i],
                walks_used=n_r,
                latency_s=dt,
                version=ver,
                error_bound=bound,
                variant=self.backend.dispatch_label("telescoped"),
            )
            for i, item in enumerate(batch)
        ]

    def _serve_next_batch(self, budget_walks: int | None) -> list[ResultEnvelope]:
        """Pop + serve ONE fused batch; fills tickets for the live slice."""
        with self._lock:
            if not self.query_queue:
                return []
            batch, live = self._pop_query_batch()
            served = self._serve_fused(batch, budget_walks)[:live]
            for item, env in zip(batch[:live], served):
                item[2].envelope = env
            self.stats.queries += live
            return served

    def drain(self, *, budget_walks: int | None = None) -> list[ResultEnvelope]:
        """Serve every queued spec in fused batches of ``batch_q``."""
        with self._lock:
            out: list[ResultEnvelope] = []
            while self.query_queue:
                out.extend(self._serve_next_batch(budget_walks))
            return out

    def _drain_until(
        self, ticket: QueryTicket, *, budget_walks: int | None = None
    ) -> None:
        """Serve queued batches (submission order) until ``ticket`` is done."""
        with self._lock:
            while ticket.envelope is None and self.query_queue:
                self._serve_next_batch(budget_walks)
            if ticket.envelope is None:
                raise RuntimeError("ticket is not queued in this session")

    # -- not ported yet ------------------------------------------------------

    def update(self, inserts=None, deletes=None):
        _not_ported("update", 8)

    def queue_update(self, src, dst, *, insert: bool = True):
        _not_ported("queue_update", 8)

    def epoch(self, *args, **kwargs):
        _not_ported("epoch", 8)

    def drain_epochs(self, *args, **kwargs):
        _not_ported("drain_epochs", 8)

    def regrow(self, **kwargs):
        _not_ported("regrow", 8)
