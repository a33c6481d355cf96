"""`SimRankSession` — the query surface over a live graph (port of
``repro.api.session``).

    h = GraphHandle.from_edges(src, dst, n, device="cuda")
    sess = SimRankSession(h, eps_a=0.1, top_k=10, batch_q=8)

    env = sess.query(QuerySpec(kind="topk", node=u))     # one-shot
    for u in nodes:
        sess.submit(u)                                   # queued ...
    results = sess.drain(budget_walks=512)               # ... fused batches

    sess.update(inserts=(new_src, new_dst))              # apply NOW
    ep = sess.epoch(inserts=(s, d), queries=[u1, u2])    # fused upd->query

* ``query(spec)`` — one-shot, delegates to ``single_source``/``topk``/
  ``multi_source*``, so a spec with an explicit ``key`` (an int seed)
  reproduces those calls under that seed;
* ``submit``/``drain`` — the serving path: each query's seed is fixed at
  submit time, and fixed-size repeat-padded batches go through the fused
  multi-query step; ``submit`` returns a :class:`QueryTicket`;
* ``update``/``epoch`` — updates applied through the coordinated
  both-mirrors path (``graph/dynamic.py``); ``epoch`` applies one update
  batch and serves one query batch on the just-written mirrors
  (``core/epoch.py``), and regrows on capacity overflow (nothing is ever
  silently dropped).

A spec with ``epsilon`` set runs the adaptive accuracy controller
(``core/accuracy.py``) through ``query`` or ``submit``/``drain``: each
escalation round is one fused ``serve_batch`` of the round's walks, and the
answer carries the certificate that stopped it.

The §4.4 switch lives in :meth:`plan`: ``variant='auto'`` takes the
prefix-tree probe when a single query's walk pool must share first-step
prefixes heavily (n_r >= 8 x in-degree(u)), the fused telescoped path
otherwise; batched specs always take the fused path.

Every result is a ``ResultEnvelope`` carrying the graph ``version`` it was
computed against, the walk budget spent and the Thm-1/2 error bound at
that budget.  Randomness: query ``seq`` of a session seeded ``seed`` draws
from ``derive_seed(seed, seq)``, so batch composition never changes an
answer.

``backend="sharded"`` (with ``shards=``, ``mesh=`` a ``ShardMesh``, and
``backend_options=`` for ``ShardedBackend``) serves the same surface over
destination row blocks of the graph (``api/backend.py``).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.api.backend import Backend, LocalBackend, ShardedBackend
from repro_torch.api.handle import GraphHandle
from repro_torch.api.spec import QuerySpec, ResultEnvelope, as_spec
from repro_torch.core.accuracy import (
    AccuracyController,
    ProbeCache,
    escalation_schedule,
)
from repro_torch.core.multisource import query_seeds
from repro_torch.core.params import abs_error_bound, make_params
from repro_torch.core.walks import derive_seed
from repro_torch.graph.dynamic import UpdateBatch, make_update_batch


@dataclass
class EngineStats:
    """Dispatch counters: ``queries`` answered and edge ops applied
    (``updates``); fused serve ``steps``, fused update->query ``epochs``,
    capacity ``regrows`` and dispatch-layer ``retries``; ``escalations``
    counts accuracy-controller rounds beyond the first (extra dispatches
    adaptive queries paid), ``hub_hits`` whole serve dispatches skipped
    because every row of an escalation round was in the hub probe cache."""

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


@dataclass
class UpdateReport:
    """Outcome of one immediate ``update()`` call."""

    submitted: int = 0
    applied: int = 0
    regrows: int = 0
    # overflow-skipped inserts, as (src, dst, True) tuples: only filled
    # with auto_regrow=False (with it, skips are regrown and retried here)
    skipped: list = field(default_factory=list)
    version: int = -1
    overflow: bool = False


@dataclass
class EpochResult:
    """Outcome of one fused update->query epoch."""

    version: int  # graph snapshot id AFTER the update batch
    overflow: bool  # sticky capacity signal (pre-regrow value)
    regrown: bool  # True if auto_regrow ran after this epoch
    updates_submitted: int  # live (non-padding) ops in the batch
    updates_applied: int  # ops that changed the graph
    updates_requeued: int  # overflow-skipped inserts pushed back for retry
    # overflow-skipped inserts this epoch, as (src, dst, True) tuples.  With
    # auto_regrow they are also re-queued (updates_requeued); without, the
    # caller regrows and re-submits them: never silently lost
    skipped_ops: list[tuple[int, int, bool]] = field(default_factory=list)
    results: list[ResultEnvelope] = field(default_factory=list)
    latency_s: float = 0.0


def _occurrence_numbers(src: np.ndarray, dst: np.ndarray, n: int) -> np.ndarray:
    """occ[i] = #{j < i : (src[j], dst[j]) == (src[i], dst[i])}, vectorized:
    stable-sort the ops by pair, number each op by its offset from its pair
    group's start, scatter back to stream order."""
    pairs = src.astype(np.int64) * np.int64(n + 1) + dst.astype(np.int64)
    _, inv, counts = np.unique(pairs, return_inverse=True, return_counts=True)
    if counts.max() <= 1:
        return np.zeros(len(pairs), np.int64)
    order = np.argsort(inv, kind="stable")  # stable: stream order per group
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    occ = np.empty(len(pairs), np.int64)
    occ[order] = np.arange(len(pairs)) - np.repeat(starts, counts)
    return occ


class SimRankSession:
    """SimRank serving session over a :class:`Backend` (local or sharded).

    ``walk_chunk`` is the total lane-column width of the fused serve step;
    ``batch_q`` the fixed query width of ``drain()``/``epoch()`` batches
    (short batches are repeat-padded); ``update_batch`` the fixed op width
    of epoch update batches; ``top_k`` the default k.  ``use_kernel``
    (default True) runs every probe level through the lane-probe kernel on
    a CUDA handle; ``kernel_dtype`` picks its storage type (local backend).
    ``backend="sharded"`` builds a :class:`ShardedBackend` over ``shards``
    row blocks on ``mesh`` (default: one per visible CUDA device), with
    ``backend_options`` passed through (``probe``, ``frontier_dtype``,
    ``edge_chunks``, ``capacity_per_shard``).

    With ``auto_regrow`` (default), capacity overflow triggers a host-side
    compaction into 2x buffers and the skipped inserts are retried: no
    update is ever lost; with ``auto_regrow=False`` skips are surfaced in
    the ``UpdateReport``/``EpochResult`` for the caller to handle.

    The session OWNS its graph (``own_graph=True`` copies the handle):
    epochs write the mirrors in place.  ``own_graph=False`` shares the
    caller's handle for read-mostly use, and ``epoch()`` refuses there.  A
    ready :class:`Backend` that sets ``supports_epoch`` is asked to own-copy
    its graph (``own_buffers``) at construction.  One re-entrant lock
    serializes queue mutation, seed assignment, ticket fills and graph
    mutation.

    Adaptive specs escalate from ``initial_budget`` walks at ``confidence``
    (``core/accuracy.py``).  Queries on hub nodes (in-degree at or above
    the ``hub_percentile``-th) without a pinned ``key`` ride node-keyed
    streams, seeded ``derive_seed(seed, 0x5B5B, node)``: a longer path, so
    no submit-order seed ``derive_seed(seed, seq)`` (seq < 2^32) equals it.  Their
    per-round rows go through a probe cache of ``probe_cache_entries``
    rows, cleared on every graph version; ``regrow`` keeps the version, so
    after it a cached row scores the same graph from other walks.
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
        update_batch: int = 64,
        auto_regrow: bool = True,
        use_kernel: bool = True,
        kernel_dtype: str = "float32",
        own_graph: bool = True,
        backend: str | Backend = "local",
        shards: int | None = None,
        mesh=None,
        backend_options: dict | None = None,
        initial_budget: int = 64,
        confidence: float = 0.99,
        hub_percentile: float = 90.0,
        probe_cache_entries: int = 256,
    ):
        if isinstance(handle, (LocalBackend, ShardedBackend)) or (
            not isinstance(handle, GraphHandle) and isinstance(handle, Backend)
        ):
            if backend != "local":  # the untouched default
                raise ValueError(
                    "pass either a Backend instance or backend=..., not both"
                )
            backend, handle = handle, None
        elif not isinstance(handle, GraphHandle):
            raise TypeError(
                "SimRankSession takes a GraphHandle — build one with "
                "GraphHandle.from_edges(src, dst, n, device=...)"
            )
        elif not isinstance(backend, str):
            # a GraphHandle positional + a ready Backend instance: the
            # handle would be silently shadowed by the backend's own graph
            raise ValueError(
                "a Backend instance brings its own graph state — pass it "
                "as the first argument instead of a GraphHandle"
            )
        if isinstance(backend, str):
            if backend == "local":
                if shards is not None or mesh is not None or backend_options:
                    # a forgotten backend="sharded" must not silently
                    # build an unsharded session
                    raise ValueError(
                        "shards/mesh/backend_options only apply to "
                        "backend='sharded' — did you forget to set it?"
                    )
                self.handle = handle.copy() if own_graph else handle
                self._owns_graph = own_graph
                self.params = make_params(handle.n, c=c, eps_a=eps_a,
                                          delta=delta)
                self.backend: Backend = LocalBackend(
                    self.handle, params=self.params, walk_chunk=walk_chunk,
                    use_kernel=use_kernel, kernel_dtype=kernel_dtype,
                )
            elif backend == "sharded":
                if kernel_dtype != "float32":
                    raise ValueError(
                        "kernel_dtype applies to the local backend; the "
                        "sharded one takes backend_options=dict("
                        "frontier_dtype=...)"
                    )
                self.params = make_params(handle.n, c=c, eps_a=eps_a,
                                          delta=delta)
                self.backend = ShardedBackend(
                    handle, params=self.params, shards=shards, mesh=mesh,
                    walk_chunk=walk_chunk, use_kernel=use_kernel,
                    **(backend_options or {}),
                )
                # the sharded state owns a partitioned copy of the edges;
                # the constructor handle is not kept (it would go stale on
                # the first shard-wise update)
                self.handle = None
                self._owns_graph = True
            else:
                raise ValueError(
                    f"backend must be 'local', 'sharded' or a Backend "
                    f"instance, got {backend!r}"
                )
        else:
            if shards is not None or mesh is not None or backend_options:
                raise ValueError(
                    "shards/mesh/backend_options configure session-built "
                    "backends; a ready Backend instance already carries "
                    "its geometry — construct it with those options"
                )
            self.backend = backend
            # a backend with the epoch stage own-copies its graph NOW, so
            # epochs never write tensors the caller still holds
            self._owns_graph = bool(backend.supports_epoch)
            if self._owns_graph:
                backend.own_buffers()
            self.handle = getattr(backend, "handle", None)
            self.params = getattr(backend, "params", None) or make_params(
                backend.n, c=c, eps_a=eps_a, delta=delta
            )
        if initial_budget < 1:
            raise ValueError("initial_budget must be >= 1")
        if not 0.0 < confidence < 1.0:
            raise ValueError("confidence must be in (0, 1)")
        self.initial_budget = int(initial_budget)
        self.confidence = float(confidence)
        self.hub_percentile = float(hub_percentile)
        self._probe_cache = ProbeCache(probe_cache_entries)
        self._plan_deg: tuple[int, np.ndarray] | None = None
        self.walk_chunk = walk_chunk
        self.top_k = top_k
        self.batch_q = batch_q
        self.update_batch = update_batch
        self.auto_regrow = auto_regrow
        self.use_kernel = use_kernel
        self.seed = int(seed)
        self.query_queue: deque[tuple[QuerySpec, int, QueryTicket]] = deque()
        self.update_queue: deque[tuple[int, int, bool]] = deque()
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
        return len(self.update_queue), len(self.query_queue)

    def error_bound(self, n_r: int | None = None) -> float:
        """Thm 1+2 absolute-error bound at the effective walk count."""
        return abs_error_bound(self.params, n=self.backend.n, n_r=n_r)

    def regrow(self, **kwargs) -> None:
        """Manual capacity recovery (see :meth:`GraphHandle.regrow`)."""
        with self._lock:
            self.backend.regrow(**kwargs)
            self.stats.regrows += 1

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
        """Serve one spec now, bypassing the queue.

        A spec with ``epsilon`` set runs the adaptive accuracy controller:
        escalate geometrically from ``initial_budget`` until a certificate
        meets epsilon, capped at ``budget_walks`` (or the flat Thm-1
        budget).  ``deadline_s`` clamps escalation (adaptive specs only): a
        miss degrades to the best-so-far answer with
        ``certificate='deadline'``; it never raises.
        """
        spec = as_spec(spec, default_k=self.top_k)
        if budget_walks is not None and spec.budget_walks is None:
            spec = dataclasses.replace(spec, budget_walks=budget_walks)
        if spec.epsilon is not None:
            with self._lock:
                return self._query_adaptive(spec, deadline_s=deadline_s)
        if deadline_s is not None:
            raise ValueError(
                "deadline_s clamps the adaptive escalation loop — it "
                "requires a spec with epsilon set"
            )
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

    # -- adaptive accuracy serving (core/accuracy.py) ------------------------

    def _query_adaptive(
        self, spec: QuerySpec, *, deadline_s: float | None = None
    ) -> ResultEnvelope:
        """One-shot adaptive spec: run the escalation loop now.

        A batched ``nodes`` spec fans out to per-node items (a scalar
        ``spec.key`` is split into per-query streams) and collapses to ONE
        envelope whose certificate is the batch's weakest member
        (``walks_used``/``certified_bound``/``rounds`` are the maxima).
        """
        if spec.nodes is None:
            seed = spec.key if spec.key is not None else self._query_seed()
            envs = self._serve_adaptive([(spec, int(seed))], deadline_s=deadline_s)
            self.stats.queries += 1
            return envs[0]
        seed, seeds = self._multi_seeds(spec)
        subs = [
            dataclasses.replace(spec, node=int(u), nodes=None)
            for u in spec.nodes
        ]
        envs = self._serve_adaptive(
            list(zip(subs, query_seeds(seed, seeds, spec.q))),
            deadline_s=deadline_s,
        )
        self.stats.queries += spec.q
        worst = max(envs, key=lambda e: e.certified_bound)
        walks = max(e.walks_used for e in envs)
        is_ss = spec.kind == "single_source"
        return ResultEnvelope(
            kind=spec.kind,
            nodes=spec.nodes,
            scores=np.stack([e.scores for e in envs]) if is_ss else None,
            topk_nodes=(
                None if is_ss else np.stack([e.topk_nodes for e in envs])
            ),
            topk_scores=(
                None if is_ss else np.stack([e.topk_scores for e in envs])
            ),
            walks_used=walks,
            latency_s=envs[0].latency_s,
            version=self.version,
            error_bound=self.error_bound(walks),
            variant=envs[0].variant,
            epsilon=spec.epsilon,
            certified_bound=worst.certified_bound,
            certificate=worst.certificate,
            rounds=max(e.rounds for e in envs),
        )

    def _serve_adaptive(
        self,
        batch: list[tuple],
        budget_walks: int | None = None,
        *,
        deadline_s: float | None = None,
    ) -> list[ResultEnvelope]:
        """Escalate one (possibly repeat-padded) batch until epsilon is met.

        Items are ``(spec, seed)`` or ``(spec, seed, ticket)`` tuples sharing
        one batch group.  Each round is ONE fused single-source
        ``serve_batch`` of the round's walks, query i drawing from
        ``derive_seed(stream_i, r)`` in round r, and its ``[Q, n]`` rows fold
        into the controller's carried accumulator; a query freezes at the
        round its certificate fires, so its answer does not depend on how
        long its batch mates escalate.  The cap is ``spec.budget_walks`` (or
        the flat Thm-1 budget), which bounds total spend at the flat budget.

        Hub queries (in-degree above ``hub_percentile``, ``spec.key`` not
        pinned) ride node-keyed streams and their rows go through the probe
        cache: a round whose rows are ALL resident skips its dispatch
        (``stats.hub_hits``) — bitwise equal to serving it, since the cached
        rows came from the same streams.

        ``deadline_s`` is checked before every round after the first; on a
        miss the still-live queries freeze with ``certificate='deadline'``
        and their best-so-far scores.
        """
        spec0 = batch[0][0]
        q = len(batch)
        conf = (
            spec0.confidence
            if spec0.confidence is not None
            else self.confidence
        )
        cap = spec0.budget_walks or budget_walks or self.params.n_r
        ctrl = AccuracyController(
            self.params,
            n=self.backend.n,
            q=q,
            epsilon=spec0.epsilon,
            confidence=conf,
            plan=escalation_schedule(min(self.initial_budget, cap), cap),
        )
        us = [item[0].node for item in batch]
        hubs = self.backend.hub_nodes(self.hub_percentile)
        streams, cacheable = [], []
        for item in batch:
            sp = item[0]
            if sp.key is None and sp.node in hubs:
                streams.append(derive_seed(self.seed, 0x5B5B, sp.node))
                cacheable.append(True)
            else:
                streams.append(int(item[1]))
                cacheable.append(False)
        ver = self.version
        t0 = time.time()
        while True:
            n_round = ctrl.next_round()
            if n_round is None:
                ctrl.finish("budget")
                break
            r = ctrl.rounds_done
            if (
                deadline_s is not None
                and r > 0
                and time.time() - t0 >= deadline_s
            ):
                ctrl.finish("deadline")
                break
            # the row is bitwise-determined by (node stream, version, round,
            # round size) plus the lane geometry (q, walk_chunk)
            ckeys = [
                (us[i], ver, r, n_round, q, self.walk_chunk)
                if cacheable[i]
                else None
                for i in range(q)
            ]
            rows = [
                None if ck is None else self._probe_cache.get(ck)
                for ck in ckeys
            ]
            if rows and all(row is not None for row in rows):
                est = np.stack(rows)
                self.stats.hub_hits += 1  # a whole dispatch skipped
            else:
                est, _, _ = self.backend.serve_batch(
                    "single_source", us, [derive_seed(s, r) for s in streams],
                    k=0, n_r=n_round,
                )
                est = np.asarray(est)
                self.stats.steps += 1
                if r > 0:
                    self.stats.escalations += 1
                for i, ck in enumerate(ckeys):
                    if ck is not None:
                        self._probe_cache.put(ck, est[i])
            ctrl.absorb(n_round, est)
            if ctrl.all_frozen:
                break
        dt = time.time() - t0
        label = self.backend.dispatch_label("telescoped")
        out = []
        for i, item in enumerate(batch):
            sp = item[0]
            scores, cert = ctrl.result(i)
            env = ResultEnvelope(
                kind=sp.kind,
                node=sp.node,
                walks_used=cert.walks,
                latency_s=dt,
                version=ver,
                error_bound=self.error_bound(cert.walks),
                variant=label,
                epsilon=sp.epsilon,
                certified_bound=cert.bound,
                certificate=cert.name,
                rounds=cert.rounds,
            )
            if sp.kind == "single_source":
                env.scores = scores
            else:
                # host top-k over the combined vector, as the fused epilogue:
                # query node masked out, ties toward the lower index
                k = sp.k or self.top_k
                masked = scores.copy()
                masked[sp.node] = -np.inf
                order = np.argsort(-masked, kind="stable")[:k]
                env.topk_nodes = order.astype(np.int32)
                env.topk_scores = masked[order]
            out.append(env)
        return out

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
        """Specs that can share one fused dispatch (same shapes/budget).

        Adaptive specs also group on (epsilon, confidence): every query of
        an escalation batch shares one controller, and flat specs never mix
        with adaptive ones.
        """
        return (
            spec.kind, spec.k, spec.budget_walks,
            spec.epsilon, spec.confidence,
        )

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
        """One fused dispatch for a (possibly repeat-padded) query batch;
        adaptive groups (``epsilon`` set) run the escalation loop instead."""
        spec0 = batch[0][0]
        if spec0.epsilon is not None:
            return self._serve_adaptive(batch, budget_walks)
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

    # -- immediate updates ---------------------------------------------------

    def _validate_ops(self, src: np.ndarray, dst: np.ndarray) -> None:
        # validate HERE: out-of-range ids would be sentinel-masked to no-ops
        # downstream and then mistaken for capacity-overflow skips, feeding
        # an unbounded retry/regrow loop
        n = self.backend.n
        bad = (src < 0) | (src >= n) | (dst < 0) | (dst >= n)
        if bad.any():
            i = int(np.argmax(bad))
            raise ValueError(
                f"edge op ({src[i]}, {dst[i]}) out of range for n={n}"
            )

    @staticmethod
    def _as_ops(edges) -> tuple[np.ndarray, np.ndarray]:
        src, dst = edges
        return (np.asarray(src, np.int32).reshape(-1),
                np.asarray(dst, np.int32).reshape(-1))

    def update(self, inserts=None, deletes=None) -> UpdateReport:
        """Apply edge updates NOW through the coordinated both-mirrors path.

        ``inserts``/``deletes`` are ``(src, dst)`` array pairs; inserts
        apply before deletes within one call.  Deleting duplicate (s, d)
        pairs in one call removes one copy per op (multigraph semantics):
        the batch path deletes at most one copy per batch, so duplicates
        are split into per-occurrence sub-batches.  With ``auto_regrow``,
        overflow-skipped inserts trigger a regrow and are retried until
        applied; otherwise they are surfaced in ``UpdateReport.skipped``.
        """
        with self._lock:
            rep = UpdateReport()
            if inserts is not None:
                s, d = self._as_ops(inserts)
                self._validate_ops(s, d)
                self._apply_now(s, d, True, rep)
            if deletes is not None:
                s, d = self._as_ops(deletes)
                self._validate_ops(s, d)
                if s.shape[0]:
                    occ = _occurrence_numbers(s, d, self.backend.n)
                    for k in range(int(occ.max()) + 1):
                        m = occ == k
                        self._apply_now(s[m], d[m], False, rep)
            rep.version = self.version
            rep.overflow = self.overflow
            return rep

    def _apply_now(
        self, src: np.ndarray, dst: np.ndarray, insert: bool, rep: UpdateReport
    ) -> None:
        if src.shape[0] == 0:
            return
        rep.submitted += int(src.shape[0])
        while True:
            applied = self.backend.apply_ops(src, dst, insert)
            n_app = int(applied.sum())
            rep.applied += n_app
            self.stats.updates += n_app
            if not insert:
                return  # unapplied deletes were genuinely absent: no retry
            skipped = ~applied
            if not skipped.any():
                return
            if not self.auto_regrow:
                rep.skipped += [
                    (int(s), int(d), True)
                    for s, d in zip(src[skipped], dst[skipped])
                ]
                return
            self.backend.regrow()  # 2x buffers per round: terminates
            self.stats.regrows += 1
            rep.regrows += 1
            src, dst = src[skipped], dst[skipped]

    # -- fused update->query epochs ------------------------------------------

    def queue_update(self, src, dst, *, insert: bool = True) -> None:
        """Enqueue edge ops for the next :meth:`epoch` step(s)."""
        s, d = self._as_ops((src, dst))
        self._validate_ops(s, d)
        with self._lock:
            for a, b in zip(s, d):
                self.update_queue.append((int(a), int(b), insert))

    def _pop_updates(self) -> tuple[list[tuple[int, int, bool]], UpdateBatch]:
        # the batch path runs its delete phase before its insert phase and
        # deletes at most one copy of a (s, d) pair per batch, so a batch
        # must not hold (a) a delete of an edge inserted earlier in the SAME
        # batch, nor (b) a second delete of the same pair: the batch is cut
        # there (the delete waits for the next epoch), keeping stream order
        ops: list[tuple[int, int, bool]] = []
        inserted: set[tuple[int, int]] = set()
        deleted: set[tuple[int, int]] = set()
        while self.update_queue and len(ops) < self.update_batch:
            s, d, ins = self.update_queue[0]
            if not ins and ((s, d) in inserted or (s, d) in deleted):
                break
            (inserted if ins else deleted).add((s, d))
            ops.append(self.update_queue.popleft())
        batch = make_update_batch(
            [s for s, _, _ in ops],
            [d for _, d, _ in ops],
            [i for _, _, i in ops] if ops else True,
            batch_size=self.update_batch,
            n=self.backend.n,
            # on the graph's device; a backend without a handle moves it
            device=self.handle.device if self.handle is not None else "cpu",
        )
        return ops, batch

    def _pop_epoch_queries(self) -> tuple[int, list, QuerySpec]:
        qs, live = self._pop_query_batch()  # same grouping/padding as drain
        return live, qs, qs[0][0]

    def epoch(
        self,
        *,
        inserts=None,
        deletes=None,
        queries=None,
        budget_walks: int | None = None,
    ) -> EpochResult:
        """Run ONE fused epoch: up to ``update_batch`` queued ops, then up to
        ``batch_q`` queued queries served on the just-written mirrors.

        ``inserts``/``deletes`` (``(src, dst)`` pairs) and ``queries``
        (node ids or single-node specs) are enqueued first; anything past
        one epoch's width stays queued (see :attr:`pending`; loop epochs to
        drain).  Scores are those of the post-update snapshot.  A top-k
        query batch runs the fused top-k epilogue, a single_source batch
        returns full score vectors.  An epoch with no queued query applies
        the batch only.
        """
        if not getattr(self.backend, "supports_epoch", False):
            raise NotImplementedError(
                f"the {self.backend.name!r} backend does not implement "
                "epoch_batch; apply update() and drain() separately"
            )
        if not self._owns_graph:
            # epochs write the mirrors in place; with own_graph=False they
            # are the caller's
            raise ValueError(
                "epoch() requires an owned graph: construct the session "
                "from a GraphHandle with own_graph=True (the default)"
            )
        with self._lock:
            return self._epoch_locked(
                inserts=inserts, deletes=deletes, queries=queries,
                budget_walks=budget_walks,
            )

    def _epoch_locked(
        self, *, inserts, deletes, queries, budget_walks
    ) -> EpochResult:
        if inserts is not None:
            self.queue_update(*self._as_ops(inserts), insert=True)
        if deletes is not None:
            self.queue_update(*self._as_ops(deletes), insert=False)
        if queries is not None:
            for q in queries:
                self.submit(q)
        if self.query_queue and self.query_queue[0][0].epsilon is not None:
            # the escalation loop reads every round's scores on the host, so
            # it cannot ride the fused update->query epoch; the specs stay
            # queued
            raise ValueError(
                "adaptive (epsilon) specs cannot be served inside a fused "
                "epoch — apply the update, then serve them via drain() or "
                "query()"
            )
        ops, batch = self._pop_updates()
        p = self.params

        t0 = time.time()
        if self.query_queue:
            live_q, qs, spec0 = self._pop_epoch_queries()
            n_r = spec0.budget_walks or budget_walks or p.n_r
            tk = spec0.k if spec0.kind == "topk" else 0
            applied, est, idx, vals = self.backend.epoch_batch(
                batch, [item[0].node for item in qs], [item[1] for item in qs],
                n_r=n_r, top_k=tk,
                lanes=self.walk_chunk, use_kernel=self.use_kernel,
            )
        else:
            live_q, qs, spec0 = 0, [], None
            n_r = budget_walks or p.n_r
            applied, est, idx, vals = self.backend.epoch_batch(
                batch, None, None,
                n_r=n_r, top_k=0,
                lanes=self.walk_chunk, use_kernel=self.use_kernel,
            )
        applied = np.asarray(applied)[: len(ops)]
        dt = time.time() - t0

        version = self.version
        overflow = self.overflow
        regrown = False
        requeued = 0
        # skipped inserts (applied == False); unapplied deletes were
        # genuinely absent: those are neither retried nor surfaced
        skipped = [op for op, ok in zip(ops, applied) if not ok and op[2]]
        if skipped and self.auto_regrow:
            # retry on the regrown buffers next epoch
            for op in reversed(skipped):
                self.update_queue.appendleft(op)
            requeued = len(skipped)
            self.backend.regrow()
            self.stats.regrows += 1
            regrown = True

        bound = self.error_bound(n_r)
        variant = self.backend.epoch_dispatch_label()
        results = [
            ResultEnvelope(
                kind=spec0.kind,
                node=item[0].node,
                scores=None if est is None else est[i],
                topk_nodes=None if est is not None else idx[i],
                topk_scores=None if est is not None else vals[i],
                walks_used=n_r,
                latency_s=dt,
                version=version,
                error_bound=bound,
                variant=variant,
            )
            for i, item in enumerate(qs[:live_q])
        ]
        for item, env in zip(qs[:live_q], results):
            item[2].envelope = env
        self.stats.epochs += 1
        self.stats.steps += 1
        self.stats.queries += live_q
        self.stats.updates += int(applied.sum())
        return EpochResult(
            version=version,
            overflow=overflow,
            regrown=regrown,
            updates_submitted=len(ops),
            updates_applied=int(applied.sum()),
            updates_requeued=requeued,
            skipped_ops=skipped,
            results=results,
            latency_s=dt,
        )

    def drain_epochs(
        self, *, budget_walks: int | None = None
    ) -> list[EpochResult]:
        """Run epochs until both queues are empty."""
        with self._lock:
            out: list[EpochResult] = []
            while self.update_queue or self.query_queue:
                out.append(self.epoch(budget_walks=budget_walks))
            return out
