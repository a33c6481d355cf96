"""`StreamDriver` — clock-driven replay of a temporal edge stream (port of
``repro.streams.driver``).

The driver advances a **virtual clock** over an :class:`EventStream` in
fixed ticks: arrivals due in a tick are ingested into the sliding window
and queued as insert ops, TTL expiries come back as delete ops, and the
resulting backlog is cut into bounded update bursts interleaved with
query traffic.  Everything dispatches through a transport:

* :class:`SessionTransport` — a ``SimRankSession``.  ``mode='epoch'`` rides
  the fused update->query epoch step (one epoch applies a burst AND
  answers the queries that share it, on the just-written mirrors);
  ``mode='drain'`` uses the immediate ``update()`` + submit/drain serve
  path.
* :class:`ServiceTransport` — the network service
  (``serving/service.py``): updates through ``apply_update``, queries
  through the micro-batching admission window (with 429 backoff).

Per query the driver records **staleness** — the wall age of the oldest
ingested-but-unapplied op at answer time (0 when the backlog is drained)
— and **version lag** (how many ops the answered snapshot is behind),
reported at p50/p99 against a :class:`FreshnessSLO`.  Periodic pooled
checkpoints (:mod:`repro_torch.streams.churn`) freeze the live window and score
the served answers against the §6.2 expert pool, so effectiveness is
reported alongside throughput while the graph churns.  Checkpoint j of a
driver seeded ``seed`` draws its expert from the int seed ``seed + j``
(the reference's ``key(seed + j)``), on the transport's ``device``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.api.spec import QuerySpec
from repro_torch.serving.protocol import QueryRequest
from repro_torch.serving.service import AdmissionError
from repro_torch.streams.churn import churn_checkpoint
from repro_torch.streams.events import EventStream, SlidingWindowExpirer

__all__ = [
    "FreshnessSLO",
    "ServiceTransport",
    "SessionTransport",
    "StreamCheckpoint",
    "StreamDriver",
    "StreamReport",
]


@dataclass(frozen=True)
class FreshnessSLO:
    """Targets the staleness distribution must meet (``None`` = unchecked)."""

    staleness_p99_s: float = 0.25
    staleness_p50_s: float | None = None
    version_lag_p99: float | None = None


@dataclass
class StreamCheckpoint:
    """One pooled effectiveness checkpoint on the frozen live window."""

    t: float  # virtual time of the freeze
    live_edges: int
    queries: int
    pool_size: float
    precision_at_k: float
    ndcg_at_k: float

    def as_dict(self) -> dict:
        return dict(vars(self))


@dataclass
class StreamReport:
    """Outcome of one :meth:`StreamDriver.run`."""

    ticks: int = 0
    duration_s: float = 0.0  # wall time spent replaying
    arrivals: int = 0
    expired: int = 0
    updates_applied: int = 0
    update_steps: int = 0
    queries: int = 0
    qps: float = 0.0
    staleness_p50_s: float = 0.0
    staleness_p99_s: float = 0.0
    version_lag_p50: float = 0.0
    version_lag_p99: float = 0.0
    rejected_429: int = 0
    final_live_edges: int = 0
    sticky_overflow: bool = False
    slo: FreshnessSLO | None = None
    slo_met: bool | None = None
    checkpoints: list[StreamCheckpoint] = field(default_factory=list)

    @property
    def final_precision_at_k(self) -> float | None:
        return (
            self.checkpoints[-1].precision_at_k if self.checkpoints else None
        )

    def as_dict(self) -> dict:
        d = dict(vars(self))
        d["slo"] = None if self.slo is None else dict(vars(self.slo))
        d["checkpoints"] = [cp.as_dict() for cp in self.checkpoints]
        d["final_precision_at_k"] = self.final_precision_at_k
        return d


def _check_slo(slo: FreshnessSLO, rep: StreamReport) -> bool:
    ok = rep.staleness_p99_s <= slo.staleness_p99_s
    if slo.staleness_p50_s is not None:
        ok = ok and rep.staleness_p50_s <= slo.staleness_p50_s
    if slo.version_lag_p99 is not None:
        ok = ok and rep.version_lag_p99 <= slo.version_lag_p99
    return ok


@dataclass
class StreamAnswer:
    """One served top-k answer plus the snapshot it observed."""

    node: int
    topk_nodes: np.ndarray
    version: int


class SessionTransport:
    """Dispatch stream traffic through a ``SimRankSession``.

    ``mode='epoch'`` (the default where supported) queues ops and queries
    and drains fused update->query epochs; ``mode='drain'`` applies
    updates immediately and serves queries through submit/drain.
    """

    def __init__(self, session, *, mode: str = "drain"):
        if mode not in ("drain", "epoch"):
            raise ValueError(f"mode must be 'drain' or 'epoch', got {mode!r}")
        if mode == "epoch" and not getattr(
            session.backend, "supports_epoch", False
        ):
            raise ValueError(
                f"backend {session.backend.name!r} does not support the "
                "fused epoch path; use mode='drain'"
            )
        self.session = session
        self.mode = mode

    @property
    def label(self) -> str:
        return f"session[{self.session.backend.name}/{self.mode}]"

    @property
    def n(self) -> int:
        return self.session.backend.n

    @property
    def version(self) -> int:
        return self.session.version

    @property
    def device(self):
        return self.session.handle.device

    @property
    def overflow(self) -> bool:
        return self.session.overflow

    @property
    def sqrt_c(self) -> float:
        return float(self.session.params.sqrt_c)

    def step(
        self, runs, nodes, *, k: int, budget_walks: int
    ) -> tuple[int, list[StreamAnswer]]:
        """Apply op runs (stream-ordered ``(src, dst, insert)`` array
        triples) and answer top-k ``nodes`` against the post-burst state;
        returns (ops applied, answers)."""
        sess = self.session
        specs = [
            QuerySpec(kind="topk", node=int(u), k=k,
                      budget_walks=budget_walks)
            for u in nodes
        ]
        applied = 0
        if self.mode == "epoch":
            for src, dst, insert in runs:
                sess.queue_update(src, dst, insert=insert)
            for spec in specs:
                sess.submit(spec)
            envs = []
            for er in sess.drain_epochs():
                applied += er.updates_applied
                envs.extend(er.results)
        else:
            for src, dst, insert in runs:
                rep = (
                    sess.update(inserts=(src, dst))
                    if insert
                    else sess.update(deletes=(src, dst))
                )
                applied += rep.applied
            tickets = [sess.submit(spec) for spec in specs]
            envs = []
            if tickets:
                sess.drain()
                envs = [tk.envelope for tk in tickets]
        return applied, [
            StreamAnswer(
                node=int(env.node),
                topk_nodes=np.asarray(env.topk_nodes),
                version=int(env.version),
            )
            for env in envs
        ]


class ServiceTransport:
    """Dispatch stream traffic through a ``SimRankService`` (the network
    front end): updates via ``apply_update`` (serialized against dispatch),
    queries through the micro-batching admission window.  Admission 429s
    back off by the service's ``Retry-After`` hint and retry; the count
    lands in the report."""

    def __init__(self, service, *, tenant: str = "stream",
                 max_retries: int = 16):
        self.service = service
        self.tenant = tenant
        self.max_retries = int(max_retries)
        self.rejected_429 = 0

    @property
    def label(self) -> str:
        return f"service[{self.service.backend_kind}]"

    @property
    def n(self) -> int:
        return self.service.n

    @property
    def version(self) -> int:
        return self.service.version

    @property
    def device(self):
        return self.service.session(self.tenant).handle.device

    @property
    def overflow(self) -> bool:
        return self.service.session(self.tenant).overflow

    @property
    def sqrt_c(self) -> float:
        return float(self.service.session(self.tenant).params.sqrt_c)

    def _enqueue(self, req):
        for _ in range(self.max_retries):
            try:
                return self.service.enqueue(req, self.tenant)
            except AdmissionError as e:
                self.rejected_429 += 1
                time.sleep(min(e.retry_after_s, 0.05))
        raise RuntimeError(
            f"query rejected {self.max_retries} times by admission control"
        )

    def step(
        self, runs, nodes, *, k: int, budget_walks: int
    ) -> tuple[int, list[StreamAnswer]]:
        applied = 0
        for src, dst, insert in runs:
            ops = np.stack(
                [np.asarray(src, np.int64), np.asarray(dst, np.int64)],
                axis=1,
            )
            rep = (
                self.service.apply_update(inserts=ops)
                if insert
                else self.service.apply_update(deletes=ops)
            )
            applied += rep["applied"]
        items = [
            self._enqueue(QueryRequest(
                kind="topk", node=int(u), k=k, budget_walks=budget_walks,
            ))
            for u in nodes
        ]
        answers = []
        for item in items:
            item.event.wait(timeout=self.service.config.response_timeout_s)
            if item.status != 200:
                raise RuntimeError(
                    f"stream query failed ({item.status}): {item.payload}"
                )
            answers.append(StreamAnswer(
                node=int(item.payload["node"]),
                topk_nodes=np.asarray(item.payload["topk_nodes"]),
                version=int(item.payload["version"]),
            ))
        return applied, answers


class StreamDriver:
    """Replay an :class:`EventStream` against a transport under a TTL
    window, interleaving bounded update bursts with query traffic.

    ``tick_s`` is the virtual-clock step: each tick ingests the arrivals
    it covers, expires the window, cuts the backlog into
    ``update_burst``-sized bursts, and spreads ``queries_per_tick`` top-k
    queries (nodes sampled from the live window) across the bursts.
    ``checkpoint_every`` > 0 freezes the window every that many ticks and
    runs a pooled effectiveness checkpoint (after draining the backlog,
    so quality measures accuracy, not staleness).
    """

    def __init__(
        self,
        transport,
        stream: EventStream,
        *,
        ttl: float,
        tick_s: float,
        queries_per_tick: int = 4,
        update_burst: int = 64,
        k: int = 10,
        budget_walks: int = 512,
        slo: FreshnessSLO | None = None,
        checkpoint_every: int = 0,
        checkpoint_queries: int = 4,
        expert_r: int = 2_000,
        fresh_budget: int = 2_048,
        seed: int = 0,
    ):
        if tick_s <= 0:
            raise ValueError(f"tick_s must be > 0, got {tick_s}")
        if update_burst < 1:
            raise ValueError(f"update_burst must be >= 1, got {update_burst}")
        if transport.n != stream.n:
            raise ValueError(
                f"transport graph has n={transport.n} but the stream was "
                f"generated for n={stream.n}"
            )
        self.transport = transport
        self.stream = stream
        self.ttl = float(ttl)
        self.tick_s = float(tick_s)
        self.queries_per_tick = int(queries_per_tick)
        self.update_burst = int(update_burst)
        self.k = int(k)
        self.budget_walks = int(budget_walks)
        self.slo = slo
        self.checkpoint_every = int(checkpoint_every)
        self.checkpoint_queries = int(checkpoint_queries)
        self.expert_r = int(expert_r)
        self.fresh_budget = int(fresh_budget)
        self.seed = int(seed)

    # -- helpers -------------------------------------------------------------

    @staticmethod
    def _runs(ops: list[tuple[float, int, int, bool]]):
        """Maximal same-type runs of (wall_due, src, dst, insert) ops, as
        the (src, dst, insert) array triples transports take — preserving
        exact stream order across the type boundaries."""
        runs = []
        i = 0
        while i < len(ops):
            j = i
            while j < len(ops) and ops[j][3] == ops[i][3]:
                j += 1
            runs.append((
                np.asarray([op[1] for op in ops[i:j]], np.int32),
                np.asarray([op[2] for op in ops[i:j]], np.int32),
                ops[i][3],
            ))
            i = j
        return runs

    def _sample_live_nodes(self, rng, expirer, count: int) -> np.ndarray:
        """Query nodes drawn from the live window's destination set (the
        nodes whose similarity neighbourhoods the window defines)."""
        _, dst = expirer.live_edges()
        if len(dst) == 0:
            return np.empty(0, np.int64)
        cand = np.unique(dst)
        return rng.choice(cand, size=min(count, len(cand)), replace=False)

    def _drain_backlog(self, backlog, rep: StreamReport) -> None:
        while backlog:
            burst = [backlog.popleft() for _ in range(
                min(self.update_burst, len(backlog))
            )]
            applied, _ = self.transport.step(
                self._runs(burst), (), k=self.k,
                budget_walks=self.budget_walks,
            )
            rep.updates_applied += applied
            rep.update_steps += 1

    # -- the replay loop -----------------------------------------------------

    def run(
        self, *, max_ticks: int | None = None, final_expire: bool = False
    ) -> StreamReport:
        from collections import deque

        rng = np.random.default_rng(self.seed)
        expirer = SlidingWindowExpirer(self.ttl)
        backlog: deque[tuple[float, int, int, bool]] = deque()
        rep = StreamReport(slo=self.slo)
        stalenesses: list[float] = []
        lags: list[int] = []
        n_ticks = int(np.ceil(self.stream.horizon / self.tick_s)) or 1
        if max_ticks is not None:
            n_ticks = min(n_ticks, max_ticks)
        pos = 0
        t = self.stream.t
        wall0 = time.monotonic()
        for tick in range(n_ticks):
            now_v = (tick + 1) * self.tick_s
            wall_due = time.monotonic()
            # arrivals due this tick -> window + insert ops
            j = int(np.searchsorted(t, now_v, side="right"))
            if j > pos:
                expirer.ingest(t[pos:j], self.stream.src[pos:j],
                               self.stream.dst[pos:j])
                for i in range(pos, j):
                    backlog.append((wall_due, int(self.stream.src[i]),
                                    int(self.stream.dst[i]), True))
                rep.arrivals += j - pos
                pos = j
            # TTL expiries -> delete ops (oldest first: the FIFO order the
            # bitwise window==rebuild invariant rides on)
            es, ed = expirer.expire_until(now_v)
            for s, d in zip(es, ed):
                backlog.append((wall_due, int(s), int(d), False))
            rep.expired += len(es)
            # interleave: spread this tick's queries across the bursts
            q_nodes = self._sample_live_nodes(
                rng, expirer, self.queries_per_tick
            )
            n_sub = max(1, -(-len(backlog) // self.update_burst))
            q_splits = np.array_split(q_nodes, n_sub)
            for sub in range(n_sub):
                burst = [backlog.popleft() for _ in range(
                    min(self.update_burst, len(backlog))
                )]
                nodes = q_splits[sub] if sub < len(q_splits) else ()
                if not burst and len(nodes) == 0:
                    continue
                applied, answers = self.transport.step(
                    self._runs(burst), nodes, k=self.k,
                    budget_walks=self.budget_walks,
                )
                rep.updates_applied += applied
                if burst:
                    rep.update_steps += 1
                t_done = time.monotonic()
                stale = (t_done - backlog[0][0]) if backlog else 0.0
                for _ in answers:
                    stalenesses.append(stale)
                    lags.append(len(backlog))
                rep.queries += len(answers)
            # pooled effectiveness checkpoint on the frozen window
            if (
                self.checkpoint_every
                and (tick + 1) % self.checkpoint_every == 0
                and expirer.live
            ):
                self._drain_backlog(backlog, rep)
                self._checkpoint(rng, expirer, now_v, rep)
            rep.ticks += 1
        if final_expire:
            # retire the whole window (warmup hygiene / teardown): every
            # surviving edge expires and the backlog drains to empty
            wall_due = time.monotonic()
            es, ed = expirer.expire_until(n_ticks * self.tick_s + self.ttl)
            for s, d in zip(es, ed):
                backlog.append((wall_due, int(s), int(d), False))
            rep.expired += len(es)
            self._drain_backlog(backlog, rep)
        rep.duration_s = time.monotonic() - wall0
        rep.qps = rep.queries / rep.duration_s if rep.duration_s else 0.0
        if stalenesses:
            rep.staleness_p50_s = float(np.percentile(stalenesses, 50))
            rep.staleness_p99_s = float(np.percentile(stalenesses, 99))
            rep.version_lag_p50 = float(np.percentile(lags, 50))
            rep.version_lag_p99 = float(np.percentile(lags, 99))
        rep.rejected_429 = getattr(self.transport, "rejected_429", 0)
        rep.final_live_edges = expirer.live
        rep.sticky_overflow = bool(self.transport.overflow)
        if self.slo is not None:
            rep.slo_met = _check_slo(self.slo, rep)
        return rep

    def _checkpoint(self, rng, expirer, now_v, rep: StreamReport) -> None:
        nodes = self._sample_live_nodes(rng, expirer, self.checkpoint_queries)
        if len(nodes) == 0:
            return
        _, answers = self.transport.step(
            (), nodes, k=self.k, budget_walks=self.budget_walks,
        )
        src, dst = expirer.live_edges()
        out = churn_checkpoint(
            self.seed + len(rep.checkpoints),
            src, dst, self.transport.n,
            {a.node: a.topk_nodes for a in answers},
            self.k,
            sqrt_c=self.transport.sqrt_c,
            expert_r=self.expert_r,
            fresh_budget=self.fresh_budget,
            device=self.transport.device,
        )
        rep.checkpoints.append(StreamCheckpoint(
            t=float(now_v),
            live_edges=out["live_edges"],
            queries=out["queries"],
            pool_size=out["pool_size"],
            precision_at_k=out["precision_at_k"],
            ndcg_at_k=out["ndcg_at_k"],
        ))
