"""`SimRankService` — multi-tenant micro-batched serving over sessions
(port of ``repro.serving.service``, local backend).

The network-facing half of the serving story lives in two layers:
``serving/server.py`` owns the HTTP surface (sockets, routes, JSON), and
this module owns everything between "a request was accepted" and "its
envelope is ready":

* **micro-batching window** — concurrent connections each carry ONE query,
  but the execution substrate's sweet spot is the lane-batched fused step
  (one fused dispatch for Q queries, DESIGN.md §3/§6).  A collector
  thread cuts cross-connection batches: the first request arms a
  ``batch_window_ms`` timer, the cut happens at the timer or as soon as
  ``max_batch_q`` requests are pending, and each cut drains through the
  tenant session's fused path — so N concurrent clients cost
  ``steps ≪ N`` fused dispatches.

* **admission control + backpressure** — the pending queue is bounded by
  ``max_inflight``; past it, requests are rejected at the door with an
  :class:`AdmissionError` (HTTP 429 + ``Retry-After``) instead of growing
  an unbounded queue whose tail would miss every deadline anyway.
  Requests whose relative ``deadline_s`` expires while still queued are
  shed at cut time (504) — an expired request never occupies a lane slot.
  Adaptive (``epsilon``) requests with deadlines degrade instead of
  shedding: they ride ``serving.straggler.dispatch_adaptive``, so the
  in-band deadline freezes best-so-far certificates
  (``certificate='deadline'``) and only a wedged dispatch past the
  backstop 504s.

* **per-tenant sessions over shared graph state** — each tenant id maps to
  its own ``SimRankSession`` (separate seed namespace, stats, planner
  caches) over ONE shared graph: on the local backend every tenant session
  holds the same ``GraphHandle`` (``own_graph=False``), on the sharded
  backend they share one ``ShardedBackend``.  ``apply_update`` is serialized
  against query dispatch and bumps the version every tenant's next answer
  observes.

Everything device-side is untouched: the service is host-side policy
around ``SimRankSession``, and every device launch happens on the
collector thread or on the one straggler worker it waits for (handler
threads only enqueue and wait).  Where the port differs:

* a wire ``seed`` pins the query's stream as the int seed ``QuerySpec.key``
  takes (the reference builds a typed key from it);
* the port's updates write the mirrors in place, so when the backstop
  abandons an adaptive dispatch (504), ``apply_update`` waits until the
  abandoned query ends, and no write lands under a query still reading
  the mirrors.  Queries go on being served meanwhile; a dispatch that
  never ends holds back every later update;
* connections turned away at the admission bound wait in a first-come
  line for freed slots (``enqueue``'s ``client``), and a 429's
  ``Retry-After`` also counts the age of the dispatch in flight: with the
  reference's admission, the clients a batch had just answered took the
  freed slots and short hints kept the collector from finishing batches,
  so closed-loop clients starved on the HepPh herd;
* on a CUDA handle (or a mesh with a CUDA device) the ``lane_probe``
  kernel is built at construction, so the first request does not wait for
  ``nvcc``.
"""
from __future__ import annotations

import threading
import time
import zlib
from collections import OrderedDict, deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.api.handle import GraphHandle
from repro_torch.api.session import SimRankSession
from repro_torch.api.spec import QuerySpec
from repro_torch.kernels import _build
from repro_torch.serving.protocol import (
    ProtocolError,
    QueryRequest,
    envelope_to_wire,
    update_report_to_wire,
)
from repro_torch.serving.straggler import (
    DeadlineError,
    HedgePolicy,
    dispatch_adaptive,
)

DEFAULT_TENANT = "default"
_TENANT_CHARS = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._-"
)


class AdmissionError(RuntimeError):
    """Admission queue full — HTTP 429 with a ``Retry-After`` hint."""

    def __init__(self, retry_after_s: float, depth: int):
        super().__init__(
            f"admission queue full ({depth} in flight); "
            f"retry after {retry_after_s:.1f}s"
        )
        self.retry_after_s = retry_after_s
        self.depth = depth


class ServiceClosed(RuntimeError):
    """Service is shutting down — HTTP 503."""


@dataclass
class ServiceConfig:
    """Knobs for the micro-batching window and admission policy.

    ``batch_window_ms`` is the collector's cut timer, armed by the first
    pending request (a cut fires early when ``max_batch_q`` requests are
    waiting, so a saturated service never idles the window).
    ``max_batch_q`` is also the tenant sessions' ``batch_q`` — one full
    cut for one tenant is exactly one fused dispatch.  ``max_inflight``
    bounds accepted-but-unanswered requests across all tenants; past it,
    enqueue raises :class:`AdmissionError` (429).
    ``tenant_max_inflight`` additionally bounds any SINGLE tenant's share
    of those slots (None = no per-tenant cap): a greedy tenant 429s at its
    own quota while a quiet tenant's requests still admit, so one hot
    tenant cannot starve the rest of the fleet.
    ``default_budget_walks`` caps queries that don't pin their own budget
    (None = the session's flat Thm-1 budget — usually far too many walks
    for interactive serving, so set this).  ``min_adaptive_deadline_s``
    is the in-band deadline handed to an adaptive query that arrives at
    dispatch already expired: round 0 still runs, so it degrades to a
    best-so-far certificate instead of shedding (flat queries 504).
    """

    batch_window_ms: float = 10.0
    max_batch_q: int = 16
    max_inflight: int = 256
    tenant_max_inflight: int | None = None
    default_budget_walks: int | None = None
    response_timeout_s: float = 600.0
    adaptive_backstop_factor: float = 4.0
    min_adaptive_deadline_s: float = 1e-3

    def __post_init__(self) -> None:
        if self.batch_window_ms < 0:
            raise ValueError("batch_window_ms must be >= 0")
        if self.max_batch_q < 1:
            raise ValueError("max_batch_q must be >= 1")
        if self.max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        if (
            self.tenant_max_inflight is not None
            and self.tenant_max_inflight < 1
        ):
            raise ValueError("tenant_max_inflight must be >= 1 (or None)")


@dataclass
class ServiceStats:
    """Service-level counters (tenant sessions keep their own
    ``EngineStats``; see :meth:`SimRankService.stats_snapshot`).

    ``batch_hist`` maps micro-batch size -> count of fused dispatches that
    served exactly that many live queries (adaptive-with-deadline requests
    dispatch individually and land in bucket 1)."""

    accepted: int = 0
    served: int = 0
    rejected_429: int = 0
    shed_504: int = 0
    errors_5xx: int = 0
    batches: int = 0
    updates_applied: int = 0
    batch_hist: dict[int, int] = field(default_factory=dict)

    def as_dict(self) -> dict:
        d = dict(vars(self))
        d["batch_hist"] = {str(k): v for k, v in sorted(self.batch_hist.items())}
        return d


class _PendingQuery:
    """One accepted request waiting for its micro-batch to dispatch."""

    __slots__ = (
        "req", "spec", "tenant", "t_enq", "t_deadline",
        "event", "status", "payload",
    )

    def __init__(self, req, spec, tenant, t_enq, t_deadline):
        self.req = req
        self.spec = spec
        self.tenant = tenant
        self.t_enq = t_enq
        self.t_deadline = t_deadline
        self.event = threading.Event()
        self.status: int = 500
        self.payload: dict = {"error": "internal: response never filled"}


def _tenant_seed(tenant: str, seed: int) -> int:
    """Stable per-tenant PRNG namespace: crc32 of the name, salted."""
    return (zlib.crc32(tenant.encode()) ^ (seed * 0x9E3779B1)) & 0x7FFFFFFF


def validate_tenant(tenant: str) -> str:
    if not tenant or len(tenant) > 64 or not set(tenant) <= _TENANT_CHARS:
        raise ProtocolError(
            "tenant must be 1-64 chars of [A-Za-z0-9._-], "
            f"got {tenant!r}"
        )
    return tenant


class SimRankService:
    """Multi-tenant micro-batched SimRank serving over shared graph state.

    ``handle`` is copied once at construction (the service owns its graph;
    the caller's handle stays authoritative for the caller) — on the
    handle's device, so at HepPh size the copy is one more 4.77 GB table.
    Tenants are created lazily on first use: each gets its own
    ``SimRankSession`` — its own seed namespace (``_tenant_seed(name,
    seed)``), stats and planner caches — over the ONE service-owned graph,
    so an update any tenant observes is the update every tenant observes.
    ``backend='sharded'`` builds one ``ShardedBackend`` (``shards=`` /
    ``mesh=``, a ``ShardMesh``; its own partitioned copy of the edges) that
    all tenant sessions share the same way.

    ``session_kwargs`` forwards session knobs (``c``, ``eps_a``,
    ``walk_chunk``, ``top_k``, ...) to every tenant session; ``batch_q``
    is pinned to ``config.max_batch_q`` (the micro-batch IS the session
    batch).  Use :func:`serving.server.start_server` to put the HTTP
    surface in front of this object, or drive :meth:`serve_request` /
    :meth:`apply_update` directly from tests.
    """

    # a client in line that has not retried within this many of its
    # Retry-After hints (at least 0.1 s each) loses its place
    _WAIT_HINTS = 8

    def __init__(
        self,
        handle: GraphHandle,
        *,
        backend: str = "local",
        shards: int | None = None,
        mesh=None,
        config: ServiceConfig | None = None,
        seed: int = 0,
        session_kwargs: dict | None = None,
    ):
        if not isinstance(handle, GraphHandle):
            raise TypeError("SimRankService takes a GraphHandle")
        if backend not in ("local", "sharded"):
            raise ValueError(
                f"backend must be 'local' or 'sharded', got {backend!r}"
            )
        self.config = config or ServiceConfig()
        self.seed = int(seed)
        self._session_kwargs = dict(session_kwargs or {})
        for k in ("batch_q", "own_graph", "backend", "shards", "mesh"):
            if k in self._session_kwargs:
                raise ValueError(
                    f"session_kwargs[{k!r}] is owned by the service "
                    "(batch_q = config.max_batch_q; graph sharing and "
                    "backend selection are constructor arguments)"
                )
        self.backend_kind = backend
        # a wire query with no k falls back to the session top_k; clamp
        # the default below the graph size so small graphs don't 500
        if "top_k" not in self._session_kwargs:
            self._session_kwargs["top_k"] = max(1, min(50, handle.n - 1))
        if backend == "local":
            self._handle = handle.copy()  # service-owned; caller's is safe
            self._root_backend = None
            on_card = self._handle.device.type == "cuda"
        else:
            from repro_torch.api.backend import ShardedBackend
            from repro_torch.core.params import make_params

            kw = self._session_kwargs
            params = make_params(
                handle.n,
                c=kw.get("c", 0.6),
                eps_a=kw.get("eps_a", 0.1),
                delta=kw.get("delta", 0.01),
            )
            # one backend (its own partitioned copy of the edges) shared by
            # every tenant session
            self._root_backend = ShardedBackend(
                handle, params=params, shards=shards, mesh=mesh,
                walk_chunk=kw.get("walk_chunk", 256),
                use_kernel=kw.get("use_kernel", True),
            )
            self._handle = None
            on_card = any(d.type == "cuda"
                          for d in self._root_backend.mesh.devices)
        if on_card:
            _build.load("lane_probe")  # nvcc now, not on the first request
        self.stats = ServiceStats()
        self._sessions: dict[str, SimRankSession] = {}
        self._sessions_lock = threading.Lock()
        # serializes graph mutation (apply_update) against query dispatch:
        # a fused drain must never observe a half-applied mirror pair
        self._graph_lock = threading.RLock()
        self._cond = threading.Condition()
        # observed per-batch service time (collector-thread EWMA; reads
        # from handler threads are racy-but-monotonic floats, fine)
        self._ewma_batch_s = max(self.config.batch_window_ms / 1e3, 1e-3)
        self._dispatch_t0: float | None = None  # start of the dispatch in flight
        # the ``done`` events of adaptive queries the backstop abandoned
        # while still running (under _graph_lock): updates wait for them
        self._abandoned: list[threading.Event] = []
        self._pending: deque[_PendingQuery] = deque()
        self._inflight = 0
        self._tenant_inflight: dict[str, int] = {}
        # clients turned away at the global bound, in the order they were
        # first turned away -> when their place lapses (see enqueue)
        self._owed: OrderedDict = OrderedDict()
        self._closed = False
        self._collector = threading.Thread(
            target=self._collector_loop, daemon=True,
            name="probesim-collector",
        )
        self._collector.start()

    # -- tenants -------------------------------------------------------------

    @property
    def n(self) -> int:
        be = self._root_backend
        return be.n if be is not None else self._handle.n

    @property
    def version(self) -> int:
        be = self._root_backend
        return be.version if be is not None else self._handle.version

    @property
    def inflight(self) -> int:
        with self._cond:
            return self._inflight

    @property
    def tenants(self) -> tuple[str, ...]:
        with self._sessions_lock:
            return tuple(self._sessions)

    def session(self, tenant: str = DEFAULT_TENANT) -> SimRankSession:
        """The tenant's session, created lazily on first use."""
        validate_tenant(tenant)
        with self._sessions_lock:
            sess = self._sessions.get(tenant)
            if sess is None:
                tseed = _tenant_seed(tenant, self.seed)
                if self._root_backend is not None:
                    # params come from the shared backend
                    sess = SimRankSession(
                        self._root_backend, seed=tseed,
                        batch_q=self.config.max_batch_q,
                        **{k: v for k, v in self._session_kwargs.items()
                           if k not in ("c", "eps_a", "delta")},
                    )
                else:
                    sess = SimRankSession(
                        self._handle, seed=tseed, own_graph=False,
                        batch_q=self.config.max_batch_q,
                        **self._session_kwargs,
                    )
                self._sessions[tenant] = sess
            return sess

    # -- query path ----------------------------------------------------------

    def _retry_after_s(self, depth: int, limit: int | None = None) -> float:
        """How long a 429'd client should back off: the time until an
        admission slot frees, i.e. enough cuts to work off the overshoot
        past the violated bound (``max_inflight`` globally, or the
        tenant's quota when ``limit`` is passed) — one batch completion
        usually frees a whole batch of slots.  Each cut is costed at the
        OBSERVED batch service time (EWMA, floored at the window): a
        window-only hint under-estimates badly once dispatch time
        dominates (retry storms), while a drain-the-whole-queue hint
        over-sleeps the herd and idles the collector.  The dispatch in
        progress counts too, once it has run longer than the EWMA: the
        collector shares the interpreter with the HTTP threads, so 429s
        that come back too often slow the very dispatch they wait for
        (on the HepPh herd, short hints kept it from finishing a batch
        for seconds, and the EWMA, which only a finished batch updates,
        never grew)."""
        window_s = max(self.config.batch_window_ms / 1e3, 1e-3)
        bound = self.config.max_inflight if limit is None else limit
        overshoot = max(1, depth - bound + 1)
        cuts = -(-overshoot // self.config.max_batch_q) or 1  # ceil
        t0 = self._dispatch_t0
        busy_s = 0.0 if t0 is None else time.monotonic() - t0
        return cuts * max(window_s, self._ewma_batch_s, busy_s)

    def _observe_batch_s(self, dt: float) -> None:
        self._ewma_batch_s += 0.3 * (dt - self._ewma_batch_s)

    def _spec_for(self, req: QueryRequest) -> QuerySpec:
        if req.node >= self.n:
            raise ProtocolError(
                f"node {req.node} out of range for n={self.n}"
            )
        budget = req.budget_walks
        if budget is None:
            budget = self.config.default_budget_walks
        key = None
        if req.seed is not None:
            # wire-pinned stream: bitwise-reproducible against a local
            # session under the same int seed (the parity tests' hook)
            key = int(req.seed)
        return QuerySpec(
            kind=req.kind,
            node=req.node,
            k=req.k,
            budget_walks=budget,
            epsilon=req.epsilon,
            confidence=req.confidence,
            key=key,
        )

    def enqueue(
        self, req: QueryRequest, tenant: str = DEFAULT_TENANT,
        client=None,
    ) -> _PendingQuery:
        """Admit one request into the micro-batching window (non-blocking).

        Raises :class:`AdmissionError` (429) past ``max_inflight``,
        :class:`ServiceClosed` (503) during shutdown, and
        :class:`ProtocolError` (400) on a bad tenant/node.  The returned
        item's ``event`` fires when ``status``/``payload`` are filled.

        ``client`` (any hashable; the HTTP server passes the connection's
        address) makes admission fair: clients turned away at the global
        bound wait in line, in the order they were first turned away.  The
        one at place r is admitted while ``inflight + max(0, r -
        max_batch_q) < max_inflight`` (any of the first ``max_batch_q`` may
        take a free slot, so one client slow to come back does not hold the
        rest), a client not in line only while ``inflight + line length <
        max_inflight``; so freed slots go to the front of the line, and
        each 429's hint grows with the client's place.  A place lapses
        ``_WAIT_HINTS`` retry hints after its last 429.  Without the line,
        the clients a batch just answered resubmit at once and take the
        freed slots, and a client whose retries fall just before each batch
        ends is turned away every time (hundreds of times in a row on the
        HepPh herd).
        """
        validate_tenant(tenant)
        spec = self._spec_for(req)  # validates before occupying a slot
        now = time.monotonic()
        deadline = None if req.deadline_s is None else now + req.deadline_s
        item = _PendingQuery(req, spec, tenant, now, deadline)
        with self._cond:
            if self._closed:
                raise ServiceClosed("service is shutting down")
            for c in [c for c, t in self._owed.items() if t <= now]:
                del self._owed[c]  # never came back: its place lapses
            if client in self._owed:  # in line: the places ahead of it
                ahead = list(self._owed).index(client) - self.config.max_batch_q
                depth = self._inflight + max(0, ahead)
            else:
                depth = self._inflight + len(self._owed)
            if depth >= self.config.max_inflight:
                self.stats.rejected_429 += 1
                hint = self._retry_after_s(depth)
                if client is not None:  # joins the line, or keeps its place
                    self._owed[client] = now + self._WAIT_HINTS * max(hint, 0.1)
                raise AdmissionError(hint, self._inflight)
            cap = self.config.tenant_max_inflight
            mine = self._tenant_inflight.get(tenant, 0)
            if cap is not None and mine >= cap:
                # the tenant blew its own share while global slots remain:
                # reject it without touching anyone else's admission
                self.stats.rejected_429 += 1
                raise AdmissionError(self._retry_after_s(mine, cap), mine)
            self._owed.pop(client, None)
            self._inflight += 1
            self._tenant_inflight[tenant] = mine + 1
            self.stats.accepted += 1
            self._pending.append(item)
            self._cond.notify_all()
        return item

    def serve_request(
        self, req: QueryRequest, tenant: str = DEFAULT_TENANT, client=None
    ) -> tuple[int, dict]:
        """Blocking convenience: enqueue + wait -> (http_status, payload)."""
        item = self.enqueue(req, tenant, client)
        if not item.event.wait(timeout=self.config.response_timeout_s):
            return 500, {"error": "response timed out inside the service"}
        return item.status, item.payload

    def forget_client(self, client) -> None:
        """Drop ``client``'s place in line (its connection closed)."""
        with self._cond:
            self._owed.pop(client, None)

    def _finish(self, item: _PendingQuery, status: int, payload: dict) -> None:
        item.status = status
        item.payload = payload
        with self._cond:
            self._inflight -= 1
            left = self._tenant_inflight.get(item.tenant, 0) - 1
            if left > 0:
                self._tenant_inflight[item.tenant] = left
            else:
                self._tenant_inflight.pop(item.tenant, None)
        item.event.set()

    # -- the collector -------------------------------------------------------

    def _collector_loop(self) -> None:
        window_s = self.config.batch_window_ms / 1e3
        while True:
            with self._cond:
                while not self._pending:
                    if self._closed:
                        return
                    self._cond.wait(timeout=0.25)
                # the first pending request armed the window; cut at the
                # timer or as soon as a full batch is waiting
                cut_at = self._pending[0].t_enq + window_s
                while (
                    len(self._pending) < self.config.max_batch_q
                    and not self._closed
                ):
                    rem = cut_at - time.monotonic()
                    if rem <= 0:
                        break
                    self._cond.wait(timeout=rem)
                batch = self._cut_window()
            try:
                self._serve_cut(batch)
            except BaseException as e:  # the collector must survive anything
                for it in batch:
                    if not it.event.is_set():
                        self.stats.errors_5xx += 1
                        self._finish(
                            it, 500,
                            {"error": f"{type(e).__name__}: {e}"},
                        )

    def _cut_window(self) -> list[_PendingQuery]:
        """Cut up to ``max_batch_q`` pending requests (under ``_cond``).

        When everything pending fits one cut (the common case) this is
        plain FIFO.  When the window OVERFLOWS a cut, deadline-bearing
        queries take the lane slots first (earliest deadline wins) and
        deadline-free ones keep FIFO order behind them — the extra window
        of waiting lands on the queries that can afford it, instead of a
        deadline query shedding (504) because FIFO queued it behind
        best-effort traffic.  The un-cut remainder keeps arrival order.
        """
        q = self.config.max_batch_q
        if len(self._pending) <= q:
            batch = list(self._pending)
            self._pending.clear()
            return batch
        items = list(self._pending)
        order = sorted(
            range(len(items)),
            key=lambda i: (
                (0, items[i].t_deadline)
                if items[i].t_deadline is not None
                else (1, items[i].t_enq)
            ),
        )
        chosen = set(order[:q])
        self._pending.clear()
        self._pending.extend(
            items[i] for i in range(len(items)) if i not in chosen
        )
        return [items[i] for i in order[:q]]

    @staticmethod
    def _group_key(spec: QuerySpec):
        # mirror SimRankSession._batch_group: specs sharing one fused
        # dispatch must agree on shapes and escalation parameters
        return (
            spec.kind, spec.k, spec.budget_walks,
            spec.epsilon, spec.confidence,
        )

    def _serve_cut(self, batch: list[_PendingQuery]) -> None:
        """Serve one window cut: shed expired, group, fuse, respond."""
        now = time.monotonic()
        groups: dict[tuple, list[_PendingQuery]] = {}
        solo: list[_PendingQuery] = []
        for it in batch:
            expired = it.t_deadline is not None and now >= it.t_deadline
            if it.spec.epsilon is not None and it.t_deadline is not None:
                # adaptive + deadline: the in-band escalation clamp is the
                # graceful version of shedding — dispatch individually
                solo.append(it)
            elif expired:
                self.stats.shed_504 += 1
                self._finish(it, 504, {
                    "error": "deadline expired before dispatch "
                    f"(queued {now - it.t_enq:.3f}s of "
                    f"{it.req.deadline_s:.3f}s)",
                })
            else:
                groups.setdefault(
                    (it.tenant, self._group_key(it.spec)), []
                ).append(it)
        try:
            for (tenant, _), items in groups.items():
                self._dispatch_t0 = time.monotonic()
                self._serve_group(tenant, items)
            for it in solo:
                self._dispatch_t0 = time.monotonic()
                self._serve_adaptive_solo(it)
        finally:
            self._dispatch_t0 = None

    def _serve_group(self, tenant: str, items: list[_PendingQuery]) -> None:
        """One tenant-homogeneous group through the fused submit/drain."""
        t0 = time.monotonic()
        try:
            sess = self.session(tenant)
            with self._graph_lock:
                tickets = [sess.submit(it.spec) for it in items]
                sess.drain()
        except Exception as e:
            for it in items:
                self.stats.errors_5xx += 1
                self._finish(it, 500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._observe_batch_s(time.monotonic() - t0)
        self.stats.batches += 1
        self.stats.batch_hist[len(items)] = (
            self.stats.batch_hist.get(len(items), 0) + 1
        )
        self.stats.served += len(items)
        for it, tk in zip(items, tickets):
            self._finish(it, 200, envelope_to_wire(
                tk.envelope,
                tenant=tenant,
                batch_size=len(items),
                queue_delay_s=t0 - it.t_enq,
            ))

    def _serve_adaptive_solo(self, it: _PendingQuery) -> None:
        """Adaptive + deadline: in-band clamp via dispatch_adaptive.

        A worker the backstop abandons goes on reading the mirrors, which
        updates write in place: its ``done`` event joins ``_abandoned``,
        and ``apply_update`` waits for it (other dispatches do not)."""
        t0 = time.monotonic()
        rem = max(
            it.t_deadline - t0, self.config.min_adaptive_deadline_s
        )
        done = threading.Event()

        def tracked_query(spec, *, deadline_s):
            try:
                return sess.query(spec, deadline_s=deadline_s)
            finally:
                done.set()

        try:
            sess = self.session(it.tenant)
            with self._graph_lock:
                try:
                    env = dispatch_adaptive(
                        tracked_query, it.spec,
                        policy=HedgePolicy(deadline_s=rem),
                        backstop_factor=self.config.adaptive_backstop_factor,
                    )
                finally:
                    if not done.is_set():
                        self._abandoned.append(done)
        except DeadlineError:
            # even the thread backstop blew: a genuinely wedged dispatch
            self.stats.shed_504 += 1
            self._finish(it, 504, {
                "error": "adaptive dispatch exceeded the backstop "
                f"deadline ({rem * self.config.adaptive_backstop_factor:.3f}s)",
            })
            return
        except Exception as e:
            self.stats.errors_5xx += 1
            self._finish(it, 500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._observe_batch_s(time.monotonic() - t0)
        self.stats.batches += 1
        self.stats.batch_hist[1] = self.stats.batch_hist.get(1, 0) + 1
        self.stats.served += 1
        self._finish(it, 200, envelope_to_wire(
            env,
            tenant=it.tenant,
            batch_size=1,
            queue_delay_s=t0 - it.t_enq,
        ))

    # -- updates -------------------------------------------------------------

    def apply_update(
        self,
        inserts: np.ndarray | None = None,
        deletes: np.ndarray | None = None,
    ) -> dict:
        """Apply one coordinated update batch to the shared graph (serialized).

        ``inserts``/``deletes`` are ``[B, 2]`` (src, dst) arrays (the
        ``parse_update_request`` output).  Runs under the graph lock, so
        it is atomic w.r.t. query dispatch: every query is answered
        against a consistent pre- or post-update snapshot, and the bumped
        ``version`` in its envelope says which.  All tenants share the
        graph state, so they all observe the new version immediately.
        It first waits for any adaptive query the backstop abandoned while
        it still reads the mirrors (without holding the lock, so queries
        go on meanwhile).
        """
        while True:
            with self._graph_lock:
                self._abandoned = [
                    ev for ev in self._abandoned if not ev.is_set()
                ]
                if not self._abandoned:
                    rep = self.session(DEFAULT_TENANT).update(
                        inserts=None if inserts is None else (
                            inserts[:, 0], inserts[:, 1]
                        ),
                        deletes=None if deletes is None else (
                            deletes[:, 0], deletes[:, 1]
                        ),
                    )
                    self.stats.updates_applied += rep.applied
                    return update_report_to_wire(rep, n=self.n)
                running = self._abandoned[0]
            running.wait()

    # -- observability -------------------------------------------------------

    def stats_snapshot(self) -> dict:
        """``GET /stats`` payload: service counters + per-tenant sessions."""
        with self._cond:
            service = self.stats.as_dict()
            service["inflight"] = self._inflight
            service["pending"] = len(self._pending)
            service["tenant_inflight"] = dict(self._tenant_inflight)
        service["max_inflight"] = self.config.max_inflight
        service["tenant_max_inflight"] = self.config.tenant_max_inflight
        service["batch_window_ms"] = self.config.batch_window_ms
        service["max_batch_q"] = self.config.max_batch_q
        with self._sessions_lock:
            tenants = {
                name: dict(sess.stats.as_dict(), version=sess.version)
                for name, sess in self._sessions.items()
            }
        return {"service": service, "tenants": tenants}

    def healthz(self) -> dict:
        """``GET /healthz`` payload: liveness + the shared snapshot id."""
        return {
            "status": "closed" if self._closed else "ok",
            "backend": self.backend_kind,
            "n": self.n,
            "version": self.version,
            "tenants": len(self._sessions),
            "inflight": self.inflight,
        }

    # -- lifecycle -----------------------------------------------------------

    def close(self, timeout_s: float = 30.0) -> None:
        """Stop admitting, flush pending requests, stop the collector."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._collector.join(timeout=timeout_s)
        # anything the collector could not flush fails loudly, not silently
        with self._cond:
            leftovers = list(self._pending)
            self._pending.clear()
        for it in leftovers:
            self._finish(it, 503, {"error": "service closed before dispatch"})

    def __enter__(self) -> "SimRankService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
