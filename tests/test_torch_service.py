"""repro_torch.serving held against repro.serving, and the port's service,
server, shims, launcher and quickstart on the CPU.

* ``protocol`` and ``straggler`` are copies: the reference's cases run
  through both packages and must give the same dataclasses, the same
  ``ProtocolError`` messages, the same JSON and the same outcomes.
* The service and the shims against repro's: both packages' services get
  one script of requests in the same cuts, over rows that depend only on
  (node, walk budget, graph version), and must give equal statuses,
  replies, hints, update reports and /stats and /healthz payloads.  The
  port's two admission changes are the only tolerated differences: the
  line of turned-away connections, which forms only when ``enqueue`` is
  given a ``client`` (the HTTP server gives the connection's address),
  and a 429 hint that counts the dispatch in flight, which differs only
  while a dispatch older than the window runs.
* The service's scenarios are the port's counterparts of
  ``tests/test_service.py``.  Answers with a pinned wire ``seed`` must be
  bitwise equal to a direct port session's solo replay (the wire seed is
  the int ``QuerySpec.key``), whatever batch the collector cut.
* A backstop 504 leaves no write under the abandoned query: the next
  update waits for it (queries do not), and the next answers equal a
  session's on a rebuild of the updated graph, bitwise.

Every thread is joined with a timeout and asserted finished; servers bind
port 0 on 127.0.0.1.
"""
import dataclasses
import json
import sys
import threading
import time
import types
import warnings
from contextlib import contextmanager

import numpy as np
import pytest
import torch

import jax

import repro.serving.protocol as JP
import repro.serving.straggler as JS
import repro_torch.serving as TSERV
import repro_torch.serving.protocol as TP
import repro_torch.serving.straggler as TS
from repro.api.spec import ResultEnvelope as JEnvelope
from repro.api.session import UpdateReport as JUpdateReport
from repro_torch.api import GraphHandle, QuerySpec, SimRankSession
from repro_torch.api.session import UpdateReport
from repro_torch.api.spec import ResultEnvelope
from repro_torch.serving import (
    AdmissionError,
    ProtocolError,
    ServiceClient,
    ServiceClosed,
    ServiceConfig,
    SimRankService,
    start_server,
    stop_server,
)
from repro_torch.serving.protocol import QueryRequest
from torch_port_helpers import CPU, needs_cuda

JOIN_S = 60.0  # every join and wait in this file is bounded


def _graph(n=48, m=300, seed=7):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, m), rng.integers(0, n, m), n


@pytest.fixture()
def handle():
    src, dst, n = _graph()
    return GraphHandle.from_edges(src, dst, n, device=CPU)


@contextmanager
def live_server(h, **cfg_kw):
    """A service behind an HTTP server on 127.0.0.1:0; yields
    (service, host, port) and stops both, threads joined, on exit."""
    cfg_kw.setdefault("batch_window_ms", 40.0)
    cfg_kw.setdefault("max_batch_q", 8)
    cfg_kw.setdefault("default_budget_walks", 64)
    session_kwargs = cfg_kw.pop("session_kwargs", None)
    svc = SimRankService(h, config=ServiceConfig(**cfg_kw),
                         session_kwargs=session_kwargs)
    server, thread = start_server(svc)
    host, port = server.server_address
    try:
        yield svc, host, port
    finally:
        stop_server(server, thread)
        assert not thread.is_alive()
        assert not svc._collector.is_alive()


def _join_all(threads):
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads)


def _solo_replay(h, spec_kw, seeds, batch_q):
    """Each (spec, seed) drained alone through a direct session at the
    service's batch width (repeat-padded), as the reference's test does."""
    ref = SimRankSession(h, batch_q=batch_q, own_graph=False)
    out = []
    for kw, seed in zip(spec_kw, seeds):
        tk = ref.submit(QuerySpec(key=seed, **kw))
        ref.drain()
        out.append(tk.envelope)
    return out


# ---------------------------------------------------------------------------
# protocol: the copy against the reference
# ---------------------------------------------------------------------------

QUERY_CASES = [
    {"node": 3, "kind": "single_source", "budget_walks": 32, "seed": 9},
    {"node": 1},
    {"node": 2, "kind": "topk", "k": 5, "epsilon": 0.1, "confidence": 0.9,
     "deadline_s": 0.5, "seed": 3},
    {"node": 1, "budget_walk": 8},
    {"kind": "topk"},
    {"node": 1, "kind": "pagerank"},
    {"node": 1.5},
    {"node": 1, "k": 0},
    {"node": 1, "confidence": 0.95},
    {"node": 1, "epsilon": float("nan")},
    {"node": None},
    {"node": -1},
    {"node": True},
    {"node": 1, "epsilon": 0.1, "confidence": 1.0},
    {"node": 1, "deadline_s": -1.0},
    [1, 2],
]

UPDATE_CASES = [
    {"inserts": [[1, 2], [3, 4]]},
    {"inserts": [[1, 2]], "deletes": [[2, 3]]},
    {"inserts": []},
    {"inserts": [[1, 2, 3]]},
    {"deletes": [[-1, 2]]},
    {"insert": [[1, 2]]},
    {"inserts": "1,2"},
    {"deletes": [[1, True]]},
    "not an object",
]


def _outcome(fn, body):
    try:
        out = fn(body)
    except ProtocolError as e:  # the port's class
        return ("error", type(e).__name__, str(e))
    except JP.ProtocolError as e:
        return ("error", type(e).__name__, str(e))
    if isinstance(out, tuple):
        return ("ok", tuple(None if a is None else (a.dtype.str, a.tolist())
                            for a in out))
    return ("ok", dataclasses.asdict(out))


@pytest.mark.parametrize("body", QUERY_CASES, ids=range(len(QUERY_CASES)))
def test_parse_query_request_equals_repro(body):
    a = _outcome(JP.parse_query_request, body)
    b = _outcome(TP.parse_query_request, body)
    assert a == b
    if a[0] == "error":
        assert b[1] == "ProtocolError" and issubclass(TP.ProtocolError,
                                                      ValueError)


@pytest.mark.parametrize("body", UPDATE_CASES, ids=range(len(UPDATE_CASES)))
def test_parse_update_request_equals_repro(body):
    assert _outcome(JP.parse_update_request, body) == _outcome(
        TP.parse_update_request, body)


def test_protocol_copy_pinned():
    assert (JP.KINDS, JP.MAX_UPDATE_OPS) == (TP.KINDS, TP.MAX_UPDATE_OPS)
    fa = [(f.name, repr(f.default)) for f in dataclasses.fields(JP.QueryRequest)]
    fb = [(f.name, repr(f.default)) for f in dataclasses.fields(TP.QueryRequest)]
    assert fa == fb


@pytest.mark.parametrize("kind", ["topk", "single_source", "adaptive"])
def test_wire_json_equal_for_equal_envelopes(kind):
    rng = np.random.default_rng(3)
    kw = dict(node=4, walks_used=64, latency_s=0.012, version=2,
              error_bound=0.0731, variant="telescoped")
    if kind == "single_source":
        s = rng.uniform(0, 1, 9).astype(np.float32)
        kw.update(kind="single_source", scores=s)
    else:
        kw.update(kind="topk", topk_nodes=np.array([3, 1, 7], np.int32),
                  topk_scores=np.array([0.5, 0.25, np.float32(1 / 3)],
                                       np.float32))
    if kind == "adaptive":
        kw.update(epsilon=0.05, certified_bound=float("nan"),
                  certificate="deadline", rounds=3)
    extra = dict(tenant="t", batch_size=np.int64(5), queue_delay_s=0.5)
    a = JP.envelope_to_wire(JEnvelope(**kw), **extra)
    b = TP.envelope_to_wire(ResultEnvelope(**kw), **extra)
    assert json.dumps(a) == json.dumps(b)
    rep = dict(submitted=5, applied=4, regrows=1, skipped=[(1, 2, True)],
               version=7, overflow=False)
    assert json.dumps(JP.update_report_to_wire(JUpdateReport(**rep), n=9)) == \
        json.dumps(TP.update_report_to_wire(UpdateReport(**rep), n=9))


# ---------------------------------------------------------------------------
# straggler: tests/test_straggler.py's cases through both modules
# ---------------------------------------------------------------------------

STRAGGLERS = pytest.mark.parametrize("S", [JS, TS], ids=["repro", "repro_torch"])


@STRAGGLERS
def test_straggler_run_with_deadline(S):
    assert S.run_with_deadline(lambda x: x + 1, 41, deadline_s=5.0) == 42
    with pytest.raises(S.DeadlineError):
        S.run_with_deadline(lambda: time.sleep(0.5), deadline_s=0.05)

    def boom():
        raise RuntimeError("worker died")

    with pytest.raises(RuntimeError, match="worker died"):
        S.run_with_deadline(boom, deadline_s=5.0)


@STRAGGLERS
def test_straggler_dispatch_budget_injection(S):
    seen = {}

    def fn(**kwargs):
        seen.update(kwargs)
        return "ok"

    assert S.dispatch(fn, policy=S.HedgePolicy(deadline_s=5.0), budget=128) == "ok"
    assert seen == {"budget_walks": 128}
    calls = {"n": 0}

    def bare(**kwargs):
        calls["n"] += 1
        assert "budget_walks" not in kwargs
        return "ok"

    assert S.dispatch(bare, policy=S.HedgePolicy(deadline_s=5.0)) == "ok"
    assert calls["n"] == 1


@STRAGGLERS
def test_straggler_dispatch_sheds_per_retry(S):
    budgets, retries = [], []

    def fn(budget_walks=None):
        budgets.append(budget_walks)
        if budget_walks > 100:
            time.sleep(0.6)
        return budget_walks

    out = S.dispatch(
        fn, policy=S.HedgePolicy(deadline_s=0.2, max_retries=3, shed_factor=0.5),
        budget=400, on_retry=retries.append,
    )
    assert out == 100 and budgets == [400, 200, 100] and retries == [1, 2]


@STRAGGLERS
def test_straggler_dispatch_exhausts_and_floors(S):
    calls = {"n": 0}

    def slow(budget_walks=None):
        calls["n"] += 1
        time.sleep(0.5)

    with pytest.raises(S.DeadlineError):
        S.dispatch(slow, policy=S.HedgePolicy(deadline_s=0.1, max_retries=2,
                                               shed_factor=0.5), budget=64)
    assert calls["n"] == 3
    budgets = []

    def fn(budget_walks=None):
        budgets.append(budget_walks)
        if len(budgets) < 3:
            time.sleep(0.6)
        return budget_walks

    out = S.dispatch(fn, policy=S.HedgePolicy(deadline_s=0.2, max_retries=4,
                                              shed_factor=0.1), budget=2)
    assert out == 1 and budgets == [2, 1, 1]


@STRAGGLERS
def test_straggler_dispatch_adaptive(S):
    seen = {}

    def fn(spec, **kwargs):
        seen.update(kwargs, spec=spec)
        return "ok"

    assert S.dispatch_adaptive(fn, "spec", policy=S.HedgePolicy(deadline_s=2.5)) == "ok"
    assert seen == {"spec": "spec", "deadline_s": 2.5}
    with pytest.raises(S.DeadlineError):
        S.dispatch_adaptive(lambda **kw: time.sleep(0.5),
                            policy=S.HedgePolicy(deadline_s=0.05),
                            backstop_factor=2.0)
    with pytest.raises(ValueError, match="backstop_factor"):
        S.dispatch_adaptive(lambda **kw: None, policy=S.HedgePolicy(deadline_s=1.0),
                            backstop_factor=0.5)


def test_straggler_copy_pinned():
    fa = [(f.name, f.default) for f in dataclasses.fields(JS.HedgePolicy)]
    fb = [(f.name, f.default) for f in dataclasses.fields(TS.HedgePolicy)]
    assert fa == fb and issubclass(TS.DeadlineError, TimeoutError)


def test_dispatch_adaptive_degrades_through_port_session(handle):
    """A missed in-band deadline freezes the best-so-far answer with
    certificate='deadline' (the port's session behind the copy)."""
    sess = SimRankSession(handle, eps_a=0.3, top_k=3)
    env = TS.dispatch_adaptive(
        sess.query, QuerySpec(kind="single_source", node=0, epsilon=1e-6),
        policy=TS.HedgePolicy(deadline_s=1e-4), backstop_factor=1e6,
    )
    assert env.certificate == "deadline" and env.rounds == 1
    assert np.isfinite(env.certified_bound)


def test_retries_reported_through_port_session(handle):
    sess = SimRankSession(handle, eps_a=0.3, top_k=3)
    for b in (32, 16):  # first calls outside the deadline
        sess.query(QuerySpec(kind="topk", node=0, k=3), budget_walks=b)

    def flaky(spec, budget_walks=None):
        if budget_walks > 16:
            time.sleep(2.0)
        return sess.query(spec, budget_walks=budget_walks)

    res = TS.dispatch(
        flaky, QuerySpec(kind="topk", node=0, k=3),
        policy=TS.HedgePolicy(deadline_s=1.0, max_retries=2, shed_factor=0.5),
        budget=32, on_retry=lambda attempt: sess.record_retry(),
    )
    assert sess.stats.retries == 1 and res.walks_used == 16
    assert len(res.topk_nodes) == 3


# ---------------------------------------------------------------------------
# the service: tests/test_service.py's scenarios on the port
# ---------------------------------------------------------------------------


def test_microbatch_parity_and_fusion(handle):
    """N threads x 1 query via HTTP == a direct port session's solo replay,
    bitwise, and the window fused them (steps < queries)."""
    q = 16
    with live_server(handle, batch_window_ms=60.0) as (svc, host, port):
        results = [None] * q
        barrier = threading.Barrier(q)

        def go(i):
            with ServiceClient(host, port) as cl:
                barrier.wait(timeout=JOIN_S)
                results[i] = cl.query(node=i, kind="topk", k=5,
                                      budget_walks=64, seed=500 + i)

        threads = [threading.Thread(target=go, args=(i,)) for i in range(q)]
        for t in threads:
            t.start()
        _join_all(threads)
        assert all(r is not None for r in results)
        ref = _solo_replay(handle, [dict(kind="topk", node=i, k=5,
                                         budget_walks=64) for i in range(q)],
                           [500 + i for i in range(q)], svc.config.max_batch_q)
        for r, env in zip(results, ref):
            assert r["topk_nodes"] == np.asarray(env.topk_nodes).tolist()
            # JSON carries the float32 scores' exact float64 widenings
            assert np.array_equal(np.asarray(r["topk_scores"], np.float32),
                                  env.topk_scores)
            assert (r["version"], r["walks_used"]) == (env.version, env.walks_used)
        st = svc.stats_snapshot()["tenants"]["default"]
        assert st["queries"] == q and st["steps"] < q
        assert sum(svc.stats.batch_hist.values()) == svc.stats.batches
        assert max(svc.stats.batch_hist) > 1
        assert svc.stats.errors_5xx == 0


def test_single_source_roundtrip(handle):
    with live_server(handle) as (svc, host, port):
        with ServiceClient(host, port) as cl:
            r = cl.query(node=2, kind="single_source", budget_walks=32, seed=11)
        assert len(r["scores"]) == handle.n
        env, = _solo_replay(handle, [dict(kind="single_source", node=2,
                                          budget_walks=32)], [11],
                            svc.config.max_batch_q)
        assert np.array_equal(np.asarray(r["scores"], np.float32), env.scores)


def test_admission_control_429(handle):
    with live_server(handle, max_inflight=2, batch_window_ms=1500.0,
                     max_batch_q=64) as (svc, host, port):
        req = QueryRequest(node=1, budget_walks=16)
        items = [svc.enqueue(req), svc.enqueue(req)]
        with pytest.raises(AdmissionError) as ei:
            svc.enqueue(req)
        assert ei.value.retry_after_s > 0
        with ServiceClient(host, port) as cl:
            status, payload = cl.query_raw(node=1, budget_walks=16)
        assert status == 429 and payload["retry_after_s"] > 0
        assert svc.stats.rejected_429 == 2
        for it in items:
            assert it.event.wait(timeout=JOIN_S) and it.status == 200


def test_flat_deadline_sheds_504(handle):
    with live_server(handle, batch_window_ms=300.0) as (svc, host, port):
        with ServiceClient(host, port) as cl:
            status, payload = cl.query_raw(node=1, budget_walks=16,
                                           deadline_s=0.01)
        assert status == 504 and "deadline" in payload["error"]
        assert svc.stats.shed_504 == 1 and svc.stats.errors_5xx == 0


def test_adaptive_deadline_degrades_not_sheds(handle):
    with live_server(handle, batch_window_ms=1.0) as (svc, host, port):
        with ServiceClient(host, port) as cl:
            r = cl.query(node=3, epsilon=1e-6, confidence=0.99,
                         budget_walks=128, deadline_s=30.0)
        assert r["certificate"] in ("budget", "deadline")
        assert r["certified_bound"] > 0 and r["batch_size"] == 1


def test_tenants_isolated_stats_shared_graph(handle):
    with live_server(handle) as (svc, host, port):
        with ServiceClient(host, port, tenant="alice") as ca, \
                ServiceClient(host, port, tenant="bob") as cb:
            ra = ca.query(node=1, budget_walks=16)
            rb = cb.query(node=2, budget_walks=16)
            assert (ra["tenant"], rb["tenant"]) == ("alice", "bob")
            v0 = ra["version"]
            rep = ca.update(inserts=[(5, 6)])
            assert rep["version"] == v0 + 1
            ra2 = ca.query(node=1, budget_walks=16)
            rb2 = cb.query(node=2, budget_walks=16)
            assert ra2["version"] == rb2["version"] == v0 + 1
            stats = ca.stats()
        assert stats["tenants"]["alice"]["queries"] == 2
        assert stats["tenants"]["bob"]["queries"] == 2
        assert svc.session("alice") is not svc.session("bob")
        assert svc.session("alice").handle is svc.session("bob").handle
        # the service owns a copy: the caller's handle saw no update
        assert handle.version == 0 and svc.session("alice").handle is not handle
        with pytest.raises(ProtocolError, match="tenant"):
            svc.session("no spaces allowed")


def test_update_validation_and_health(handle):
    with live_server(handle) as (svc, host, port):
        with ServiceClient(host, port) as cl:
            h = cl.healthz()
            assert h["status"] == "ok" and h["n"] == handle.n
            assert h["backend"] == "local"
            with pytest.raises(RuntimeError, match="400"):
                cl.update(inserts=[])
            status, payload = cl.query_raw(node=10**6, budget_walks=16)
            assert status == 400 and "out of range" in payload["error"]
            status, _ = cl._request("GET", "/nowhere")
            assert status == 404


def test_service_close_rejects_503(handle):
    with live_server(handle) as (svc, host, port):
        pass
    with pytest.raises(ServiceClosed):
        svc.enqueue(QueryRequest(node=1, budget_walks=16))


def test_collector_survives_group_failure(handle):
    with live_server(handle) as (svc, host, port):
        svc.session("mallory").backend = None  # AttributeError at dispatch
        with ServiceClient(host, port, tenant="mallory") as cm:
            status, _ = cm.query_raw(node=1, budget_walks=16)
        assert status == 500 and svc.stats.errors_5xx == 1
        with ServiceClient(host, port) as cl:
            assert cl.query(node=1, budget_walks=16)["kind"] == "topk"


def test_admission_fair_to_turned_away_clients(handle):
    """Clients turned away at the bound wait in line for freed slots: the
    client just answered cannot take its slot back by resubmitting first,
    nor can an anonymous caller; the first max_batch_q places may take a
    free slot, a client further back may not, and the line keeps its
    order."""
    svc = SimRankService(handle, config=ServiceConfig(
        max_inflight=2, max_batch_q=1, batch_window_ms=0.0,
        default_budget_walks=16))
    svc._WAIT_HINTS = 10_000  # no place lapses while the test runs
    gate = threading.Semaphore(0)  # one permit per dispatch
    real = svc.session().backend.serve_batch

    def gated(*a, **kw):
        assert gate.acquire(timeout=JOIN_S)
        return real(*a, **kw)

    svc.session().backend.serve_batch = gated

    def settle(pending):  # the collector has taken all but `pending`
        t0 = time.monotonic()
        while len(svc._pending) != pending and time.monotonic() - t0 < JOIN_S:
            time.sleep(0.005)
        assert len(svc._pending) == pending

    req = QueryRequest(node=1, budget_walks=16)
    try:
        a = svc.enqueue(req, client="a")
        settle(0)
        b = svc.enqueue(req, client="b")
        for c in ("c", "d", "e"):
            with pytest.raises(AdmissionError):
                svc.enqueue(req, client=c)
        assert list(svc._owed) == ["c", "d", "e"]
        gate.release()  # a is answered; b is dispatched: one slot frees
        assert a.event.wait(timeout=JOIN_S) and a.status == 200
        settle(0)
        with pytest.raises(AdmissionError) as fresh:
            svc.enqueue(req, client="a")  # resubmits at once: back of the line
        with pytest.raises(AdmissionError):
            svc.enqueue(req)  # anonymous: no place
        with pytest.raises(AdmissionError) as behind:
            svc.enqueue(req, client="e")  # place 2: past the first one
        assert fresh.value.retry_after_s >= behind.value.retry_after_s > 0
        d = svc.enqueue(req, client="d")  # place 1: within the first one
        with pytest.raises(AdmissionError):
            svc.enqueue(req, client="c")  # no free slot left
        assert svc.inflight == 2 and list(svc._owed) == ["c", "e", "a"]
        assert svc.stats.rejected_429 == 7
        svc.forget_client("e")
        assert list(svc._owed) == ["c", "a"]
        svc._owed["c"] = time.monotonic() - 1.0  # c never came back
        with pytest.raises(AdmissionError):
            svc.enqueue(req, client="f")
        assert list(svc._owed) == ["a", "f"]  # c's place lapsed
    finally:
        for _ in range(4):
            gate.release()
        svc.close()
    assert not svc._collector.is_alive()
    for it in (b, d):
        assert it.event.wait(timeout=JOIN_S) and it.status == 200


def test_retry_hint_counts_the_dispatch_in_flight(handle):
    """The one place the port's admission departs from the reference's: a
    429's hint costs each cut at least the age of the dispatch in flight,
    so clients back off while the collector is slow.  With no dispatch in
    flight, or one younger than the window, the hints equal repro's."""
    import repro.serving.service as JSV
    from repro.api import GraphHandle as JHandle

    src, dst, n = _graph()
    cfg = dict(batch_window_ms=20.0, max_batch_q=4, max_inflight=8)
    svc = SimRankService(handle, config=ServiceConfig(**cfg))
    ref = JSV.SimRankService(JHandle.from_edges(src, dst, n),
                             config=JSV.ServiceConfig(**cfg))
    try:
        cases = [(8, None), (13, None), (40, None), (3, 2), (9, 2)]
        for ewma in (0.005, 0.02, 0.3):
            svc._ewma_batch_s = ref._ewma_batch_s = ewma
            for young in (None, 0.001):
                svc._dispatch_t0 = (None if young is None
                                    else time.monotonic() - young)
                assert [svc._retry_after_s(*c) for c in cases] == \
                    [ref._retry_after_s(*c) for c in cases]
        svc._dispatch_t0 = time.monotonic() - 1.0  # running for a second
        assert ref._retry_after_s(8) == pytest.approx(0.3)
        assert 1.0 <= svc._retry_after_s(8) < 2.0
        assert svc._retry_after_s(13) >= 2.0  # two cuts ahead
    finally:
        svc._dispatch_t0 = None
        svc.close()
        ref.close()
    assert not svc._collector.is_alive() and not ref._collector.is_alive()


def test_owed_claim_ends_with_the_connection(handle):
    with live_server(handle, max_inflight=1, batch_window_ms=250.0,
                     max_batch_q=64) as (svc, host, port):
        held = svc.enqueue(QueryRequest(node=1, budget_walks=16))
        with ServiceClient(host, port) as cl:
            status, _ = cl.query_raw(node=1, budget_walks=16)
            assert status == 429 and len(svc._owed) == 1
        t0 = time.monotonic()
        while svc._owed and time.monotonic() - t0 < JOIN_S:
            time.sleep(0.01)  # the handler thread forgets it on close
        assert not svc._owed
        assert held.event.wait(timeout=JOIN_S) and held.status == 200


def test_tenant_quota_greedy_vs_quiet(handle):
    svc = SimRankService(handle, config=ServiceConfig(
        max_inflight=64, tenant_max_inflight=2, batch_window_ms=250.0,
        max_batch_q=64, default_budget_walks=16))
    try:
        req = QueryRequest(node=1, budget_walks=16)
        greedy = [svc.enqueue(req, "greedy"), svc.enqueue(req, "greedy")]
        with pytest.raises(AdmissionError):
            svc.enqueue(req, "greedy")
        assert svc.stats.rejected_429 == 1
        quiet = svc.enqueue(req, "quiet")
        for item in greedy + [quiet]:
            assert item.event.wait(timeout=JOIN_S) and item.status == 200
        assert svc.enqueue(req, "greedy").event.wait(timeout=JOIN_S)
        snap = svc.stats_snapshot()["service"]
        assert snap["tenant_max_inflight"] == 2 and snap["tenant_inflight"] == {}
    finally:
        svc.close()
    assert not svc._collector.is_alive()


def test_cut_window_priority_lane(handle):
    from repro_torch.serving.service import _PendingQuery

    svc = SimRankService(handle, config=ServiceConfig(max_batch_q=2,
                                                      batch_window_ms=0.0))
    svc.close()  # stop the collector; drive _cut_window by hand
    assert not svc._collector.is_alive()

    def pend(name, t_enq, t_deadline):
        it = _PendingQuery(None, None, "t", t_enq, t_deadline)
        it.payload = {"name": name}
        return it

    svc._pending.extend([pend("free-a", 1.0, None), pend("free-b", 2.0, None),
                         pend("dl-late", 3.0, 50.0), pend("dl-soon", 4.0, 10.0)])
    assert [it.payload["name"] for it in svc._cut_window()] == ["dl-soon", "dl-late"]
    assert [it.payload["name"] for it in svc._pending] == ["free-a", "free-b"]
    assert [it.payload["name"] for it in svc._cut_window()] == ["free-a", "free-b"]
    assert not svc._pending


def test_service_config_validation(handle):
    for kw in (dict(tenant_max_inflight=0), dict(max_batch_q=0),
               dict(max_inflight=0), dict(batch_window_ms=-1.0)):
        with pytest.raises(ValueError):
            ServiceConfig(**kw)
    with pytest.raises(TypeError):
        SimRankService(object())
    with pytest.raises(ValueError, match="backend"):
        SimRankService(handle, backend="mesh")
    with pytest.raises(ValueError, match="owned by the service"):
        SimRankService(handle, session_kwargs=dict(batch_q=4))


# ---------------------------------------------------------------------------
# the service held against repro's: one script of requests, both packages
# ---------------------------------------------------------------------------


def _stub_rows(us, n, n_r, version):
    """Rows that depend only on (node, walk budget, graph version): the two
    packages draw their walks from different generators, so both serve
    these instead (noise shrinks as 1/sqrt(n_r), so adaptive escalation
    still meets its certificates)."""
    rows = []
    for u in us:
        rng = np.random.default_rng([int(u), int(n_r), int(version)])
        base = rng.uniform(0, 0.3, n) * (rng.uniform(0, 1, n) < 0.3)
        noise = rng.standard_normal(n) * (int(u) % 3) / np.sqrt(n_r)
        rows.append(np.clip(base + noise, 0.0, 1.0))
    return np.stack(rows).astype(np.float32)


@pytest.fixture()
def stub_rows(monkeypatch):
    """Both packages' ``LocalBackend`` serve ``_stub_rows`` (updates stay
    real); returns the set of nodes whose dispatch raises."""
    import repro.api.backend as JB
    import repro_torch.api.backend as TB

    failing: set[int] = set()

    def serve_batch(self, kind, us, streams, *, k=0, n_r, **_):
        bad = failing & {int(u) for u in us}
        if bad:
            raise RuntimeError(f"stub dispatch failed on node {min(bad)}")
        est = _stub_rows(us, self.handle.n, n_r, int(self.handle.version))
        if kind != "topk":
            return est, None, None
        idx = np.argsort(-est, axis=1, kind="stable")[:, :k].astype(np.int32)
        return None, idx, np.take_along_axis(est, idx, 1)

    def epoch_batch(self, batch, us, streams, *, n_r, top_k, **_):
        applied = np.asarray(self.handle.apply_batch(batch))
        if us is None:
            return applied, None, None, None
        kind = "topk" if top_k else "single_source"
        est, idx, vals = serve_batch(self, kind, us, streams, k=top_k, n_r=n_r)
        return applied, est, idx, vals

    def serve_one(self, *a, **kw):
        raise AssertionError("these paths dispatch through serve_batch")

    for mod in (JB, TB):
        monkeypatch.setattr(mod.LocalBackend, "serve_batch", serve_batch)
        monkeypatch.setattr(mod.LocalBackend, "epoch_batch", epoch_batch)
        monkeypatch.setattr(mod.LocalBackend, "serve_one", serve_one)
    return failing


def _services(cfg_kw, **kw):
    """(repro's service, the port's) over handles of the same edges."""
    import repro.serving as JS
    from repro.api import GraphHandle as JHandle

    src, dst, n = _graph()
    out = []
    for mod, h in (
        (JS, JHandle.from_edges(src, dst, n, capacity=400, k_max=64)),
        (TSERV, GraphHandle.from_edges(src, dst, n, capacity=400,
                                       k_max=64, device=CPU)),
    ):
        out.append((mod, mod.SimRankService(
            h, config=mod.ServiceConfig(**cfg_kw), **kw)))
    return out


def _wire(payload):
    """A reply without its timing: latency, queue delay, and the measured
    seconds that 504 messages quote."""
    d = {k: v for k, v in payload.items()
         if k not in ("latency_s", "queue_delay_s")}
    if "error" in d:
        d["error"] = d["error"].split(" (queued")[0]
    return d


def _held(mod, svc, reqs, hold_s=0.0):
    """Enqueue ``reqs`` ((wire body, tenant) pairs) with the collector held
    off (under the service's condition), wait ``hold_s`` more, let go, and
    wait for every answer.  Returns each request's outcome: an exception's
    (class, message[, hint, depth]) or the answer's (status, wire reply).
    The batch-time EWMA is a measured time, so both services start the
    step from the same value (the window), and the collector is idle."""
    t0 = time.monotonic()
    while (svc._pending or getattr(svc, "_dispatch_t0", None) is not None) \
            and time.monotonic() - t0 < JOIN_S:
        time.sleep(0.002)
    svc._ewma_batch_s = max(svc.config.batch_window_ms / 1e3, 1e-3)
    out, items = [], []
    with svc._cond:
        for body, tenant in reqs:
            try:
                req = mod.parse_query_request(body)
                items.append(svc.enqueue(req, tenant))
                out.append(None)
            except mod.AdmissionError as e:
                out.append(("AdmissionError", str(e), e.retry_after_s, e.depth))
            except (mod.ProtocolError, mod.ServiceClosed) as e:
                out.append((type(e).__name__, str(e)))
        time.sleep(hold_s)
    for it in items:
        assert it.event.wait(timeout=JOIN_S)
    answers = iter(items)
    for i, o in enumerate(out):
        if o is None:
            it = next(answers)
            out[i] = (it.status, _wire(it.payload))
    return out


def _update(mod, svc, inserts=None, deletes=None):
    try:
        return svc.apply_update(
            None if inserts is None else np.asarray(inserts, np.int32),
            None if deletes is None else np.asarray(deletes, np.int32))
    except Exception as e:
        return (type(e).__name__, str(e))


def _topk(node, tenant="default", **kw):
    return (dict(node=node, kind="topk", k=5, budget_walks=32, **kw), tenant)


SCRIPTS = {
    # one tenant and two, pinned seeds and not, two kinds: cuts of 4
    "fusion": (dict(batch_window_ms=10.0, max_batch_q=4), [
        ("held", [_topk(u, seed=100 + u) for u in range(5)]
         + [_topk(u) for u in (5, 6, 7)]
         + [(dict(node=u, kind="single_source", budget_walks=32), "b")
            for u in (1, 2, 3)], 0.02),
        ("held", [_topk(9, seed=3), _topk(9, seed=3)], 0.02),
    ]),
    # the global bound: the last three 429 with the reference's hints
    "admission": (dict(batch_window_ms=20.0, max_batch_q=2, max_inflight=3), [
        ("held", [_topk(u) for u in range(6)], 0.03),
        ("held", [_topk(u, seed=u) for u in range(4)], 0.03),
    ]),
    # a tenant's quota: the greedy tenant 429s, the quiet one admits
    "quota": (dict(batch_window_ms=20.0, max_batch_q=8, max_inflight=64,
                   tenant_max_inflight=2), [
        ("held", [_topk(1, "greedy"), _topk(2, "greedy"), _topk(3, "greedy"),
                  _topk(4, "quiet"), _topk(5, "greedy")], 0.03),
        ("held", [_topk(6, "greedy")], 0.03),
    ]),
    # flat queries past their deadline shed 504; an adaptive one degrades
    # to its in-band deadline (here long enough to end by certificate)
    "deadlines": (dict(batch_window_ms=5.0, max_batch_q=8,
                       min_adaptive_deadline_s=20.0), [
        ("held", [_topk(1, deadline_s=0.005), _topk(2)]
         + [(dict(node=u, kind="single_source", epsilon=0.1,
                  deadline_s=0.005), "default") for u in (3, 4)]
         + [(dict(node=5, kind="topk", k=4, epsilon=0.1, deadline_s=0.005),
             "default")], 0.05),
        ("held", [(dict(node=u, kind="single_source", epsilon=0.1,
                        budget_walks=4096), "default") for u in (6, 7, 8)],
         0.02),
    ]),
    # an overflowing window: deadline-bearing queries take the cut first
    "priority": (dict(batch_window_ms=5.0, max_batch_q=2), [
        ("held", [_topk(1), _topk(2), _topk(3, deadline_s=30.0),
                  _topk(4, deadline_s=20.0), _topk(5)], 0.02),
    ]),
    # updates between queries, a skipped delete, an invalid batch, and a
    # regrow past the COO buffer
    "updates": (dict(batch_window_ms=5.0, max_batch_q=4), [
        ("held", [_topk(u, seed=u) for u in range(4)], 0.01),
        ("update", [[1, 2], [3, 4]], [[40, 41]]),
        ("update", None, [[1, 2]]),
        ("update", [[1, 99]], None),
        ("held", [_topk(u, seed=u) for u in range(4)], 0.01),
        ("update", [[i % 48, (i * 7 + 1) % 48] for i in range(120)], None),
        ("held", [_topk(u, "other", seed=u) for u in range(3)], 0.01),
    ]),
    # a failing group 500s; the collector goes on serving
    "failure": (dict(batch_window_ms=5.0, max_batch_q=8), [
        ("fail", {13}),
        ("held", [_topk(13), _topk(2, "b")], 0.01),
        ("fail", set()),
        ("held", [_topk(13), _topk(2, "b")], 0.01),
    ]),
    # bad requests 400; after close every enqueue 503s
    "close": (dict(batch_window_ms=5.0, max_batch_q=8), [
        ("held", [_topk(2), (dict(node=48, kind="topk"), "default"),
                  (dict(node=1), "bad tenant!")], 0.01),
        ("close",),
        ("held", [_topk(2)], 0.0),
    ]),
}


def _run_script(mod, svc, steps, failing):
    out = []
    for step in steps:
        if step[0] == "held":
            out.append(_held(mod, svc, step[1], step[2]))
        elif step[0] == "update":
            out.append(_update(mod, svc, step[1], step[2]))
        elif step[0] == "fail":
            failing.clear()
            failing.update(step[1])
        elif step[0] == "close":
            svc.close()
            out.append(svc.healthz())
    snap = svc.stats_snapshot()
    out.append(snap)
    out.append(svc.healthz())
    return out


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_service_equals_repro_on_one_script(name, stub_rows):
    """Both packages' SimRankService, fed the same requests in the same
    cuts over rows that depend only on (node, budget, version): equal
    statuses, wire replies (batch_size and tenant included), 400 / 429 /
    503 messages, Retry-After hints and depths, 504s, update reports, and
    the /stats and /healthz payloads at the end.  No request names a
    client, so the port's admission line never forms
    (``test_admission_fair_to_turned_away_clients`` shows it when one
    does)."""
    cfg_kw, steps = SCRIPTS[name]
    runs = []
    for mod, svc in _services(cfg_kw, seed=5):
        try:
            runs.append(_run_script(mod, svc, steps, stub_rows))
        finally:
            svc.close()
        assert not svc._collector.is_alive()
        assert not getattr(svc, "_owed", None)  # no client named, no line
    ref, port = runs
    assert port == ref
    snap = port[-2]["service"]
    assert snap["served"] + snap["rejected_429"] + snap["shed_504"] > 0
    if name == "admission":
        assert snap["rejected_429"] == 4
    if name == "deadlines":
        assert snap["shed_504"] == 1 and snap["batch_hist"].get("1", 0) >= 3


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 3])
def test_tenant_seed_equals_repro(seed):
    import repro.serving.service as JSV
    import repro_torch.serving.service as TSV

    for tenant in ("default", "a", "stream", "tenant-x.1", "Z" * 64):
        assert TSV._tenant_seed(tenant, seed) == JSV._tenant_seed(tenant, seed)


def test_shims_equal_repro(stub_rows):
    """Both packages' SimRankEngine and DynamicEngine, the same calls over
    the stub rows: equal envelopes (latency aside), versions and stats."""
    import repro.serving as JS
    from repro.api import GraphHandle as JHandle

    src, dst, n = _graph()
    runs = []
    for mod, h in ((JS, JHandle.from_edges(src, dst, n, capacity=400,
                                           k_max=64)),
                   (TSERV, GraphHandle.from_edges(src, dst, n, capacity=400,
                                                  k_max=64, device=CPU))):
        out = []
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            eng = mod.SimRankEngine(h.g, h.eg, top_k=5, batch_q=4, seed=3)
            dyn = mod.DynamicEngine(h.g, h.eg, top_k=5, batch_q=2,
                                    update_batch=8, seed=4, use_kernel=False)
        out.append(_env_dict(eng.run_query(4, budget_walks=64)))
        for u in (1, 2, 7, 9, 11):
            eng.submit(u)
        out += [_env_dict(e) for e in eng.drain(budget_walks=64)]
        eng.insert(np.array([5]), np.array([6]))
        eng.delete(np.array([5]), np.array([6]))
        out.append((eng.version, eng.overflow, eng.stats.as_dict()))
        dyn.insert([1, 2, 3], [4, 5, 6])
        dyn.delete([1], [4])
        for u in (0, 9, 12):
            dyn.submit(u)
        for er in dyn.drain(budget_walks=64):
            out.append((er.version, er.updates_applied, er.updates_submitted,
                        [_env_dict(e) for e in er.results]))
        out.append((dyn.version, dyn.pending, vars(dyn.stats)))
        runs.append(out)
    assert runs[1] == runs[0]


def _env_dict(e):
    d = dataclasses.asdict(e)
    d.pop("latency_s")
    for f, v in d.items():
        if isinstance(v, (np.ndarray, torch.Tensor)):
            d[f] = np.asarray(v).tolist()
        elif isinstance(v, float) and v != v:
            d[f] = "nan"
    return d


# ---------------------------------------------------------------------------
# the backstop: an abandoned worker and the in-place mirrors
# ---------------------------------------------------------------------------


def test_backstop_504_then_update_equals_rebuild(handle):
    """The update waits for the adaptive worker the backstop abandoned
    until its query ends (it never writes under the query, though the
    query runs in another tenant's session, whose lock the update does not
    take), and the answers after the update equal a session's on a
    rebuild of the updated graph, bitwise."""
    cfg = dict(batch_window_ms=1.0, adaptive_backstop_factor=2.0)
    with live_server(handle, **cfg) as (svc, host, port):
        sess = svc.session("slow")
        real = sess.backend.serve_batch
        seen, done = [], threading.Event()

        def wedged(*a, **kw):  # the first call outlives the backstop
            if not done.is_set():
                v0 = svc.version
                time.sleep(1.5)
                out = real(*a, **kw)
                seen.append((v0, svc.version))
                done.set()
                return out
            return real(*a, **kw)

        sess.backend.serve_batch = wedged
        with ServiceClient(host, port, tenant="slow") as slow, \
                ServiceClient(host, port) as cl:
            t0 = time.monotonic()
            status, payload = slow.query_raw(node=3, epsilon=1e-6,
                                             budget_walks=128, deadline_s=0.05)
            shed_s = time.monotonic() - t0
            assert status == 504 and "backstop" in payload["error"]
            assert shed_s < 1.5 and not done.is_set()  # answered, not waited
            rep = svc.apply_update(inserts=np.array([[5, 6], [7, 8]]))
            assert done.is_set()  # the update ran after the worker ended
            assert seen == [(0, 0)]  # no write landed under the query
            assert rep["version"] == 1 and rep["applied"] == 2
            replies = [cl.query(node=u, kind="topk", k=5, budget_walks=64,
                                seed=90 + u) for u in range(6)]
        assert svc.stats.shed_504 == 1 and svc.stats.errors_5xx == 0
        h = svc.session().handle
        src, dst = h.to_host_edges()
        rb = GraphHandle.from_edges(src, dst, h.n, capacity=h.capacity,
                                    k_max=h.k_max, device=CPU)
        for a, b in ((h.g.src, rb.g.src), (h.g.dst, rb.g.dst),
                     (h.eg.in_nbrs, rb.eg.in_nbrs), (h.eg.in_deg, rb.eg.in_deg)):
            assert torch.equal(a, b)
        ref = _solo_replay(rb, [dict(kind="topk", node=u, k=5, budget_walks=64)
                                for u in range(6)], [90 + u for u in range(6)],
                           svc.config.max_batch_q)
        for r, env in zip(replies, ref):
            assert r["topk_nodes"] == env.topk_nodes.tolist()
            assert np.array_equal(np.asarray(r["topk_scores"], np.float32),
                                  env.topk_scores)
            assert r["version"] == 1


def test_wedged_adaptive_dispatch_holds_back_only_updates(handle):
    """What a client sees when an abandoned adaptive dispatch does not end:
    its request gets 504, other tenants' queries go on being answered at
    the old version, and an update waits (it would write the mirrors under
    the query) until the dispatch ends; then it applies and the next
    answer reports the new version."""
    with live_server(handle, batch_window_ms=1.0,
                     adaptive_backstop_factor=2.0) as (svc, host, port):
        sess = svc.session("slow")
        real = sess.backend.serve_batch
        release = threading.Event()

        def wedged(*a, **kw):
            assert release.wait(timeout=JOIN_S)
            return real(*a, **kw)

        sess.backend.serve_batch = wedged
        upd = {}
        writer = threading.Thread(target=lambda: upd.update(
            svc.apply_update(inserts=np.array([[5, 6]]))))
        try:
            with ServiceClient(host, port, tenant="slow") as slow, \
                    ServiceClient(host, port) as cl:
                status, payload = slow.query_raw(
                    node=3, epsilon=1e-6, budget_walks=128, deadline_s=0.05)
                assert status == 504 and "backstop" in payload["error"]
                before = [cl.query(node=u, kind="topk", k=5, budget_walks=64)
                          for u in range(3)]
                assert [r["version"] for r in before] == [0, 0, 0]
                writer.start()
                writer.join(timeout=0.5)
                assert writer.is_alive() and svc.version == 0  # held back
                during = cl.query(node=4, kind="topk", k=5, budget_walks=64)
                assert during["version"] == 0 and writer.is_alive()
                release.set()
                writer.join(timeout=JOIN_S)
                assert not writer.is_alive()
                assert upd["version"] == 1 and upd["applied"] == 1
                after = cl.query(node=4, kind="topk", k=5, budget_walks=64)
                assert after["version"] == 1
        finally:
            release.set()
            if writer.ident is not None:
                writer.join(timeout=JOIN_S)
        assert not writer.is_alive()
        assert svc.stats.shed_504 == 1 and svc.stats.errors_5xx == 0


# ---------------------------------------------------------------------------
# thread safety of the module-level kernel caches
# ---------------------------------------------------------------------------


def test_plan_of_from_many_threads():
    """Threads asking for the plans of the same and of different row_len
    tensors at once: one build per tensor (and per in-place change), every
    caller gets the kept plan, no exception."""
    from repro_torch.kernels import ell_plan

    rng = np.random.default_rng(0)
    lens = [torch.from_numpy(rng.integers(0, 300, 64).astype(np.int32))
            for _ in range(3)]
    ell_plan.clear_plans()
    ell_plan.build_plan.builds = 0
    errors, got = [], []
    barrier = threading.Barrier(12)

    def ask(i):
        try:
            barrier.wait(timeout=JOIN_S)
            for _ in range(20):
                rl = lens[i % 3]
                got.append((i % 3, ell_plan.plan_of(rl, 300)))
        except Exception as e:  # surfaced below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        _join_all(threads)
        assert not errors and ell_plan.build_plan.builds == 3
        for j in range(3):
            assert len({id(p) for i, p in got if i == j}) == 1
        lens[1].add_(0)  # written in place: a new _version
        got.clear()
        barrier = threading.Barrier(12)
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        _join_all(threads)
    finally:
        sys.setswitchinterval(old)
        ell_plan.clear_plans()
    assert not errors and ell_plan.build_plan.builds == 4


def test_build_load_once_from_many_threads(monkeypatch):
    """Concurrent first loads of one kernel library build and load it once."""
    from repro_torch.kernels import _build

    builds, lib = [], object()

    def fake_build(names):
        builds.append(names)
        time.sleep(0.05)

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build_all", fake_build)
    monkeypatch.setattr(_build, "ctypes", types.SimpleNamespace(CDLL=lambda p: lib))
    out = []
    threads = [threading.Thread(target=lambda: out.append(_build.load("k")))
               for _ in range(8)]
    for t in threads:
        t.start()
    _join_all(threads)
    assert builds == [("k",)] and len(out) == 8 and all(x is lib for x in out)


# ---------------------------------------------------------------------------
# the deprecated shims, the launcher and the quickstart
# ---------------------------------------------------------------------------


def _top_fields(env):
    return (env.node, env.topk_nodes.tolist(), env.topk_scores.tolist(),
            env.version, env.walks_used, env.error_bound)


def test_simrank_engine_shim_warns_and_delegates():
    from repro_torch.serving import SimRankEngine

    src, dst, n = _graph()
    handle = GraphHandle.from_edges(src, dst, n, capacity=400, k_max=64,
                                    device=CPU)

    with pytest.warns(DeprecationWarning, match="SimRankSession"):
        eng = SimRankEngine(handle.g, handle.eg, top_k=5, batch_q=4, seed=3)
    sess = SimRankSession(handle, top_k=5, batch_q=1, seed=3, auto_regrow=False)
    one = eng.run_query(4, budget_walks=64)
    sess.submit(4)
    assert _top_fields(one) == _top_fields(sess.drain(budget_walks=64)[0])
    batch = SimRankSession(handle, top_k=5, batch_q=4, seed=3)
    batch.submit(0)  # seq 0 went to run_query in the engine
    batch.drain(budget_walks=64)
    for u in (1, 2, 7, 9, 11):
        eng.submit(u)
        batch.submit(u)
    got = eng.drain(budget_walks=64)
    want = batch.drain(budget_walks=64)
    assert [_top_fields(e) for e in got] == [_top_fields(e) for e in want]
    eng.insert(np.array([5]), np.array([6]))
    assert eng.version == 1 and handle.version == 0  # the shim owns a copy
    assert eng.stats.queries == 6 and eng.session.stats is eng.stats


def test_dynamic_engine_shim_warns_and_delegates(handle):
    from repro_torch.serving import DynamicEngine

    with pytest.warns(DeprecationWarning, match="epoch"):
        eng = DynamicEngine(handle.g, handle.eg, top_k=5, batch_q=2,
                            update_batch=8, seed=4)
    sess = SimRankSession(handle, top_k=5, batch_q=2, update_batch=8, seed=4)
    eng.insert([1, 2, 3], [4, 5, 6])
    eng.delete([1], [4])
    for u in (0, 9):
        eng.submit(u)
    got = eng.drain(budget_walks=64)
    sess.queue_update([1, 2, 3], [4, 5, 6], insert=True)
    sess.queue_update([1], [4], insert=False)
    for u in (0, 9):
        sess.submit(u)
    want = sess.drain_epochs(budget_walks=64)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.version, a.updates_applied, a.updates_submitted) == \
            (b.version, b.updates_applied, b.updates_submitted)
        assert [_top_fields(e) for e in a.results] == \
            [_top_fields(e) for e in b.results]
    assert eng.stats.epochs == sess.stats.epochs and eng.pending == (0, 0)
    assert eng.use_kernel is True
    with pytest.raises(ValueError, match="top_k"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            DynamicEngine(handle.g, handle.eg, top_k=0)


TOY_LAUNCH = ["--device", "cpu", "--nodes", "200", "--edges", "1200",
              "--queries", "3", "--walk-budget", "64",
              "--updates-per-batch", "16", "--top-k", "5"]


@pytest.mark.parametrize("mode", ["flat", "epochs", "adaptive"])
def test_launcher_in_process(mode, capsys):
    from repro_torch.launch import serve

    extra = {"flat": [], "epochs": ["--epochs"],
             "adaptive": ["--epsilon", "0.2", "--deadline-s", "30"]}[mode]
    served = serve.main(TOY_LAUNCH + extra)
    assert [e.version for e in served] == [1, 2, 3]
    for e in served:
        assert e.topk_nodes.shape == (5,) and np.isfinite(e.topk_scores).all()
        assert e.node not in e.topk_nodes.tolist()
    out = capsys.readouterr().out
    assert "on cpu" in out and "latency:" in out
    with pytest.raises(SystemExit):
        serve.main(TOY_LAUNCH + ["--epochs", "--epsilon", "0.1"])


def test_quickstart_in_process(capsys):
    from repro_torch.examples import quickstart

    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "max abs error" in out and "HTTP top-3" in out


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_service_on_card_equals_cpu(monkeypatch):
    """The service's answers on a CUDA handle equal the CPU's when both
    draw the same walks (the walk uniforms drawn on the CPU): flat top-k
    at fp32 1e-5 (kernel against plain summation order), versions equal."""
    needs_cuda()
    import repro_torch.core.multisource as ms
    from repro_torch.core.walks import make_generator

    real = ms.batch_uniforms
    monkeypatch.setattr(ms, "make_generator",
                        lambda seed, dev: make_generator(seed, CPU))
    monkeypatch.setattr(
        ms, "batch_uniforms",
        lambda gens, *, device, **kw: tuple(
            x.to(device) for x in real(gens, device=CPU, **kw)))
    src, dst, n = _graph(n=300, m=2400, seed=2)
    runs = []
    for dev in (CPU, "cuda"):
        h = GraphHandle.from_edges(src, dst, n, device=dev)
        svc = SimRankService(h, config=ServiceConfig(
            batch_window_ms=20.0, max_batch_q=8, default_budget_walks=256))
        try:
            items = [svc.enqueue(QueryRequest(node=u, k=10, seed=40 + u))
                     for u in range(12)]
            for it in items:
                assert it.event.wait(timeout=JOIN_S) and it.status == 200
            svc.apply_update(inserts=np.array([[1, 2], [3, 4]]))
            after = svc.serve_request(QueryRequest(node=2, k=10, seed=7))
            runs.append([it.payload for it in items] + [after[1]])
        finally:
            svc.close()
    for a, b in zip(*runs):
        assert a["version"] == b["version"] and a["node"] == b["node"]
        np.testing.assert_allclose(b["topk_scores"], a["topk_scores"],
                                   rtol=0, atol=1e-5)
