"""repro_torch.streams held against repro.streams on the CPU.

* The arrival generators and the sliding-window expirer are copies: the
  same seeds give bitwise the same streams, expiries and batches.
* The TTL window maintained through the port's session stays bitwise equal
  to a rebuild of the live window and to the reference's mirrors, across
  interleaves, an overflow regrow and an emptied window.
* ``StreamDriver`` driven through both packages' transports makes the
  same bursts (op runs in stream order) and the same query nodes, counts
  the same arrivals, expiries, applied ops, update steps and ticks, and
  its answers observe the same versions; the mirrors end equal.  Scores
  differ (the packages draw different walks) and are not compared.
* ``churn_checkpoint`` gives the same pooled metrics when both packages
  get the same served lists, the same scout lists and the same expert
  scores.
"""
import types

import numpy as np
import pytest
import torch

import jax

import repro.core.pooling as jpool
import repro.streams as JST
import repro.streams.churn as jchurn
import repro_torch.core.pooling as tpool
import repro_torch.streams as TST
import repro_torch.streams.churn as tchurn
from repro.api.handle import GraphHandle as JHandle
from repro.api.session import SimRankSession as JSession
from repro.graph import ell_from_edges as j_ell, graph_from_edges as j_coo
from repro_torch.api import GraphHandle, SimRankSession
from repro_torch.core.walks import derive_seed
from repro_torch.graph import ell_from_edges, graph_from_edges
from torch_port_helpers import CPU

N = 40


def _mirrors(h):
    """Every mirror field of a handle of either package, on the host."""
    g, eg = h.g, h.eg
    return dict(
        src=np.asarray(g.src), dst=np.asarray(g.dst),
        in_deg=np.asarray(g.in_deg), out_deg=np.asarray(g.out_deg),
        num_edges=int(g.num_edges), in_nbrs=np.asarray(eg.in_nbrs),
        ell_in_deg=np.asarray(eg.in_deg), version=int(eg.version),
        overflow=bool(g.overflow), n=g.n,
    )


def _assert_mirrors_equal(a, b):
    ma, mb = _mirrors(a), _mirrors(b)
    assert ma.keys() == mb.keys()
    for k in ma:
        np.testing.assert_array_equal(ma[k], mb[k], err_msg=k)


def _empty_sessions(n=N, *, capacity=512, k_max=32, **kw):
    """A reference and a port session over the same empty graph."""
    kw.setdefault("top_k", 8)
    e = np.empty(0, np.int32)
    js = JSession(JHandle.from_edges(e, e, n, capacity=capacity, k_max=k_max),
                  **kw)
    ts = SimRankSession(GraphHandle.from_edges(e, e, n, capacity=capacity,
                                               k_max=k_max, device=CPU), **kw)
    return js, ts


def _assert_window_equals_rebuild(sess, expirer):
    h = sess.backend.handle
    src, dst = expirer.live_edges()
    g = graph_from_edges(src, dst, h.n, capacity=h.g.capacity, device=CPU)
    eg = ell_from_edges(src, dst, h.n, k_max=h.eg.k_max, device=CPU)
    for a, b in ((h.g.src, g.src), (h.g.dst, g.dst), (h.g.in_deg, g.in_deg),
                 (h.g.out_deg, g.out_deg), (h.eg.in_nbrs, eg.in_nbrs),
                 (h.eg.in_deg, eg.in_deg)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# events: generators and the expirer are copies
# ---------------------------------------------------------------------------

GENERATORS = [
    ("poisson", dict(n=100, rate=2_000, horizon=1.0, seed=3)),
    ("poisson", dict(n=34_546, rate=50_000, horizon=0.2, seed=0)),
    ("bursty", dict(n=100, rate_on=4_000, mean_on=0.05, mean_off=0.2,
                    horizon=2.0, seed=5)),
    ("bursty", dict(n=500, rate_on=10_000, rate_off=50.0, mean_on=0.15,
                    mean_off=0.3, horizon=1.0, seed=1)),
    ("preferential", dict(n=200, rate=3_000, horizon=1.0, seed=7)),
    ("preferential", dict(n=50, rate=500, horizon=0.5, seed=2, p_uniform=1.0)),
]
MAKERS = {"poisson": "poisson_edge_stream", "bursty": "bursty_edge_stream",
          "preferential": "preferential_attachment_stream"}


@pytest.mark.parametrize("name,kw", GENERATORS,
                         ids=[f"{g}{i}" for i, (g, _) in enumerate(GENERATORS)])
def test_generators_equal_repro(name, kw):
    a = getattr(JST, MAKERS[name])(**kw)
    b = getattr(TST, MAKERS[name])(**kw)
    assert len(a) > 0 and (a.n, len(a)) == (b.n, len(b))
    for f in ("t", "src", "dst"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _raises_same(fa, fb):
    with pytest.raises(ValueError) as ea:
        fa()
    with pytest.raises(ValueError) as eb:
        fb()
    assert str(ea.value) == str(eb.value)


def test_event_stream_validation_equal():
    for args in (([1.0, 0.5], [0, 1], [1, 2], 10), ([1.0], [0, 1], [1, 2], 10),
                 ([1.0], [0], [10], 10)):
        _raises_same(lambda: JST.EventStream(*args),
                     lambda: TST.EventStream(*args))
    for make, kw in (("poisson_edge_stream", dict(n=1, rate=1.0, horizon=1.0)),
                     ("poisson_edge_stream", dict(n=5, rate=0.0, horizon=1.0)),
                     ("bursty_edge_stream", dict(n=5, rate_on=1.0, mean_on=0.0,
                                                 mean_off=1.0, horizon=1.0)),
                     ("preferential_attachment_stream",
                      dict(n=5, rate=1.0, horizon=1.0, p_uniform=0.0))):
        _raises_same(lambda: getattr(JST, make)(**kw),
                     lambda: getattr(TST, make)(**kw))
    a = JST.EventStream([0.1, 0.2, 0.3], [0, 1, 2], [1, 2, 3], 10)
    b = TST.EventStream([0.1, 0.2, 0.3], [0, 1, 2], [1, 2, 3], 10)
    ca, cb = a.slice_time(0.1, 0.25), b.slice_time(0.1, 0.25)
    assert (len(cb), int(cb.src[0]), cb.horizon) == (len(ca), int(ca.src[0]),
                                                     ca.horizon)
    assert list(a.events()) == [JST.EdgeEvent(e.t, e.src, e.dst, e.insert)
                                for e in b.events()]


def test_expirer_equal_repro():
    """The same ingest/expire sequence through both expirers: the same
    delete ops, live window, counters and padded delete batches."""
    stream = JST.poisson_edge_stream(60, 3_000, 2.0, seed=4)
    ja, ta = JST.SlidingWindowExpirer(0.3), TST.SlidingWindowExpirer(0.3)
    lo = 0.0
    for hi in np.arange(0.05, 2.6, 0.05):
        cut = stream.slice_time(lo, float(hi))
        assert ja.ingest(cut.t, cut.src, cut.dst) == ta.ingest(cut.t, cut.src,
                                                               cut.dst)
        if int(hi * 20) % 3:
            for x, y in zip(ja.expire_until(float(hi)),
                            ta.expire_until(float(hi))):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
        else:
            jb = ja.expire_batches(float(hi), batch_size=16, n=60)
            tb = ta.expire_batches(float(hi), batch_size=16, n=60, device=CPU)
            assert len(jb) == len(tb)
            for x, y in zip(jb, tb):
                for f in ("src", "dst", "insert"):
                    np.testing.assert_array_equal(np.asarray(getattr(x, f)),
                                                  getattr(y, f).numpy())
                assert bool(x.has_deletes) == y.has_deletes
        assert (ja.live, ja.oldest_t, ja.expired_total) == \
            (ta.live, ta.oldest_t, ta.expired_total)
        for x, y in zip(ja.live_edges() + (ja.live_times(),),
                        ta.live_edges() + (ta.live_times(),)):
            np.testing.assert_array_equal(x, y)
        lo = float(hi)
    assert ta.expired_total > 4096  # the compaction branch ran
    _raises_same(lambda: ja.expire_until(0.1), lambda: ta.expire_until(0.1))
    _raises_same(lambda: ja.ingest([0.5], [0], [1]),
                 lambda: ta.ingest([0.5], [0], [1]))
    _raises_same(lambda: JST.SlidingWindowExpirer(0.0),
                 lambda: TST.SlidingWindowExpirer(0.0))


def test_expire_batches_apply_equals_rebuild():
    rng = np.random.default_rng(0)
    n, m = 30, 60
    src = rng.integers(0, n, m).astype(np.int32)
    dst = (src + 1 + rng.integers(0, n - 1, m).astype(np.int32)) % n
    t = np.sort(rng.uniform(0, 1, m))
    h = GraphHandle.from_edges(src, dst, n, capacity=128, k_max=32, device=CPU)
    ex = TST.SlidingWindowExpirer(ttl=0.4)
    ex.ingest(t, src, dst)
    batches = ex.expire_batches(1.0, batch_size=16, n=n, device=CPU)
    assert len(batches) >= 2
    for b in batches:
        assert b.has_deletes and not bool(b.insert.any())
        applied = h.apply_batch(b)
        assert applied[b.src < n].all()
    ls, ld = ex.live_edges()
    g = graph_from_edges(ls, ld, n, capacity=h.g.capacity, device=CPU)
    assert torch.equal(h.g.src, g.src) and torch.equal(h.g.dst, g.dst)
    assert h.num_edges == ex.live


# ---------------------------------------------------------------------------
# the TTL window through the port's session == rebuild == reference
# ---------------------------------------------------------------------------

WINDOWS = {
    # (rate, horizon, seed, ttl, capacity, k_max, ticks)
    "interleaved": (600, 1.0, 11, 0.3, 512, 32, np.arange(0.1, 1.3, 0.1)),
    "regrow": (500, 1.0, 13, 0.5, 16, 4, np.arange(0.1, 1.1, 0.1)),
    "emptied": (300, 0.3, 17, 0.1, 512, 32, np.arange(0.1, 0.9, 0.1)),
}


@pytest.mark.parametrize("case", list(WINDOWS))
def test_window_equals_rebuild_and_repro(case):
    rate, horizon, seed, ttl, capacity, k_max, ticks = WINDOWS[case]
    stream = TST.poisson_edge_stream(N, rate=rate, horizon=horizon, seed=seed)
    js, ts = _empty_sessions(capacity=capacity, k_max=k_max)
    ex = TST.SlidingWindowExpirer(ttl=ttl)
    lo = 0.0
    for hi in ticks:
        cut = stream.slice_time(lo, float(hi))
        if len(cut):
            ex.ingest(cut.t, cut.src, cut.dst)
            ra = js.update(inserts=(cut.src, cut.dst))
            rb = ts.update(inserts=(cut.src, cut.dst))
            assert (ra.applied, ra.regrows, ra.version) == \
                (rb.applied, rb.regrows, rb.version)
        es, ed = ex.expire_until(float(hi))
        if len(es):
            assert js.update(deletes=(es, ed)).applied == \
                ts.update(deletes=(es, ed)).applied == len(es)
        _assert_window_equals_rebuild(ts, ex)
        _assert_mirrors_equal(js.backend.handle, ts.backend.handle)
        lo = float(hi)
    assert ts.backend.handle.num_edges == ex.live and not ts.overflow
    if case == "regrow":
        assert ts.stats.regrows == js.stats.regrows > 0
    if case == "emptied":
        assert ex.live == 0 and ts.backend.handle.num_edges == 0


# ---------------------------------------------------------------------------
# the replay driver through both packages
# ---------------------------------------------------------------------------


class Recording:
    """A transport that records every step: the op runs it was handed, the
    query nodes, the ops applied and the answers' (node, version)."""

    def __init__(self, inner):
        self.inner = inner
        self.steps = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def step(self, runs, nodes, *, k, budget_walks):
        applied, answers = self.inner.step(runs, nodes, k=k,
                                           budget_walks=budget_walks)
        self.steps.append((
            [(np.asarray(s).tolist(), np.asarray(d).tolist(), bool(i))
             for s, d, i in runs],
            [int(u) for u in nodes], int(applied),
            [(a.node, a.version, len(a.topk_nodes)) for a in answers],
        ))
        return applied, answers


COUNTERS = ("ticks", "arrivals", "expired", "updates_applied", "update_steps",
            "queries", "final_live_edges", "sticky_overflow", "rejected_429")


def _drive(pkg, transport, stream, **kw):
    rec = Recording(transport)
    drv = pkg.StreamDriver(rec, stream, ttl=0.2, tick_s=0.1, queries_per_tick=2,
                           update_burst=32, k=5, budget_walks=64, **kw)
    return rec, drv


@pytest.mark.parametrize("mode", ["drain", "epoch"])
@pytest.mark.parametrize("grow", [False, True], ids=["roomy", "regrow"])
def test_driver_equals_repro(mode, grow):
    stream = TST.poisson_edge_stream(N, rate=400, horizon=0.5, seed=19)
    cap = dict(capacity=24, k_max=4) if grow else {}
    js, ts = _empty_sessions(batch_q=4, **cap)
    reps, recs = [], []
    for pkg, sess in ((JST, js), (TST, ts)):
        rec, drv = _drive(pkg, pkg.SessionTransport(sess, mode=mode), stream,
                          slo=pkg.FreshnessSLO(staleness_p99_s=120.0))
        reps.append(drv.run(final_expire=True))
        recs.append(rec)
    (ja, jr), (ta, tr) = zip(reps, recs)
    assert jr.steps == tr.steps
    for f in COUNTERS:
        assert getattr(ja, f) == getattr(ta, f), f
    assert ta.arrivals == ta.expired == len(stream)
    assert ta.updates_applied == 2 * len(stream) and ta.slo_met is True
    assert ta.queries > 0 and ta.staleness_p99_s >= ta.staleness_p50_s >= 0.0
    _assert_mirrors_equal(js.backend.handle, ts.backend.handle)
    assert ts.backend.handle.num_edges == 0
    assert (ts.stats.regrows > 0) == grow
    assert ts.stats.regrows == js.stats.regrows
    d = ta.as_dict()
    assert d["slo"]["staleness_p99_s"] == 120.0 and d["final_precision_at_k"] is None
    assert tr.label == f"session[local/{mode}]"


def test_driver_service_transport_equals_repro():
    from repro.serving import ServiceConfig as JConfig, SimRankService as JService
    from repro_torch.serving import ServiceConfig, SimRankService

    stream = TST.poisson_edge_stream(N, rate=400, horizon=0.4, seed=29)
    e = np.empty(0, np.int32)
    cfg = dict(batch_window_ms=2.0, max_batch_q=4, default_budget_walks=64)
    handles = (JHandle.from_edges(e, e, N, capacity=512, k_max=32),
               GraphHandle.from_edges(e, e, N, capacity=512, k_max=32,
                                      device=CPU))
    out = []
    for pkg, svc in ((JST, JService(handles[0], config=JConfig(**cfg))),
                     (TST, SimRankService(handles[1], config=ServiceConfig(**cfg)))):
        with svc:
            rec, drv = _drive(pkg, pkg.ServiceTransport(svc, tenant="stream"),
                              stream)
            rep = drv.run()
            assert svc.stats.served >= rep.queries > 0
            assert svc.stats.updates_applied == rep.updates_applied
            assert svc.stats.errors_5xx == 0
            out.append((rep, rec, svc.session("stream").handle))
        assert not svc._collector.is_alive()
    (ja, jr, jh), (ta, tr, th) = out
    assert jr.steps == tr.steps
    for f in COUNTERS:
        assert getattr(ja, f) == getattr(ta, f), f
    _assert_mirrors_equal(jh, th)
    assert tr.label == "service[local]" and ta.arrivals == len(stream)


def test_driver_pooled_checkpoints():
    stream = TST.poisson_edge_stream(N, rate=400, horizon=0.5, seed=19)
    _, ts = _empty_sessions(batch_q=4)
    _, drv = _drive(TST, TST.SessionTransport(ts, mode="drain"), stream,
                    checkpoint_every=3, checkpoint_queries=2, expert_r=400,
                    fresh_budget=256)
    rep = drv.run()
    assert len(rep.checkpoints) >= 1
    cp = rep.checkpoints[-1]
    assert 0.0 <= cp.precision_at_k <= 1.0 and 0.0 <= cp.ndcg_at_k <= 1.0 + 1e-9
    assert cp.pool_size >= drv.k and cp.live_edges > 0
    assert rep.final_precision_at_k == cp.precision_at_k


def test_driver_validates_inputs():
    stream = TST.poisson_edge_stream(N, rate=100, horizon=0.2, seed=1)
    _, ts = _empty_sessions()
    tr = TST.SessionTransport(ts)
    with pytest.raises(ValueError, match="tick_s"):
        TST.StreamDriver(tr, stream, ttl=0.1, tick_s=0.0)
    with pytest.raises(ValueError, match="update_burst"):
        TST.StreamDriver(tr, stream, ttl=0.1, tick_s=0.1, update_burst=0)
    with pytest.raises(ValueError, match="mode"):
        TST.SessionTransport(ts, mode="warp")
    other = TST.poisson_edge_stream(N + 1, rate=100, horizon=0.2, seed=1)
    with pytest.raises(ValueError, match="n="):
        TST.StreamDriver(tr, other, ttl=0.1, tick_s=0.1)


# ---------------------------------------------------------------------------
# pooled checkpoints under churn
# ---------------------------------------------------------------------------


def test_frozen_window_handle_equals_repro():
    stream = TST.poisson_edge_stream(N, rate=500, horizon=0.4, seed=5)
    a = jchurn.frozen_window_handle(stream.src, stream.dst, N)
    b = tchurn.frozen_window_handle(stream.src, stream.dst, N, device=CPU)
    _assert_mirrors_equal(a, b)
    assert (a.capacity, a.k_max) == (b.capacity, b.k_max) == (256, 16)


@pytest.mark.parametrize("k", [3, 5])
def test_churn_checkpoint_equals_repro(monkeypatch, k):
    """Same served lists, same scout lists, same expert scores: the same
    pooled precision / NDCG / pool size; query i's expert draws from the
    generator seeded derive_seed(seed, i)."""
    rng = np.random.default_rng(k)
    stream = TST.poisson_edge_stream(N, rate=600, horizon=0.5, seed=k)
    served = {int(u): rng.permutation(N)[:k].astype(np.int32)
              for u in rng.choice(np.unique(stream.dst), 4, replace=False)}
    scout = {u: np.concatenate([v[:2], rng.permutation(N)[:k]])[:k]
             for u, v in served.items()}
    expert = rng.uniform(0, 0.3, (N, N))
    seeds = []

    def fake_expert(gen, _eg, u, pool, **_kw):
        if isinstance(gen, torch.Generator):
            seeds.append(gen.initial_seed())
        return torch.tensor([expert[int(u), int(v)] for v in np.asarray(pool)])

    class FakeScout:
        def __init__(self, handle, **kw):
            assert kw["top_k"] == min(k, N - 1) and kw["batch_q"] == len(served)

        def submit(self, spec):
            assert spec.budget_walks == 256 and spec.k == k
            return types.SimpleNamespace(envelope=types.SimpleNamespace(
                topk_nodes=scout[spec.node]))

        def drain(self):
            return []

    for mod in (jpool, tpool):
        monkeypatch.setattr(mod, "mc_pool_scores", fake_expert)
    for mod in (jchurn, tchurn):
        monkeypatch.setattr(mod, "SimRankSession", FakeScout)
    kw = dict(sqrt_c=0.6 ** 0.5, expert_r=400, fresh_budget=256)
    ref = jchurn.churn_checkpoint(jax.random.key(11), stream.src, stream.dst,
                                  N, served, k, **kw)
    out = tchurn.churn_checkpoint(11, stream.src, stream.dst, N, served, k,
                                  device=CPU, **kw)
    assert out == ref
    assert seeds == [derive_seed(11, i) for i in range(len(served))]
    with pytest.raises(ValueError, match="at least one"):
        tchurn.churn_checkpoint(11, stream.src, stream.dst, N, {}, k,
                                device=CPU, **kw)
