"""repro_torch adaptive accuracy: the controller, the hub probe cache and the
session's adaptive half, held against repro.

* The copied numpy core (``escalation_schedule``, ``normal_quantile``,
  ``empirical_error_bound``, ``AccuracyController``, ``ProbeCache``) and
  ``hub_nodes`` are pinned equal to repro's on the same inputs.
* Session parity runs both packages' sessions over one stub backend whose
  rows depend only on (node, round size, call index): certificates, bounds,
  walks, rounds, scores, top-k and counters must be equal.
* The port's own properties on repro's 120-node oracle graph: every
  certified bound holds against the port's own Power Method; escalated ==
  one-shot, cache hit == served row and batch mates changing nothing, all
  bitwise; a version bump clears the cache; a deadline miss answers with
  the best so far.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax

import repro.api as JA
import repro.core.accuracy as JACC
import repro_torch.api as TA
import repro_torch.core.accuracy as TACC
from repro.api.backend import _hub_nodes_from_degrees as j_hubs
from repro.core.params import make_params as j_make_params
from repro.graph import powerlaw_graph
from repro_torch.api.backend import _hub_nodes_from_degrees as t_hubs
from repro_torch.core.params import make_params
from repro_torch.core.power import simrank_power
from torch_port_helpers import CPU, needs_cuda

C = 0.6


# ---------------------------------------------------------------------------
# The copied numpy core, pinned equal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("initial", [1, 3, 64, 100, 511])
def test_escalation_schedule_equals_repro(initial):
    for cap in (1, 2, 63, 64, 65, 1000, 7131, 10_840, 43_354):
        assert TACC.escalation_schedule(initial, cap) == \
            JACC.escalation_schedule(initial, cap)
    for bad in ((0, 10), (5, 0)):
        with pytest.raises(ValueError) as ea:
            JACC.escalation_schedule(*bad)
        with pytest.raises(ValueError) as eb:
            TACC.escalation_schedule(*bad)
        assert str(ea.value) == str(eb.value)


def test_normal_quantile_equals_repro():
    for p in (1e-12, 0.01, 0.3, 0.5, 0.7, 0.975, 0.995, 1 - 1e-9, 0.99999):
        assert TACC.normal_quantile(p) == JACC.normal_quantile(p)
    for bad in (0.0, 1.0, -1.0):
        with pytest.raises(ValueError):
            TACC.normal_quantile(bad)


@pytest.mark.parametrize("seed", range(4))
def test_empirical_bound_equals_repro(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(50, 3000))
    kw = dict(c=float(rng.uniform(0.3, 0.8)), eps_a=float(rng.uniform(0.05, 0.3)),
              delta=0.01)
    r = int(rng.integers(2, 7))
    sizes = rng.integers(8, 512, size=r)
    scores = rng.uniform(0.0, rng.uniform(0.01, 1.0), size=(r, n))
    conf = float(rng.uniform(0.9, 0.999))
    a = TACC.empirical_error_bound(make_params(n, **kw), n=n, round_sizes=sizes,
                                   round_scores=scores, confidence=conf)
    b = JACC.empirical_error_bound(j_make_params(n, **kw), n=n,
                                   round_sizes=sizes, round_scores=scores,
                                   confidence=conf)
    assert a == b


def _certs(ctrl):
    return [c and dataclasses.asdict(c) for c in ctrl.certificates]


@pytest.mark.parametrize("eps,plan", [
    (0.1, [64, 64, 128, 256]), (0.06, [32, 32, 64]), (0.0, [16, 16]),
    (0.3, [500]),
])
def test_controller_equals_repro(eps, plan):
    """Fed the same seeded rows, both controllers freeze the same queries at
    the same rounds with the same certificates and scores."""
    n, q = 80, 4
    rng = np.random.default_rng(int(eps * 1000) + len(plan))
    noise = np.array([0.0, 0.02, 0.2, 1.0])
    ctrls = [mod.AccuracyController(mk(n, c=C, eps_a=0.1, delta=0.01), n=n, q=q,
                                    epsilon=eps, confidence=0.99, plan=plan)
             for mod, mk in ((TACC, make_params), (JACC, j_make_params))]
    base = rng.uniform(0, 0.2, (q, n))
    for size in plan:
        rows = np.clip(base + noise[:, None] * rng.standard_normal((q, n))
                       / math.sqrt(size), 0, 1).astype(np.float32)
        for ctrl in ctrls:
            assert ctrl.next_round() == size
            ctrl.absorb(size, rows)
        assert _certs(ctrls[0]) == _certs(ctrls[1])
        if ctrls[0].all_frozen:
            break
    for ctrl in ctrls:
        ctrl.finish("budget")
    for i in range(q):
        (sa, ca), (sb, cb) = ctrls[0].result(i), ctrls[1].result(i)
        assert dataclasses.asdict(ca) == dataclasses.asdict(cb)
        np.testing.assert_array_equal(sa, sb)


def _cache_trace(mod):
    cache = mod.ProbeCache(max_entries=3)
    k = lambda node, ver=0, r=0: (node, ver, r, 64, 4, 128)  # noqa: E731
    out = []
    for node in (1, 2, 3, 4):  # the fourth evicts node 1
        cache.put(k(node), np.full(4, node, np.float32))
    out.append([None if (x := cache.get(k(v))) is None else x.tolist()
                for v in (1, 2, 3, 4)])
    cache.put(k(3), np.ones(4, np.float32))  # resident: no eviction
    out.append([cache.get(k(v)) is None for v in (2, 3, 4)])
    out.append((len(cache), cache.hits, cache.misses))
    out.append(cache.get(k(2, ver=1)) is None)  # a new version clears all
    out.append((len(cache), cache.hits, cache.misses))
    cache.put(k(5, ver=1, r=2), np.zeros(4, np.float32))
    out.append((len(cache), cache.get(k(5, ver=1, r=2)).tolist()))
    return out


def test_probe_cache_equals_repro():
    assert _cache_trace(TACC) == _cache_trace(JACC)
    for mod in (TACC, JACC):
        with pytest.raises(ValueError, match="max_entries"):
            mod.ProbeCache(max_entries=0)


@pytest.fixture(scope="module")
def oracle():
    """repro's oracle graph (tests/test_accuracy.py) on both packages, with
    the port's own Power Method as the truth."""
    src, dst, n = powerlaw_graph(120, 900, seed=1)
    in_deg = np.bincount(dst, minlength=n)
    kw = dict(capacity=len(src) + 64, k_max=int(in_deg.max()) + 8)
    th = TA.GraphHandle.from_edges(src, dst, n, device=CPU, **kw)
    truth = simrank_power(th.g, c=C, iters=55).numpy()
    rng = np.random.default_rng(0)
    nodes = rng.choice(np.where(in_deg > 0)[0], size=6, replace=False)
    return dict(src=src, dst=dst, n=n, kw=kw, th=th, truth=truth,
                nodes=[int(u) for u in nodes], in_deg=in_deg)


@pytest.mark.parametrize("percentile", [0.0, 50.0, 90.0, 100.0])
def test_hub_nodes_equal_repro(oracle, percentile):
    jh = JA.GraphHandle.from_edges(oracle["src"], oracle["dst"], oracle["n"],
                                   **oracle["kw"])
    jb = JA.LocalBackend(jh, params=j_make_params(oracle["n"]))
    tb = TA.LocalBackend(oracle["th"], params=make_params(oracle["n"]))
    hubs = tb.hub_nodes(percentile)
    assert hubs == jb.hub_nodes(percentile)
    assert tb.hub_nodes(percentile) is hubs  # cached per (version, percentile)
    rng = np.random.default_rng(int(percentile))
    for deg in (rng.zipf(2.0, 300) - 1, np.zeros(10, np.int32)):
        assert t_hubs(deg, percentile) == j_hubs(deg, percentile)
    with pytest.raises(ValueError, match="percentile"):
        tb.hub_nodes(101.0)


# ---------------------------------------------------------------------------
# Session parity through one stub backend
# ---------------------------------------------------------------------------


class StubBackend:
    """A backend whose rows depend only on (node, round size, call index),
    so both packages' sessions see the same numbers whatever seeds they
    pass.  Nodes differ in noise: u % 4 == 0 rows are exact (the empirical
    certificate fires at round 2), the rest noisier."""

    name = "stub"
    supports_epoch = False
    variants = ("auto", "telescoped")

    def __init__(self, n=60, hubs=frozenset({3, 7})):
        self.n = n
        self.version = 0
        self.overflow = False
        self.hubs = hubs
        self.calls = 0
        rng = np.random.default_rng(0)
        self.base = rng.uniform(0, 0.3, (n, n)) * (rng.uniform(0, 1, (n, n)) < 0.2)
        self.noise = np.array([0.0, 0.15, 0.5, 2.0])[np.arange(n) % 4]

    def host_in_degrees(self):
        return np.ones(self.n, np.int32)

    def hub_nodes(self, percentile):
        return self.hubs

    def dispatch_label(self, variant):
        return f"stub:{variant}"

    def batch_dispatch_label(self, q):
        return f"stub[{q}]"

    def epoch_dispatch_label(self):
        return "stub"

    def serve_batch(self, kind, us, streams, *, k=0, n_r, **_):
        self.calls += 1
        rows = []
        for u in us:
            rng = np.random.default_rng([int(u), int(n_r), self.calls])
            noise = rng.standard_normal(self.n) * self.noise[u] / math.sqrt(n_r)
            rows.append(np.clip(self.base[u] + noise, 0.0, 1.0))
        return np.stack(rows).astype(np.float32), None, None

    def _unused(self, *a, **kw):
        raise AssertionError("the adaptive path called an unexpected method")

    serve_one = apply_ops = regrow = to_host_edges = own_buffers = _unused
    epoch_batch = _unused


def _env_fields(e):
    d = dataclasses.asdict(e)
    d.pop("latency_s")
    if d["certified_bound"] != d["certified_bound"]:  # a flat spec's nan
        d["certified_bound"] = "nan"
    for f in ("scores", "topk_nodes", "topk_scores", "nodes"):
        if d[f] is not None:
            d[f] = np.asarray(d[f]).tolist()
    return d


def _scenario(mod, name):
    """Run one scenario through ``mod``'s session over a fresh stub."""
    be = StubBackend()
    s = mod.SimRankSession(be, c=C, eps_a=0.1, delta=0.01, seed=3, batch_q=4,
                           top_k=5, initial_budget=32)
    Q = mod.QuerySpec
    out = []
    if name == "one_shot":
        for eps in (0.1, 0.06):
            for u in range(6):
                out.append(s.query(Q(kind="single_source", node=u, epsilon=eps)))
    elif name == "topk":
        for u in (0, 2, 5):
            out.append(s.query(Q(kind="topk", node=u, k=5, epsilon=0.1)))
    elif name == "drain":
        for u in (0, 3, 5, 7, 9):
            s.submit(Q(kind="single_source", node=u, epsilon=0.1))
        s.submit(Q(kind="single_source", node=4, epsilon=0.06, confidence=0.9))
        s.submit(Q(kind="single_source", node=6))  # flat, its own group
        for u in (7, 3, 1):
            s.submit(Q(kind="topk", node=u, k=3, epsilon=0.1))
        out += s.drain(budget_walks=2000)
    elif name == "nodes":
        out.append(s.query(Q(kind="single_source", nodes=(0, 1, 2), epsilon=0.1)))
        out.append(s.query(Q(kind="topk", nodes=(4, 6), k=4, epsilon=0.08),
                           budget_walks=900))
    elif name == "deadline":
        out.append(s.query(Q(kind="single_source", node=2, epsilon=1e-6),
                           deadline_s=0.0))
        out.append(s.query(Q(kind="single_source", node=6, epsilon=0.0,
                             budget_walks=300)))
    elif name == "hubs":
        for _ in range(2):
            out.append(s.query(Q(kind="single_source", node=3, epsilon=0.1)))
            out.append(s.query(Q(kind="single_source", node=7, epsilon=0.05)))
        be.version = 1  # a new graph version: every cached row is stale
        out.append(s.query(Q(kind="single_source", node=3, epsilon=0.1)))
    return [_env_fields(e) for e in out], s.stats.as_dict(), be.calls


@pytest.mark.parametrize("name", ["one_shot", "topk", "drain", "nodes",
                                  "deadline", "hubs"])
def test_session_parity_through_stub_backend(name):
    jenvs, jstats, jcalls = _scenario(JA, name)
    tenvs, tstats, tcalls = _scenario(TA, name)
    assert tstats == jstats and tcalls == jcalls
    assert len(tenvs) == len(jenvs)
    for a, b in zip(tenvs, jenvs):
        assert a == b
    if name == "one_shot":  # the scenario reaches every certificate it can
        assert {e["certificate"] for e in tenvs} >= {"empirical", "budget"}
    if name == "hubs":
        assert tstats["hub_hits"] > 0


def test_adaptive_refusals_match_repro(oracle):
    """deadline_s without epsilon, and an epoch with a queued epsilon spec:
    both packages raise ValueError, and the epoch leaves its queues as they
    were after enqueueing (the spec stays queued)."""
    d = oracle
    jh = JA.GraphHandle.from_edges(d["src"], d["dst"], d["n"], **d["kw"])
    sessions = [JA.SimRankSession(jh, seed=0),
                TA.SimRankSession(d["th"], seed=0)]
    for mod, s in zip((JA, TA), sessions):
        with pytest.raises(ValueError, match="requires a spec with epsilon"):
            s.query(mod.QuerySpec(kind="single_source", node=1), deadline_s=1.0)
        s.submit(mod.QuerySpec(kind="single_source", node=1, epsilon=0.1))
    msgs = []
    for s in sessions:
        with pytest.raises(ValueError) as e:
            s.epoch(inserts=(np.array([0], np.int32), np.array([1], np.int32)))
        msgs.append(str(e.value))
        assert s.pending == (1, 1) and s.query_queue[0][0].epsilon == 0.1
    assert msgs[0] == msgs[1] and "epoch" in msgs[0]


# ---------------------------------------------------------------------------
# The port's own properties on the oracle graph
# ---------------------------------------------------------------------------


def _session(h, eps_a=0.1, **kw):
    kw.setdefault("own_graph", False)
    return TA.SimRankSession(h, c=C, eps_a=eps_a, delta=0.01, walk_chunk=128,
                             **kw)


@pytest.mark.parametrize("eps", [0.1, 0.05])
def test_certified_bound_holds_against_own_oracle(oracle, eps):
    """Every adaptively served query: max |est - S[u]| over v != u within
    the certified bound, and fewer walks than flat serving."""
    s = _session(oracle["th"], eps, seed=11)
    walks = []
    for u in oracle["nodes"]:
        env = s.query(TA.QuerySpec(kind="single_source", node=u, epsilon=eps))
        e = np.abs(env.scores - oracle["truth"][u])
        e[u] = 0.0
        assert float(e.max()) <= env.certified_bound, (u, e.max(), env)
        assert env.certificate in ("analytic", "empirical", "budget")
        if env.certificate != "budget":
            assert env.certified_bound <= eps
        assert env.epsilon == eps and env.rounds >= 1
        walks.append(env.walks_used)
    assert max(walks) <= s.params.n_r
    assert s.params.n_r / np.mean(walks) >= 4.0  # walks saved
    assert s.stats.escalations > 0


def test_escalated_equals_one_shot_bitwise(oracle):
    s = _session(oracle["th"], seed=0)
    u = oracle["nodes"][1]
    for kind in ("single_source", "topk"):
        env = s.query(TA.QuerySpec(kind=kind, node=u, epsilon=0.1, key=7, k=10))
        assert env.certificate in ("analytic", "empirical")
        ref = s.query(TA.QuerySpec(kind=kind, node=u, epsilon=0.0, key=7, k=10,
                                   budget_walks=env.walks_used))
        assert ref.certificate == "budget"
        assert (ref.walks_used, ref.rounds) == (env.walks_used, env.rounds)
        if kind == "single_source":
            assert np.array_equal(env.scores, ref.scores)
            ss = env
        else:
            np.testing.assert_array_equal(env.topk_nodes, ref.topk_nodes)
            assert np.array_equal(env.topk_scores, ref.topk_scores)
            masked = ss.scores.copy()
            masked[u] = -np.inf
            order = np.argsort(-masked, kind="stable")[:10]
            np.testing.assert_array_equal(env.topk_nodes, order.astype(np.int32))
            assert env.topk_nodes.dtype == np.int32 and u not in env.topk_nodes


def test_batch_mates_change_nothing(oracle):
    """A pinned-seed query drained beside different mates (same padded batch
    width) gets the same answer, bit for bit."""
    nodes = oracle["nodes"]

    def drain(mates):
        s = _session(oracle["th"], seed=0, batch_q=3)
        s.submit(TA.QuerySpec(kind="single_source", node=nodes[0], epsilon=0.1,
                              key=123))
        for u in mates:
            s.submit(TA.QuerySpec(kind="single_source", node=u, epsilon=0.1))
        return s.drain()[0]

    a, b = drain(nodes[1:3]), drain(nodes[4:5])
    assert np.array_equal(a.scores, b.scores)
    assert (a.certificate, a.walks_used, a.rounds) == \
        (b.certificate, b.walks_used, b.rounds)


def test_hub_cache_hits_equal_served_rows(oracle):
    h = oracle["th"]
    hub = int(np.argmax(oracle["in_deg"]))
    s = _session(h, seed=0, hub_percentile=50.0)
    assert hub in s.backend.hub_nodes(50.0)
    a = s.query(TA.QuerySpec(kind="single_source", node=hub, epsilon=0.1))
    steps = s.stats.steps
    assert s.stats.hub_hits == 0
    b = s.query(TA.QuerySpec(kind="single_source", node=hub, epsilon=0.1))
    assert np.array_equal(a.scores, b.scores)
    assert (a.certificate, a.walks_used) == (b.certificate, b.walks_used)
    assert s.stats.hub_hits == a.rounds and s.stats.steps == steps
    # a pinned key bypasses the node-keyed stream and the cache
    c = s.query(TA.QuerySpec(kind="single_source", node=hub, epsilon=0.1, key=1))
    assert s.stats.hub_hits == a.rounds and not np.array_equal(a.scores, c.scores)


def test_version_bump_clears_hub_cache(oracle):
    d = oracle
    h = TA.GraphHandle.from_edges(d["src"], d["dst"], d["n"], device=CPU, **d["kw"])
    hub = int(np.argmax(d["in_deg"]))
    s = _session(h, seed=0, hub_percentile=50.0, own_graph=True)
    a = s.query(TA.QuerySpec(kind="single_source", node=hub, epsilon=0.1))
    s.update(inserts=(np.array([0, 1], np.int32), np.array([2, hub], np.int32)))
    b = s.query(TA.QuerySpec(kind="single_source", node=hub, epsilon=0.1))
    assert b.version == a.version + 1 and s.stats.hub_hits == 0
    assert not np.array_equal(a.scores, b.scores)


def test_deadline_miss_answers_best_so_far(oracle):
    s = _session(oracle["th"], seed=0)
    env = s.query(TA.QuerySpec(kind="single_source", node=oracle["nodes"][0],
                               epsilon=1e-6), deadline_s=0.0)
    assert env.certificate == "deadline" and env.rounds == 1
    assert env.walks_used == s.initial_budget
    assert np.isfinite(env.certified_bound) and env.certified_bound > 1e-6
    assert np.isfinite(env.scores).all()
    with pytest.raises(ValueError, match="initial_budget"):
        _session(oracle["th"], initial_budget=0)
    with pytest.raises(ValueError, match="confidence"):
        _session(oracle["th"], confidence=1.0)


def test_batched_nodes_spec_reports_worst_member(oracle):
    s = _session(oracle["th"], seed=2)
    nodes = oracle["nodes"][:3]
    env = s.query(TA.QuerySpec(kind="single_source", nodes=nodes, epsilon=0.1))
    assert env.scores.shape == (3, oracle["n"])
    assert env.certificate in ("analytic", "empirical", "budget")
    assert env.certified_bound > 0.0 and env.walks_used <= s.params.n_r
    tk = s.query(TA.QuerySpec(kind="topk", nodes=nodes, k=4, epsilon=0.1, key=9))
    assert tk.topk_nodes.shape == (3, 4) and tk.scores is None
    assert s.stats.queries == 6


def test_randomized_variant_through_session(oracle):
    s = _session(oracle["th"], 0.3, seed=4)
    u = oracle["nodes"][0]
    env = s.query(TA.QuerySpec(kind="single_source", node=u,
                               variant="randomized"), budget_walks=64)
    assert env.variant == "randomized" and env.walks_used == 64
    assert env.scores[u] == 1.0 and np.isfinite(env.scores).all()


@pytest.mark.cuda
def test_adaptive_session_on_card_equals_cpu(oracle, monkeypatch):
    """On a CUDA handle the adaptive session gives the CPU's answers when
    both draw the same walks (the walk uniforms drawn on the CPU)."""
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
    d = oracle
    hub = int(np.argmax(d["in_deg"]))
    runs = []
    for dev in (CPU, "cuda"):
        h = TA.GraphHandle.from_edges(d["src"], d["dst"], d["n"], device=dev,
                                      **d["kw"])
        s = _session(h, seed=5, batch_q=4, hub_percentile=50.0)
        for u in d["nodes"][:3] + [hub, hub]:
            s.submit(TA.QuerySpec(kind="single_source", node=u, epsilon=0.05))
        envs = s.drain() + [s.query(TA.QuerySpec(kind="topk", node=hub, k=5,
                                                 epsilon=0.1))]
        runs.append((envs, s.stats.as_dict()))
    (cpu, cst), (gpu, gst) = runs
    assert cst == gst
    for a, b in zip(cpu, gpu):
        assert (a.certificate, a.walks_used, a.rounds) == \
            (b.certificate, b.walks_used, b.rounds)
        assert b.certified_bound == pytest.approx(a.certified_bound, rel=1e-5)
        if a.scores is not None:
            np.testing.assert_allclose(b.scores, a.scores, rtol=0, atol=1e-5)
        else:
            np.testing.assert_allclose(b.topk_scores, a.topk_scores, atol=1e-5)
