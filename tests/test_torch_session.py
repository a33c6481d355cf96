"""repro_torch session API held against repro's session on the same graph.

Envelope fields (kind, node, version, walks_used, error_bound, variant)
must be equal; a batched drain equals serial serving under the same seeds;
the copied ``api/spec.py`` is pinned field for field.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.api as JA
import repro_torch.api as TA
from repro_torch.core import make_params, multi_source, single_source
from torch_port_helpers import port_handle


@pytest.fixture()
def powerlaw_handle(small_powerlaw):
    return port_handle(small_powerlaw["g"], small_powerlaw["eg"])


def _nodes(h, q):
    return np.argsort(-h.eg.in_deg.numpy())[:q].astype(int).tolist()


def test_spec_copy_pinned():
    from repro.api import spec as js
    from repro_torch.api import spec as ts

    assert (js.VARIANTS, js.KINDS) == (ts.VARIANTS, ts.KINDS)
    for a, b in ((js.QuerySpec, ts.QuerySpec),
                 (js.ResultEnvelope, ts.ResultEnvelope)):
        fa = [(f.name, repr(f.default)) for f in dataclasses.fields(a)]
        fb = [(f.name, repr(f.default)) for f in dataclasses.fields(b)]
        assert fa == fb
    bad = [dict(kind="x", node=1), dict(variant="x", node=1), dict(),
           dict(node=1, nodes=(1,)), dict(node=1, k=0),
           dict(node=1, budget_walks=0), dict(node=1, epsilon=-1.0),
           dict(node=1, epsilon=0.1, confidence=1.5),
           dict(node=1, confidence=0.9)]
    for kw in bad:
        with pytest.raises(ValueError) as ea:
            js.QuerySpec(**kw)
        with pytest.raises(ValueError) as eb:
            ts.QuerySpec(**kw)
        assert str(ea.value) == str(eb.value)
    a = js.QuerySpec(nodes=np.array([[1, 2], [3, 4]]), kind="single_source")
    b = ts.QuerySpec(nodes=np.array([[1, 2], [3, 4]]), kind="single_source")
    assert (a.nodes, a.q) == (b.nodes, b.q)
    assert dataclasses.asdict(js.as_spec(5, default_k=7)) == dataclasses.asdict(
        ts.as_spec(5, default_k=7))


def test_drain_equals_serial(powerlaw_handle):
    """Batched drain (with repeat padding) == one-at-a-time serving: each
    query's seed is fixed at submit time."""
    nodes = _nodes(powerlaw_handle, 5)
    runs = []
    for batch_q in (4, 1):
        s = TA.SimRankSession(powerlaw_handle, eps_a=0.2, top_k=5,
                              walk_chunk=128, batch_q=batch_q, seed=7)
        tickets = [s.submit(u) for u in nodes]
        envs = s.drain(budget_walks=96)
        assert [t.result() for t in tickets] == envs
        runs.append((envs, s.stats))
    (batched, st_b), (serial, st_s) = runs
    assert [e.node for e in batched] == nodes
    assert (st_b.queries, st_b.steps, st_s.steps) == (5, 2, 5)
    for a, b in zip(batched, serial):
        np.testing.assert_allclose(a.topk_scores, b.topk_scores, atol=1e-5)
        assert set(a.topk_nodes) == set(b.topk_nodes)


def test_envelopes_match_repro(small_powerlaw, powerlaw_handle):
    """Same graph, same specs: the envelope metadata of the two sessions is
    equal (the scores differ by RNG only)."""
    d = small_powerlaw
    nodes = _nodes(powerlaw_handle, 3)
    jh = JA.GraphHandle.from_edges(d["src"], d["dst"], d["n"])
    js = JA.SimRankSession(jh, eps_a=0.2, top_k=4, walk_chunk=64, batch_q=2)
    ts = TA.SimRankSession(powerlaw_handle, eps_a=0.2, top_k=4, walk_chunk=64,
                           batch_q=2)
    assert dataclasses.asdict(js.params) == dataclasses.asdict(ts.params)
    for s in (js, ts):
        for u in nodes:
            s.submit(u)
        s.submit(JA.QuerySpec(kind="single_source", node=nodes[0])
                 if s is js else TA.QuerySpec(kind="single_source",
                                              node=nodes[0]))
    j_envs, t_envs = js.drain(budget_walks=80), ts.drain(budget_walks=80)
    fields = ("kind", "node", "nodes", "version", "walks_used", "error_bound",
              "variant", "epsilon", "rounds")
    for a, b in zip(j_envs, t_envs, strict=True):
        assert {f: getattr(a, f) for f in fields} == {f: getattr(b, f)
                                                      for f in fields}
        for f in ("scores", "topk_nodes", "topk_scores"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None)
            if x is not None:
                assert np.shape(x) == np.shape(y)
    assert js.error_bound() == ts.error_bound()
    assert js.plan(JA.QuerySpec(node=nodes[0])) == ts.plan(
        TA.QuerySpec(node=nodes[0]))
    assert ts.stats.as_dict() == js.stats.as_dict()


def test_query_reproduces_core_calls(powerlaw_handle):
    """An explicit int seed reproduces the core entry points exactly."""
    h = powerlaw_handle
    nodes = _nodes(h, 3)
    s = TA.SimRankSession(h, eps_a=0.3, walk_chunk=64, batch_q=2)
    p = s.params
    env = s.query(TA.QuerySpec(kind="single_source", nodes=tuple(nodes), key=9),
                  budget_walks=50)
    ref = multi_source(9, h.g, h.eg, nodes, p, lanes=64, n_r=50)
    np.testing.assert_array_equal(env.scores, ref.numpy())
    env = s.query(TA.QuerySpec(kind="single_source", nodes=tuple(nodes),
                               key=[4, 5, 6]), budget_walks=50)
    ref = multi_source(None, h.g, h.eg, nodes, p, lanes=64, n_r=50,
                       seeds=[4, 5, 6])
    np.testing.assert_array_equal(env.scores, ref.numpy())
    env = s.query(TA.QuerySpec(kind="single_source", node=nodes[0], key=3,
                               variant="telescoped"))
    ref = single_source(3, h.g, h.eg, nodes[0], p, walk_chunk=64)
    np.testing.assert_array_equal(env.scores, ref.numpy())
    assert env.variant == "telescoped" and env.walks_used == p.n_r
    env = s.query(TA.QuerySpec(kind="topk", node=nodes[0], k=3, key=3))
    assert env.topk_nodes.shape == (3,) and nodes[0] not in env.topk_nodes
    assert s.stats.queries == 3 + 3 + 1 + 1


def test_own_rng_within_bound_on_toy(toy):
    """The port's own random streams, served through the session, stay
    within the Thm-1/2 bound of the Power Method (repro.core.power)."""
    from repro.core import simrank_power

    truth = np.asarray(simrank_power(toy["g"], c=0.25, iters=60))[0]
    s = TA.SimRankSession(port_handle(toy["g"], toy["eg"]), c=0.25, eps_a=0.1,
                          seed=1)
    s.submit(TA.QuerySpec(kind="single_source", node=0))
    (env,) = s.drain()
    err = np.abs(env.scores - truth)
    assert err.max() <= env.error_bound, err.max()
    assert env.scores[0] == 1.0 and env.version == 0


def test_kernel_dtype_and_switches(powerlaw_handle):
    h = powerlaw_handle
    s = TA.SimRankSession(h, eps_a=0.3, walk_chunk=64, batch_q=2,
                          kernel_dtype="bfloat16", seed=2)
    f = TA.SimRankSession(h, eps_a=0.3, walk_chunk=64, batch_q=2, seed=2)
    u = _nodes(h, 1)[0]
    a = s.query(TA.QuerySpec(kind="single_source", nodes=(u,)), budget_walks=64)
    b = f.query(TA.QuerySpec(kind="single_source", nodes=(u,)), budget_walks=64)
    assert np.abs(a.scores - b.scores).max() < 1e-3
    with pytest.raises(ValueError, match="kernel_dtype"):
        TA.SimRankSession(h, kernel_dtype="float16")
    assert s.handle is not h and torch.equal(s.handle.eg.in_nbrs, h.eg.in_nbrs)
    shared = TA.SimRankSession(h, own_graph=False)
    assert shared.handle is h


def test_not_ported_paths_raise(powerlaw_handle):
    """The sharded backend is ported (tests/test_torch_sharded*.py), and so
    are the production-mesh pieces that used to raise here: the CSR
    sampler, both production steps and the abstract ring graph now return
    walks, answers and shapes (held against the reference in
    tests/test_torch_production.py)."""
    from repro_torch.configs.base import ProbeSimConfig
    from repro_torch.core import distributed, ring
    from repro_torch.launch.mesh import ShardMesh

    mesh = ShardMesh(["cpu"] * 2)
    sess = TA.SimRankSession(powerlaw_handle, backend="sharded", mesh=mesh)
    assert sess.backend.name == "sharded" and sess.handle is None
    assert powerlaw_handle.shard(mesh=mesh).shards == 2
    src, dst = powerlaw_handle.to_host_edges()
    n = powerlaw_handle.n
    sg = distributed.build_sharded_graph(src, dst, n, mesh=mesh, pad_nodes=8)
    rg = ring.build_ring_graph(src, dst, n, mesh=mesh, csr=True)
    u = int(np.bincount(dst, minlength=n).argmax())
    walks = distributed.sample_walks_sharded(
        torch.Generator().manual_seed(0), sg, [u], walks_per_query=16,
        max_len=5, sqrt_c=0.775)
    assert walks.shape == (16, 5) and bool((walks[:, 0] == u).all())
    cfg = ProbeSimConfig(name="t", n=n, m=len(src))
    for make, g in ((distributed.make_serve_step, sg),
                    (ring.make_ring_serve_step, rg)):
        step = make(cfg, queries=1, walk_chunk=16, max_len=5, top_k=4)
        idx, vals = step(g, torch.tensor([u]), torch.Generator().manual_seed(0))
        assert idx.shape == vals.shape == (1, 4) and u not in idx[0].tolist()
        assert bool(torch.isfinite(vals).all()) and float(vals[0, 0]) > 0
    abstract = ring.ring_graph_abstract(1000, 5000, 2, 2048)
    assert abstract.src_sh[0].is_meta and abstract.src_sh[0].shape == (2, 2048)


def test_backend_instance_and_errors(powerlaw_handle):
    h = powerlaw_handle
    be = TA.LocalBackend(h, params=make_params(h.n, eps_a=0.3), walk_chunk=64)
    assert isinstance(be, TA.Backend)
    s = TA.SimRankSession(be, batch_q=2)
    # a backend with the epoch stage own-copies its handle for the session
    assert s.backend is be and s.handle is be.handle and s.params is be.params
    assert s.handle is not h and torch.equal(s.handle.eg.in_nbrs, h.eg.in_nbrs)
    assert be.batch_dispatch_label(3) == "local[fused,Q=3]"
    with pytest.raises(TypeError):
        TA.SimRankSession(object())
    with pytest.raises(ValueError, match="submit takes single-node"):
        s.submit(TA.QuerySpec(nodes=(1, 2)))
    with pytest.raises(ValueError, match="queued serving"):
        s.submit(TA.QuerySpec(node=1, variant="tree"))
    t = s.submit(1)
    assert t.poll() is None and not t.done
    assert t.result(budget_walks=32).walks_used == 32 and t.done
    assert s.pending == (0, 0)
    s.record_retry(2)
    assert s.stats.retries == 2
