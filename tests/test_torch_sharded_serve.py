"""repro_torch's sharded serving held against repro's and against its own
local backend on the same inputs.

The lane probes (all-gather and ring, plain and through the kernel's plain
version on the CPU) are fed repro's walk draws and held against repro's
LOCAL fused serve at 1e-5: repro's lane-batched mesh serve fails on this
jax (a shard_map carry check), and repro pins its sharded path to the
local one.  The bf16 exchange stays within 1e-3 of fp32.  Sessions on the
sharded backend answer like local port sessions under the same seeds;
epochs keep the device state equal to a rebuild; labels and refusals are
repro's strings.  The shards run on the CPU (``ShardMesh(["cpu"] * S)``);
the ``cuda`` cases put S blocks on one card and hold the kernel serve
bitwise against the local one.
"""
from contextlib import contextmanager

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.api as JA
import repro.core as JC
import repro_torch.api as TA
from repro.graph import ell_from_edges as j_ell_from_edges
from repro.graph import powerlaw_graph
from repro_torch.api import GraphHandle, QuerySpec, SimRankSession
from repro_torch.api.backend import ShardedBackend, ShardedGraphState
from repro_torch.core import make_params
from repro_torch.core.epoch import build_shard_epoch_graph, make_sharded_serve_step
from repro_torch.kernels import ell_plan
from repro_torch.launch.mesh import ShardMesh
from torch_port_helpers import jax_uniforms, needs_cuda, one_thread

# a file of many small CPU ops: one intra-op thread beside the other workers
pytestmark = pytest.mark.usefixtures("one_thread")

SHARDS = (1, 2, 4)


@pytest.fixture(scope="module")
def graph():
    src, dst, n = powerlaw_graph(203, 1500, seed=3)
    k_max = int(np.bincount(dst, minlength=n).max()) + 8
    return src, dst, n, k_max


@pytest.fixture()
def handle(graph):
    src, dst, n, k_max = graph
    return GraphHandle.from_edges(src, dst, n, capacity=len(src) + 64,
                                  k_max=k_max, device="cpu")


def _mesh(s, dev="cpu"):
    return ShardMesh([dev] * s)


def _nodes(graph, q, seed=0):
    src, dst, n, _ = graph
    cand = np.flatnonzero(np.bincount(dst, minlength=n) > 0)
    return [int(u) for u in np.random.default_rng(seed).choice(cand, q,
                                                                 replace=False)]


def _untied_equal(idx_a, vals_a, idx_b, vals_b, tol=1e-5):
    np.testing.assert_allclose(vals_a, vals_b, rtol=tol, atol=tol)
    for q in range(vals_b.shape[0]):
        gaps = np.abs(np.diff(vals_b[q])) > 2 * tol
        untied = np.ones(vals_b.shape[1], bool)
        untied[:-1] &= gaps
        untied[1:] &= gaps
        np.testing.assert_array_equal(np.asarray(idx_a[q])[untied],
                                      np.asarray(idx_b[q])[untied])


# ---------------------------------------------------------------------------
# The lane probes against repro's local serve
# ---------------------------------------------------------------------------


def _state(graph, s):
    src, dst, n, k_max = graph
    hs, hd = ShardedGraphState(src, dst, n, shards=s).to_host_edges()
    return build_shard_epoch_graph(hs, hd, n, capacity_per_shard=1600,
                                   k_max=k_max, mesh=_mesh(s))


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("probe", ["spmd", "ring"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_lane_probes_match_repro_local(graph, key, s, probe, use_kernel):
    src, dst, n, k_max = graph
    us = _nodes(graph, 3, seed=s)
    n_r, wq = 40, 16
    params = make_params(n, c=0.6, eps_a=0.2, n_r_override=n_r)
    keys = jax.random.split(key, len(us))
    uni = jax_uniforms(keys, n_r=n_r, max_len=params.max_len,
                       sqrt_c=params.sqrt_c)
    jeg = j_ell_from_edges(src, dst, n, k_max=k_max)
    st = _state(graph, s)
    ring = None
    if probe == "ring":
        from repro_torch.core.ring import build_ring_graph

        ring = build_ring_graph(*ShardedGraphState(src, dst, n, shards=s)
                                .to_host_edges(), n, mesh=st.mesh)
    for top_k in (0, 7):
        step = make_sharded_serve_step(
            st, q=len(us), n_r=n_r, lanes_q=wq, top_k=top_k,
            max_len=params.max_len, sqrt_c=params.sqrt_c, eps_p=params.eps_p,
            eps_t=params.eps_t, truncation_shift=params.truncation_shift,
            probe=probe, use_kernel=use_kernel,
        )
        est, idx, vals = step(st, us, uniforms=uni, ring=ring)
        if top_k:
            j_idx, j_vals = JC.multi_source_topk(
                None, jeg, jeg, jnp.asarray(us), top_k, params,
                lanes=len(us) * wq, keys=keys)
            _untied_equal(idx.numpy(), vals.numpy(), np.asarray(j_idx),
                          np.asarray(j_vals))
        else:
            ref = JC.multi_source(None, jeg, jeg, jnp.asarray(us), params,
                                  lanes=len(us) * wq, keys=keys)
            np.testing.assert_allclose(est.numpy(), np.asarray(ref),
                                       rtol=1e-5, atol=1e-5)
            assert (est.numpy() > 0).sum() > 3 * len(us)


@pytest.mark.parametrize("s", [2, 4])
def test_bf16_exchange_within_1e3(graph, key, s):
    src, dst, n, k_max = graph
    us = _nodes(graph, 2)
    params = make_params(n, c=0.6, eps_a=0.2, n_r_override=48)
    keys = jax.random.split(key, len(us))
    uni = jax_uniforms(keys, n_r=48, max_len=params.max_len,
                       sqrt_c=params.sqrt_c)
    st = _state(graph, s)
    out = {}
    for wire in ("float32", "bfloat16"):
        step = make_sharded_serve_step(
            st, q=2, n_r=48, lanes_q=16, top_k=0, max_len=params.max_len,
            sqrt_c=params.sqrt_c, eps_p=params.eps_p, eps_t=params.eps_t,
            truncation_shift=params.truncation_shift, frontier_dtype=wire)
        out[wire] = step(st, us, uniforms=uni)[0]
    err = float((out["float32"] - out["bfloat16"]).abs().max())
    assert 0 < err <= 1e-3


# ---------------------------------------------------------------------------
# Sessions and the backend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("probe", ["spmd", "ring"])
def test_session_topk_matches_local(graph, handle, s, probe):
    """16 top-k queries drained in batches of 8: the sharded session's
    answers equal a local port session's under the same seeds (ids where
    untied, scores at 1e-5)."""
    nodes = _nodes(graph, 16, seed=1)
    kw = dict(seed=3, top_k=10, batch_q=8, walk_chunk=64)
    loc = SimRankSession(handle, **kw)
    shd = SimRankSession(handle, backend="sharded", mesh=_mesh(s),
                         backend_options=dict(probe=probe), **kw)
    outs = []
    for sess in (loc, shd):
        for u in nodes:
            sess.submit(QuerySpec(kind="topk", node=u, budget_walks=96))
        outs.append(sess.drain())
    for a, b in zip(*outs):
        assert (a.node, a.version, a.walks_used) == (b.node, b.version,
                                                     b.walks_used)
        _untied_equal(b.topk_nodes[None], b.topk_scores[None],
                      a.topk_nodes[None], a.topk_scores[None])
    assert outs[1][0].variant == f"sharded[{probe}]"
    assert shd.stats.steps == 2


def _mirror_equals_rebuild(be):
    st = be._epoch_graph
    rb = build_shard_epoch_graph(*be.state.to_host_edges(), be.n,
                                 capacity_per_shard=st.capacity,
                                 k_max=st.k_max, mesh=be.mesh)
    a, b = st.host_arrays(), rb.host_arrays()
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    for rep, want in zip(st.in_deg, rb.in_deg):  # no stale replica
        assert torch.equal(rep, want)


@pytest.mark.parametrize("s", [2, 4])
def test_epochs_keep_state_equal_to_rebuild(graph, handle, s):
    """A mixed epoch stream with queries at S > 1: after every epoch the
    carried device state equals a rebuild; the stream overflows a shard
    mid-way, regrows and retries; a host update after an epoch rebuilds the
    state; answers equal the local session's epochs (same walks, other
    lane schedule) at 1e-5."""
    src, dst, n, _ = graph
    rng = np.random.default_rng(s)
    rows = -(-n // s)
    live = int(np.bincount(dst // rows, minlength=s).max())
    state = ShardedGraphState(src, dst, n, shards=s,
                              capacity_per_shard=live + 5)
    p = make_params(n, c=0.6, eps_a=0.1, delta=0.01)
    be = ShardedBackend(state, params=p, mesh=_mesh(s), walk_chunk=64)
    kw = dict(seed=0, top_k=5, batch_q=2, update_batch=16)
    shd = SimRankSession(be, **kw)
    loc = SimRankSession(handle, walk_chunk=64, **kw)
    hs, hd = handle.to_host_edges()
    full = int(np.argmax(np.bincount(dst // rows, minlength=s)))
    into_full = int(dst[dst // rows == full][0])
    regrown = 0
    for ep in range(6):
        k = rng.integers(0, len(hs), 3)
        ins = (rng.integers(0, n, 6), rng.integers(0, n, 6))
        ins[1][:3] = into_full  # the fullest shard overflows mid-stream
        qs = [QuerySpec(kind="single_source", node=u) for u in _nodes(graph, 2, ep)]
        a = loc.epoch(inserts=ins, deletes=(hs[k], hd[k]), queries=qs,
                      budget_walks=48)
        b = shd.epoch(inserts=ins, deletes=(hs[k], hd[k]), queries=qs,
                      budget_walks=48)
        _mirror_equals_rebuild(be)
        assert b.results[0].variant == "sharded[spmd]"
        regrown += b.regrown
        if not regrown:  # until the first regrow both streams are in step
            assert (b.version, b.updates_applied) == (a.version,
                                                      a.updates_applied)
            for x, y in zip(a.results, b.results):
                np.testing.assert_allclose(y.scores, x.scores, rtol=1e-5,
                                           atol=1e-5)
    assert regrown and not shd.overflow and ep > 0
    rest = shd.drain_epochs(budget_walks=48)
    loc.drain_epochs(budget_walks=48)
    _mirror_equals_rebuild(be)
    ls, ld = loc.handle.to_host_edges()
    ss, sd = be.to_host_edges()
    assert sorted(zip(ls.tolist(), ld.tolist())) == sorted(
        zip(ss.tolist(), sd.tolist()))
    assert all(e.updates_applied >= 0 for e in rest)
    # a host-path update after the epochs: the device state is rebuilt
    st_before = be._epoch_graph
    rep = shd.update(inserts=([1, 2], [3, 4]), deletes=([int(ss[0])],
                                                        [int(sd[0])]))
    assert rep.applied == 3
    ep = shd.epoch(inserts=([5], [6]), queries=[1], budget_walks=48)
    assert be._epoch_graph is not st_before
    assert ep.version == shd.version and ep.updates_applied == 1
    _mirror_equals_rebuild(be)


def test_serving_reuses_the_device_state_until_an_update(handle):
    sess = SimRankSession(handle, backend="sharded", mesh=_mesh(2),
                          walk_chunk=64)
    sess.query(QuerySpec(kind="single_source", node=1, budget_walks=32))
    st1 = sess.backend._epoch_graph
    sess.query(QuerySpec(kind="single_source", node=2, budget_walks=32))
    assert sess.backend._epoch_graph is st1  # carried, not rebuilt
    assert sess.update(inserts=([0, 1], [2, 3])).applied == 2
    env = sess.query(QuerySpec(kind="single_source", node=1, budget_walks=32))
    assert env.version == 1 and sess.backend._epoch_graph is not st1
    _mirror_equals_rebuild(sess.backend)


def test_handle_shard_equals_repro(graph):
    src, dst, n, k_max = graph
    jh = JA.GraphHandle.from_edges(src, dst, n, capacity=len(src) + 64,
                                   k_max=k_max)
    th = GraphHandle.from_edges(src, dst, n, capacity=len(src) + 64,
                                k_max=k_max, device="cpu")
    for s in (1, 2, 4):
        j, t = jh.shard(shards=s), th.shard(shards=s)
        np.testing.assert_array_equal(t._src_sh, j._src_sh)
        np.testing.assert_array_equal(t._dst_sh, j._dst_sh)
        assert (t.version, t.capacity_per_shard) == (j.version,
                                                     j.capacity_per_shard)
    assert th.shard(mesh=_mesh(4)).shards == 4


def _repro_backend(graph, **kw):
    src, dst, n, k_max = graph
    jh = JA.GraphHandle.from_edges(src, dst, n, capacity=len(src) + 64,
                                   k_max=k_max)
    p = JC.make_params(n, c=0.6, eps_a=0.2, delta=0.01)
    return JA.ShardedBackend(jh.shard(shards=1), params=p, **kw), jh, p


@pytest.mark.parametrize("probe", ["spmd", "ring"])
def test_labels_equal_repro(graph, handle, probe):
    jb, _, _ = _repro_backend(graph, probe=probe)
    p = make_params(handle.n, c=0.6, eps_a=0.2, delta=0.01)
    tb = ShardedBackend(handle.shard(shards=2), params=p, mesh=_mesh(2),
                        probe=probe)
    for q in (1, 3, 8):
        assert tb.batch_dispatch_label(q) == jb.batch_dispatch_label(q)
    assert tb.dispatch_label("telescoped") == jb.dispatch_label("telescoped")
    assert tb.epoch_dispatch_label() == jb.epoch_dispatch_label()
    assert tb.variants == jb.variants and tb.name == jb.name
    assert tb.batch_dispatch_label(8) == f"sharded[{probe},Q=8]"
    # a ring backend stamps spmd on epochs, ring on its serves
    sess = SimRankSession(tb, seed=0, top_k=5, batch_q=1, update_batch=8)
    ep = sess.epoch(inserts=([0], [1]), queries=[1], budget_walks=32)
    assert ep.results[0].variant == "sharded[spmd]"
    env = sess.query(QuerySpec(kind="topk", node=1, budget_walks=32))
    assert env.variant == f"sharded[{probe}]"


def _message(fn):
    with pytest.raises((ValueError, TypeError)) as e:
        fn()
    return type(e.value), str(e.value)


def test_refusals_equal_repro(graph, handle, monkeypatch):
    """The refusals of repro's backend tests, with repro's messages."""
    jb, jh, jp = _repro_backend(graph)
    p = make_params(handle.n, c=0.6, eps_a=0.2, delta=0.01)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)  # repro: 1 device
    pairs = [
        (lambda: JA.ShardedBackend(jh.shard(shards=3), params=jp),
         lambda: ShardedBackend(handle.shard(shards=3), params=p)),
        (lambda: JA.ShardedBackend(jh.shard(shards=1), params=jp, probe="nope"),
         lambda: ShardedBackend(handle.shard(shards=1), params=p,
                                probe="nope")),
        (lambda: JA.ShardedBackend(jh.shard(shards=1), params=jp,
                                   frontier_dtype="float16"),
         lambda: ShardedBackend(handle.shard(shards=1), params=p,
                                frontier_dtype="float16")),
        (lambda: JA.SimRankSession(jh, shards=8),
         lambda: SimRankSession(handle, shards=8)),
        (lambda: JA.SimRankSession(JA.LocalBackend(jh.copy(), params=jp),
                                   shards=2),
         lambda: SimRankSession(TA.LocalBackend(handle.copy(), params=p),
                                shards=2)),
        (lambda: JA.SimRankSession(JA.LocalBackend(jh.copy(), params=jp),
                                   backend="sharded"),
         lambda: SimRankSession(TA.LocalBackend(handle.copy(), params=p),
                                backend="sharded")),
        (lambda: JA.SimRankSession(jh, backend=JA.LocalBackend(jh.copy(),
                                                               params=jp)),
         lambda: SimRankSession(handle, backend=TA.LocalBackend(
             handle.copy(), params=p))),
        (lambda: JA.SimRankSession(jh, backend="nope"),
         lambda: SimRankSession(handle, backend="nope")),
    ]
    for ref, port in pairs:
        assert _message(port) == _message(ref)
    # a mesh of the wrong extent (repro: a mesh without a 'model' axis)
    with pytest.raises(ValueError, match="model"):
        ShardedBackend(handle.shard(shards=1), params=p, mesh=_mesh(2))
    with pytest.raises(ValueError, match="model"):
        ShardedBackend(handle.shard(shards=1), params=p, mesh=object())
    with pytest.raises(ValueError, match="variant"):
        SimRankSession(handle, backend="sharded", mesh=_mesh(1)).query(
            QuerySpec(kind="topk", node=1, variant="tree"))


def test_adaptive_spec_on_sharded(handle, graph):
    """An epsilon spec escalates on the sharded backend exactly as on the
    local one under the same seeds."""
    nodes = _nodes(graph, 3, seed=4)
    kw = dict(seed=1, top_k=5, batch_q=4, walk_chunk=64, initial_budget=32)
    out = []
    for extra in ({}, dict(backend="sharded", mesh=_mesh(2))):
        sess = SimRankSession(handle, **kw, **extra)
        envs = [sess.query(QuerySpec(kind="single_source", node=nodes[0],
                                     epsilon=0.2, budget_walks=256))]
        for u in nodes:
            sess.submit(QuerySpec(kind="topk", node=u, epsilon=0.2,
                                  budget_walks=256))
        envs += sess.drain()
        out.append((envs, sess.stats.escalations))
    (a, ea), (b, eb) = out
    assert ea == eb
    for x, y in zip(a, b):
        assert (x.walks_used, x.rounds, x.certificate) == (
            y.walks_used, y.rounds, y.certificate)
        np.testing.assert_allclose(y.certified_bound, x.certified_bound,
                                   rtol=1e-5)
        if x.scores is not None:
            np.testing.assert_allclose(y.scores, x.scores, rtol=1e-5,
                                       atol=1e-5)
        else:
            _untied_equal(y.topk_nodes[None], y.topk_scores[None],
                          x.topk_nodes[None], x.topk_scores[None])


# ---------------------------------------------------------------------------
# The service and the launcher
# ---------------------------------------------------------------------------


@contextmanager
def _server(svc):
    from repro_torch.serving import start_server, stop_server

    server, thread = start_server(svc)
    try:
        yield server.server_address
    finally:
        stop_server(server, thread)
        assert not thread.is_alive() and not svc._collector.is_alive()


def test_service_on_sharded_backend(handle):
    from repro_torch.serving import ServiceClient, ServiceConfig, SimRankService

    svc = SimRankService(handle, backend="sharded", mesh=_mesh(2),
                         config=ServiceConfig(batch_window_ms=5.0,
                                              default_budget_walks=64),
                         session_kwargs=dict(walk_chunk=64))
    ref = SimRankSession(handle, backend="sharded", mesh=_mesh(2),
                         walk_chunk=64, batch_q=svc.config.max_batch_q)
    with _server(svc) as (host, port):
        with ServiceClient(host, port) as cl:
            r = cl.query(node=4, kind="topk", k=5, seed=9)
            rep = cl.update(inserts=[(1, 4)])
            assert cl.healthz()["backend"] == "sharded"
            assert cl.healthz()["version"] == rep["version"] == 1
            r2 = cl.query(node=4, kind="topk", k=5, seed=9)
    env = ref.query(QuerySpec(kind="topk", node=4, k=5, key=9,
                              budget_walks=64))
    assert r["topk_nodes"] == env.topk_nodes.tolist()
    assert r2["version"] == 1
    assert svc._handle is None and svc.version == 1


@pytest.mark.parametrize("epochs", [False, True])
def test_launcher_sharded(epochs):
    from repro_torch.launch.serve import main

    argv = ["--device", "cpu", "--nodes", "300", "--edges", "2000",
            "--queries", "2", "--walk-budget", "64", "--backend", "sharded",
            "--shards", "2"] + (["--epochs"] if epochs else [])
    served = main(argv)
    assert len(served) == 2
    assert all(e.variant == "sharded[spmd]" for e in served)
    assert [e.version for e in served] == [1, 2]


# ---------------------------------------------------------------------------
# On the card: S blocks on one device
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_sharded_kernel_serve_bitwise_on_card(graph):
    """Two row blocks on cuda:0, the kernel on: 16 top-k answers equal the
    local kernel serve's bit for bit; one warm drain builds no plan."""
    needs_cuda()
    src, dst, n, k_max = graph
    h = GraphHandle.from_edges(src, dst, n, k_max=k_max, device="cuda")
    nodes = _nodes(graph, 16, seed=2)
    kw = dict(seed=5, top_k=10, batch_q=8, walk_chunk=64)
    loc = SimRankSession(h, **kw)
    shd = SimRankSession(h, backend="sharded", mesh=_mesh(2, "cuda:0"), **kw)
    outs = []
    for sess in (loc, shd):
        for u in nodes:
            sess.submit(QuerySpec(kind="topk", node=u, budget_walks=128))
        outs.append(sess.drain())
    for a, b in zip(*outs):
        assert np.array_equal(a.topk_nodes, b.topk_nodes)
        assert np.array_equal(a.topk_scores, b.topk_scores)
    ell_plan.build_plan.builds = 0
    for u in nodes:
        shd.submit(QuerySpec(kind="topk", node=u, budget_walks=128))
    shd.drain()
    assert ell_plan.build_plan.builds == 0


@pytest.mark.cuda
def test_sharded_epochs_on_card_equal_rebuild(graph):
    needs_cuda()
    src, dst, n, k_max = graph
    h = GraphHandle.from_edges(src, dst, n, capacity=len(src) + 64,
                               k_max=k_max, device="cuda")
    sess = SimRankSession(h, backend="sharded", mesh=_mesh(4, "cuda:0"),
                          seed=0, top_k=5, batch_q=2, update_batch=16,
                          walk_chunk=64)
    rng = np.random.default_rng(9)
    hs, hd = h.to_host_edges()
    for _ in range(4):
        k = rng.integers(0, len(hs), 3)
        sess.epoch(inserts=(rng.integers(0, n, 6), rng.integers(0, n, 6)),
                   deletes=(hs[k], hd[k]), queries=[1, 2], budget_walks=64)
        _mirror_equals_rebuild(sess.backend)


@pytest.mark.cuda
def test_one_block_per_card_equals_one_card():
    """One block per visible card (peer copies between them) against the
    same blocks on one card, after an update epoch: spmd answers bit for
    bit, ring ones at 1e-5 (its pushes are atomic adds).  Skips on a
    machine with one card."""
    needs_cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    src, dst, n = powerlaw_graph(2003, 15000, seed=3)
    h = GraphHandle.from_edges(src, dst, n, capacity=len(src) + 64,
                               device="cuda:0")
    s = torch.cuda.device_count()
    kw = dict(seed=5, top_k=10, batch_q=8, walk_chunk=64, update_batch=16)
    one = SimRankSession(h, backend="sharded", mesh=_mesh(s, "cuda:0"), **kw)
    many = SimRankSession(h, backend="sharded", mesh=ShardMesh(shards=s), **kw)
    assert len(set(many.backend.mesh.devices)) == s
    rng = np.random.default_rng(1)
    ins = (rng.integers(0, n, 8), rng.integers(0, n, 8))
    for sess in (one, many):
        assert sess.epoch(inserts=ins, budget_walks=64).updates_applied == 8
    _mirror_equals_rebuild(many.backend)
    for probe in ("spmd", "ring"):
        outs = []
        for sess in (one, many):
            sess.backend.probe = probe
            for u in range(1, 17):
                sess.submit(QuerySpec(kind="topk", node=u, budget_walks=128,
                                      key=u))
            outs.append(sess.drain())
        for a, b in zip(*outs):
            if probe == "spmd":
                assert np.array_equal(a.topk_nodes, b.topk_nodes)
                assert np.array_equal(a.topk_scores, b.topk_scores)
            else:
                _untied_equal(b.topk_nodes[None], b.topk_scores[None],
                              a.topk_nodes[None], a.topk_scores[None])
