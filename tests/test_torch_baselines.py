"""repro_torch baselines and oracles held against repro on the same inputs.

The Power Method (the exact oracle) at fp32 1e-5, its truncated form, and
its numpy copy exactly; MC, TSF and the randomized probe fed repro's
uniforms through their ``*_from_uniforms`` seams, exactly or at 1e-6; the
copied metrics exactly; ``evaluate_with_pool`` with injected expert scores
exactly.  Then the port's own generators: the randomized variant within its
bound of the oracle, independent of its walk chunk.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core as JC
from repro.core import metrics as jm
from repro.core import pooling as jpool
from repro.core import probe_random as jpr
from repro.core.walks import walk_uniforms as j_walk_uniforms
from repro.graph import ell_from_edges, graph_from_edges, powerlaw_graph
from repro_torch.core import metrics as tm
from repro_torch.core import montecarlo as tmc
from repro_torch.core import pooling as tpool
from repro_torch.core import power as tp
from repro_torch.core import probe_random as tpr
from repro_torch.core import tsf as ttsf
from repro_torch.core.params import abs_error_bound, make_params
from repro_torch.core.probesim import single_source
from torch_port_helpers import needs_cuda, one_thread, port_handle

# a file of many small CPU ops: one intra-op thread beside the other workers
pytestmark = pytest.mark.usefixtures("one_thread")

SQRT_C = float(np.sqrt(0.6))


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def g300():
    """A 300-node power-law graph (the largest these tests use)."""
    src, dst, n = powerlaw_graph(300, 2400, seed=7)
    g = graph_from_edges(src, dst, n)
    eg = ell_from_edges(src, dst, n)
    return dict(src=src, dst=dst, n=n, g=g, eg=eg, h=port_handle(g, eg))


def _graph(request, name):
    d = request.getfixturevalue(name)
    if "h" not in d:
        d = dict(d, h=port_handle(d["g"], d["eg"]))
    return d


# ---------------------------------------------------------------------------
# metrics: a copy, pinned equal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_repro(seed):
    rng = np.random.default_rng(seed)
    n, k = 40, 8
    truth = rng.uniform(0, 1, n)
    truth[rng.integers(0, n, 5)] = truth[0]  # ties
    est = truth + rng.normal(0, 0.05, n)
    pred = rng.permutation(n)[:k]
    true_top = np.argsort(-truth, kind="stable")[:k]
    for ex in (None, 3):
        assert tm.abs_error(est, truth, ex) == jm.abs_error(est, truth, ex)
    assert tm.precision_at_k(pred, true_top) == jm.precision_at_k(pred, true_top)
    assert tm.ndcg_at_k(pred, truth, true_top) == jm.ndcg_at_k(pred, truth, true_top)
    assert tm.kendall_tau(pred, truth) == jm.kendall_tau(pred, truth)
    assert tm.kendall_tau(pred[:1], truth) == jm.kendall_tau(pred[:1], truth)


# ---------------------------------------------------------------------------
# Power Method: the exact oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,c,iters", [
    ("toy", 0.25, 60), ("small_powerlaw", 0.6, 55), ("g300", 0.6, 55),
    ("g300", 0.8, 7),
])
def test_simrank_power_equals_repro(request, name, c, iters):
    d = _graph(request, name)
    ref = np.asarray(JC.simrank_power(d["g"], c=c, iters=iters))
    out = tp.simrank_power(d["h"].g, c=c, iters=iters)
    assert out.dtype == torch.float32 and out.shape == (d["n"], d["n"])
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    host = tp.simrank_power_host(d["src"], d["dst"], d["n"], c=c, iters=iters)
    np.testing.assert_array_equal(
        host, JC.simrank_power_host(d["src"], d["dst"], d["n"], c=c, iters=iters))
    np.testing.assert_allclose(out.numpy(), host, rtol=0, atol=1e-5)


def test_simrank_power_toy_table2(toy):
    """Node a of the paper's toy graph at c = 0.25 against Table 2 (the
    printed values are rounded to 3 digits)."""
    from repro_torch.graph import TOY_TABLE2
    from repro_torch.graph.generators import TOY_NODES

    s = tp.simrank_power(port_handle(toy["g"], toy["eg"]).g, c=0.25, iters=55)
    for i, ch in enumerate(TOY_NODES):
        assert abs(float(s[0, i]) - TOY_TABLE2[ch]) < 1e-3, ch


def test_simrank_power_multigraph_and_padding():
    """Parallel edges weigh in P as the reference's dense add does, and
    capacity padding adds nothing."""
    src = np.array([0, 0, 1, 2, 2, 3], np.int32)
    dst = np.array([1, 1, 2, 3, 0, 1], np.int32)
    g = graph_from_edges(src, dst, 4, capacity=16)
    h = port_handle(g, ell_from_edges(src, dst, 4, k_max=6))
    ref = np.asarray(JC.simrank_power(g, c=0.6, iters=30))
    np.testing.assert_allclose(tp.simrank_power(h.g, c=0.6, iters=30).numpy(),
                               ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("u,iters", [(0, 3), (5, 3), (11, 1)])
def test_truncated_single_source_equals_repro(small_powerlaw, u, iters):
    d = small_powerlaw
    h = port_handle(d["g"], d["eg"])
    ref = np.asarray(JC.simrank_truncated_single_source(d["g"], u, c=0.6,
                                                        iters=iters))
    out = tp.simrank_truncated_single_source(h.g, u, c=0.6, iters=iters)
    assert out.shape == (d["n"],)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# Monte Carlo: repro's uniforms through the seams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,u,v,r,max_len", [
    ("toy", 0, 3, 2000, 16), ("g300", 1, 2, 300, 9),
])
def test_mc_single_pair_on_repro_uniforms(request, key, name, u, v, r, max_len):
    d = _graph(request, name)
    ref = float(JC.mc_single_pair(key, d["eg"], u, v, r=r, max_len=max_len,
                                  sqrt_c=SQRT_C))
    ku, kv = jax.random.split(key)
    kw = dict(n_r=r, max_len=max_len, sqrt_c=SQRT_C)
    uni_u = tuple(_t(x) for x in j_walk_uniforms(ku, **kw))
    uni_v = tuple(_t(x) for x in j_walk_uniforms(kv, **kw))
    out = tmc.mc_single_pair_from_uniforms(d["h"].eg, u, v, uni_u, uni_v)
    assert float(out) == ref


@pytest.mark.parametrize("name,u,r,batch", [
    ("toy", 0, 1000, 64), ("small_powerlaw", 3, 200, 3),
])
def test_mc_pool_scores_on_repro_uniforms(request, key, name, u, r, batch):
    d = _graph(request, name)
    pool = np.arange(1, min(d["n"], 9), dtype=np.int32)
    max_len = 12
    ref = np.asarray(JC.mc_pool_scores(key, d["eg"], jnp.int32(u),
                                       jnp.asarray(pool), r=r, max_len=max_len,
                                       sqrt_c=SQRT_C))
    ku, kv = jax.random.split(key)
    kw = dict(n_r=r, max_len=max_len, sqrt_c=SQRT_C)
    uni_u = tuple(_t(x) for x in j_walk_uniforms(ku, **kw))
    draws = [j_walk_uniforms(jax.random.fold_in(kv, int(v)), **kw) for v in pool]
    uni_pool = (torch.stack([_t(c) for c, _ in draws]),
                torch.stack([_t(p) for _, p in draws]))
    out = tmc.mc_pool_scores_from_uniforms(d["h"].eg, u, torch.from_numpy(pool),
                                           uni_u, uni_pool, batch=batch)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("name,u,r,max_len", [
    ("toy", 0, 300, 10), ("small_powerlaw", 7, 40, 12),
])
def test_mc_single_source_on_repro_uniforms(request, key, name, u, r, max_len):
    d = _graph(request, name)
    n = d["n"]
    ref = np.asarray(JC.mc_single_source(key, d["eg"], np.int32(u), r=r,
                                         max_len=max_len, sqrt_c=SQRT_C))
    ku, kv = jax.random.split(key)
    uni_u = tuple(_t(x) for x in j_walk_uniforms(ku, n_r=r, max_len=max_len,
                                                 sqrt_c=SQRT_C))

    def trial(t):
        k_cont, k_step = jax.random.split(jax.random.fold_in(kv, t))
        return (jax.random.uniform(k_cont, (max_len, n)),
                jax.random.uniform(k_step, (max_len, n)))

    cont_u, pick = jax.vmap(trial)(jnp.arange(r))
    out = tmc.mc_single_source_from_uniforms(
        d["h"].eg, u, uni_u, _t(cont_u), _t(pick), sqrt_c=SQRT_C)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_mc_own_generator_near_truth(toy):
    """The port's own draws: MC pair, pool and single-source estimates near
    the oracle on the toy graph (r = 20,000 pairs: 3 sigma about 0.01)."""
    h = port_handle(toy["g"], toy["eg"])
    truth = tp.simrank_power(h.g, c=0.25, iters=60).numpy()[0]
    gen = torch.Generator().manual_seed(3)
    est = float(tmc.mc_single_pair(gen, h.eg, 0, 3, r=20_000, max_len=16,
                                   sqrt_c=0.5))
    assert est == pytest.approx(truth[3], abs=0.015)
    pool = tmc.mc_pool_scores(gen, h.eg, 0, np.arange(1, 8), r=8000,
                              max_len=16, sqrt_c=0.5)
    np.testing.assert_allclose(pool.numpy(), truth[1:8], atol=0.03)
    ss = tmc.mc_single_source(gen, h.eg, 0, r=8000, max_len=16, sqrt_c=0.5)
    assert float(ss[0]) == 1.0
    np.testing.assert_allclose(ss.numpy()[1:], truth[1:], atol=0.03)


# ---------------------------------------------------------------------------
# TSF
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,u,r_g,r_q,t,c", [
    ("toy", 0, 20, 4, 8, 0.6), ("g300", 2, 6, 5, 6, 0.8),
])
def test_tsf_on_repro_uniforms(request, key, name, u, r_g, r_q, t, c):
    d = _graph(request, name)
    n = d["n"]
    k_idx, k_q = jax.random.split(key)
    ref_idx = np.asarray(JC.build_oneway_index(k_idx, d["eg"], r_g=r_g))
    idx = ttsf.build_oneway_index_from_uniforms(
        d["h"].eg, _t(jax.random.uniform(k_idx, (r_g, n))))
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    ref = np.asarray(JC.tsf_single_source(k_q, jnp.asarray(ref_idx), d["eg"],
                                          np.int32(u), r_q=r_q, t=t, c=c))

    def draws(gi, qi):
        kq = jax.random.fold_in(jax.random.fold_in(k_q, gi), qi)
        return jax.vmap(jax.random.uniform)(jax.random.split(kq, t))

    uni = jax.vmap(lambda gi: jax.vmap(lambda qi: draws(gi, qi))(
        jnp.arange(r_q)))(jnp.arange(r_g))
    out = ttsf.tsf_single_source_from_uniforms(idx, d["h"].eg, u, _t(uni), c=c)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_tsf_overestimates_on_cyclic_graph():
    """TSF sums meets over steps, not first meets: on h -> a, h -> b,
    h <-> x the walks from a and b meet at every step, so its estimate of
    s(a, b) = c is far above c (the paper's §2.3 critique)."""
    from repro_torch.api import GraphHandle

    src = np.array([2, 2, 3, 2], np.int32)
    dst = np.array([0, 1, 2, 3], np.int32)
    h = GraphHandle.from_edges(src, dst, 4, device="cpu")
    truth = tp.simrank_power(h.g, c=0.8, iters=80).numpy()
    assert truth[0, 1] == pytest.approx(0.8, abs=1e-6)
    gen = torch.Generator().manual_seed(1)
    idx = ttsf.build_oneway_index(gen, h.eg, r_g=50)
    est = ttsf.tsf_single_source(gen, idx, h.eg, 0, r_q=5, t=12, c=0.8).numpy()
    assert est[1] > truth[0, 1] + 0.5 and est[0] == 1.0


# ---------------------------------------------------------------------------
# Randomized PROBE (Alg. 4)
# ---------------------------------------------------------------------------


def _split3_chain(key, steps, shape):
    """repro's per-step draws: key, k_edge, k_bern = split(key, 3)."""
    edge, bern = [], []
    for _ in range(steps):
        key, k_edge, k_bern = jax.random.split(key, 3)
        edge.append(np.array(jax.random.uniform(k_edge, shape)))
        bern.append(np.array(jax.random.uniform(k_bern, shape)))
    return (torch.from_numpy(np.stack(edge)) if edge else torch.zeros((0,) + shape),
            torch.from_numpy(np.stack(bern)) if bern else torch.zeros((0,) + shape))


@pytest.mark.parametrize("name,prefix", [
    ("toy", [0, 2, 5]), ("small_powerlaw", [3, 17, 40, 8, 1]), ("toy", [4]),
])
def test_randomized_prefix_on_repro_uniforms(request, key, name, prefix):
    d = _graph(request, name)
    ref = np.asarray(jpr.randomized_probe_prefix(
        key, d["eg"], jnp.asarray(prefix, jnp.int32), sqrt_c=SQRT_C))
    edge, bern = _split3_chain(key, len(prefix) - 1, (d["n"],))
    out = tpr.randomized_probe_prefix_from_uniforms(
        d["h"].eg, prefix, edge, bern, sqrt_c=SQRT_C)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("name,u,max_len,w", [
    ("toy", 0, 6, 5), ("small_powerlaw", 4, 8, 6), ("g300", 10, 5, 4),
])
def test_randomized_walks_on_repro_uniforms(request, key, name, u, max_len, w):
    """A chunk of W walks stepped together equals repro's one-walk probe of
    each, given each walk's own draws."""
    d = _graph(request, name)
    n = d["n"]
    walks = np.array(JC.sample_walks(key, d["eg"], u, n_r=w, max_len=max_len,
                                       sqrt_c=SQRT_C))
    walks[0, 2:] = n  # one walk that dies early
    keys = [jax.random.fold_in(key, 10_000 + k) for k in range(w)]
    ref = np.stack([np.asarray(jpr.randomized_probe_walk(
        k, d["eg"], jnp.asarray(wk), sqrt_c=SQRT_C, max_len=max_len))
        for k, wk in zip(keys, walks)])
    draws = [_split3_chain(k, max_len - 1, (n, max_len - 1)) for k in keys]
    out = tpr.randomized_probe_walks_from_uniforms(
        d["h"].eg, torch.from_numpy(walks),
        torch.stack([e for e, _ in draws]), torch.stack([b for _, b in draws]),
        sqrt_c=SQRT_C)
    assert out.shape == (w, n)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_randomized_variant_own_rng(small_powerlaw):
    """single_source(variant='randomized') on the port's own generators:
    within its Thm-1/2 bound of the oracle, and bitwise independent of the
    walk chunk (each walk draws from its own generator)."""
    d = small_powerlaw
    h = port_handle(d["g"], d["eg"])
    truth = tp.simrank_power(h.g, c=0.6, iters=55).numpy()
    p = make_params(d["n"], c=0.6, eps_a=0.3, n_r_override=300)
    u = int(np.argmax(h.eg.in_deg.numpy()))
    a = single_source(5, h.g, h.eg, u, p, variant="randomized", walk_chunk=128)
    b = single_source(5, h.g, h.eg, u, p, variant="randomized", walk_chunk=7)
    assert torch.equal(a, b)
    err = np.abs(a.numpy() - truth[u])
    err[u] = 0.0
    assert float(a[u]) == 1.0
    assert err.max() <= abs_error_bound(p, n=d["n"], n_r=300), err.max()


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [3, 5])
def test_evaluate_with_pool_injected_expert(monkeypatch, small_powerlaw, key, k):
    """Same candidate lists and the same expert scores: the same verdicts."""
    d = small_powerlaw
    h = port_handle(d["g"], d["eg"])
    rng = np.random.default_rng(k)
    lists = {name: rng.permutation(d["n"])[:k].astype(np.int32)
             for name in ("probesim", "mc", "tsf")}
    lists["tsf"][:2] = lists["probesim"][:2]
    pool = tpool.build_pool(lists)
    np.testing.assert_array_equal(pool, jpool.build_pool(lists))
    expert = dict(zip(pool.tolist(), rng.uniform(0, 0.3, len(pool))))
    expert[int(pool[1])] = expert[int(pool[0])]  # a tie in the expert scores

    def fake(_key, _eg, _u, pool, **_kw):
        return torch.tensor([expert[int(v)] for v in np.asarray(pool)])

    monkeypatch.setattr(jpool, "mc_pool_scores", fake)
    monkeypatch.setattr(tpool, "mc_pool_scores", fake)
    ref = jpool.evaluate_with_pool(key, d["eg"], 3, lists, k, sqrt_c=SQRT_C)
    out = tpool.evaluate_with_pool(torch.Generator(), h.eg, 3, lists, k,
                                   sqrt_c=SQRT_C)
    assert out == ref


def test_pooling_protocol_own_expert(toy):
    """The port's expert ranks a good list above a bad one on the toy graph."""
    h = port_handle(toy["g"], toy["eg"])
    truth = tp.simrank_power(h.g, c=0.25, iters=60).numpy()[0]
    good = np.argsort(-np.where(np.arange(8) == 0, -1.0, truth))[:3]
    bad = np.array([7, 6, 5], np.int32)
    out = tpool.evaluate_with_pool(
        torch.Generator().manual_seed(2), h.eg, 0,
        {"good": good.astype(np.int32), "bad": bad}, 3,
        expert_r=4000, sqrt_c=0.5, max_len=12,
    )
    assert out["good"]["precision"] >= out["bad"]["precision"]
    assert out["good"]["ndcg"] >= out["bad"]["ndcg"]


@pytest.mark.cuda
def test_simrank_power_cuda_equals_cpu(g300):
    """The oracle on a CUDA handle equals the CPU's at fp32 1e-5."""
    needs_cuda()
    from repro_torch.api import GraphHandle

    d = g300
    cpu = tp.simrank_power(d["h"].g, c=0.6, iters=55)
    hc = GraphHandle.from_edges(d["src"], d["dst"], d["n"], device="cuda")
    out = tp.simrank_power(hc.g, c=0.6, iters=55)
    torch.testing.assert_close(out.cpu(), cpu, rtol=0, atol=1e-5)
    tr = tp.simrank_truncated_single_source(hc.g, 4, c=0.6, iters=3)
    torch.testing.assert_close(
        tr.cpu(), tp.simrank_truncated_single_source(d["h"].g, 4, c=0.6, iters=3),
        rtol=0, atol=1e-5)
