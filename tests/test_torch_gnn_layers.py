"""repro_torch's GNN layers (``models/gnn/layers.py``), segment softmax,
SO(3) tables (``models/gnn/so3.py``) and the op counter's scatter rule,
held against repro on the CPU.

The layers run on one graph with every kind of edge a batch holds: live
edges, masked padding pointing at a real node (the launcher's padding),
sentinel edges (src = dst = N), an isolated node and a node whose only
in-edges are masked.  Weights are drawn by repro's ``init_*`` and carried
over as numpy.  Outputs are held at 1e-5 and gradients at 1e-4 of each
tensor's largest magnitude (fp32 on both sides; the sums run in other
orders); the SO(3) tables are pinned numpy copies and must be equal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models.gnn import layers as JL
from repro.models.gnn import so3 as JS

import repro_torch.roofline.analysis as RA
from repro_torch.models.gnn import layers as TL
from repro_torch.models.gnn import so3 as TS
from torch_port_helpers import one_thread, rel_close  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

FWD_TOL, GRAD_TOL = 1e-5, 1e-4
N, D = 14, 12
ISOLATED, MASKED_ONLY = N - 1, N - 2


def graph(seed=0):
    """src, dst int32 [E], mask bool [E] over N nodes: 40 live edges among
    the first N - 2 nodes, 6 masked edges into MASKED_ONLY, 6 masked
    padding edges into node 0 and 4 sentinel edges (N -> N)."""
    rng = np.random.default_rng(seed)
    live_s = rng.integers(0, N - 2, 40)
    live_d = rng.integers(0, N - 2, 40)
    src = np.concatenate([live_s, rng.integers(0, N - 2, 6), np.zeros(6, int),
                          np.full(4, N)]).astype(np.int32)
    dst = np.concatenate([live_d, np.full(6, MASKED_ONLY), np.zeros(6, int),
                          np.full(4, N)]).astype(np.int32)
    mask = np.concatenate([np.ones(40, bool), np.zeros(16, bool)])
    return src, dst, mask


def as_torch(tree):
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)).requires_grad_(a.dtype == np.float32),
        jax.tree_util.tree_map(np.asarray, tree))


def both(jfn, tfn, jparams, h, *extra):
    """Each layer's outputs and the gradients of a fixed random projection
    of them (parameters and node features) through both packages."""
    src, dst, mask = graph()
    jargs = [jnp.asarray(x) for x in (src, dst, mask)]
    targs = [torch.from_numpy(x) for x in (src, dst, mask)]
    jx = [jnp.asarray(x) for x in (h,) + extra]
    tx = [torch.from_numpy(x).requires_grad_(True) for x in (h,) + extra]
    tparams = as_torch(jparams)

    def outs(r):
        return r if isinstance(r, tuple) else (r,)

    jout = outs(jfn(jparams, *jx, *jargs))
    tout = outs(tfn(tparams, *tx, *targs))
    rng = np.random.default_rng(1)
    ws = [rng.normal(size=o.shape).astype(np.float32) for o in jout]

    def jloss(p, xs):
        return sum(jnp.sum(o * w) for o, w in zip(outs(jfn(p, *xs, *jargs)), ws))

    jg = jax.grad(jloss, argnums=(0, 1))(jparams, jx)
    tl = sum(torch.sum(o * torch.from_numpy(w)) for o, w in zip(tout, ws))
    tleaves = jax.tree_util.tree_leaves(tparams) + tx
    tg = torch.autograd.grad(tl, tleaves)
    for i, (a, b) in enumerate(zip(tout, jout)):
        rel_close(a, b, FWD_TOL, f"output {i}")
    for i, (a, b) in enumerate(zip(tg, jax.tree_util.tree_leaves(jg))):
        rel_close(a, b, GRAD_TOL, f"gradient {i}")
    return tout


def feats(d=D, seed=2):
    return np.random.default_rng(seed).normal(size=(N, d)).astype(np.float32)


@pytest.mark.parametrize("act", ["relu", None])
def test_gcn_layer_equals_repro(act):
    p = JL.init_gcn_layer(jax.random.key(0), D, 8, jnp.float32)
    p = dict(p, b=jnp.linspace(-0.5, 0.5, 8))  # a nonzero bias
    out, = both(lambda p, h, s, d, m: JL.gcn_layer(p, h, s, d, m, act=jax.nn.relu if act else None),
                lambda p, h, s, d, m: TL.gcn_layer(p, h, s, d, m,
                                                   act=torch.relu if act else None), p, feats())
    if act is None:
        assert bool((out < 0).any())


def test_gin_layer_equals_repro():
    p = JL.init_gin_layer(jax.random.key(1), D, 8, jnp.float32)
    p = dict(p, eps=jnp.float32(0.25))
    both(JL.gin_layer, TL.gin_layer, p, feats())


def test_gatedgcn_layer_equals_repro_edges_and_nodes():
    p = JL.init_gatedgcn_layer(jax.random.key(2), D, jnp.float32)
    e = np.random.default_rng(3).normal(size=(len(graph()[0]), D)).astype(np.float32)
    h_new, e_new = both(JL.gatedgcn_layer, TL.gatedgcn_layer, p, feats(), e)
    assert h_new.shape == (N, D) and e_new.shape == e.shape


def test_gat_layer_equals_repro():
    p = JL.init_gat_layer(jax.random.key(3), D, 4, 4, jnp.float32)
    out, = both(JL.gat_layer, TL.gat_layer, p, feats())
    # no live in-edge: no message
    assert float(out[[ISOLATED, MASKED_ONLY]].detach().abs().max()) == 0.0


def test_segment_softmax_equals_repro():
    src, dst, mask = graph()
    rng = np.random.default_rng(4)
    scores = (rng.normal(size=(len(dst), 3)) * 5).astype(np.float32)
    got = TL.segment_softmax(torch.from_numpy(scores), torch.from_numpy(dst), N + 1,
                             torch.from_numpy(mask))
    for col in range(3):
        want = JL.segment_softmax(jnp.asarray(scores[:, col]), jnp.asarray(dst), N + 1,
                                  jnp.asarray(mask))
        rel_close(got[:, col], want, FWD_TOL, f"column {col}")
    # each live segment sums to 1, masked edges and empty segments get 0
    sums = torch.zeros(N + 1, 3).index_add_(0, torch.from_numpy(dst).long(), got)
    live = np.unique(dst[mask])
    torch.testing.assert_close(sums[live], torch.ones(len(live), 3))
    empty = np.setdiff1d(np.arange(N + 1), live)
    assert set(empty) >= {ISOLATED, MASKED_ONLY, N}
    assert float(sums[empty].abs().max()) == 0.0
    assert float(got[torch.from_numpy(~mask)].abs().max()) == 0.0
    # one column: the same as the reference's 1-D call
    one = TL.segment_softmax(torch.from_numpy(scores[:, 0]), torch.from_numpy(dst), N + 1,
                             torch.from_numpy(mask))
    torch.testing.assert_close(one, got[:, 0], rtol=0, atol=0)


def test_scatter_sum_and_degree_drop_the_sentinel():
    src, dst, mask = graph()
    vals = np.random.default_rng(5).normal(size=(len(dst), 3)).astype(np.float32)
    got = TL.scatter_sum(torch.from_numpy(vals), torch.from_numpy(dst), N)
    rel_close(got, JL.scatter_sum(jnp.asarray(vals), jnp.asarray(dst), N), FWD_TOL)
    deg = TL.degree(torch.from_numpy(dst), torch.from_numpy(mask), N)
    np.testing.assert_array_equal(deg.numpy(), np.asarray(
        JL.degree(jnp.asarray(dst), jnp.asarray(mask), N)))
    assert deg[ISOLATED] == 0 and deg[MASKED_ONLY] == 0


PATHS = JS.tp_paths(2)


def test_tp_paths_equal_repro():
    for lmax in range(4):
        assert TS.tp_paths(lmax) == JS.tp_paths(lmax)
    assert len(PATHS) == 15


@pytest.mark.parametrize("path", PATHS, ids=lambda p: "_".join(map(str, p)))
def test_cg_tables_equal_repro(path):
    np.testing.assert_array_equal(TS.cg_real(*path), JS.cg_real(*path))
    np.testing.assert_array_equal(TS.cg_complex(*path), JS.cg_complex(*path))


@pytest.mark.parametrize("l", [0, 1, 2])
def test_real_sh_equals_repro(l):
    v = np.random.default_rng(l).normal(size=(50, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    np.testing.assert_array_equal(TS.real_sh(l, v), JS.real_sh(l, v))
    np.testing.assert_array_equal(TS.complex_to_real(l), JS.complex_to_real(l))
    v32 = v.astype(np.float32)
    got = TS.real_sh(l, torch.from_numpy(v32))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    rel_close(got, np.asarray(JS.real_sh(l, jnp.asarray(v32))), 1e-6)


# ---------------------------------------------------------------------------
# The op counter's scatter rule (the GNN path's scatter ops)
# ---------------------------------------------------------------------------


def _count(fn):
    c = RA.OpCounter()
    with torch.inference_mode(), c:
        fn()
    return c


@pytest.mark.parametrize("op", ["scatter_reduce_", "scatter_reduce", "scatter_add_",
                                "scatter_add"])
def test_counter_scatter_rule(op):
    """One operation per source element; index and source read once; in
    place each addressed element read and written once per source element,
    out of place ``self`` read and the whole output written: not the
    elementwise rule (one operation per element of the largest tensor)."""
    acc = torch.full((1_000, 4), -1.0)
    idx = torch.tensor([[3] * 4, [3] * 4, [900] * 4], dtype=torch.int64)
    src = torch.randn(3, 4)
    extra = dict(reduce="amax", include_self=False) if "reduce" in op else {}
    c = _count(lambda: getattr(acc, op)(0, idx, src, **extra))
    calls, w = c.by_op[op]
    assert calls == 1 and w.flops == 12
    moved = 3 * 4 * 8 + 3 * 4 * 4  # index (int64) and source
    if op.endswith("_"):
        assert w.bytes == moved + 2 * 12 * 4
    else:
        assert w.bytes == moved + 2 * 1_000 * 4 * 4
