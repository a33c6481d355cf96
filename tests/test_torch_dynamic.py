"""repro_torch's dynamic-graph path held against repro's on the same inputs.

Op streams are drawn from a seeded numpy generator and go through both
packages.  After every batch the port's mirrors, applied mask and snapshot
fields are *equal* to repro's, the ELL table keeps live slots first
(``check_live_prefix``), and both mirrors equal a rebuild from the live
edge list.  With repro's walk draws injected, the port's fused epoch agrees
with repro's at 1e-5.  Session-level reports are compared field by field
(every field that is not a time).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.api as JA
import repro.core as JC
import repro.graph as JG
import repro_torch.api as TA
import repro_torch.graph as TG
from repro.core.epoch import epoch_step as j_epoch_step
from repro_torch.core import make_params, multi_source
from repro_torch.core.epoch import epoch_step
from repro_torch.graph.structs import check_coo_prefix, check_live_prefix
from repro_torch.kernels import ell_plan
from torch_port_helpers import CPU, jax_uniforms, needs_cuda, one_thread, port_handle

# a file of many small CPU ops: one intra-op thread beside the other workers
pytestmark = pytest.mark.usefixtures("one_thread")


def _jax_pair(src, dst, n, *, capacity=None, k_max=None):
    g = JG.graph_from_edges(src, dst, n, capacity=capacity)
    eg = JG.ell_from_edges(src, dst, n, k_max=k_max)
    return (g.replace(version=jnp.asarray(0, jnp.int32), overflow=jnp.asarray(False)),
            eg.replace(version=jnp.asarray(0, jnp.int32), overflow=jnp.asarray(False)))


def _graph(name, small_powerlaw):
    """(src, dst, n, capacity, k_max) of a test graph with insert headroom."""
    if name == "small":
        src, dst, n = JG.erdos_renyi_graph(60, 300, seed=5)
    else:
        src, dst, n = (small_powerlaw[k] for k in ("src", "dst", "n"))
    deg = int(np.bincount(dst, minlength=n).max())
    return src, dst, n, len(src) + 64, deg + 8


def _assert_equal(jg, jeg, tg, teg):
    """Every field of both mirrors equal (arrays bit for bit)."""
    for a, b in ((jg.src, tg.src), (jg.dst, tg.dst), (jg.in_deg, tg.in_deg),
                 (jg.out_deg, tg.out_deg), (jeg.in_nbrs, teg.in_nbrs),
                 (jeg.in_deg, teg.in_deg)):
        np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy())
    assert (int(jg.num_edges), jg.capacity, jeg.k_max) == (
        tg.num_edges, tg.capacity, teg.k_max)
    assert (int(jg.version), int(jeg.version)) == (tg.version, teg.version)
    assert (bool(jg.overflow), bool(jeg.overflow)) == (tg.overflow, teg.overflow)


def _assert_rebuild(tg, teg):
    """Live slots first, and both mirrors equal a rebuild of the live edges."""
    check_live_prefix(teg.in_nbrs, teg.in_deg, teg.n)
    src, dst = TG.graph_to_host_edges(tg)
    rg = TG.graph_from_edges(src, dst, tg.n, capacity=tg.capacity, device=CPU)
    reg = TG.ell_from_edges(src, dst, tg.n, k_max=teg.k_max, device=CPU)
    for a, b in ((tg.src, rg.src), (tg.dst, rg.dst), (tg.in_deg, rg.in_deg),
                 (tg.out_deg, rg.out_deg), (teg.in_nbrs, reg.in_nbrs),
                 (teg.in_deg, reg.in_deg)):
        assert torch.equal(a, b)


def _draw_batch(rng, host_src, host_dst, n, b, kind):
    """(src, dst, insert) of one op batch of ``kind``: inserts of random
    pairs (repeats and existing edges included), deletes of live edges,
    of absent pairs and of one pair twice, sentinel ops."""
    k = int(rng.integers(1, b + 1))
    ins = np.ones(k, bool) if kind == "insert_only" else rng.random(k) < 0.5
    s = rng.integers(0, n, k).astype(np.int32)
    d = rng.integers(0, n, k).astype(np.int32)
    if len(host_src):
        pick = rng.integers(0, len(host_src), k)
        s = np.where(ins, s, host_src[pick]).astype(np.int32)
        d = np.where(ins, d, host_dst[pick]).astype(np.int32)
    if kind == "mixed" and k >= 4:
        ins[:2] = False  # the same live pair deleted twice in one batch
        s[1], d[1] = s[0], d[0]
        s[2], d[2] = n, 0  # a sentinel op inside the batch
        d[3] = s[3] = int(rng.integers(0, n))  # a self loop
    if kind == "insert_only" and k >= 2:
        s[1], d[1] = s[0], d[0]  # a repeated insert (multigraph)
    return s, d, ins


# ---------------------------------------------------------------------------
# apply_update_batch: every output equal to repro's after every batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["small", "small_powerlaw"])
@pytest.mark.parametrize("kind", ["mixed", "insert_only"])
def test_apply_update_batch_stream_matches_repro(name, kind, small_powerlaw):
    src, dst, n, cap, k_max = _graph(name, small_powerlaw)
    jg, jeg = _jax_pair(src, dst, n, capacity=cap, k_max=k_max)
    h = port_handle(jg, jeg)
    rng = np.random.default_rng(11)
    for _ in range(10):
        hs, hd = TG.graph_to_host_edges(h.g)
        s, d, ins = _draw_batch(rng, hs, hd, n, 16, kind)
        jb = JG.make_update_batch(s, d, ins, batch_size=16, n=n)
        tb = TG.make_update_batch(s, d, ins, batch_size=16, n=n, device=CPU)
        assert tb.has_deletes == jb.has_deletes
        jg, jeg, ja = JG.apply_update_batch_jit(jg, jeg, jb)
        g2, eg2, ta = TG.apply_update_batch(h.g, h.eg, tb)
        assert g2 is h.g and eg2 is h.eg  # in place
        assert ta.dtype == torch.bool and ta.device.type == "cpu"
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        _assert_equal(jg, jeg, h.g, h.eg)
        _assert_rebuild(h.g, h.eg)
    if kind == "insert_only":  # the stream ran past the COO headroom
        assert h.g.overflow


def test_all_sentinel_batch_writes_nothing(small_powerlaw):
    src, dst, n, cap, k_max = _graph("small_powerlaw", small_powerlaw)
    jg, jeg = _jax_pair(src, dst, n, capacity=cap, k_max=k_max)
    h = port_handle(jg, jeg)
    before = h.copy()
    tb = TG.make_update_batch([], [], True, batch_size=8, n=n, device=CPU)
    sentinel = TG.make_update_batch([n, -1], [0, n + 3], [True, False],
                                    batch_size=8, n=n, device=CPU)
    assert not tb.has_ops and not sentinel.has_ops and sentinel.has_deletes
    versions = [x._version for x in (h.g.src, h.eg.in_nbrs, h.eg.in_deg)]
    for b in (tb, sentinel):
        jg2, jeg2, ja = JG.apply_update_batch_jit(
            jg, jeg, JG.make_update_batch(b.src.numpy()[:2], b.dst.numpy()[:2],
                                          b.insert.numpy()[:2], batch_size=8, n=n))
        _, _, ta = TG.apply_update_batch(h.g, h.eg, b)
        assert not ta.any() and not np.asarray(ja).any()
        _assert_equal(jg2, jeg2, h.g, h.eg)
    _assert_equal(jg, jeg, before.g, before.eg)
    # nothing was written, so the kernels' chunk plan of in_deg stays valid
    assert versions == [x._version for x in (h.g.src, h.eg.in_nbrs, h.eg.in_deg)]


@pytest.mark.parametrize("case", ["coo_full", "row_full", "both"])
def test_overflow_matches_repro(case):
    src = np.array([0, 1, 2], np.int32)
    dst = np.array([1, 2, 0], np.int32)
    n = 6
    cap, k_max = {"coo_full": (4, 3), "row_full": (10, 2), "both": (4, 2)}[case]
    jg, jeg = _jax_pair(src, dst, n, capacity=cap, k_max=k_max)
    h = port_handle(jg, jeg)
    batches = [([3, 4, 5, 3], [0, 1, 2, 0], True),
               ([], [], True),                       # overflow stays sticky
               ([0, 3], [1, 0], [False, True]),      # a delete frees room
               ([1, 5, 5], [0, 0, 0], True)]
    for s, d, ins in batches:
        jg, jeg, ja = JG.apply_update_batch_jit(
            jg, jeg, JG.make_update_batch(s, d, ins, batch_size=4, n=n))
        _, _, ta = TG.apply_update_batch(
            h.g, h.eg, TG.make_update_batch(s, d, ins, batch_size=4, n=n,
                                            device=CPU))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        _assert_equal(jg, jeg, h.g, h.eg)
        _assert_rebuild(h.g, h.eg)
    assert h.overflow


# ---------------------------------------------------------------------------
# Per-struct fast paths and regrow
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["insert_edges", "insert_edges_ell",
                                "delete_edges", "delete_edges_ell"])
def test_per_struct_paths_match_repro(fn, small_powerlaw):
    src, dst, n, _, k_max = _graph("small_powerlaw", small_powerlaw)
    # room for 12 more COO edges and 2 more slots in the fullest row: the
    # insert stream overflows both
    jg, jeg = _jax_pair(src, dst, n, capacity=len(src) + 12, k_max=k_max - 6)
    h = port_handle(jg, jeg)
    rng = np.random.default_rng(5)
    coo = fn in ("insert_edges", "delete_edges")
    for i in range(4):
        if fn.startswith("insert"):
            s = rng.integers(0, n, 8).astype(np.int32)
            d = rng.integers(0, n, 8).astype(np.int32)
            d[:4] = int(np.argmax(np.asarray(jeg.in_deg)))  # the fullest row
        else:
            hs, hd = JG.graph_to_host_edges(jg) if coo else (src, dst)
            pick = rng.integers(0, len(hs), 8)
            s, d = hs[pick].copy(), hd[pick].copy()
            s[1], d[1] = s[0], d[0]  # one pair twice
            s[2] = n + 1 + i  # an absent pair
        s[-1] = n  # sentinel
        if coo:
            jg = getattr(JG, fn)(jg, jnp.asarray(s), jnp.asarray(d))
            out = getattr(TG, fn)(h.g, s, d)
            assert out is h.g
        else:
            jeg = getattr(JG, fn)(jeg, jnp.asarray(s), jnp.asarray(d))
            out = getattr(TG, fn)(h.eg, s, d)
            assert out is h.eg
            check_live_prefix(h.eg.in_nbrs, h.eg.in_deg, n)
        _assert_equal(jg, jeg, h.g, h.eg)
    if fn.startswith("insert"):
        assert h.g.overflow if coo else h.eg.overflow


def test_ops_that_alias_the_mirrors(small_powerlaw):
    """Host edge lists are copies, and a per-struct path reads its ops
    before it writes: ops given as views of the very buffers the update
    writes in place give repro's result on the same values."""
    src, dst, n, cap, k_max = _graph("small_powerlaw", small_powerlaw)
    jg, jeg = _jax_pair(src, dst, n, capacity=cap, k_max=k_max)
    h = port_handle(jg, jeg)
    hs, hd = h.to_host_edges()
    first = hs[:5].copy()
    jg = JG.delete_edges(jg, jnp.asarray(hs[:5]), jnp.asarray(hd[:5]))
    TG.delete_edges(h.g, h.g.src[:5], h.g.dst[:5])  # views of the buffers
    np.testing.assert_array_equal(hs[:5], first)  # the host copy kept still
    hub = int(np.argmax(np.bincount(dst, minlength=n)))
    row = np.asarray(jeg.in_nbrs)[hub, :5]
    jeg = JG.delete_edges_ell(jeg, jnp.asarray(row), jnp.full(5, hub))
    TG.delete_edges_ell(h.eg, h.eg.in_nbrs[hub, :5], np.full(5, hub))
    _assert_equal(jg, jeg, h.g, h.eg)
    check_live_prefix(h.eg.in_nbrs, h.eg.in_deg, n)


@pytest.mark.parametrize("kw", [{}, {"capacity": 2000, "k_max": 256},
                                {"growth": 1.5}])
def test_regrow_matches_repro(kw, small_powerlaw):
    src, dst, n, cap, k_max = _graph("small_powerlaw", small_powerlaw)
    jg, jeg = _jax_pair(src, dst, n, capacity=cap, k_max=k_max)
    h = port_handle(jg, jeg)
    rng = np.random.default_rng(2)
    hs, hd = TG.graph_to_host_edges(h.g)
    pick = rng.integers(0, len(hs), 30)
    s = np.concatenate([rng.integers(0, n, 30), hs[pick]]).astype(np.int32)
    d = np.concatenate([np.full(30, np.argmax(np.bincount(dst))), hd[pick]]
                       ).astype(np.int32)
    ins = np.arange(60) < 30
    jg, jeg, _ = JG.apply_update_batch_jit(
        jg, jeg, JG.make_update_batch(s, d, ins, batch_size=64, n=n))
    TG.apply_update_batch(h.g, h.eg, TG.make_update_batch(
        s, d, ins, batch_size=64, n=n, device=CPU))
    assert h.overflow and h.version == 1
    jg, jeg = JG.regrow(jg, jeg, **kw)
    h.regrow(**kw)
    _assert_equal(jg, jeg, h.g, h.eg)
    _assert_rebuild(h.g, h.eg)
    assert not h.overflow and h.version == 1
    with pytest.raises(ValueError, match="capacity"):
        h.regrow(capacity=3)


# ---------------------------------------------------------------------------
# The fused epoch step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("top_k", [0, 5])
def test_epoch_step_matches_repro(use_kernel, top_k, small_powerlaw, key):
    src, dst, n, cap, k_max = _graph("small_powerlaw", small_powerlaw)
    jg, jeg = _jax_pair(src, dst, n, capacity=cap, k_max=k_max)
    h = port_handle(jg, jeg)
    rng = np.random.default_rng(7)
    us = [3, 11, 0]
    n_r = 64
    params = JC.make_params(n, c=0.6, eps_a=0.2, n_r_override=n_r)
    common = dict(n_r=n_r, lanes_q=32, max_len=params.max_len,
                  sqrt_c=params.sqrt_c, eps_p=params.eps_p, eps_t=params.eps_t,
                  truncation_shift=params.truncation_shift,
                  use_kernel=use_kernel, top_k=top_k)
    for step in range(2):
        hs, hd = TG.graph_to_host_edges(h.g)
        s, d, ins = _draw_batch(rng, hs, hd, n, 16, "mixed")
        keys = jax.random.split(jax.random.fold_in(key, step), len(us))
        uni = jax_uniforms(keys, n_r=n_r, max_len=params.max_len,
                           sqrt_c=params.sqrt_c)
        jg, jeg, ja, jest, jidx, jvals = j_epoch_step(
            jg, jeg, JG.make_update_batch(s, d, ins, batch_size=16, n=n), keys,
            jnp.asarray(us, jnp.int32), jnp.zeros((len(us), n), jnp.float32),
            **common)
        g2, eg2, ta, est, idx, vals = epoch_step(
            h.g, h.eg, TG.make_update_batch(s, d, ins, batch_size=16, n=n,
                                            device=CPU),
            us, uniforms=uni, **common)
        assert g2 is h.g and eg2 is h.eg
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        _assert_equal(jg, jeg, h.g, h.eg)
        np.testing.assert_allclose(est.numpy(), np.asarray(jest), rtol=1e-5,
                                   atol=1e-5)
        if top_k:
            np.testing.assert_allclose(vals.numpy(), np.asarray(jvals),
                                       rtol=1e-5, atol=1e-5)
            jv = np.asarray(jvals)
            for q in range(len(us)):
                untied = np.ones(top_k, bool)
                gaps = np.abs(np.diff(jv[q])) > 1e-4
                untied[:-1] &= gaps
                untied[1:] &= gaps
                np.testing.assert_array_equal(idx[q].numpy()[untied],
                                              np.asarray(jidx)[q][untied])
        else:
            assert idx is None and vals is None
    assert h.version == 2


def test_epoch_step_overflow_matches_repro(key):
    """An epoch whose inserts overflow a full row reports the skips and the
    sticky flag after the probe, as repro's epoch does."""
    src = np.array([0, 1, 2, 3], np.int32)
    dst = np.array([1, 2, 0, 1], np.int32)
    n, n_r = 6, 16
    jg, jeg = _jax_pair(src, dst, n, capacity=10, k_max=2)
    h = port_handle(jg, jeg)
    params = JC.make_params(n, c=0.6, eps_a=0.2, n_r_override=n_r)
    common = dict(n_r=n_r, lanes_q=16, max_len=params.max_len,
                  sqrt_c=params.sqrt_c, eps_p=params.eps_p, eps_t=params.eps_t,
                  truncation_shift=params.truncation_shift, use_kernel=False,
                  top_k=0)
    us = [1, 4]
    s, d, ins = [4, 5, 1, 2], [1, 0, 2, 3], [True, True, False, True]
    keys = jax.random.split(key, len(us))
    uni = jax_uniforms(keys, n_r=n_r, max_len=params.max_len,
                       sqrt_c=params.sqrt_c)
    jg, jeg, ja, jest, _, _ = j_epoch_step(
        jg, jeg, JG.make_update_batch(s, d, ins, batch_size=4, n=n), keys,
        jnp.asarray(us, jnp.int32), jnp.zeros((len(us), n), jnp.float32),
        **common)
    _, _, ta, est, _, _ = epoch_step(
        h.g, h.eg, TG.make_update_batch(s, d, ins, batch_size=4, n=n,
                                        device=CPU),
        us, uniforms=uni, **common)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert not ta[0] and h.overflow and h.version == 1
    _assert_equal(jg, jeg, h.g, h.eg)
    np.testing.assert_allclose(est.numpy(), np.asarray(jest), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# Padding: the in-place writes add onto exactly n
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pad", ["n_plus_1", "int32_max"])
def test_updates_on_arrays_padded_above_n(pad, small_powerlaw):
    """A snapshot whose padding holds ids above n (the JAX package overwrites
    padding, so it accepts any) is taken in with its padding set to n, and
    a mixed stream then gives repro's outputs on the n-padded snapshot."""
    src, dst, n, cap, k_max = _graph("small_powerlaw", small_powerlaw)
    jg, jeg = _jax_pair(src, dst, n, capacity=cap, k_max=k_max)
    big = n + 1 if pad == "n_plus_1" else np.iinfo(np.int32).max
    coo = [np.where(np.asarray(x) < n, np.asarray(x), big) for x in (jg.src, jg.dst)]
    nbrs = np.where(np.asarray(jeg.in_nbrs) < n, np.asarray(jeg.in_nbrs), big)
    h = TG.handle_from_arrays(src=coo[0], dst=coo[1], in_nbrs=nbrs,
                              in_deg=np.asarray(jeg.in_deg), n=n, device=CPU)
    _assert_equal(jg, jeg, h.g, h.eg)
    rng = np.random.default_rng(3)
    for _ in range(4):
        hs, hd = TG.graph_to_host_edges(h.g)
        s, d, ins = _draw_batch(rng, hs, hd, n, 16, "mixed")
        jg, jeg, ja = JG.apply_update_batch_jit(
            jg, jeg, JG.make_update_batch(s, d, ins, batch_size=16, n=n))
        _, _, ta = TG.apply_update_batch(
            h.g, h.eg, TG.make_update_batch(s, d, ins, batch_size=16, n=n,
                                            device=CPU))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        _assert_equal(jg, jeg, h.g, h.eg)
        _assert_rebuild(h.g, h.eg)


@pytest.mark.parametrize("fault", ["coo_hole", "coo_count", "coo_half_pad",
                                   "ell_pad", "ell_negative"])
def test_mirrors_breaking_the_padding_rule_are_refused(fault):
    """graph_from_arrays and set_mirrors refuse a COO whose live edges are
    not the first num_edges positions; set_mirrors refuses an ELL table
    whose padding is not exactly n."""
    src, dst, n = JG.erdos_renyi_graph(30, 90, seed=1)
    h = TA.GraphHandle.from_edges(src, dst, n, capacity=100, device=CPU)
    s, d = h.g.src.numpy().copy(), h.g.dst.numpy().copy()
    g, eg = h.g, h.eg.in_nbrs.clone()
    if fault == "coo_hole":
        s[[3, 95]], d[[3, 95]] = s[[95, 3]], d[[95, 3]]
    elif fault == "coo_half_pad":
        d[3] = n
    if fault.startswith("coo"):
        with pytest.raises(ValueError, match="live-prefix"):
            TG.graph_from_arrays(src=s, dst=d, n=n, device=CPU,
                                 num_edges=91 if fault == "coo_count" else None)
        g = dataclasses.replace(h.g, src=torch.from_numpy(s),
                                dst=torch.from_numpy(d),
                                num_edges=91 if fault == "coo_count" else 90)
        with pytest.raises(ValueError, match="live-prefix"):
            h.set_mirrors(g=g)
        return
    if fault == "ell_pad":  # the first padding slot of the shortest row
        v = int(torch.argmin(h.eg.in_deg))
        eg[v, int(h.eg.in_deg[v])] = n + 1
    else:
        eg[int(torch.argmax(h.eg.in_deg)), 0] = -1
    with pytest.raises(ValueError, match="live-prefix"):
        h.set_mirrors(eg=dataclasses.replace(h.eg, in_nbrs=eg))
    with pytest.raises(ValueError, match="live-prefix"):
        check_live_prefix(eg, h.eg.in_deg, n)
    check_coo_prefix(h.g.src, h.g.dst, h.num_edges, n)


def _serve_update_serve(dev):
    """Serve, apply a delete-heavy batch in place, serve again; then the same
    serve on a handle rebuilt from the live edges.  Returns both estimates
    and the plan-build counts of the two serves around the apply."""
    src, dst, n = JG.powerlaw_graph(300, 2400, seed=4)
    deg = np.bincount(dst, minlength=n)
    h = TA.GraphHandle.from_edges(src, dst, n, capacity=len(src) + 64,
                                  k_max=int(deg.max()) + 8, device=dev)
    params = make_params(n, c=0.6, eps_a=0.2, n_r_override=128)
    us = np.argsort(-deg)[:4].astype(np.int32)
    kw = dict(lanes=128, seeds=[1, 2, 3, 4])
    multi_source(None, h.eg, h.eg, us, params, **kw)
    hub = int(np.argmax(deg))
    rows = np.flatnonzero(dst == hub)[:24]  # 24 deletes from the hub row
    s = np.concatenate([src[rows], [5, 6]]).astype(np.int32)
    d = np.concatenate([dst[rows], [hub, 7]]).astype(np.int32)
    ins = np.arange(len(s)) >= len(rows)
    ptr, ver = h.eg.in_deg.data_ptr(), h.eg.in_deg._version
    builds = ell_plan.build_plan.builds
    applied = h.apply_batch(TG.make_update_batch(s, d, ins, batch_size=32, n=n,
                                                 device=dev))
    assert applied[: len(s)].all()
    assert h.eg.in_deg.data_ptr() == ptr and h.eg.in_deg._version != ver
    est = multi_source(None, h.eg, h.eg, us, params, **kw)
    rebuilt_builds = ell_plan.build_plan.builds - builds
    hs, hd = h.to_host_edges()
    rb = TA.GraphHandle.from_edges(hs, hd, n, capacity=h.capacity,
                                   k_max=h.k_max, device=dev)
    ref = multi_source(None, rb.eg, rb.eg, us, params, **kw)
    check_live_prefix(h.eg.in_nbrs, h.eg.in_deg, n)
    return h, est, ref, rebuilt_builds


def test_serve_update_serve_equals_rebuild_and_replans():
    """The stale-plan test on the CPU: the in-place apply keeps in_deg's
    memory and moves its _version, so plan_of builds a new plan, equal to
    one built from scratch; the serve after the apply equals a serve on a
    rebuild (plain version of the kernel path)."""
    h, est, ref, _ = _serve_update_serve(CPU)
    assert torch.equal(est, ref)
    k = h.k_max
    stale = ell_plan.build_plan(h.eg.in_deg.clone(), k)
    before = ell_plan.build_plan.builds
    plan = ell_plan.plan_of(h.eg.in_deg, k)
    assert ell_plan.plan_of(h.eg.in_deg, k) is plan  # kept while unchanged
    h.apply_batch(TG.make_update_batch([1, 2], [3, 3], True, batch_size=4,
                                       n=h.n, device=CPU))
    fresh = ell_plan.plan_of(h.eg.in_deg, k)
    assert fresh is not plan and ell_plan.build_plan.builds == before + 2
    want = ell_plan.build_plan(h.eg.in_deg.clone(), k)
    for f in ("chunks", "short_rows", "short_ptr", "long_rows", "long_first"):
        assert torch.equal(getattr(fresh, f), getattr(want, f)), f
    assert not torch.equal(stale.short_ptr, want.short_ptr)
    # an all-sentinel batch writes nothing: the plan is kept
    h.apply_batch(TG.make_update_batch([], [], True, batch_size=4, n=h.n,
                                       device=CPU))
    assert ell_plan.plan_of(h.eg.in_deg, k) is fresh


@pytest.mark.cuda
def test_serve_update_serve_on_card():
    """On the card: the kernel path after an in-place apply equals the kernel
    path on a rebuild, with exactly one new plan for the changed in_deg."""
    needs_cuda()
    ell_plan.clear_plans()
    _, est, ref, builds = _serve_update_serve("cuda")
    assert builds == 1
    torch.testing.assert_close(est, ref, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Session parity (the counterparts of tests/test_dynamic.py's engine tests)
# ---------------------------------------------------------------------------


def _sessions(src, dst, n, *, capacity=None, k_max=None, **kw):
    jh = JA.GraphHandle.from_edges(src, dst, n, capacity=capacity, k_max=k_max)
    th = TA.GraphHandle.from_edges(src, dst, n, capacity=capacity, k_max=k_max,
                                   device=CPU)
    common = dict(c=0.3, eps_a=0.3, top_k=2, batch_q=2, seed=0)
    common.update(kw)
    return JA.SimRankSession(jh, **common), TA.SimRankSession(th, **common)


def _fields(x):
    """Every field of an UpdateReport / EpochResult that is not a time."""
    d = dataclasses.asdict(x) if not isinstance(x, list) else None
    if d is None:
        return [_fields(e) for e in x]
    d.pop("latency_s", None)
    res = d.pop("results", None)
    d["skipped"] = [tuple(int(v) for v in op[:2]) + (bool(op[2]),)
                    for op in d.pop("skipped", d.pop("skipped_ops", []))]
    if res is not None:
        d["results"] = [(r["kind"], int(r["node"]), r["version"], r["walks_used"],
                         r["variant"]) for r in res]
    return d


def _same_state(js, ts):
    _assert_equal(js.handle.g, js.handle.eg, ts.handle.g, ts.handle.eg)
    _assert_rebuild(ts.handle.g, ts.handle.eg)
    assert js.pending == ts.pending
    jst, tst = js.stats.as_dict(), ts.stats.as_dict()
    for k in ("queries", "updates", "steps", "epochs", "regrows"):
        assert jst[k] == tst[k], k


@pytest.fixture()
def small():
    src, dst, n = JG.erdos_renyi_graph(60, 300, seed=5)
    return dict(src=src, dst=dst, n=n, capacity=len(src) + 64,
                k_max=int(np.bincount(dst, minlength=n).max()) + 8)


def _session_kw(d):
    return dict(capacity=d["capacity"], k_max=d["k_max"])


def test_session_update_matches_repro(small):
    js, ts = _sessions(small["src"], small["dst"], small["n"], **_session_kw(small))
    rng = np.random.default_rng(4)
    n = small["n"]
    fresh = (int(small["src"][0]) + 9) % n, int(small["dst"][0])
    calls = [
        dict(inserts=(rng.integers(0, n, 10), rng.integers(0, n, 10))),
        dict(inserts=([fresh[0]] * 2, [fresh[1]] * 2)),
        # duplicate pairs in one call: one copy per op (multigraph split)
        dict(deletes=([fresh[0]] * 2 + [int(small["src"][3])],
                      [fresh[1]] * 2 + [int(small["dst"][3])])),
        dict(inserts=([1], [2]), deletes=([1, 0], [2, 0])),  # 0->0 is absent
    ]
    for kw in calls:
        assert _fields(js.update(**kw)) == _fields(ts.update(**kw))
        _same_state(js, ts)
    assert ts.version == 6  # calls 3 and 4 apply two sub-batches each


@pytest.mark.parametrize("auto_regrow", [True, False])
def test_session_update_overflow_matches_repro(auto_regrow):
    src = np.array([0, 1, 2], np.int32)
    dst = np.array([1, 2, 0], np.int32)
    js, ts = _sessions(src, dst, 6, capacity=4, k_max=2, auto_regrow=auto_regrow)
    kw = dict(inserts=([3, 4, 5], [0, 1, 2]))
    rj, rt = js.update(**kw), ts.update(**kw)
    assert _fields(rj) == _fields(rt)
    assert (rt.regrows > 0) == auto_regrow and rt.overflow != auto_regrow
    _same_state(js, ts)
    js.regrow(capacity=16, k_max=4)
    ts.regrow(capacity=16, k_max=4)
    _same_state(js, ts)


def _epoch_parity(js, ts, **epoch_kw):
    je = js.drain_epochs(**epoch_kw)
    te = ts.drain_epochs(**epoch_kw)
    assert _fields(je) == _fields(te)
    _same_state(js, ts)
    return te


def test_session_epochs_match_repro(small):
    """A mixed epoch stream with queries: an insert->delete conflict and a
    repeated delete pair cut the batch, overflowing inserts are regrown and
    retried, results carry the post-update version."""
    n = small["n"]
    js, ts = _sessions(small["src"], small["dst"], n, update_batch=8,
                       capacity=len(small["src"]) + 3, k_max=small["k_max"])
    rng = np.random.default_rng(6)
    fresh = (int(small["src"][0]) + 7) % n, int(small["dst"][0])
    ops = [([fresh[0]], [fresh[1]], True), ([fresh[0]], [fresh[1]], False),
           (small["src"][:3], small["dst"][:3], False),
           (rng.integers(0, n, 9), rng.integers(0, n, 9), True),
           ([small["src"][5]] * 2, [small["dst"][5]] * 2, False)]
    for s_ in (js, ts):
        for s, d, ins in ops:
            s_.queue_update(s, d, insert=ins)
        for u in (1, 2, 3):
            s_.submit(u)
    assert js.pending == ts.pending == (16, 3)
    te = _epoch_parity(js, ts, budget_walks=16)
    assert te[0].updates_submitted == 1  # cut before the delete of fresh
    assert any(e.regrown for e in te) and not ts.overflow
    assert [len(e.results) for e in te][:2] == [2, 1]
    assert ts.stats.regrows >= 1 and ts.stats.epochs == len(te)


def test_session_epochs_no_autoregrow_surface_skips():
    src = np.array([0, 1, 2], np.int32)
    dst = np.array([1, 2, 0], np.int32)
    js, ts = _sessions(src, dst, 6, capacity=4, k_max=2, update_batch=8,
                       auto_regrow=False)
    for s_ in (js, ts):
        s_.queue_update([3, 4, 5], [0, 1, 2])
        s_.submit(0)
    (te,) = _epoch_parity(js, ts, budget_walks=16)
    assert sorted(te.skipped_ops) == [(4, 1, True), (5, 2, True)]
    assert ts.overflow and not te.regrown and te.updates_requeued == 0


def test_session_update_only_epochs_and_rejects(small):
    n = small["n"]
    js, ts = _sessions(small["src"], small["dst"], n, update_batch=4,
                       **_session_kw(small))
    for s_ in (js, ts):
        with pytest.raises(ValueError, match="out of range"):
            s_.queue_update([n], [0])
        with pytest.raises(ValueError, match="out of range"):
            s_.update(deletes=([0], [-1]))
    assert js.pending == ts.pending == (0, 0)
    rng = np.random.default_rng(4)
    s, d = rng.integers(0, n, 10), rng.integers(0, n, 10)
    for s_ in (js, ts):
        s_.queue_update(s, d)
    te = _epoch_parity(js, ts, budget_walks=16)
    assert len(te) == 3 and all(e.results == [] for e in te)
    assert ts.version == 3 and ts.pending == (0, 0)
    # a query-only epoch changes nothing and stamps the current version
    te = ts.epoch(queries=[1], budget_walks=16)
    assert (te.version, te.updates_submitted, te.results[0].version) == (3, 0, 3)
    assert te.results[0].variant == "telescoped"


def test_session_epoch_ownership(small):
    """Epochs write the mirrors in place: the session's copy, never the
    caller's handle; own_graph=False refuses epochs, as repro does."""
    th = TA.GraphHandle.from_edges(small["src"], small["dst"], small["n"],
                                   capacity=small["capacity"],
                                   k_max=small["k_max"], device=CPU)
    before = th.copy()
    ts = TA.SimRankSession(th, batch_q=2, update_batch=4, top_k=2)
    ts.epoch(inserts=([1], [2]), queries=[1], budget_walks=16)
    assert ts.version == 1 and th.version == 0
    assert torch.equal(th.g.src, before.g.src)
    assert torch.equal(th.eg.in_nbrs, before.eg.in_nbrs)
    jh = JA.GraphHandle.from_edges(small["src"], small["dst"], small["n"])
    for sess in (JA.SimRankSession(jh, own_graph=False),
                 TA.SimRankSession(th, own_graph=False)):
        with pytest.raises(ValueError, match="owned graph"):
            sess.epoch()
    be = TA.LocalBackend(th, params=make_params(th.n), walk_chunk=64)
    s = TA.SimRankSession(be)
    assert be.handle is not th and s.handle is be.handle
    s.epoch(inserts=([1], [2]))
    assert th.version == 0 and s.version == 1


def test_handle_set_mirrors_copies():
    src, dst, n = JG.erdos_renyi_graph(30, 90, seed=1)
    h = TA.GraphHandle.from_edges(src, dst, n, device=CPU)
    g = TG.graph_from_edges(src[:50], dst[:50], n, device=CPU)
    h.set_mirrors(g=g)
    assert h.g is not g and torch.equal(h.g.src, g.src) and h.num_edges == 50
    h.set_mirrors(eg=h.eg, copy=False)
    with pytest.raises(ValueError, match="n="):
        h.set_mirrors(g=TG.graph_from_edges(src, dst, n + 1, device=CPU))


def _state(h):
    """A handle's mirrors and snapshot fields as host values."""
    return ([x.cpu().numpy().tolist() for x in (h.g.src, h.g.dst, h.g.in_deg,
                                               h.g.out_deg, h.eg.in_nbrs,
                                               h.eg.in_deg)]
            + [h.num_edges, h.capacity, h.k_max, h.version, h.overflow])


@pytest.mark.cuda
def test_dynamic_paths_on_card_equal_cpu(small):
    """Every dynamic entry point on a CUDA handle gives the CPU's results:
    the session's update / queue_update / drain_epochs / regrow / pending,
    the per-struct paths and set_mirrors (scores are not compared: the two
    devices draw different walks from one seed)."""
    needs_cuda()
    n = small["n"]
    outs = []
    for dev in (CPU, "cuda"):
        h = TA.GraphHandle.from_edges(small["src"], small["dst"], n,
                                      capacity=small["src"].size + 20,
                                      k_max=small["k_max"], device=dev)
        s = TA.SimRankSession(h, c=0.3, eps_a=0.3, top_k=2, batch_q=2,
                              update_batch=8, seed=0)
        rng = np.random.default_rng(9)
        out = [_fields(s.update(inserts=(rng.integers(0, n, 12),
                                         rng.integers(0, n, 12)))),
               _fields(s.update(deletes=(small["src"][:6], small["dst"][:6]))),
               _state(s.handle)]
        s.queue_update(rng.integers(0, n, 20), rng.integers(0, n, 20))
        s.queue_update(small["src"][6:9], small["dst"][6:9], insert=False)
        for u in (1, 2, 3):
            s.submit(u)
        out += [s.pending, _fields(s.drain_epochs(budget_walks=16)),
                _state(s.handle)]
        s.regrow(k_max=small["k_max"] + 4)
        out += [_state(s.handle), s.stats.as_dict()]
        hc = s.handle.copy()
        s_, d_ = rng.integers(0, n, 6), rng.integers(0, n, 6)
        TG.insert_edges(hc.g, s_, d_)
        TG.insert_edges_ell(hc.eg, s_, d_)
        out.append(_state(hc))
        hs, hd = hc.to_host_edges()
        TG.delete_edges(hc.g, hs[:5], hd[:5])
        TG.delete_edges_ell(hc.eg, hs[:5], hd[:5])
        h2 = TA.GraphHandle.from_edges(small["src"], small["dst"], n, device=dev)
        h2.set_mirrors(g=hc.g, eg=hc.eg)
        check_live_prefix(h2.eg.in_nbrs, h2.eg.in_deg, n)
        out += [_state(hc), _state(h2)]
        outs.append(out)
    what = ["update inserts", "update deletes", "state after updates",
            "pending", "epochs", "state after epochs", "state after regrow",
            "stats", "per-struct inserts", "per-struct deletes", "set_mirrors"]
    for name, a, b in zip(what, *outs):
        assert a == b, name
