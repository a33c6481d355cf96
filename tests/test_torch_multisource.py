"""repro_torch fused serve path and single-source variants held against repro.

With repro's walk draws injected (``uniforms=``), the port's
``multi_source``/``multi_source_topk`` agree with repro's at 1e-5 (float
summation order).  The port's own RNG is held to the batch == per-query
contract and, on the paper's toy graph, to the Thm-1/2 bound.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core as J
from repro_torch.core import (
    estimate_walk_reference,
    make_params,
    multi_source,
    multi_source_topk,
    probe_prefix_reference,
    probe_tree_levels,
    probe_walks_telescoped,
    sample_walks,
    sample_walks_batch,
    single_source,
    topk,
)
from repro_torch.core.tree import build_prefix_tree
from repro_torch.core.walks import make_generator
from torch_port_helpers import jax_uniforms, one_thread, port_handle

# a file of many small CPU ops: one intra-op thread beside the other workers
pytestmark = pytest.mark.usefixtures("one_thread")


def _setup(d, key, us, *, n_r, c=0.6, eps_a=0.2):
    params = make_params(d["n"], c=c, eps_a=eps_a, n_r_override=n_r)
    keys = jax.random.split(key, len(us))
    uni = jax_uniforms(keys, n_r=n_r, max_len=params.max_len,
                       sqrt_c=params.sqrt_c)
    return params, keys, uni, port_handle(d["g"], d["eg"])


@pytest.mark.parametrize("name,us,n_r,lanes", [
    ("toy", [0, 3], 96, 32),
    ("toy", [0, 3], 77, 32),   # partial pool: n_r % lanes != 0
    ("toy", [2], 5, 64),       # n_r < lanes
    ("small_powerlaw", [3, 11, 3], 150, 96),
])
@pytest.mark.parametrize("push", ["coo", "ell"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_multi_source_matches_repro(request, key, name, us, n_r, lanes, push,
                                    use_kernel):
    d = request.getfixturevalue(name)
    params, keys, uni, h = _setup(d, key, us, n_r=n_r)
    jg, tg = (d["g"], h.g) if push == "coo" else (d["eg"], h.eg)
    ref = np.asarray(J.multi_source(None, jg, d["eg"], jnp.asarray(us), params,
                                    lanes=lanes, keys=keys))
    est = multi_source(None, tg, h.eg, us, params, lanes=lanes, uniforms=uni,
                       use_kernel=use_kernel)
    assert est.shape == (len(us), d["n"]) and est.dtype == torch.float32
    np.testing.assert_allclose(est.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_multi_source_topk_matches_repro(small_powerlaw, key):
    d = small_powerlaw
    us = [3, 11, 0, 7]
    params, keys, uni, h = _setup(d, key, us, n_r=128)
    j_idx, j_vals = J.multi_source_topk(None, d["g"], d["eg"], jnp.asarray(us),
                                        10, params, lanes=64, keys=keys)
    t_idx, t_vals = multi_source_topk(None, h.g, h.eg, us, 10, params, lanes=64,
                                      uniforms=uni)
    j_idx, j_vals = np.asarray(j_idx), np.asarray(j_vals)
    np.testing.assert_allclose(t_vals.numpy(), j_vals, rtol=1e-5, atol=1e-5)
    for q, u in enumerate(us):
        assert u not in t_idx[q].tolist()
        gaps = np.abs(np.diff(j_vals[q]))
        untied = np.ones(10, bool)
        untied[:-1] &= gaps > 1e-4
        untied[1:] &= gaps > 1e-4
        np.testing.assert_array_equal(t_idx[q].numpy()[untied], j_idx[q][untied])


def test_kernel_on_equals_off(small_powerlaw):
    """The lane-probe level (plain version on CPU) == the kernel-off
    composition over the ELL push, under the port's own RNG."""
    h = port_handle(small_powerlaw["g"], small_powerlaw["eg"])
    params = make_params(h.n, c=0.6, eps_a=0.2, n_r_override=128)
    on = multi_source(5, h.g, h.eg, [3, 11], params, lanes=64, use_kernel=True)
    off = multi_source(5, h.eg, h.eg, [3, 11], params, lanes=64, use_kernel=False)
    coo = multi_source(5, h.g, h.eg, [3, 11], params, lanes=64, use_kernel=False)
    np.testing.assert_allclose(on.numpy(), off.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(on.numpy(), coo.numpy(), rtol=1e-5, atol=1e-6)


def test_bf16_storage_close_to_fp32(small_powerlaw):
    """bf16 lane buffers with fp32 accumulation stay within 1e-3 of fp32 on
    unit-scale estimates (repro's bound)."""
    h = port_handle(small_powerlaw["g"], small_powerlaw["eg"])
    params = make_params(h.n, c=0.6, eps_a=0.2, n_r_override=256)
    f32 = multi_source(9, h.eg, h.eg, [3, 11], params, lanes=96)
    bf16 = multi_source(9, h.eg, h.eg, [3, 11], params, lanes=96,
                        kernel_dtype="bfloat16")
    assert np.abs(f32.numpy() - bf16.numpy()).max() < 1e-3


def test_batch_matches_per_query(small_powerlaw):
    """A Q = 4 batch == 4 single-query calls with the same per-query seeds."""
    h = port_handle(small_powerlaw["g"], small_powerlaw["eg"])
    params = make_params(h.n, c=0.6, eps_a=0.2, n_r_override=150)
    us = np.argsort(-h.eg.in_deg.numpy())[:4].astype(np.int32)
    seeds = [101, 102, 103, 104]
    batch = multi_source(None, h.g, h.eg, us, params, lanes=64, seeds=seeds)
    for i in range(4):
        solo = multi_source(None, h.g, h.eg, us[i:i + 1], params, lanes=64,
                            seeds=seeds[i:i + 1])
        np.testing.assert_allclose(batch[i].numpy(), solo[0].numpy(), atol=1e-5)


def test_fused_equals_telescoped_oracle(toy):
    """Compacted fused probe == per-walk telescoped sums of the same pool."""
    h = port_handle(toy["g"], toy["eg"])
    params = make_params(h.n, c=0.25, eps_a=0.1, n_r_override=77)
    seeds = [1, 2]
    est = multi_source(None, h.g, h.eg, [0, 3], params, lanes=32, seeds=seeds)
    pool = sample_walks_batch([make_generator(s, "cpu") for s in seeds], h.eg,
                              [0, 3], n_r=77, max_len=params.max_len,
                              sqrt_c=params.sqrt_c)
    for q, u in enumerate([0, 3]):
        cols = probe_walks_telescoped(h.g, pool[q], sqrt_c=params.sqrt_c,
                                      eps_p=params.eps_p)
        ref = cols.sum(dim=1) / 77
        ref[u] = 1.0
        np.testing.assert_allclose(est[q].numpy(), ref.numpy(), atol=2e-5)


def test_probes_match_repro_on_same_walks(small_powerlaw, key):
    """Telescoped, tree and reference probes of one JAX walk pool == repro's."""
    d = small_powerlaw
    h = port_handle(d["g"], d["eg"])
    u = int(np.argmax(np.asarray(d["g"].in_deg)))
    walks = J.sample_walks(key, d["eg"], u, n_r=32, max_len=7, sqrt_c=0.775)
    tw = torch.from_numpy(np.array(walks))
    for jgr, tgr in ((d["g"], h.g), (d["eg"], h.eg)):
        ref = np.asarray(J.probe_walks_telescoped(jgr, walks, sqrt_c=0.775,
                                                  eps_p=0.01))
        out = probe_walks_telescoped(tgr, tw, sqrt_c=0.775, eps_p=0.01)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
    tree = build_prefix_tree(np.asarray(walks), d["n"])
    jt = J.probe_tree_levels(
        d["g"], *(tuple(jnp.asarray(x) for x in f) for f in
                  (tree.nodes, tree.weights, tree.parent, tree.parent_node)),
        sqrt_c=0.775, eps_p=0.01)
    for tgr in (h.g, h.eg):
        tt = probe_tree_levels(tgr, tree.nodes, tree.weights, tree.parent,
                               tree.parent_node, sqrt_c=0.775, eps_p=0.01)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5,
                                   atol=1e-6)
    for k in (0, 5):
        np.testing.assert_allclose(
            estimate_walk_reference(h.g, tw[k], 0.775, eps_p=0.01).numpy(),
            np.asarray(J.estimate_walk_reference(d["g"], walks[k], 0.775,
                                                 eps_p=0.01)),
            rtol=1e-5, atol=1e-6)


def test_single_source_variants_agree(small_powerlaw):
    """One seed gives every variant the same walk pool (chunk 0 and query 0
    share a stream), so telescoped, tree, auto and reference agree."""
    h = port_handle(small_powerlaw["g"], small_powerlaw["eg"])
    params = make_params(h.n, c=0.6, eps_a=0.3, n_r_override=60)
    u = int(np.argmax(h.eg.in_deg.numpy()))
    tele = single_source(3, h.g, h.eg, u, params, walk_chunk=64)
    assert float(tele[u]) == 1.0
    for variant, g in (("tree", h.g), ("tree", h.eg), ("auto", h.eg),
                       ("reference", h.g)):
        est = single_source(3, g, h.eg, u, params, variant=variant,
                            walk_chunk=64)
        np.testing.assert_allclose(est.numpy(), tele.numpy(), atol=1e-5,
                                   err_msg=variant)
    idx, vals = topk(3, h.g, h.eg, u, 5, params, walk_chunk=64)
    assert u not in idx.tolist() and (np.diff(vals.numpy()) <= 0).all()
    rnd = single_source(3, h.g, h.eg, u, params, variant="randomized",
                        walk_chunk=64)
    assert float(rnd[u]) == 1.0 and bool(torch.isfinite(rnd).all())
    with pytest.raises(ValueError, match="unknown variant"):
        single_source(3, h.g, h.eg, u, params, variant="nope")


@pytest.mark.parametrize("variant", ["telescoped", "tree"])
def test_error_bound_toy(toy, variant):
    """The port's own RNG stays within the Thm-2 bound of the Power Method
    (repro.core.power) on the paper's graph."""
    truth = np.asarray(J.simrank_power(toy["g"], c=0.25, iters=60))[0]
    h = port_handle(toy["g"], toy["eg"])
    params = make_params(h.n, c=0.25, eps_a=0.1, delta=0.01)
    est = single_source(0, h.g, h.eg, 0, params, variant=variant).numpy()
    err = np.abs(est - truth)
    err[0] = 0
    assert err.max() <= params.eps_a, f"maxerr {err.max()}"


# ---------------------------------------------------------------------------
# The paper's worked example (tests/test_paper_example.py counterparts)
# ---------------------------------------------------------------------------

SQRT_C = 0.5  # the example's c = 0.25
WALK = [0, 1, 0, 1]  # W(a) = (a, b, a, b)
NODES = "abcdefgh"


def _scores(vec, tol=1e-9):
    return {NODES[i]: float(v) for i, v in enumerate(vec.tolist()) if v > tol}


def test_paper_probe_prefixes(toy):
    h = port_handle(toy["g"], toy["eg"])
    s2 = _scores(probe_prefix_reference(h.g, WALK[:2], SQRT_C))
    assert s2 == pytest.approx({"c": 1 / 6, "d": 0.5, "e": 0.25}, abs=1e-6)
    s3 = _scores(probe_prefix_reference(h.g, WALK[:3], SQRT_C))
    assert s3 == pytest.approx({"f": 1 / 48, "g": 1 / 36, "h": 1 / 36}, abs=1e-6)
    s4 = _scores(probe_prefix_reference(h.eg, WALK[:4], SQRT_C))
    assert set(s4) == {"b", "c", "e", "f"}
    for ch, want in dict(b=0.011, c=0.033, e=0.038, f=0.019).items():
        assert s4[ch] == pytest.approx(want, abs=1.5e-3)


def test_paper_walk_estimate_and_telescoping(toy):
    h = port_handle(toy["g"], toy["eg"])
    est = estimate_walk_reference(h.g, WALK, SQRT_C)
    s = _scores(est)
    for ch, want in dict(b=0.011, c=0.2, d=0.5, e=0.2877, f=0.04, g=0.028,
                         h=0.028).items():
        assert s[ch] == pytest.approx(want, abs=2e-3), ch
    for g in (h.g, h.eg):
        tele = probe_walks_telescoped(g, torch.tensor([WALK], dtype=torch.int32),
                                      sqrt_c=SQRT_C)[:, 0]
        np.testing.assert_allclose(tele.numpy(), est.numpy(), atol=1e-6)


def test_sample_walks_from_seed_is_reproducible(toy):
    h = port_handle(toy["g"], toy["eg"])
    a = sample_walks(make_generator(4, "cpu"), h.eg, 0, n_r=20, max_len=5,
                     sqrt_c=0.5)
    b = sample_walks(make_generator(4, "cpu"), h.eg, 0, n_r=20, max_len=5,
                     sqrt_c=0.5)
    assert torch.equal(a, b) and (a[:, 0] == 0).all()


def test_fused_serve_plan_and_buffers(small_powerlaw, monkeypatch):
    """The kernel path hands every level the graph's own in_deg tensor (the
    kernel's plan is built on the first launch and found after; the plain
    version on the CPU builds none), reads each level from one of two
    [n + 1, W] buffers and writes the other (out never the table), deposits
    into total in place, and makes no torch.cat per level."""
    import repro_torch.kernels.lane_probe.ops as lops
    from repro_torch.kernels.ell_plan import build_plan

    h = port_handle(small_powerlaw["g"], small_powerlaw["eg"])
    params = make_params(h.n, c=0.6, eps_a=0.2, n_r_override=400)
    want = multi_source(5, h.g, h.eg, [3, 11], params, lanes=64)
    seen, cats = [], [0]
    real_level, real_cat = lops.lane_probe_level, torch.cat

    def level(*args, **kw):
        seen.append((args[2].data_ptr(), kw["out"].data_ptr(),
                     args[4].data_ptr(), kw["tot"].data_ptr(), kw["row_len"]))
        return real_level(*args, **kw)

    def cat(*args, **kw):
        cats[0] += 1
        return real_cat(*args, **kw)

    monkeypatch.setattr(lops, "lane_probe_level", level)
    monkeypatch.setattr(torch, "cat", cat)
    before = build_plan.builds
    est = multi_source(5, h.g, h.eg, [3, 11], params, lanes=64)
    assert build_plan.builds == before
    assert torch.equal(est, want)
    assert len(seen) > 8 and cats[0] < len(seen) // 4
    tables = {t for t, _, _, _, _ in seen}
    assert len(tables) == 2 and all(o != t and o in tables for t, o, _, _, _ in seen)
    assert all(tot == total for _, _, total, tot, _ in seen)
    assert len({id(rl) for *_, rl in seen}) == 1
    assert torch.equal(seen[0][-1], h.eg.in_deg)
