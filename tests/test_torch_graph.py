"""repro_torch graph layer and numpy copies held against repro.

Integer outputs (COO/ELL tables, degrees, generators, prefix trees) must be
equal; float outputs of the three pushes agree within 1e-6.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.graph import structs as jstructs
from repro_torch.graph import structs as tstructs
from torch_port_helpers import CPU, port_handle

GRAPHS = ("toy", "small_powerlaw")


def _graph(request, name):
    return request.getfixturevalue(name)


@pytest.mark.parametrize("name", GRAPHS)
def test_coo_mirror_equal(request, name):
    d = _graph(request, name)
    for cap in (None, len(d["src"]) + 7):
        jg = jstructs.graph_from_edges(d["src"], d["dst"], d["n"], capacity=cap)
        tg = tstructs.graph_from_edges(d["src"], d["dst"], d["n"], capacity=cap,
                                       device=CPU)
        for f in ("src", "dst", "in_deg", "out_deg"):
            a, b = np.asarray(getattr(jg, f)), getattr(tg, f).numpy()
            assert b.dtype == np.int32
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert (tg.n, tg.capacity, tg.num_edges) == (jg.n, jg.capacity,
                                                    int(jg.num_edges))
        np.testing.assert_array_equal(np.asarray(jg.edge_mask()),
                                      tg.edge_mask().numpy())
        np.testing.assert_allclose(np.asarray(jg.inv_in_deg),
                                   tg.inv_in_deg.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("pad", [0, 5])
def test_ell_mirror_equal(request, name, pad):
    d = _graph(request, name)
    k_max = int(np.bincount(d["dst"], minlength=d["n"]).max()) + pad
    jeg = jstructs.ell_from_edges(d["src"], d["dst"], d["n"], k_max=k_max)
    teg = tstructs.ell_from_edges(d["src"], d["dst"], d["n"], k_max=k_max,
                                  device=CPU)
    assert teg.in_nbrs.dtype == torch.int32 and teg.k_max == jeg.k_max
    np.testing.assert_array_equal(np.asarray(jeg.in_nbrs), teg.in_nbrs.numpy())
    np.testing.assert_array_equal(np.asarray(jeg.in_deg), teg.in_deg.numpy())
    # every padded slot is the sentinel n (the dump row's index)
    slots = np.arange(k_max)[None, :] >= teg.in_deg.numpy()[:, None]
    assert (teg.in_nbrs.numpy()[slots] == d["n"]).all()


def test_ell_rejects_small_k_max(small_powerlaw):
    d = small_powerlaw
    with pytest.raises(ValueError, match="exceeds k_max"):
        tstructs.ell_from_edges(d["src"], d["dst"], d["n"], k_max=1, device=CPU)


@pytest.mark.parametrize("name", GRAPHS)
def test_convert_carries_jax_state(request, name):
    """handle_from_arrays rebuilds the JAX mirrors verbatim (padding, slot
    order, version, overflow)."""
    d = _graph(request, name)
    jg = jstructs.graph_from_edges(d["src"], d["dst"], d["n"],
                                   capacity=len(d["src"]) + 9)
    k_max = int(np.bincount(d["dst"], minlength=d["n"]).max()) + 3
    jeg = jstructs.ell_from_edges(d["src"], d["dst"], d["n"], k_max=k_max)
    jg = jg.replace(version=jnp.asarray(3, jnp.int32), overflow=jnp.asarray(True))
    jeg = jeg.replace(version=jnp.asarray(3, jnp.int32))
    h = port_handle(jg, jeg)
    np.testing.assert_array_equal(h.g.src.numpy(), np.asarray(jg.src))
    np.testing.assert_array_equal(h.g.dst.numpy(), np.asarray(jg.dst))
    np.testing.assert_array_equal(h.g.in_deg.numpy(), np.asarray(jg.in_deg))
    np.testing.assert_array_equal(h.eg.in_nbrs.numpy(), np.asarray(jeg.in_nbrs))
    assert (h.version, h.overflow, h.capacity, h.k_max, h.num_edges) == (
        3, True, jg.capacity, k_max, len(d["src"]))
    src, dst = h.to_host_edges()
    np.testing.assert_array_equal(src, d["src"])
    np.testing.assert_array_equal(dst, d["dst"])


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("cols", [None, 5])
def test_pushes_match_jax(request, name, cols):
    """push_coo, push_ell and push_ell_padded == repro's within 1e-6."""
    d = _graph(request, name)
    n = d["n"]
    rng = np.random.default_rng(11)
    shape = (n,) if cols is None else (n, cols)
    scores = rng.random(shape).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    h = port_handle(d["g"], d["eg"])
    ts, tw = torch.from_numpy(scores), torch.from_numpy(w)
    pairs = [
        (jstructs.push_coo(d["g"], jnp.asarray(scores), jnp.asarray(w)),
         tstructs.push_coo(h.g, ts, tw)),
        (jstructs.push_ell(d["eg"], jnp.asarray(scores), jnp.asarray(w)),
         tstructs.push_ell(h.eg, ts, tw)),
        (jstructs.push_coo(d["g"], jnp.asarray(scores)),
         tstructs.push_coo(h.g, ts)),
    ]
    padded = np.concatenate([scores, np.zeros((1,) + shape[1:], np.float32)])
    pairs.append((
        jstructs.push_ell_padded(d["eg"], jnp.asarray(padded), jnp.asarray(w)),
        tstructs.push_ell_padded(h.eg, torch.from_numpy(padded), tw),
    ))
    for a, b in pairs:
        assert tuple(b.shape) == shape
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6, atol=1e-6)


def test_gather_sum_chunks_match_whole(small_powerlaw, monkeypatch):
    """A byte budget of a few rows per chunk gives the one-shot answer."""
    h = port_handle(small_powerlaw["g"], small_powerlaw["eg"])
    scores = torch.rand((h.n + 1, 3), generator=torch.Generator().manual_seed(0))
    scores[h.n] = 0
    whole = tstructs.push_ell_padded(h.eg, scores)
    monkeypatch.setattr(tstructs, "GATHER_BUDGET_BYTES", 3 * h.k_max * 3 * 4)
    np.testing.assert_array_equal(tstructs.push_ell_padded(h.eg, scores).numpy(),
                                  whole.numpy())


# ---------------------------------------------------------------------------
# The numpy / pure-Python copies, pinned equal to their originals
# ---------------------------------------------------------------------------


def test_generators_copy_equal():
    from repro.graph import generators as jgen
    from repro_torch.graph import generators as tgen

    assert tgen.TOY_TABLE2 == jgen.TOY_TABLE2
    assert tgen.TOY_EDGES == jgen.TOY_EDGES and tgen.TOY_NODES == jgen.TOY_NODES
    assert tgen.PAPER_DATASETS == jgen.PAPER_DATASETS
    cases = [
        ("toy_graph", ()),
        ("powerlaw_graph", (200, 1500, 3)),
        ("powerlaw_graph", (500, 4000, 1, 2.3, 20)),
        ("erdos_renyi_graph", (300, 900, 2)),
        ("bipartite_graph", (50, 80, 600, 4)),
        ("paper_dataset", ("hepth", 0.02)),
        ("paper_dataset", ("hepph", 0.01, 5)),
    ]
    for fn, args in cases:
        a, b = getattr(jgen, fn)(*args), getattr(tgen, fn)(*args)
        assert a[2] == b[2]
        for x, y in zip(a[:2], b[:2]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y, err_msg=fn)


def test_params_copy_equal():
    from repro.core import params as jp
    from repro_torch.core import params as tp

    for n, kw in [(8, dict(c=0.25)), (34_546, {}), (1000, dict(eps_a=0.2,
                  delta=0.05, truncation_shift=True)),
                  (500, dict(n_r_override=77, max_len_override=5))]:
        a, b = jp.make_params(n, **kw), tp.make_params(n, **kw)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.sqrt_c == b.sqrt_c
        for n_r in (None, 10, 1000):
            assert jp.abs_error_bound(a, n=n, n_r=n_r) == tp.abs_error_bound(
                b, n=n, n_r=n_r)
        for eps in (0.0, 0.05, 0.2, 0.5):
            assert jp.walks_for_error(a, n=n, epsilon=eps) == tp.walks_for_error(
                b, n=n, epsilon=eps)
    with pytest.raises(ValueError):
        tp.make_params(10, c=1.5)


def test_tree_copy_equal(small_powerlaw):
    from repro.core import tree as jt
    from repro_torch.core import tree as tt

    n = small_powerlaw["n"]
    rng = np.random.default_rng(5)
    walks = rng.integers(0, n + 1, (64, 6)).astype(np.int32)
    walks[:, 0] = 3
    walks[:, 1] = rng.integers(0, 4, 64)  # shared prefixes
    lengths = rng.integers(1, 7, 64)
    walks[np.arange(6)[None, :] >= lengths[:, None]] = n  # dead tails
    for pad_to in (8, 3):
        a = jt.build_prefix_tree(walks, n, pad_to=pad_to)
        b = tt.build_prefix_tree(walks, n, pad_to=pad_to)
        assert (a.n_r, a.total_columns) == (b.n_r, b.total_columns)
        for f in ("nodes", "weights", "parent", "parent_node"):
            for x, y in zip(getattr(a, f), getattr(b, f), strict=True):
                np.testing.assert_array_equal(x, y)
        assert jt.tree_stats(a) == tt.tree_stats(b)


# ---------------------------------------------------------------------------
# The live-prefix rule the kernels' row extent relies on
# ---------------------------------------------------------------------------


def _live_first(in_nbrs, in_deg, n):
    """in_nbrs[v, k] < n exactly when k < in_deg[v] (numpy)."""
    slots = np.arange(in_nbrs.shape[1])[None, :] < in_deg[:, None]
    return bool(((in_nbrs < n) == slots).all())


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("pad", [0, 3])
def test_port_ell_keeps_live_slots_first(request, name, pad):
    d = _graph(request, name)
    k_max = int(np.bincount(d["dst"], minlength=d["n"]).max()) + pad
    teg = tstructs.ell_from_edges(d["src"], d["dst"], d["n"], k_max=k_max,
                                  device=CPU)
    assert _live_first(teg.in_nbrs.numpy(), teg.in_deg.numpy(), d["n"])
    tstructs.check_live_prefix(teg.in_nbrs, teg.in_deg, d["n"])


@pytest.mark.parametrize("name", GRAPHS)
def test_reference_updates_keep_live_slots_first(request, name):
    """repro's apply_update_batch keeps live slots first after a stream of
    delete-heavy batches (stable row compaction, appends at in_deg), and the
    port accepts each snapshot through ell_from_arrays."""
    from repro.graph.dynamic import apply_update_batch_jit, make_update_batch
    from repro_torch.graph.convert import ell_from_arrays

    d = _graph(request, name)
    n = d["n"]
    k_max = int(np.bincount(d["dst"], minlength=n).max()) + 2
    g = jstructs.graph_from_edges(d["src"], d["dst"], n, capacity=len(d["src"]) + 16)
    eg = jstructs.ell_from_edges(d["src"], d["dst"], n, k_max=k_max)
    rng = np.random.default_rng(5)
    for _ in range(6):
        src, dst = jstructs.graph_to_host_edges(g)
        pick = rng.choice(len(src), size=min(len(src), 6), replace=False)
        new_s, new_d = rng.integers(0, n, 2), rng.integers(0, n, 2)
        batch = make_update_batch(
            np.concatenate([src[pick], new_s]), np.concatenate([dst[pick], new_d]),
            np.concatenate([np.zeros(len(pick), bool), np.ones(2, bool)]),
            batch_size=16, n=n)
        g, eg, applied = apply_update_batch_jit(g, eg, batch)
        assert bool(np.asarray(applied)[: len(pick)].all())
        nbrs, deg = np.asarray(eg.in_nbrs), np.asarray(eg.in_deg)
        assert _live_first(nbrs, deg, n)
        teg = ell_from_arrays(in_nbrs=nbrs, in_deg=deg, n=n, device=CPU)
        np.testing.assert_array_equal(teg.in_nbrs.numpy(), nbrs)
    assert int(np.asarray(g.num_edges)) < len(d["src"])


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("fault", ["hole", "live_past_deg", "deg_past_k"])
def test_live_prefix_check_raises(request, name, fault, monkeypatch):
    """ell_from_arrays refuses a table that breaks the rule, also when the
    check runs in chunks of a few rows."""
    from repro_torch.graph.convert import ell_from_arrays

    d = _graph(request, name)
    n = d["n"]
    nbrs = np.array(d["eg"].in_nbrs)
    deg = np.array(d["eg"].in_deg)
    v = int(np.argmax(deg))
    if fault == "hole":
        nbrs[v, 0] = n               # a sentinel before a live id
    elif fault == "live_past_deg":
        deg[v] -= 1                  # the last live id now lies past in_deg
    else:
        deg[v] = nbrs.shape[1] + 1
    monkeypatch.setattr(tstructs, "GATHER_BUDGET_BYTES", 3 * nbrs.shape[1])
    with pytest.raises(ValueError, match="live-prefix"):
        ell_from_arrays(in_nbrs=nbrs, in_deg=deg, n=n, device=CPU)
