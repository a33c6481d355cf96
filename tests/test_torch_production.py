"""repro_torch's production serve step (the paper's ``probesim`` arch family)
held against repro's on the same inputs.

The config, the shapes, the CSR row blocks and their buckets, the CSR walk
sampler (fed repro's uniforms: bitwise), the all-gather and ring serve
steps (against repro's jitted steps on one CPU device, the ring's on a
1 x 1 mesh: fp32 at 1e-5, a bf16 frontier at 1e-3), the full-scale
abstract state (``meta`` tensors against repro's ``ShapeDtypeStruct``s)
and the smoke bundles go through both packages.  The port's row blocks
run on the CPU (``ShardMesh(["cpu"] * S)``).  Also here: the edge-list IO
copy, and the two ported examples run at toy size.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.arch as JA
import repro.configs.base as JCB
import repro.core.distributed as JD
import repro.core.ring as JR
import repro.graph.io as JIO
from repro.configs import probesim as j_probesim
from repro.graph import powerlaw_graph
from repro.graph.partition import partition_edges_by_dst
from repro.utils.jaxcompat import make_mesh, set_mesh

import repro_torch.arch as TA
import repro_torch.configs.base as TCB
import repro_torch.core.distributed as TD
import repro_torch.core.ring as TR
import repro_torch.graph.io as TIO
from repro_torch.configs import probesim as t_probesim
from repro_torch.core.params import make_params
from repro_torch.launch.mesh import ShardMesh
from torch_port_helpers import needs_cuda, one_thread

# a file of many small CPU ops: one intra-op thread beside the other workers
pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, SQRT_C = 0.6, float(np.sqrt(0.6))
L, B, TOP_K = 6, 32, 8


@pytest.fixture(scope="module")
def graph():
    """A power-law graph with a hub, plus isolated nodes at the end: n = 210
    needs padding to 224 (pad_nodes 32)."""
    src, dst, n = powerlaw_graph(203, 1500, seed=3)
    return src, dst, n + 7


def _mesh(s, dev="cpu"):
    return ShardMesh([dev] * s)


def _queries(graph, q):
    src, dst, n = graph
    return [int(dst[0]), 9][:q]


def _ref_uniforms(key, walks):
    """repro's draws of ``sample_walks_sharded`` (distributed.py: split the
    key, then ``cont`` and ``pick``), as tensors."""
    k_cont, k_pick = jax.random.split(key)
    cont = jax.random.uniform(k_cont, (L - 1, walks)) < SQRT_C
    pick = jax.random.uniform(k_pick, (L - 1, walks))
    return (torch.from_numpy(np.array(cont)), torch.from_numpy(np.array(pick)))


def _untied_equal(idx_a, vals_a, idx_b, vals_b, tol):
    vals_a, vals_b = np.asarray(vals_a, np.float32), np.asarray(vals_b, np.float32)
    assert np.abs(vals_a - vals_b).max() <= tol
    for q in range(vals_b.shape[0]):
        gaps = np.abs(np.diff(vals_b[q])) > 2 * tol
        untied = np.ones(vals_b.shape[1], bool)
        untied[:-1] &= gaps
        untied[1:] &= gaps
        np.testing.assert_array_equal(np.asarray(idx_a[q])[untied],
                                      np.asarray(idx_b[q])[untied])


def _csr_values(g) -> np.ndarray:
    """A graph's CSR values: each block's live prefix, concatenated."""
    return torch.cat([
        v[: int(TD.row_block(d, s, g.rows).sum())]
        for s, (v, d) in enumerate(zip(g.indices, g.in_deg))
    ]).numpy()


def _cfg(graph, **kw):
    src, _, n = graph
    return dict(name="t", n=n, m=len(src), c=C, **kw)


# ---------------------------------------------------------------------------
# Config and shapes
# ---------------------------------------------------------------------------


def test_probesim_config_and_shapes_equal_repro():
    fields = [(f.name, f.default) for f in dataclasses.fields(TCB.ProbeSimConfig)]
    assert fields == [(f.name, f.default)
                      for f in dataclasses.fields(JCB.ProbeSimConfig)]
    for name in ("CONFIG", "SMOKE"):
        assert (dataclasses.asdict(getattr(t_probesim, name))
                == dataclasses.asdict(getattr(j_probesim, name)))
    for smoke in (False, True):
        assert (dataclasses.asdict(TCB.get_config("probesim", smoke=smoke))
                == dataclasses.asdict(JCB.get_config("probesim", smoke=smoke)))
    ref = [(s.name, s.kind, s.dims) for s in JCB.PROBESIM_SHAPES]
    for shapes in (TCB.PROBESIM_SHAPES, TCB.shapes_for("probesim")):
        assert [(s.name, s.kind, s.dims) for s in shapes] == ref
    assert "probesim" not in TCB.NOT_PORTED
    for arch, shape in (("probesim", "serve_batch"), ("probesim", "serve_online"),
                        ("llama3.2-1b", "long_500k"),
                        ("llama3.2-1b", "prefill_32k")):
        assert TA.is_applicable(arch, shape) == JA.is_applicable(arch, shape)


# ---------------------------------------------------------------------------
# The production layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 2, 4])
def test_build_sharded_graph_matches_repro(graph, s):
    """The row blocks concatenated are repro's indptr / in_deg / indices;
    each block's bucket is ``partition_edges_by_dst`` of the edges sorted
    by (source, destination) (global destination ids, padding n_pad)."""
    src, dst, n = graph
    ref = JD.build_sharded_graph(src, dst, n, pad_nodes=32, pad_edges=64)
    sg = TD.build_sharded_graph(src, dst, n, mesh=_mesh(s), pad_nodes=32,
                                pad_edges=64)
    assert (sg.n, sg.n_pad, sg.m, sg.m_pad) == (ref.n, ref.n_pad, ref.m, ref.m_pad)
    assert sg.n_pad == 224 and sg.rows == 224 // s
    np.testing.assert_array_equal(torch.cat(sg.indptr).numpy(), ref.indptr)
    np.testing.assert_array_equal(torch.cat(sg.in_deg).numpy(), ref.in_deg)
    assert (np.asarray(ref.in_deg)[203:] == 0).all()
    np.testing.assert_array_equal(_csr_values(sg), np.asarray(ref.indices)[: ref.m])
    assert sg.base == [int(np.asarray(ref.indptr)[b * sg.rows]) if b * sg.rows < 203
                       else ref.m for b in range(s)]
    order = np.lexsort((dst, src))
    part = partition_edges_by_dst(src[order], dst[order], sg.n_pad, s)
    assert sg.counts == part["counts"].tolist()
    for b in range(s):
        assert sg.indices[b].shape == sg.src_sh[b].shape
        np.testing.assert_array_equal(sg.src_sh[b].numpy(), part["src_sh"][b])
        c = sg.counts[b]
        np.testing.assert_array_equal(sg.dst_sh[b][:c].numpy() - b * sg.rows,
                                      part["dst_sh"][b][:c])
        assert (sg.dst_sh[b][c:] == sg.n_pad).all()
        assert (sg.src_sh[b][c:] == sg.n_pad).all()
    with pytest.raises(ValueError, match="divisible"):
        TD.build_sharded_graph(src, dst, n, mesh=_mesh(3), pad_nodes=32)


@pytest.mark.parametrize("s", [1, 4])
def test_csr_walks_equal_repro_bitwise(graph, s):
    """Fed repro's uniforms, the sampler over the row blocks (and over the
    ring graph's CSR view) returns repro's walks bit for bit."""
    src, dst, n = graph
    queries = _queries(graph, 2)
    key = jax.random.key(11)
    ref_sg = JD.build_sharded_graph(src, dst, n, pad_nodes=32, pad_edges=64)
    ref = JD.sample_walks_sharded(key, ref_sg, jnp.asarray(queries, jnp.int32),
                                  walks_per_query=B, max_len=L, sqrt_c=SQRT_C)
    cont, pick = _ref_uniforms(key, 2 * B)
    sg = TD.build_sharded_graph(src, dst, n, mesh=_mesh(s), pad_nodes=32,
                                pad_edges=64)
    walks = TD.walks_from_uniforms_csr(sg, torch.tensor(queries), cont, pick)
    assert walks.dtype == torch.int32 and walks.shape == (2 * B, L)
    np.testing.assert_array_equal(walks.numpy(), np.asarray(ref))
    assert (walks[:, 1:] == sg.n_pad).any() and (walks[:, 1:] < n).any()

    rg_ref = JR.build_ring_graph(src, dst, n, shards=s)

    class _V:  # repro's duck-typed view (make_ring_serve_step)
        n_pad = rg_ref.n_pad
        in_deg = rg_ref.in_deg
        indptr = rg_ref.indptr
        indices = rg_ref.indices

    ref_r = JD.sample_walks_sharded(key, _V, jnp.asarray(queries, jnp.int32),
                                    walks_per_query=B, max_len=L, sqrt_c=SQRT_C)
    rg = TR.build_ring_graph(src, dst, n, mesh=_mesh(s), csr=True)
    np.testing.assert_array_equal(
        TD.walks_from_uniforms_csr(rg, torch.tensor(queries), cont, pick).numpy(),
        np.asarray(ref_r))
    # the sampler's own draws: repro's shapes and order, on the home device
    gen = torch.Generator().manual_seed(3)
    c2, p2 = TD.csr_uniforms(gen, walks=2 * B, max_len=L, sqrt_c=SQRT_C,
                             device="cpu")
    assert (c2.shape, c2.dtype, p2.shape, p2.dtype) == (
        (L - 1, 2 * B), torch.bool, (L - 1, 2 * B), torch.float32)
    drawn = TD.sample_walks_sharded(torch.Generator().manual_seed(3), sg,
                                    queries, walks_per_query=B, max_len=L,
                                    sqrt_c=SQRT_C)
    assert torch.equal(drawn, TD.walks_from_uniforms_csr(sg, queries, c2, p2))


# ---------------------------------------------------------------------------
# The serve steps against repro's jitted steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("q", [1, 2])
@pytest.mark.parametrize("edge_chunks", [1, 4])
def test_serve_step_matches_repro(graph, s, q, edge_chunks):
    src, dst, n = graph
    cfg_kw = _cfg(graph)
    key = jax.random.key(7 + q)
    queries = _queries(graph, q)
    ref_sg = JD.build_sharded_graph(src, dst, n, pad_nodes=32, pad_edges=64)
    ref_step = JD.make_serve_step(JCB.ProbeSimConfig(**cfg_kw), queries=q,
                                  walk_chunk=B, max_len=L, top_k=TOP_K,
                                  edge_chunks=edge_chunks)
    r_idx, r_vals = jax.jit(ref_step)(ref_sg, jnp.asarray(queries, jnp.int32), key)
    step = TD.make_serve_step(TCB.ProbeSimConfig(**cfg_kw), queries=q,
                              walk_chunk=B, max_len=L, top_k=TOP_K,
                              edge_chunks=edge_chunks)
    sg = TD.build_sharded_graph(src, dst, n, mesh=_mesh(s), pad_nodes=32,
                                pad_edges=64)
    idx, vals = step(sg, torch.tensor(queries, dtype=torch.int32),
                     uniforms=_ref_uniforms(key, q * B))
    assert idx.dtype == torch.int32 and vals.dtype == torch.float32
    assert idx.shape == vals.shape == (q, TOP_K)
    _untied_equal(idx.numpy(), vals.numpy(), r_idx, r_vals, 1e-5)
    assert float(vals.max()) > 0.01
    for row, u in zip(idx.tolist(), queries):
        assert u not in row


@pytest.mark.parametrize("fdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("q", [1, 2])
def test_ring_serve_step_matches_repro(graph, fdt, q):
    """The ring step at 4 blocks against repro's jitted ring step on a 1 x 1
    mesh (its ring over one block): the same walks, fp32 at 1e-5, a bf16
    frontier at 1e-3 (repro rounds its bf16 means to bf16, the port takes
    them in fp32)."""
    src, dst, n = graph
    cfg_kw = _cfg(graph, push_mode="ring", frontier_dtype=fdt)
    key = jax.random.key(21 + q)
    queries = _queries(graph, q)
    jdt = jnp.bfloat16 if fdt == "bfloat16" else jnp.float32
    ref_step = JR.make_ring_serve_step(JCB.ProbeSimConfig(**cfg_kw), queries=q,
                                       walk_chunk=B, max_len=L, top_k=TOP_K,
                                       frontier_dtype=jdt)
    with set_mesh(make_mesh((1, 1), ("data", "model"))):
        r_idx, r_vals = jax.jit(ref_step)(
            JR.build_ring_graph(src, dst, n, shards=1),
            jnp.asarray(queries, jnp.int32), key)
    tdt = torch.bfloat16 if fdt == "bfloat16" else torch.float32
    step = TR.make_ring_serve_step(TCB.ProbeSimConfig(**cfg_kw), queries=q,
                                   walk_chunk=B, max_len=L, top_k=TOP_K,
                                   frontier_dtype=tdt)
    rg = TR.build_ring_graph(src, dst, n, mesh=_mesh(4), csr=True)
    idx, vals = step(rg, torch.tensor(queries, dtype=torch.int32),
                     uniforms=_ref_uniforms(key, q * B))
    tol = 1e-3 if fdt == "bfloat16" else 1e-5
    _untied_equal(idx.numpy(), vals.numpy(), r_idx, r_vals, tol)
    # against the all-gather step on the same walks
    auto = TD.make_serve_step(TCB.ProbeSimConfig(**_cfg(graph)), queries=q,
                              walk_chunk=B, max_len=L, top_k=TOP_K)
    sg = TD.build_sharded_graph(src, dst, n, mesh=_mesh(4), pad_nodes=4)
    a_idx, a_vals = auto(sg, torch.tensor(queries, dtype=torch.int32),
                         uniforms=_ref_uniforms(key, q * B))
    _untied_equal(idx.numpy(), vals.numpy(), a_idx.numpy(), a_vals.numpy(), tol)
    # without csr=True (the sharded backend's ring graphs) the same buckets
    # and degrees, and no view
    plain = TR.build_ring_graph(src, dst, n, mesh=_mesh(4))
    assert plain.indptr is None and plain.indices is None
    for f in ("src_sh", "dst_sh", "in_deg"):
        for a, b in zip(getattr(plain, f), getattr(rg, f)):
            assert torch.equal(a, b)
    assert plain.counts == rg.counts
    with pytest.raises(ValueError, match="CSR view"):
        step(plain, torch.tensor(queries), torch.Generator())


# ---------------------------------------------------------------------------
# Full-scale abstract state and the bundles
# ---------------------------------------------------------------------------


def _shapes(blocks, stack=False):
    assert all(b.is_meta and b.dtype == torch.int32 for b in blocks)
    return tuple((torch.stack(blocks) if stack else torch.cat(blocks)).shape)


def _sds(x):
    assert x.dtype == jnp.int32
    return tuple(x.shape)


@pytest.mark.parametrize("s", [1, 4])
def test_ring_graph_abstract_matches_repro(s):
    n, m = 41_652_230, 1_468_365_182
    e_max = -(-m * 3 // (2 * s * s) // 8) * 8
    ref = JR.ring_graph_abstract(n, m, s, e_max)
    rg = TR.ring_graph_abstract(n, m, s, e_max)
    assert (rg.n, rg.n_pad, rg.m, rg.shards) == (ref.n, ref.n_pad, ref.m, ref.shards)
    assert _shapes(rg.src_sh, stack=True) == _sds(ref.src_sh)
    assert _shapes(rg.dst_sh, stack=True) == _sds(ref.dst_sh)
    assert _shapes(rg.in_deg, stack=True)[1:] == _sds(ref.in_deg)
    assert _shapes(rg.indptr) == _sds(ref.indptr)
    assert _shapes(rg.indices) == _sds(ref.indices)


@pytest.mark.parametrize("shape", ["serve_batch", "serve_online"])
@pytest.mark.parametrize("push_mode", ["auto", "ring"])
def test_full_scale_bundle_state_is_abstract(shape, push_mode):
    """The full Twitter config's init: meta tensors of repro's shapes (one
    block, as repro's bundle outside a mesh), nothing allocated; the batch
    specs and MODEL_FLOPS."""
    cfg_t = dataclasses.replace(t_probesim.CONFIG, push_mode=push_mode)
    cfg_j = dataclasses.replace(j_probesim.CONFIG, push_mode=push_mode)
    j_shape = next(x for x in JCB.shapes_for("probesim") if x.name == shape)
    t_shape = next(x for x in TCB.shapes_for("probesim") if x.name == shape)
    ref = JA.build_with_cfg("probesim", cfg_j, j_shape)
    bundle = TA.build_with_cfg("probesim", cfg_t, t_shape, device="cpu")
    (rs,) = ref.init(jax.random.key(0))
    (st,) = bundle.init(torch.Generator())
    if push_mode == "ring":
        assert isinstance(st, TR.RingGraph)
        pairs = [(_shapes(st.src_sh, stack=True), _sds(rs.src_sh)),
                 (_shapes(st.dst_sh, stack=True), _sds(rs.dst_sh)),
                 (_shapes(st.in_deg), _sds(rs.in_deg))]
    else:
        assert isinstance(st, TD.ShardedGraph)
        assert (st.n_pad, st.m_pad) == (rs.n_pad, rs.m_pad)
        pairs = [(_shapes(st.in_deg), _sds(rs.in_deg)),
                 (_shapes(st.src_sh), _sds(rs.src)),
                 (_shapes(st.dst_sh), _sds(rs.dst))]
    pairs += [(_shapes(st.indptr), _sds(rs.indptr)),
              (_shapes(st.indices), _sds(rs.indices))]
    for mine, theirs in pairs:
        assert mine == theirs
    assert bundle.model_flops() == ref.model_flops()
    assert bundle.notes == ref.notes
    q = t_shape.dims["queries"]
    specs = bundle.input_specs()["batch"]
    assert specs["queries"].shape == tuple(ref.input_specs()["batch"]["queries"].shape) == (q,)
    assert specs["queries"].dtype == torch.int32 and specs["seed"].shape == ()
    # four blocks: the same totals, split (the ring pads n to 4 blocks)
    four = TA.build_with_cfg("probesim", cfg_t, t_shape,
                             mesh=_mesh(4)).init()[0]
    assert len(four.indptr) == 4 and four.n_pad % 4 == 0
    if push_mode == "auto":
        assert _shapes(four.indptr) == _sds(rs.indptr)


@pytest.mark.parametrize("shape", ["serve_batch", "serve_online"])
@pytest.mark.parametrize("push_mode", ["auto", "ring"])
def test_smoke_bundle_matches_repro(shape, push_mode):
    """The smoke bundles: ``init`` builds repro's graph, the step on repro's
    draws answers as repro's jitted step, MODEL_FLOPS and the shrunk shape
    are repro's."""
    if push_mode == "auto":
        ref = JA.build("probesim", shape, smoke=True)
        bundle = TA.build("probesim", shape, smoke=True, device="cpu")
    else:
        cfg_j = dataclasses.replace(j_probesim.SMOKE, push_mode="ring")
        cfg_t = dataclasses.replace(t_probesim.SMOKE, push_mode="ring")
        shp = [x for x in JCB.shapes_for("probesim") if x.name == shape][0]
        ref = JA.build_with_cfg("probesim", cfg_j, JA._shrink_shape(cfg_j, shp))
        bundle = TA.build_with_cfg(
            "probesim", cfg_t,
            TA._shrink_shape(cfg_t, [x for x in TCB.shapes_for("probesim")
                                     if x.name == shape][0]),
            mesh=_mesh(2))
    assert bundle.shape.dims == ref.shape.dims == dict(queries=2, walk_chunk=16)
    assert bundle.model_flops() == ref.model_flops()
    (rs,) = ref.init(jax.random.key(0))
    (st,) = bundle.init(torch.Generator())
    np.testing.assert_array_equal(torch.cat(st.indptr).numpy(), rs.indptr)
    np.testing.assert_array_equal(_csr_values(st), np.asarray(rs.indices)[: rs.m])
    deg = torch.cat([TD.row_block(d, s, st.rows) for s, d in enumerate(st.in_deg)])
    np.testing.assert_array_equal(deg.numpy(), rs.in_deg)
    deg = np.asarray(rs.in_deg)
    queries = [int(np.argmax(deg)), int(np.flatnonzero(deg > 0)[0])]
    key = jax.random.key(5)
    batch = dict(queries=jnp.asarray(queries, jnp.int32), key=key)
    with set_mesh(make_mesh((1, 1), ("data", "model"))):
        r_idx, r_vals = jax.jit(ref.step)(rs, batch)
    smoke = TCB.get_config("probesim", smoke=True)
    max_len = make_params(smoke.n, c=smoke.c, eps_a=smoke.eps_a,
                          delta=smoke.delta).max_len
    k_cont, k_pick = jax.random.split(key)
    cont = jax.random.uniform(k_cont, (max_len - 1, 2 * 16)) < SQRT_C
    pick = jax.random.uniform(k_pick, (max_len - 1, 2 * 16))
    idx, vals = bundle.step(st, dict(queries=torch.tensor(queries), seed=0),
                            uniforms=(torch.from_numpy(np.array(cont)),
                                      torch.from_numpy(np.array(pick))))
    _untied_equal(idx.numpy(), vals.numpy(), r_idx, r_vals, 1e-5)
    # the port's own draws: a seed on the home device, repeatable
    a = bundle.step(st, dict(queries=torch.tensor(queries), seed=3))
    b = bundle.step(st, dict(queries=torch.tensor(queries), seed=3))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_bundle_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TA.build("probesim", "serve_batch", smoke=True)


@pytest.mark.cuda
@pytest.mark.parametrize("push_mode", ["auto", "ring"])
def test_step_on_the_card_equals_cpu(graph, push_mode):
    """The bundle's step on 4 blocks of one card against 4 CPU blocks on the
    same draws: 1e-5."""
    needs_cuda()
    src, dst, n = graph
    cfg = TCB.ProbeSimConfig(**_cfg(graph, push_mode=push_mode))
    shape = TCB.ShapeSpec("t", "simrank_serve", dict(queries=2, walk_chunk=B))
    queries = torch.tensor(_queries(graph, 2), dtype=torch.int32)
    max_len = make_params(n, c=C, eps_a=cfg.eps_a, delta=cfg.delta).max_len
    cont, pick = TD.csr_uniforms(torch.Generator().manual_seed(2), walks=2 * B,
                                 max_len=max_len, sqrt_c=SQRT_C, device="cpu")
    out = []
    for dev in ("cpu", "cuda:0"):
        mesh = _mesh(4, dev)
        bundle = TA.build_with_cfg("probesim", cfg, shape, mesh=mesh)
        g = (TR.build_ring_graph(src, dst, n, mesh=mesh, csr=True)
             if push_mode == "ring"
             else TD.build_sharded_graph(src, dst, n, mesh=mesh, pad_nodes=128,
                                         pad_edges=4096))
        idx, vals = bundle.step(g, dict(queries=queries, seed=0),
                                uniforms=(cont.to(dev), pick.to(dev)))
        assert vals.device.type == torch.device(dev).type
        out.append((idx.cpu().numpy(), vals.cpu().numpy()))
    _untied_equal(out[1][0], out[1][1], out[0][0], out[0][1], 1e-5)


# ---------------------------------------------------------------------------
# Edge-list IO and the examples
# ---------------------------------------------------------------------------


def test_graph_io_equals_repro(tmp_path, monkeypatch):
    snap = tmp_path / "g.txt"
    snap.write_text("# a SNAP file\n% and a comment\n10 20\n20 30\n\n"
                    "30 10\n7 20\n10 7\n")
    for a, b in zip(TIO.read_edgelist(str(snap)), JIO.read_edgelist(str(snap))):
        np.testing.assert_array_equal(a, b)
    src, dst, n = powerlaw_graph(50, 200, seed=1)
    TIO.write_edgelist(str(tmp_path / "t.txt"), src, dst)
    JIO.write_edgelist(str(tmp_path / "j.txt"), src, dst)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    TIO.save_graph_npz(str(tmp_path / "t.npz"), src, dst, n)
    for a, b in zip(TIO.load_graph_npz(str(tmp_path / "t.npz")),
                    JIO.load_graph_npz(str(tmp_path / "t.npz"))):
        np.testing.assert_array_equal(a, b)
    s2, d2, n2 = TIO.load_graph_npz(str(tmp_path / "t.npz"))
    assert n2 == n and s2.dtype == np.int32
    np.testing.assert_array_equal(s2, src)
    np.testing.assert_array_equal(d2, dst)
    monkeypatch.setenv("REPRO_CACHE", str(tmp_path / "cache"))
    assert TIO.cache_dir() == JIO.cache_dir() == str(tmp_path / "cache")
    assert os.path.isdir(tmp_path / "cache")
    monkeypatch.delenv("REPRO_CACHE")
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    os.makedirs(tmp_path / "tmp")
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    assert TIO.cache_dir() == str(tmp_path / "tmp" / "repro_cache")


@pytest.mark.parametrize("argv", [
    ["repro_torch.examples.distributed_serve_demo", "--nodes", "2000",
     "--edges", "12000"],
    ["repro_torch.examples.dynamic_graph_serving", "--nodes", "300",
     "--edges", "2000"],
    ["repro_torch.examples.dynamic_graph_serving", "--backend", "sharded",
     "--shards", "2", "--nodes", "300", "--edges", "2000"],
])
def test_examples_run_at_toy_size(argv):
    # one intra-op thread, as the ``one_thread`` fixture gives the tests
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", *argv, "--device", "cpu"],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    if "demo" in argv[0]:
        assert "ms/step" in r.stdout
        assert "identical across implementations: True" in r.stdout
    else:
        assert "served 12 queries across 3 epochs" in r.stdout
