"""repro_torch's sharded graph layer held against repro's on the same inputs.

The partition, the host ``ShardedGraphState``, the device epoch graph, the
shard-wise apply, the walk sampler over the row-sharded ELL table and the
per-level walk probes (all-gather and ring) go through both packages.
Integer state must be equal after every batch; float outputs agree at
1e-5 (the ring's bf16 frontier at repro's own 2e-3).  The shards run on
the CPU (``ShardMesh(["cpu"] * S)``).  repro's mesh code runs in process at
one shard, and at 2 and 4 shards in one subprocess on 8 fake XLA host
devices (the flag must precede jax's start), whose results it writes to
a file.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.api.backend as JB
import repro.core.epoch as JE
import repro.graph.partition as JP
from repro.core.distributed import build_sharded_graph, probe_walks_sharded
from repro.core.walks import walks_from_uniforms as j_walks
from repro.graph import ell_from_edges as j_ell_from_edges
from repro.graph import make_update_batch as j_batch
from repro.graph import powerlaw_graph
from repro.utils.jaxcompat import make_mesh, set_mesh

import repro_torch.graph.partition as TP
from repro_torch.api.backend import ShardedGraphState
from repro_torch.core import distributed as TD
from repro_torch.core import ring as TR
from repro_torch.core.epoch import (
    apply_shard_batch,
    build_shard_epoch_graph,
    check_shard_prefix,
    make_sharded_epoch_step,
)
from repro_torch.core.walks import walks_from_uniforms
from repro_torch.graph import (
    ell_from_edges,
    make_update_batch,
    ring_graph_from_arrays,
    shard_epoch_graph_from_arrays,
)
from repro_torch.launch.mesh import ShardMesh
from torch_port_helpers import jax_uniforms, one_thread

# a file of many small CPU ops: one intra-op thread beside the other workers
pytestmark = pytest.mark.usefixtures("one_thread")

SHARDS = (1, 2, 4)
N_NODES, N_EDGES = 203, 1500  # n = 203: divisible by none of 2, 3, 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def graph():
    src, dst, n = powerlaw_graph(N_NODES, N_EDGES, seed=3)
    k_max = int(np.bincount(dst, minlength=n).max()) + 8
    return src, dst, n, k_max


def _mesh(s):
    return ShardMesh(["cpu"] * s)


def _draw_ops(rng, st_src, st_dst, n, b):
    """A mixed batch: live deletes (one repeated), inserts into a hub row
    and elsewhere, an absent delete."""
    k = rng.integers(0, len(st_src), b // 4)
    dels_s, dels_d = list(st_src[k]), list(st_dst[k])
    dels_s.append(dels_s[0])
    dels_d.append(dels_d[0])
    hub = int(np.bincount(st_dst, minlength=n).argmax())
    ins_s = list(rng.integers(0, n, b // 2))
    ins_d = list(rng.integers(0, n, b // 2))
    ins_d[:3] = [hub] * 3
    s = np.array(dels_s + ins_s + [n - 1], np.int32)
    d = np.array(dels_d + ins_d + [n - 2], np.int32)
    ins = np.array([False] * len(dels_s) + [True] * len(ins_s) + [False])
    perm = rng.permutation(len(s))
    return s[perm], d[perm], ins[perm]


def _cut(s, d, ins):
    """Drop later deletes of a pair already in the batch (a batch deletes
    one copy of a pair), as the session's batch cutter does."""
    seen, keep = set(), []
    for i, (a, b, x) in enumerate(zip(s, d, ins)):
        if not x and (a, b) in seen:
            continue
        seen.add((a, b))
        keep.append(i)
    return s[keep], d[keep], ins[keep]


# ---------------------------------------------------------------------------
# The partition (a copy of repro's numpy module)
# ---------------------------------------------------------------------------


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, tuple):
        for x, y in zip(a, b, strict=True):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_partition_matches_repro(graph, s):
    src, dst, n, _ = graph
    assert TP.pad_to_multiple(n, s) == JP.pad_to_multiple(n, s)
    _same(TP.partition_edges_by_dst(src, dst, n, s),
          JP.partition_edges_by_dst(src, dst, n, s))
    _same(TP.partition_edges_2d(src, dst, n, s),
          JP.partition_edges_2d(src, dst, n, s))
    vals = np.random.default_rng(s).random((n, 3)).astype(np.float32)
    _same(TP.partition_nodes(vals, s, fill=-1),
          JP.partition_nodes(vals, s, fill=-1))
    n_pad = TP.pad_to_multiple(n, s)
    _same(TP.partition_ops_by_dst(dst[:50], n_pad, s),
          JP.partition_ops_by_dst(dst[:50], n_pad, s))
    counts = TP.partition_edges_by_dst(src, dst, n, s)["counts"]
    assert TP.edge_balance_stats(counts) == JP.edge_balance_stats(counts)


# ---------------------------------------------------------------------------
# The host state
# ---------------------------------------------------------------------------


def _assert_state(j, t):
    np.testing.assert_array_equal(t._src_sh, j._src_sh)
    np.testing.assert_array_equal(t._dst_sh, j._dst_sh)
    np.testing.assert_array_equal(t._counts, j._counts)
    assert (t.version, t.overflow, t.mutations, t.capacity_per_shard) == (
        j.version, j.overflow, j.mutations, j.capacity_per_shard)
    for a, b in zip(t.to_host_edges(), j.to_host_edges(), strict=True):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.host_in_degrees(), j.host_in_degrees())


@pytest.mark.parametrize("s", SHARDS)
def test_sharded_state_matches_repro(graph, s):
    """Seeded homogeneous batches (overflowing inserts, duplicate and absent
    deletes), regrow and ensure_capacity, copy, and replay_applied fed the
    port's device apply: every buffer and field equal after every step."""
    src, dst, n, k_max = graph
    rng = np.random.default_rng(10 + s)
    live = int(np.bincount(dst // (TP.pad_to_multiple(n, s) // s),
                           minlength=s).max())
    j = JB.ShardedGraphState(src, dst, n, shards=s, capacity_per_shard=live + 6)
    t = ShardedGraphState(src, dst, n, shards=s, capacity_per_shard=live + 6)
    _assert_state(j, t)
    for step in range(8):
        hs, hd = t.to_host_edges()
        if step % 2 == 0:
            a = rng.integers(0, n, 24).astype(np.int32)
            b = rng.integers(0, n, 24).astype(np.int32)
            ins = True
        else:
            k = rng.integers(0, len(hs), 10)
            a = np.concatenate([hs[k], hs[k[:2]], [n - 1]]).astype(np.int32)
            b = np.concatenate([hd[k], hd[k[:2]], [0]]).astype(np.int32)
            ins = False
        np.testing.assert_array_equal(t.apply_ops(a, b, ins),
                                      j.apply_ops(a, b, ins))
        _assert_state(j, t)
        if step == 2:
            assert t.overflow
            j.regrow()
            t.regrow()
            _assert_state(j, t)
        if step == 5:
            j.regrow(capacity_per_shard=j.capacity_per_shard + 40)
            t.regrow(capacity_per_shard=t.capacity_per_shard + 40)
            j.ensure_capacity(j.capacity_per_shard + 3)
            t.ensure_capacity(t.capacity_per_shard + 3)
            _assert_state(j, t)
    c = t.copy()
    assert c._src_sh is not t._src_sh
    cj = j.copy()
    _assert_state(cj, c)
    # replay_applied with the device apply's decisions on mixed batches
    for _ in range(3):
        hs, hd = t.to_host_edges()
        bs, bd, bi = _cut(*_draw_ops(rng, hs, hd, n, 16))
        st = build_shard_epoch_graph(hs, hd, n, capacity_per_shard=t.capacity_per_shard,
                                     k_max=k_max + 16, mesh=_mesh(s))
        applied, _ = apply_shard_batch(
            st, make_update_batch(bs, bd, bi, batch_size=32, n=n, device="cpu"))
        applied = applied.numpy()[: len(bs)]
        j.replay_applied(bs, bd, bi, applied)
        t.replay_applied(bs, bd, bi, applied)
        _assert_state(j, t)
        rb = build_shard_epoch_graph(*t.to_host_edges(), n,
                                     capacity_per_shard=t.capacity_per_shard,
                                     k_max=k_max + 16, mesh=_mesh(s))
        _same(st.host_arrays(), rb.host_arrays())


def test_replay_refuses_a_diverged_state(graph):
    src, dst, n, _ = graph
    t = ShardedGraphState(src, dst, n, shards=2)  # the fuller shard is full
    with pytest.raises(RuntimeError, match="diverged"):
        t.replay_applied([n - 1], [0], [False], [True])
    full = int(np.argmax(t._counts))
    d = int(dst[dst // t.rows == full][0])
    with pytest.raises(RuntimeError, match="diverged"):
        t.replay_applied([0], [d], [True], [True])


# ---------------------------------------------------------------------------
# The device epoch graph, its conversion and the walk sampler
# ---------------------------------------------------------------------------


def _j_fields(st):
    return {f: np.asarray(getattr(st, f))
            for f in ("src_sh", "dst_sh", "counts", "in_nbrs", "in_deg")}


@pytest.mark.parametrize("s", SHARDS)
def test_build_shard_epoch_graph_matches_repro(graph, s):
    src, dst, n, k_max = graph
    hs, hd = ShardedGraphState(src, dst, n, shards=s).to_host_edges()
    j = JE.build_shard_epoch_graph(hs, hd, n, shards=s, capacity_per_shard=700,
                                   k_max=k_max)
    t = build_shard_epoch_graph(hs, hd, n, capacity_per_shard=700, k_max=k_max,
                                mesh=_mesh(s))
    assert (t.n, t.n_pad, t.rows, t.shards, t.capacity, t.k_max) == (
        j.n, j.n_pad, j.rows, j.shards, j.capacity, j.k_max)
    _same(t.host_arrays(), _j_fields(j))
    check_shard_prefix(t)
    # the carried-state converter: repro's arrays in, the same graph out
    c = shard_epoch_graph_from_arrays(**_j_fields(j), n=n, mesh=_mesh(s))
    _same(c.host_arrays(), _j_fields(j))
    with pytest.raises(ValueError, match="k_max"):
        build_shard_epoch_graph(hs, hd, n, capacity_per_shard=700, k_max=4,
                                mesh=_mesh(s))
    with pytest.raises(ValueError, match="capacity"):
        build_shard_epoch_graph(hs, hd, n, capacity_per_shard=3, k_max=k_max,
                                mesh=_mesh(s))


def test_converter_refuses_broken_padding(graph):
    src, dst, n, k_max = graph
    j = _j_fields(JE.build_shard_epoch_graph(src, dst, n, shards=2,
                                             capacity_per_shard=900,
                                             k_max=k_max))
    j["src_sh"] = j["src_sh"].copy()
    j["src_sh"][0, int(j["counts"][0])] = 5  # a live id in the padding
    with pytest.raises(ValueError, match="live-prefix"):
        shard_epoch_graph_from_arrays(**j, n=n, mesh=_mesh(2))


@pytest.mark.parametrize("s", SHARDS)
def test_sharded_walks_equal_whole_table(graph, s, key):
    """Given repro's uniforms, walks stepped on the shards that own their
    nodes equal the whole-table walks of both packages, bit for bit."""
    src, dst, n, k_max = graph
    hs, hd = ShardedGraphState(src, dst, n, shards=s).to_host_edges()
    st = build_shard_epoch_graph(hs, hd, n, capacity_per_shard=900,
                                 k_max=k_max, mesh=_mesh(s))
    us = np.array([0, 5, int(np.bincount(dst, minlength=n).argmax())])
    keys = jax.random.split(key, len(us))
    cont, pick = jax_uniforms(keys, n_r=40, max_len=9, sqrt_c=0.8)
    u = torch.from_numpy(np.repeat(us, 40).astype(np.int32))
    c2, p2 = cont.reshape(-1, 8), pick.reshape(-1, 8)
    got = TD.walks_from_uniforms_sharded(st, u, c2, p2)
    whole = walks_from_uniforms(ell_from_edges(hs, hd, n, k_max=k_max,
                                               device="cpu"), u, c2, p2)
    ref = j_walks(j_ell_from_edges(hs, hd, n, k_max=k_max), jnp.asarray(u),
                  jnp.asarray(c2.numpy()), jnp.asarray(p2.numpy()))
    assert torch.equal(got, whole)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got[:, 1:] < n).any()


# ---------------------------------------------------------------------------
# The shard-wise apply and the epoch step
# ---------------------------------------------------------------------------


def _epoch_kw(n):
    return dict(q=2, n_r=24, top_k=0, max_len=6, sqrt_c=0.775, eps_p=0.0,
                eps_t=0.02, truncation_shift=True, walk_chunk=16,
                edge_chunks=4)


def _port_stream(graph, s, batches, uniforms, *, use_kernel):
    """The port's epoch step over ``batches``; per batch the fields, the
    applied mask, the overflow bit and the estimates."""
    src, dst, n, k_max = graph
    hs, hd = ShardedGraphState(src, dst, n, shards=s).to_host_edges()
    st = build_shard_epoch_graph(hs, hd, n, capacity_per_shard=_cap(graph, s),
                                 k_max=k_max + 4, mesh=_mesh(s))
    step = make_sharded_epoch_step(st, **_epoch_kw(n), use_kernel=use_kernel)
    out = []
    for (bs, bd, bi), uni in zip(batches, uniforms):
        b = make_update_batch(bs, bd, bi, batch_size=32, n=n, device="cpu")
        _, applied, ovf, est, _, _ = step(st, b, [1, 7], uniforms=uni)
        check_shard_prefix(st)
        out.append((st.host_arrays(), applied.numpy(), ovf, est.numpy()))
    return out


def _cap(graph, s):
    src, dst, n, _ = graph
    rows = TP.pad_to_multiple(n, s) // s
    # a multiple of edge_chunks (4) that a few batches of inserts overflow
    return TP.pad_to_multiple(int(np.bincount(dst // rows, minlength=s).max())
                              + 12, 4)


def _batches(graph, s, seed):
    src, dst, n, _ = graph
    rng = np.random.default_rng(seed)
    hs, hd = ShardedGraphState(src, dst, n, shards=s).to_host_edges()
    return [_cut(*_draw_ops(rng, hs, hd, n, 24)) for _ in range(3)]


def _check_stream(got, ref):
    for (fields, applied, ovf, est), (jf, ja, jo, je) in zip(got, ref,
                                                             strict=True):
        _same(fields, jf)
        np.testing.assert_array_equal(applied, ja)
        assert ovf == jo
        np.testing.assert_allclose(est, je, rtol=1e-5, atol=1e-5)


def test_shard_apply_matches_repro_one_shard(graph, key):
    """At one shard repro's mesh epoch (kernel off) runs in process: fields,
    masks, overflow (the tight capacity overflows) and estimates, kernel on
    and off, after every batch."""
    src, dst, n, k_max = graph
    batches = _batches(graph, 1, 3)
    keys = [jax.random.split(jax.random.fold_in(key, i), 2) for i in range(3)]
    uniforms = [jax_uniforms(k, n_r=24, max_len=6, sqrt_c=0.775) for k in keys]
    hs, hd = ShardedGraphState(src, dst, n, shards=1).to_host_edges()
    mesh = make_mesh((1, 1), ("data", "model"))
    st = JE.build_shard_epoch_graph(hs, hd, n, shards=1,
                                    capacity_per_shard=_cap(graph, 1),
                                    k_max=k_max + 4)
    kw = _epoch_kw(n)
    step = JE.make_sharded_epoch_step(st, mesh, has_deletes=True, **kw)
    ref = []
    for (bs, bd, bi), k in zip(batches, keys):
        with set_mesh(mesh):
            st, ja, jo, je, _, _ = step(
                st, j_batch(bs, bd, bi, batch_size=32, n=n),
                jnp.asarray([1, 7], jnp.int32), k)
        ref.append((_j_fields(st), np.asarray(ja), bool(jo), np.asarray(je)))
    assert any(r[2] for r in ref)  # the stream overflows a shard
    for use_kernel in (False, True):
        _check_stream(_port_stream(graph, 1, batches, uniforms,
                                   use_kernel=use_kernel), ref)


_MESH_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import numpy as np
import jax, jax.numpy as jnp
from repro.core.distributed import (build_sharded_graph, probe_walks_sharded,
                                    sample_walks_sharded)
from repro.core.epoch import (build_shard_epoch_graph, make_sharded_epoch_step,
                              shard_epoch_specs)
from repro.core.ring import build_ring_graph, probe_walks_ring
from repro.graph import make_update_batch
from repro.utils.jaxcompat import make_mesh, set_mesh, specs_to_shardings

job = json.loads(sys.argv[1])
src, dst = np.asarray(job["src"], np.int32), np.asarray(job["dst"], np.int32)
n = job["n"]
out = {}
for s, spec in job["epochs"].items():
    s = int(s)
    mesh = make_mesh((8 // s, s), ("data", "model"))
    st = build_shard_epoch_graph(np.asarray(spec["hs"], np.int32),
                                 np.asarray(spec["hd"], np.int32), n,
                                 shards=s, capacity_per_shard=spec["cap"],
                                 k_max=spec["k_max"])
    step = make_sharded_epoch_step(st, mesh, has_deletes=True, **job["kw"])
    for i, (b, k) in enumerate(zip(spec["batches"], spec["keys"])):
        batch = make_update_batch(*[np.asarray(x) for x in b], batch_size=32,
                                  n=n)
        keys = jax.random.split(jax.random.fold_in(jax.random.key(k[0]), k[1]), 2)
        # the step's output state comes back with other shardings than its
        # inputs ask for: put it back where the step expects it
        st = jax.device_put(st, specs_to_shardings(shard_epoch_specs(st),
                                                   mesh=mesh))
        with set_mesh(mesh):
            st, a, o, e, _, _ = step(st, batch, jnp.asarray([1, 7], jnp.int32),
                                     keys)
        for f in ("src_sh", "dst_sh", "counts", "in_nbrs", "in_deg"):
            out[f"e{s}_{i}_{f}"] = np.asarray(getattr(st, f))
        out[f"e{s}_{i}_applied"] = np.asarray(a)
        out[f"e{s}_{i}_ovf"] = np.asarray(o)
        out[f"e{s}_{i}_est"] = np.asarray(e)
print("EPOCHS_OK", flush=True)
mesh = make_mesh((2, 4), ("data", "model"))
rg = build_ring_graph(src, dst, n, shards=4)
sg = build_sharded_graph(src, dst, n, pad_nodes=4, pad_edges=64)
with set_mesh(mesh):
    walks = sample_walks_sharded(jax.random.key(5), sg,
                                 jnp.asarray([int(dst[0]), 3], jnp.int32),
                                 walks_per_query=16, max_len=6, sqrt_c=0.775)
    ref = probe_walks_sharded(sg, walks, sqrt_c=0.775, edge_chunks=4)
    walks_r = jnp.where(walks >= sg.n_pad, rg.n_pad, walks)
    # jitted: run op by op, the ring's shard_map takes about 40 s
    ring = jax.jit(lambda w: probe_walks_ring(rg, w, sqrt_c=0.775))(walks_r)
    ring16 = jax.jit(lambda w: probe_walks_ring(
        rg, w, sqrt_c=0.775, frontier_dtype=jnp.bfloat16))(walks_r)
out["walks"] = np.asarray(walks_r)
out["spmd"] = np.asarray(ref)
out["ring"] = np.asarray(ring)
out["ring16"] = np.asarray(ring16, np.float32)
for f in ("src_sh", "dst_sh", "in_deg"):
    out[f"rg_{f}"] = np.asarray(getattr(rg, f))
np.savez(job["out"], **out)
print("WALK_PROBES_OK", flush=True)
"""


@pytest.fixture(scope="module")
def mesh_results(graph, tmp_path_factory):
    """repro's mesh epochs at 2 and 4 shards and its walk probes on a
    (2, 4) mesh, on 8 fake XLA host devices in one subprocess."""
    src, dst, n, k_max = graph
    path = str(tmp_path_factory.mktemp("mesh") / "ref.npz")
    epochs = {}
    for s in (2, 4):
        hs, hd = ShardedGraphState(src, dst, n, shards=s).to_host_edges()
        epochs[s] = dict(
            hs=hs.tolist(), hd=hd.tolist(), cap=_cap(graph, s), k_max=k_max + 4,
            batches=[[x.tolist() for x in b] for b in _batches(graph, s, 20 + s)],
            keys=[[s, i] for i in range(3)],
        )
    kw = {k: v for k, v in _epoch_kw(n).items()}
    job = dict(src=src.tolist(), dst=dst.tolist(), n=n, epochs=epochs, kw=kw,
               out=path)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", _MESH_SCRIPT, json.dumps(job)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "EPOCHS_OK" in res.stdout and "WALK_PROBES_OK" in res.stdout
    return dict(np.load(path)), epochs


@pytest.mark.parametrize("s", [2, 4])
def test_shard_apply_matches_repro_on_fake_mesh(graph, mesh_results, s):
    """At 2 and 4 shards the port's epoch step (kernel off and on) against
    repro's mesh epoch on 8 fake devices: every field, mask and overflow
    bit equal after every batch, estimates at 1e-5."""
    res, epochs = mesh_results
    spec = epochs[s]
    batches = [tuple(np.asarray(x) for x in b) for b in spec["batches"]]
    for i, b in enumerate(batches):
        batches[i] = (b[0].astype(np.int32), b[1].astype(np.int32),
                      b[2].astype(bool))
    uniforms, ref = [], []
    for i, (a, c) in enumerate(spec["keys"]):
        keys = jax.random.split(jax.random.fold_in(jax.random.key(a), c), 2)
        uniforms.append(jax_uniforms(keys, n_r=24, max_len=6, sqrt_c=0.775))
        ref.append((
            {f: res[f"e{s}_{i}_{f}"]
             for f in ("src_sh", "dst_sh", "counts", "in_nbrs", "in_deg")},
            res[f"e{s}_{i}_applied"], bool(res[f"e{s}_{i}_ovf"]),
            res[f"e{s}_{i}_est"],
        ))
    for use_kernel in (False, True):
        _check_stream(_port_stream(graph, s, batches, uniforms,
                                   use_kernel=use_kernel), ref)


def test_walk_probes_match_repro_on_fake_mesh(graph, mesh_results):
    """``probe_walks_sharded`` and ``probe_walks_ring`` at 4 shards against
    repro's on a (2, 4) mesh: fp32 at 1e-5; the ring's bf16 frontier within
    repro's own 2e-3 of the fp32 probe.  The ring buckets go through the
    converter."""
    src, dst, n, k_max = graph
    res, _ = mesh_results
    walks = torch.from_numpy(res["walks"])
    mesh = _mesh(4)
    hs, hd = ShardedGraphState(src, dst, n, shards=4).to_host_edges()
    st = build_shard_epoch_graph(hs, hd, n, capacity_per_shard=900,
                                 k_max=k_max, mesh=mesh)
    spmd = TD.probe_walks_sharded(st, walks, sqrt_c=0.775, edge_chunks=4)
    np.testing.assert_allclose(spmd[:n].numpy(), res["spmd"][:n], atol=1e-5)
    rg = ring_graph_from_arrays(src_sh=res["rg_src_sh"], dst_sh=res["rg_dst_sh"],
                                in_deg=res["rg_in_deg"], n=n, mesh=mesh)
    built = TR.build_ring_graph(src, dst, n, mesh=mesh)
    for a, b in zip(rg.src_sh + rg.dst_sh, built.src_sh + built.dst_sh):
        assert torch.equal(a, b)
    assert rg.counts == built.counts
    ring = TR.probe_walks_ring(rg, walks, sqrt_c=0.775)
    np.testing.assert_allclose(ring[:n].numpy(), res["ring"][:n], atol=1e-5)
    ring16 = TR.probe_walks_ring(rg, walks, sqrt_c=0.775,
                                 frontier_dtype=torch.bfloat16)
    assert float((ring16[:n].float() - torch.from_numpy(res["spmd"][:n])
                  ).abs().max()) < 2e-3
    assert float(np.abs(res["ring16"][:n] - res["spmd"][:n]).max()) < 2e-3


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("eps_p", [0.0, 0.01])
def test_probe_walks_sharded_matches_repro(graph, s, eps_p, key):
    """The all-gather walk probe against repro's (unsharded in process) at
    every shard count, with and without pruning."""
    src, dst, n, k_max = graph
    sg = build_sharded_graph(src, dst, n, pad_nodes=32, pad_edges=64)
    from repro.core.distributed import sample_walks_sharded

    walks = sample_walks_sharded(key, sg, jnp.asarray([int(dst[0]), 9],
                                                      jnp.int32),
                                 walks_per_query=16, max_len=6, sqrt_c=0.775)
    ref = np.asarray(probe_walks_sharded(sg, walks, sqrt_c=0.775, eps_p=eps_p,
                                         edge_chunks=4))
    hs, hd = ShardedGraphState(src, dst, n, shards=s).to_host_edges()
    st = build_shard_epoch_graph(hs, hd, n, capacity_per_shard=900,
                                 k_max=k_max, mesh=_mesh(s))
    w = torch.from_numpy(np.minimum(np.asarray(walks), n).astype(np.int32))
    got = TD.probe_walks_sharded(st, w, sqrt_c=0.775, eps_p=eps_p,
                                 edge_chunks=4)
    np.testing.assert_allclose(got[:n].numpy(), ref[:n], atol=1e-5)
    assert np.abs(ref[:n]).sum() > 0


@pytest.mark.parametrize("s", [2, 4])
def test_every_in_deg_replica_takes_the_update(graph, s):
    """A stale replica shows only at S > 1 after an update: every shard's
    in_deg must equal a rebuild's, and the walks and pushes that read them
    must equal a rebuild's too."""
    src, dst, n, k_max = graph
    hs, hd = ShardedGraphState(src, dst, n, shards=s).to_host_edges()
    st = build_shard_epoch_graph(hs, hd, n, capacity_per_shard=_cap(graph, s),
                                 k_max=k_max + 4, mesh=_mesh(s))
    host = ShardedGraphState(hs, hd, n, shards=s,
                             capacity_per_shard=_cap(graph, s))
    for bs, bd, bi in _batches(graph, s, 40 + s):
        applied, _ = apply_shard_batch(
            st, make_update_batch(bs, bd, bi, batch_size=32, n=n, device="cpu"))
        host.replay_applied(bs, bd, bi, applied.numpy()[: len(bs)])
    rb = build_shard_epoch_graph(*host.to_host_edges(), n,
                                 capacity_per_shard=_cap(graph, s),
                                 k_max=k_max + 4, mesh=_mesh(s))
    for rep in st.in_deg:
        assert torch.equal(rep, rb.in_deg[0])
    _same(st.host_arrays(), rb.host_arrays())
    walks = torch.randint(0, n, (8, 5), generator=torch.Generator().manual_seed(s),
                          dtype=torch.int32)
    assert torch.equal(TD.probe_walks_sharded(st, walks, sqrt_c=0.775),
                       TD.probe_walks_sharded(rb, walks, sqrt_c=0.775))


def test_epoch_step_refuses_indivisible_chunks(graph):
    src, dst, n, k_max = graph
    st = build_shard_epoch_graph(src, dst, n, capacity_per_shard=1501,
                                 k_max=k_max, mesh=_mesh(1))
    with pytest.raises(ValueError, match="edge_chunks"):
        make_sharded_epoch_step(st, **_epoch_kw(n))


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


def test_shard_mesh_exchanges():
    gen = torch.Generator().manual_seed(0)
    blocks = [torch.rand((3, 5), generator=gen) for _ in range(4)]
    mesh = _mesh(4)
    assert mesh.single_device and mesh.shards == 4
    fulls = mesh.all_gather_rows(blocks)
    assert all(f is fulls[0] for f in fulls)
    assert torch.equal(fulls[0], torch.cat(blocks))
    wire = mesh.all_gather_rows(blocks, wire="bfloat16")[0]
    assert wire.dtype == torch.float32
    assert torch.equal(wire, torch.cat(blocks).to(torch.bfloat16).float())
    shifted = mesh.ring_shift(blocks)
    assert all(shifted[i] is blocks[(i - 1) % 4] for i in range(4))
    reps = mesh.replicate(blocks[0])
    assert len({r.data_ptr() for r in reps}) == 4
    with pytest.raises(ValueError, match="shards=3"):
        ShardMesh(["cpu"] * 2, shards=3)


def test_shard_mesh_default_needs_divisible_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="3 shards need a device count "
                                         "divisible by 3; have 2"):
        ShardMesh(shards=3)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
        ShardMesh(shards=1)
