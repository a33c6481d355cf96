"""The production push over the in-CSR: ``spmm_csr`` and ``coo_push``'s routes.

CPU: the plain CSR version (``spmm_csr_ref``, what ``coo_push`` runs on a
``ShardedGraph`` of CPU blocks) against the ``index_add_`` push
(``bucket_push``) on graphs with a skewed in-degree, and against a loop
over a hand-made block; which route ``probe_walks_sharded`` takes on each
kind of graph; the meta route and the counted work.

``cuda`` (skip without a card): the kernel against the plain version at
2,048 columns and at odd widths, with a hub row cut into several pieces,
empty and padded rows, on blocks whose ``base`` is past 0; one block a
card on two cards (skip with fewer); equal bits on two launches; one
launch a level and block through ``make_serve_step``.

Imports no JAX: the comparisons are within the port.
"""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

import repro_torch.core.distributed as TD
import repro_torch.kernels.spmm_ell.ops as spmm_ops
from repro_torch.api.backend import ShardedGraphState
from repro_torch.core.epoch import build_shard_epoch_graph
from repro_torch.kernels.ell_plan import CHUNK_SLOTS, plan_of
from repro_torch.kernels.spmm_ell import spmm_csr, spmm_csr_ref
from repro_torch.launch.mesh import ShardMesh
from repro_torch.roofline.analysis import OpCounter

SQRT_C = 0.6 ** 0.5
N = 300  # n_pad 320 at pad_nodes 64: 20 padded rows


def needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run with `python -m pytest -m cuda`")


def skewed_edges(n=N, m=3000, seed=0):
    """Zipf(1.1) destinations, uniform sources: node 0's in-degree is about
    540, cut into several CHUNK_SLOTS pieces; the tail leaves rows empty."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n + 1) ** 1.1
    dst = rng.choice(n, m, p=p / p.sum()).astype(np.int32)
    src = rng.integers(0, n, m).astype(np.int32)
    return src, dst


def sharded(shards, device="cpu", seed=0):
    src, dst = skewed_edges(seed=seed)
    return TD.build_sharded_graph(src, dst, N, mesh=ShardMesh([device] * shards),
                                  pad_nodes=64, pad_edges=64)


def frontier(sg, width, seed=1):
    g = torch.Generator().manual_seed(seed)
    full = torch.rand((sg.n_pad, width), generator=g)
    return [full.to(d) for d in sg.mesh.devices]


def test_graph_shape():
    sg = sharded(4)
    deg = torch.cat(sg.in_deg)
    assert sg.n_pad == 320 and int(deg[N:].abs().sum()) == 0
    assert int(deg.max()) > 3 * CHUNK_SLOTS and int((deg[:N] == 0).sum()) > 0
    assert sg.base[0] == 0 and all(b > 0 for b in sg.base[1:])


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("width", [1, 33, 256])
def test_csr_push_equals_index_add_push(shards, width):
    sg = sharded(shards, seed=shards)
    fulls = frontier(sg, width)
    w = TD.push_weights(sg, SQRT_C)
    got = TD.coo_push(fulls, sg, w)
    want = TD.bucket_push(fulls, sg.src_sh, sg.dst_sh, sg.counts, w,
                          rows=sg.rows, n_pad=sg.n_pad)
    for a, b in zip(got, want):
        assert a.shape == b.shape == (sg.rows, width) and a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert float(torch.cat(got).abs().sum()) > 0


def test_csr_ref_by_hand():
    """A block of 4 rows from global offset 5: an empty row, a sentinel id
    (>= n, skipped) and ids in slot order."""
    n, b = 6, 3
    scores = torch.arange(n * b, dtype=torch.float32).reshape(n, b)
    indices = torch.tensor([2, 0, 7, 5, 1, 6, 6], dtype=torch.int32)  # 6 = pad
    indptr = torch.tensor([5, 7, 7, 9], dtype=torch.int32)
    row_len = torch.tensor([2, 0, 2, 1], dtype=torch.int32)
    w = torch.tensor([1.0, 2.0, 0.5, 3.0])
    got = spmm_csr_ref(indices, scores, w, indptr=indptr, row_len=row_len, base=5)
    want = torch.zeros(4, b)
    for v in range(4):
        for k in range(int(row_len[v])):
            x = int(indices[int(indptr[v]) - 5 + k])
            if x < n:
                want[v] += scores[x]
        want[v] *= w[v]
    assert torch.equal(got, want)
    assert torch.equal(spmm_csr(indices, scores, w, indptr=indptr, row_len=row_len,
                                base=5, live=5), got)


def _route_counts(monkeypatch, csr=True):
    """Count the calls of ``bucket_push`` and (``csr``: on CPU blocks, where
    the op launches nothing) of ``spmm_csr``."""
    calls = {"spmm_csr": 0, "bucket_push": 0}

    def counting(name, real):
        def fn(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        return fn

    if csr:
        monkeypatch.setattr(spmm_ops, "spmm_csr", counting("spmm_csr", spmm_csr))
    monkeypatch.setattr(TD, "bucket_push", counting("bucket_push", TD.bucket_push))
    return calls


@pytest.mark.parametrize("shards", [1, 2])
def test_probe_walks_routes(monkeypatch, shards):
    """A ShardedGraph takes the CSR route once a level and block; a
    ShardEpochGraph (COO buckets only) still takes the index_add_ push once
    a level; both give the same scores."""
    src, dst = skewed_edges()
    walks = torch.randint(0, N, (24, 6), generator=torch.Generator().manual_seed(3),
                          dtype=torch.int32)
    levels = walks.shape[1] - 1
    calls = _route_counts(monkeypatch)
    sg = TD.build_sharded_graph(src, dst, N, mesh=ShardMesh(["cpu"] * shards),
                                pad_nodes=64, pad_edges=64)
    csr = TD.probe_walks_sharded(sg, walks, sqrt_c=SQRT_C)
    assert calls == {"spmm_csr": levels * shards, "bucket_push": 0}
    hs, hd = ShardedGraphState(src, dst, N, shards=shards).to_host_edges()
    st = build_shard_epoch_graph(hs, hd, N, capacity_per_shard=3000, k_max=1024,
                                 mesh=ShardMesh(["cpu"] * shards))
    coo = TD.probe_walks_sharded(st, walks.clamp(max=N), sqrt_c=SQRT_C)
    assert calls == {"spmm_csr": levels * shards, "bucket_push": levels}
    torch.testing.assert_close(csr[:N], coo[:N], rtol=1e-5, atol=1e-6)


def test_meta_route_and_counted_work():
    """meta tensors give a meta [R, B]; under a counter a call is one op of
    csr_work, counted from shapes and ``live`` alone, on every route."""
    sg = sharded(1)
    full, w = frontier(sg, 8)[0], TD.push_weights(sg, SQRT_C)[0]
    args = (sg.indices[0], full, w)
    kw = dict(indptr=sg.indptr[0], row_len=sg.in_deg[0], base=0, live=sg.counts[0])
    counts = []
    for dev in ("cpu", "meta"):
        a = [x.to(dev) for x in args]
        k = {key: (v.to(dev) if torch.is_tensor(v) else v) for key, v in kw.items()}
        with OpCounter() as c:
            out = spmm_csr(*a, **k)
        assert out.device.type == dev and out.shape == (sg.n_pad, 8)
        assert list(c.by_op) == ["spmm_csr"]
        counts.append(c.totals())
    assert counts[0] == counts[1]
    want = spmm_ops.csr_work(*args, **kw)
    assert counts[0]["flops"] == want.flops == sg.counts[0] * 8 + sg.n_pad * 8
    assert counts[0]["bytes"] == want.bytes


def test_plan_of_takes_chunk_slots():
    """A plan at explicit chunk slots is kept beside the default one, and
    the default still reads ``CHUNK_SLOTS`` at the call."""
    deg = sharded(1).in_deg[0].clone()
    k = int(deg.max())
    default = plan_of(deg, k)
    small = plan_of(deg, k, chunk_slots=16)
    assert default.chunk_slots == CHUNK_SLOTS and small.chunk_slots == 16
    assert small.n_pieces > default.n_pieces
    assert plan_of(deg, k, chunk_slots=16) is small and plan_of(deg, k) is default


def test_refusals():
    sg = sharded(1)
    full, w = frontier(sg, 4)[0], TD.push_weights(sg, SQRT_C)[0]
    kw = dict(indptr=sg.indptr[0].to("meta"), row_len=sg.in_deg[0].to("meta"),
              base=0, live=1)
    with pytest.raises(TypeError, match="dtype"):
        spmm_csr(sg.indices[0].to("meta"), full.double().to("meta"), w.to("meta"), **kw)
    with pytest.raises(ValueError, match="weights"):
        spmm_csr(sg.indices[0].to("meta"), full.to("meta"), w[:-1].to("meta"), **kw)
    with pytest.raises(ValueError, match="indices"):
        spmm_csr(sg.indices[0].long().to("meta"), full.to("meta"), w.to("meta"), **kw)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("width", [2048, 37, 64])
def test_spmm_csr_kernel_matches_plain(shards, width):
    """The kernel (coo_push on blocks of the card) against the plain version
    (the same graph on CPU blocks): a hub cut into pieces, empty and padded
    rows, blocks from base > 0; fp32 at 1e-5 of the largest value."""
    needs_cuda()
    cpu, card = sharded(shards), sharded(shards, "cuda:0")
    assert max(int(d.max()) for d in card.in_deg) > 3 * CHUNK_SLOTS
    fulls = frontier(cpu, width)
    before = spmm_csr.launches
    got = TD.coo_push([f.to("cuda:0") for f in fulls], card,
                      TD.push_weights(card, SQRT_C))
    torch.cuda.synchronize()
    assert spmm_csr.launches - before == shards
    want = TD.coo_push(fulls, cpu, TD.push_weights(cpu, SQRT_C))
    for s, (a, b) in enumerate(zip(got, want)):
        assert a.device.type == "cuda" and a.shape == b.shape
        scale = float(b.abs().max())
        assert scale > 0 or s > 0
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5 * max(scale, 1e-30))
    plan = plan_of(card.in_deg[0], card.indices[0].shape[0])
    assert plan.n_pieces > 3 and plan.n_long >= 1


@pytest.mark.cuda
def test_spmm_csr_launches_on_each_blocks_card():
    """One block a card, driven from one thread while cuda:0 is current:
    each block's launch goes to its own card and equals the plain version,
    and make_serve_step over the two cards answers as over CPU blocks."""
    needs_cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    devs = [torch.device(f"cuda:{i}") for i in range(2)]
    src, dst = skewed_edges(seed=2)
    cpu = TD.build_sharded_graph(src, dst, N, mesh=ShardMesh(["cpu"] * 2),
                                 pad_nodes=64, pad_edges=64)
    card = TD.build_sharded_graph(src, dst, N, mesh=ShardMesh(devs),
                                  pad_nodes=64, pad_edges=64)
    fulls = frontier(cpu, 2048)
    torch.cuda.set_device(0)
    before = spmm_csr.launches
    got = TD.coo_push([f.to(d) for f, d in zip(fulls, devs)], card,
                      TD.push_weights(card, SQRT_C))
    for d in devs:
        torch.cuda.synchronize(d)
    assert spmm_csr.launches - before == 2
    want = TD.coo_push(fulls, cpu, TD.push_weights(cpu, SQRT_C))
    for a, b, d in zip(got, want, devs):
        assert a.device == d
        scale = max(float(b.abs().max()), 1e-30)
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5 * scale)
    step = TD.make_serve_step(types.SimpleNamespace(c=0.6), queries=2,
                              walk_chunk=16, max_len=6, top_k=5)
    cont, pick = TD.csr_uniforms(torch.Generator().manual_seed(5), walks=32,
                                 max_len=6, sqrt_c=SQRT_C, device="cpu")
    q = torch.tensor([0, 7], dtype=torch.int32)
    before = spmm_csr.launches
    _, vals = step(card, q.to(devs[0]), uniforms=(cont.to(devs[0]), pick.to(devs[0])))
    assert spmm_csr.launches - before == 5 * 2
    _, ref = step(cpu, q, uniforms=(cont, pick))
    torch.testing.assert_close(vals.cpu(), ref, rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
def test_spmm_csr_kernel_repeats_bit_for_bit():
    """No float atomics: two launches on equal inputs give equal bits (the
    hub's pieces are added by whichever block arrives last, in piece order)."""
    needs_cuda()
    sg = sharded(1, "cuda:0")
    full = frontier(sg, 2048)[0].to("cuda:0")
    w = TD.push_weights(sg, SQRT_C)
    a = TD.coo_push([full], sg, w)[0]
    b = TD.coo_push([full.clone()], sg, w)[0]
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 2])
def test_serve_step_launches_once_a_level_a_block(monkeypatch, shards):
    """make_serve_step on blocks of the card: spmm_csr once a level and
    block, no index_add_ push; the answers equal the CPU blocks' on the same
    draws."""
    needs_cuda()
    calls = _route_counts(monkeypatch, csr=False)
    step = TD.make_serve_step(types.SimpleNamespace(c=0.6), queries=2,
                              walk_chunk=16, max_len=6, top_k=5)
    cont, pick = TD.csr_uniforms(torch.Generator().manual_seed(5), walks=32,
                                 max_len=6, sqrt_c=SQRT_C, device="cpu")
    q = torch.tensor([0, 7], dtype=torch.int32)
    out = {}
    for dev in ("cpu", "cuda:0"):
        before = spmm_csr.launches
        idx, vals = step(sharded(shards, dev), q.to(dev),
                         uniforms=(cont.to(dev), pick.to(dev)))
        out[dev] = (idx.cpu(), vals.cpu())
        if dev != "cpu":
            torch.cuda.synchronize()
            assert spmm_csr.launches - before == 5 * shards
    assert calls["bucket_push"] == 0
    torch.testing.assert_close(out["cuda:0"][1], out["cpu"][1], rtol=1e-5, atol=1e-7)
    assert float(out["cpu"][1].max()) > 0
