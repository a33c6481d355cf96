"""Ring push over a :class:`~repro_torch.launch.mesh.ShardMesh` (port of
``repro.core.ring``).

The all-gather push (``core/distributed.py``) hands every shard the whole
frontier each level.  The ring instead keeps one row block resident per
shard and an edge bucket per ``(dst_shard = me, src_block)``
(``graph/partition.py::partition_edges_2d``): each of S steps pushes the
resident block's bucket, then passes the block to the next shard
(``ShardMesh.ring_shift``), so a level moves exactly one frontier's worth
of rows.  The pushes are ``index_add_`` over each bucket's live prefix
(JAX code outside any kernel in the JAX package); accumulation is fp32,
and ``probe_walks_ring`` can carry its frontier in bf16.

``probe_lanes_ring`` runs the compacted lane loop with the ring push; with
``use_kernel`` each level's prologue (deposit, injection, pruning) is one
``lane_probe`` launch per shard in its identity form: each row's one
"neighbor" is itself (``K = 1``, weight 1, ``tab0 = 0``: the table is the
resident block), and the exclusion follows the push.

``make_ring_serve_step`` is the production serve step with the ring push:
it samples walks through the CSR sampler of ``core/distributed.py`` over
the graph's CSR view (built once, by ``build_ring_graph(..., csr=True)``)
and probes them with ``probe_walks_ring``.  ``ring_graph_abstract`` gives the full-scale
graph's shapes as ``meta`` tensors.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.distributed import (
    csr_blocks,
    even_split,
    exclude,
    inject,
    lane_level,
    lane_probe_block,
    push_weights,
    row_ids,
    serve_topk,
    step_walks,
)
from repro_torch.graph.partition import pad_to_multiple, partition_edges_2d
from repro_torch.graph.structs import GATHER_BUDGET_BYTES

Tensor = torch.Tensor


@dataclasses.dataclass
class RingGraph:
    """2-D partitioned edges, one row of buckets per shard.

    ``src_sh[s]`` / ``dst_sh[s]`` are int32 ``[S, E]`` on shard s's device:
    bucket ``(s, b)`` holds the edges into block s from block b, source ids
    relative to block b and destination ids relative to block s, live edges
    first and sentinel ``rows`` after them; ``counts[s][b]`` is that
    bucket's live edge count (host ints).  ``in_deg`` is an ``[n_pad]``
    replica per shard.

    The CSR view the production step samples walks from (the reference's
    ``indptr`` / ``indices``) is cut into the same row blocks:
    ``indptr[s]`` int32 ``[rows]`` (global offsets), ``indices[s]`` (the
    block's in-neighbour lists, sorted stably by destination, padded with
    ``n_pad``) and ``base[s]`` (its first offset).
    ``build_ring_graph(..., csr=True)`` builds it from the edge list; other
    graphs (the sharded backend's, ``ring_graph_from_parts``'s) have none:
    their probes read only the buckets.
    """

    src_sh: list
    dst_sh: list
    counts: list
    in_deg: list
    n: int
    n_pad: int
    shards: int
    mesh: object
    indptr: list | None = None
    indices: list | None = None
    base: list | None = None
    m: int | None = None

    @property
    def rows(self) -> int:
        return self.n_pad // self.shards


def ring_graph_from_parts(src_sh, dst_sh, in_deg, n: int, mesh) -> RingGraph:
    """Place host ``[S, S, E]`` buckets and an ``[n_pad]`` degree vector on
    the mesh (live edges must come first in every bucket)."""
    s_count = mesh.shards
    src_sh = np.asarray(src_sh, np.int32)
    dst_sh = np.asarray(dst_sh, np.int32)
    n_pad = pad_to_multiple(n, s_count)
    rows = n_pad // s_count
    if src_sh.shape[:2] != (s_count, s_count) or dst_sh.shape != src_sh.shape:
        raise ValueError(
            f"ring buckets must be [S={s_count}, S, E], got {src_sh.shape} "
            f"and {dst_sh.shape}"
        )
    live = src_sh < rows
    counts = live.sum(axis=2)
    e = src_sh.shape[2]
    if not (live == (np.arange(e) < counts[..., None])).all():
        raise ValueError("ring buckets must hold their live edges first")
    deg = torch.from_numpy(np.array(in_deg, np.int32).reshape(n_pad))
    return RingGraph(
        src_sh=[torch.from_numpy(src_sh[s]).to(d)
                for s, d in enumerate(mesh.devices)],
        dst_sh=[torch.from_numpy(dst_sh[s]).to(d)
                for s, d in enumerate(mesh.devices)],
        counts=[[int(c) for c in row] for row in counts],
        in_deg=mesh.replicate(deg),
        n=int(n), n_pad=int(n_pad), shards=s_count, mesh=mesh,
    )


def build_ring_graph(src: np.ndarray, dst: np.ndarray, n: int, *, mesh,
                     csr: bool = False) -> RingGraph:
    """The ring layout of a host edge list over ``mesh``'s S shards; with
    ``csr`` also its CSR view, which only the production step reads (it
    costs a stable sort of the edges on the host and a second per-block
    edge array on the devices)."""
    part = partition_edges_2d(src, dst, n, mesh.shards)
    if not csr:
        in_deg = np.zeros(part["n_pad"], np.int32)
        in_deg[:n] = np.bincount(np.asarray(dst), minlength=n)[:n]
        return ring_graph_from_parts(part["src_sh"], part["dst_sh"], in_deg,
                                     n, mesh)
    view = csr_blocks(src, dst, n, part["n_pad"], mesh)
    rg = ring_graph_from_parts(part["src_sh"], part["dst_sh"],
                               view["in_deg"], n, mesh)
    rows = rg.rows
    rg.indptr = [torch.from_numpy(view["indptr"][s * rows : (s + 1) * rows]
                                  .copy()).to(d)
                 for s, d in enumerate(mesh.devices)]
    rg.indices = [torch.from_numpy(view["part"]["src_sh"][s].copy()).to(d)
                  for s, d in enumerate(mesh.devices)]
    rg.base = view["base"]
    rg.m = len(src)
    return rg


def ring_graph_abstract(n: int, m: int, shards: int, e_max: int) -> RingGraph:
    """The full-scale ring graph as ``meta`` tensors (shapes and dtypes
    only, nothing allocated): stacked or concatenated over the shards they
    are the reference's ``src_sh`` / ``dst_sh`` [S, S, e_max], ``in_deg`` /
    ``indptr`` [n_pad] and ``indices`` [m_pad] (``m_pad`` a multiple of
    4,096, split evenly over the blocks).  The m live edges are split
    evenly over the S x S buckets (``counts``), each within ``e_max``."""
    from repro_torch.launch.mesh import ShardMesh

    mesh = ShardMesh(["meta"] * shards)
    n_pad = pad_to_multiple(n, shards)
    rows = n_pad // shards
    m_pad = -(-m // 4096) * 4096

    def blocks(*shape):
        return [torch.empty(shape, dtype=torch.int32, device="meta")
                for _ in range(shards)]

    live = even_split(m, shards * shards)
    if live[0] > e_max:
        raise ValueError(f"{live[0]} edges a bucket exceed e_max {e_max}")
    return RingGraph(
        src_sh=blocks(shards, e_max), dst_sh=blocks(shards, e_max),
        counts=[live[s * shards : (s + 1) * shards] for s in range(shards)],
        in_deg=blocks(n_pad), n=int(n), n_pad=n_pad,
        shards=shards, mesh=mesh, indptr=blocks(rows),
        indices=blocks(m_pad // shards),
        base=[int(b) for b in np.cumsum([0] + even_split(m, shards)[:-1])],
        m=int(m),
    )


def make_ring_serve_step(cfg, *, queries: int, walk_chunk: int, max_len: int,
                         top_k: int = 50, frontier_dtype=torch.float32):
    """The production serve step with the ring push (port of
    ``repro.core.ring.make_ring_serve_step``): ``step(rg, query_nodes, gen,
    *, uniforms=None) -> (idx int32 [Q, k], vals fp32 [Q, k])``, as
    ``core.distributed.make_serve_step``, the walks drawn over ``rg``'s CSR
    view and probed by ``probe_walks_ring`` in ``frontier_dtype``.  The
    mean is taken in fp32 (the reference's sum of a bf16 frontier is
    rounded to bf16)."""
    sqrt_c = math.sqrt(cfg.c)

    def serve_step(rg: RingGraph, query_nodes, gen=None, *, uniforms=None):
        if rg.indices is None:
            raise ValueError("the ring graph has no CSR view to sample walks "
                             "from: build it with build_ring_graph(..., csr=True)")
        walks = step_walks(rg, query_nodes, gen, uniforms,
                           walk_chunk=walk_chunk, max_len=max_len,
                           sqrt_c=sqrt_c)
        scores = probe_walks_ring(rg, walks, sqrt_c=sqrt_c,
                                  frontier_dtype=frontier_dtype)
        return serve_topk(scores, query_nodes, queries=queries,
                          walk_chunk=walk_chunk, top_k=top_k)

    return serve_step


def _ring_push_level(bufs: list[Tensor], rg: RingGraph) -> list[Tensor]:
    """One full frontier pass of the ring: returns each shard's
    un-renormalized push accumulator [rows, C] in fp32.

    ``bufs[s]`` is block s, resident on shard s.  At step t shard s holds
    block ``(s - t) mod S``, adds its bucket's live prefix, and passes the
    block on (no pass after the last step).  A bucket goes in slices whose
    gathered ``[slice, C]`` fp32 block stays under ``GATHER_BUDGET_BYTES``
    (the slices keep the edges' order).
    """
    mesh, s_count, rows = rg.mesh, rg.shards, rg.rows
    accs = [torch.zeros((rows, b.shape[1]), dtype=torch.float32,
                        device=b.device) for b in bufs]
    ch = max(1, GATHER_BUDGET_BYTES // max(1, bufs[0].shape[1] * 4))
    for step in range(s_count):
        for me in range(s_count):
            blk = (me - step) % s_count
            c = rg.counts[me][blk]
            for a in range(0, c, ch):
                b = min(c, a + ch)
                src = rg.src_sh[me][blk, a:b].long()
                dst = rg.dst_sh[me][blk, a:b].long()
                accs[me].index_add_(0, dst, bufs[me][src].float())
        if step < s_count - 1:
            bufs = mesh.ring_shift(bufs)
    return accs


def probe_walks_ring(
    rg: RingGraph,
    walks: Tensor,  # int32 [C, L] (sentinel >= n_pad, or n)
    *,
    sqrt_c: float,
    eps_p: float = 0.0,
    frontier_dtype=torch.float32,
) -> Tensor:
    """Telescoped probe with the ring push; returns scores [n_pad, C] on
    shard 0's device.  The frontier blocks are carried (and passed) in
    ``frontier_dtype``; pushes accumulate in fp32."""
    mesh, rows = rg.mesh, rg.rows
    c, length = walks.shape
    cols = mesh.broadcast(walks)
    ar = [torch.arange(c, device=d) for d in mesh.devices]
    w = push_weights(rg, sqrt_c)
    scores = [torch.zeros((rows, c), dtype=frontier_dtype, device=d)
              for d in mesh.devices]
    for p in range(length, 1, -1):
        for s, sc in enumerate(scores):
            inject(sc, cols[s][:, p - 1], s, rows, ar[s])
            if eps_p > 0.0:
                sc.masked_fill_(sc <= eps_p / (sqrt_c ** (p - 1)), 0.0)
        accs = _ring_push_level(scores, rg)
        scores = [(a * w[s][:, None]).to(frontier_dtype)
                  for s, a in enumerate(accs)]
        del accs
        for s, sc in enumerate(scores):
            exclude(sc, cols[s][:, p - 2], s, rows, ar[s])
    return mesh.gather_rows(scores)


_IDENTITY: dict = {}


def _identity_rows(device, row0: int, rows: int):
    """The ring kernel prologue's operands for one block: own-row ids
    [rows, 1], unit weights and unit row lengths.  The row lengths are one
    tensor per (device, rows), shared by every shard there, so the
    kernels' chunk plan is built once for all of them."""
    key = (torch.device(device), rows)
    ones = _IDENTITY.get(key)
    if ones is None:
        ones = _IDENTITY[key] = torch.ones(rows, dtype=torch.int32,
                                           device=device)
    ident = (row0 + torch.arange(rows, dtype=torch.int32, device=device))
    return ident[:, None].contiguous(), ones.float(), ones


def probe_lanes_ring(
    rg: RingGraph,
    w: list[Tensor],  # f32 [rows] per shard: push weights of its rows
    pool: Tensor,  # int32 [Q * n_r, L] on shard 0's device (sentinel n)
    pool_len: Tensor,
    *,
    q: int,
    wq: int,
    n_r: int,
    max_len: int,
    sqrt_c: float,
    eps_p: float,
    sentinel: int,
    use_kernel: bool = True,
) -> Tensor:
    """Lane-batched telescoped probe with the ring push; returns ``total``
    [n_pad, W] on shard 0's device.

    The ring counterpart of ``core.distributed.probe_lanes_sharded``.  With
    ``use_kernel`` each level's deposit + inject + prune is one identity
    ``lane_probe`` launch per shard (the push cannot ride inside the
    kernel, since it runs through the ring), then the ring push, the
    weights and the exclusion.
    """
    mesh, rows = rg.mesh, rg.rows
    width = q * wq

    def push(blocks):
        return [a * ws[:, None] for a, ws in zip(_ring_push_level(blocks, rg), w)]

    if use_kernel:
        from repro_torch.kernels.lane_probe.ops import lane_probe_level

        ops = [_identity_rows(d, s * rows, rows)
               for s, d in enumerate(mesh.devices)]
        no_excl = [torch.full((width,), sentinel, dtype=torch.int32, device=d)
                   for d in mesh.devices]
        rids = row_ids(mesh, rg.rows)

        def level_fn(scores, total, vecs):
            prepped = []
            for s, (fin, u_p, _, thr) in enumerate(vecs):
                ident, ones, row_len = ops[s]
                prep, _ = lane_probe_level(
                    ident, ones, scores[s], scores[s], total[s],
                    fin, u_p, no_excl[s], thr, row_len=row_len,
                    row0=s * rows, tab0=0, n_live=sentinel,
                    prune=eps_p > 0.0, tot=total[s],
                )
                prepped.append(prep)
            out = [
                torch.where(rids[s] == vecs[s][2][None, :],
                            torch.zeros((), device=p.device), p)
                for s, p in enumerate(push(prepped))
            ]
            return out, total
    else:
        level_fn = lane_level(push, mesh=mesh, rows=rows, eps_p=eps_p)

    totals = lane_probe_block(
        level_fn, pool, pool_len, mesh=mesh, rows=rows, q=q, wq=wq,
        n_r=n_r, max_len=max_len, sqrt_c=sqrt_c, eps_p=eps_p,
        sentinel=sentinel,
    )
    return mesh.gather_rows(totals)
