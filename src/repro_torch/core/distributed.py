"""Sharded ProbeSim probes over a :class:`~repro_torch.launch.mesh.ShardMesh`
(port of ``repro.core.distributed``).

Layout: node rows are range-partitioned into S blocks of ``rows = n_pad /
S``; shard s holds block s of every frontier, the in-edges of its rows
(destination partitioning, ``graph/partition.py``) as a COO bucket, and
rows ``[s * rows, (s + 1) * rows)`` of the ELL table.  A push level
all-gathers the frontier once (``ShardMesh.all_gather_rows``) and each
shard gathers its sources from it and writes only its own rows.

The JAX package runs each shard's loop inside ``shard_map``; here one
controller runs the shards in turn.  The lane bookkeeping (cursors, walk
positions, the continue predicate) is kept once, on shard 0's device, and
only the four ``[W]`` vectors a level reads (``fin``, ``u_p``, ``u_prev``,
``thr``) are sent to the other devices; the loop reads its predicate on
the host once per level, as the local serve does.

* ``walks_from_uniforms_sharded`` — the sqrt(c)-walk sampler over the
  row-sharded ELL table: each step is served by the shard that owns the
  walk's current node (one ``[R]`` exchange per step).  Given the same
  uniforms it returns ``core.walks.walks_from_uniforms``'s walks on the
  whole table, bit for bit.
* ``lane_level`` / ``lane_probe_block`` — the plain level over all row
  blocks and the compacted lane loop that drives a level function.
* ``probe_lanes_sharded`` — the lane-batched probe with the all-gather
  push: each level runs the ``lane_probe`` kernel per shard over the
  gathered frontier (``use_kernel``), or the plain level with a COO
  ``index_add_`` push over the shard's source-sorted bucket
  (``bucket_push``).
* ``probe_walks_sharded`` — the per-level telescoped probe over a walk
  matrix (the mesh epoch's probe with the kernel off, and the production
  step's); its push, ``coo_push``, runs the ``spmm_csr`` kernel over each
  block's in-CSR where the graph has one, else ``bucket_push``.

The production serve step (the paper's ``probesim`` arch family):

* ``ShardedGraph`` / ``build_sharded_graph`` — the production layout: per
  row block its ``in_deg`` and ``indptr`` rows and its in-neighbour lists
  (the sampler and the push read them), and its destination-partitioned
  COO bucket sorted by source;
* ``walks_from_uniforms_csr`` / ``sample_walks_sharded`` — the CSR walk
  sampler, each step served by the block that owns the walk's node;
* ``make_serve_step`` — sample, probe (``probe_walks_sharded``), mean over
  the walk chunk, exclude the query node, top-k.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.multisource import (
    lane_columns,
    lane_continue,
    lane_frontier,
    lane_max_steps,
    lane_refill,
    lane_thresholds,
)
from repro_torch.graph.partition import pad_to_multiple, partition_edges_by_dst
from repro_torch.graph.structs import GATHER_BUDGET_BYTES
from repro_torch.spans import span

Tensor = torch.Tensor


def even_split(total: int, parts: int) -> list[int]:
    """``total`` split into ``parts`` host ints as evenly as it goes (the
    remainder on the first parts)."""
    q, r = divmod(int(total), parts)
    return [q + (i < r) for i in range(parts)]


def row_block(x: Tensor, s: int, rows: int) -> Tensor:
    """Shard s's rows of a per-shard node vector, which is either its row
    block already or a full ``[n_pad]`` replica."""
    return x if x.shape[0] == rows else x[s * rows : (s + 1) * rows]


# ---------------------------------------------------------------------------
# The production layout: CSR row blocks sharing their COO buckets
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedGraph:
    """The production serve step's graph over a ``ShardMesh`` (port of
    ``repro.core.distributed.ShardedGraph``).

    Every list holds one tensor per row block, on that block's device;
    block s owns rows ``[s * rows, (s + 1) * rows)``:

    * ``indptr`` int32 ``[rows]`` — the global in-CSR start offset of each
      of its rows (the reference's ``indptr``, cut into blocks);
    * ``in_deg`` int32 ``[rows]``;
    * ``indices`` int32 ``[E]`` — the block's in-neighbour lists (its CSR
      values: the reference's ``indices[base[s] : base[s] + counts[s]]``),
      edges sorted stably by destination, padded with ``n_pad``; the
      sampler and the push read them;
    * ``src_sh`` / ``dst_sh`` int32 ``[E]`` — the block's
      destination-partitioned COO bucket (global ids, padded with
      ``n_pad``): the same edges as ``indices`` sorted by (source,
      destination).  No route of the port reads it since the push went
      to the in-CSR (``bucket_push`` runs on ``ShardEpochGraph``'s
      buckets); it stays for the tests' shape parity with the reference,
      which keeps its COO ``src`` / ``dst`` apart from ``indices``, until a
      later change drops it (ROADMAP P3);
    * ``counts`` / ``base`` — host ints: the block's live edges and the
      global CSR offset of its first edge.

    ``n_pad`` is the reference's (``pad_to_multiple(n, pad_nodes)``) and is
    also the walks' sentinel; ``m_pad`` is the reference's padded edge count
    (the port's blocks are padded to the largest block instead).  The
    sampler reads ``indptr`` / ``in_deg`` / ``indices``; the push
    (``coo_push``, the ``spmm_csr`` kernel) reads ``indptr`` / ``indices``
    / ``base`` / ``in_deg``, and ``counts`` for its counted work.
    """

    indptr: list
    in_deg: list
    indices: list
    src_sh: list
    dst_sh: list
    counts: list
    base: list
    n: int
    n_pad: int
    m: int
    m_pad: int
    mesh: object

    @property
    def shards(self) -> int:
        return self.mesh.shards

    @property
    def rows(self) -> int:
        return self.n_pad // self.mesh.shards


def csr_blocks(src, dst, n: int, n_pad: int, mesh) -> dict:
    """The in-CSR of ``(src, dst)`` cut into ``mesh``'s row blocks of
    ``n_pad / S`` rows, on the host: ``indptr`` / ``in_deg`` [n_pad] (the
    reference's, global), ``part`` (``partition_edges_by_dst`` of the edges
    sorted stably by destination: each bucket's sources are its rows' CSR
    values) and ``base`` (each block's first CSR offset)."""
    src = np.asarray(src, np.int32).reshape(-1)
    dst = np.asarray(dst, np.int32).reshape(-1)
    shards = mesh.shards
    if n_pad % shards:
        raise ValueError(f"n_pad {n_pad} is not divisible by {shards} shards")
    order = np.argsort(dst, kind="stable")
    cnt = np.bincount(dst, minlength=n)
    in_deg = np.zeros(n_pad, np.int32)
    in_deg[:n] = cnt[:n]
    indptr = np.zeros(n_pad, np.int32)
    np.cumsum(cnt[: n - 1], out=indptr[1:n])
    part = partition_edges_by_dst(src[order], dst[order], n_pad, shards)
    base = np.concatenate([[0], np.cumsum(part["counts"])[:-1]])
    return dict(indptr=indptr, in_deg=in_deg, part=part,
                base=[int(b) for b in base])


def build_sharded_graph(
    src: np.ndarray, dst: np.ndarray, n: int, *, mesh, pad_nodes: int = 1,
    pad_edges: int = 1,
) -> ShardedGraph:
    """Host-side constructor: place the CSR row blocks and their buckets on
    ``mesh`` (``n_pad = pad_to_multiple(n, pad_nodes)`` must be divisible by
    the shard count)."""
    n_pad = pad_to_multiple(n, pad_nodes)
    m = len(src)
    csr = csr_blocks(src, dst, n, n_pad, mesh)
    part, rows = csr["part"], n_pad // mesh.shards
    blocks = dict(indptr=[], in_deg=[], indices=[], dst=[])
    for s, d in enumerate(mesh.devices):
        live = np.arange(part["src_sh"].shape[1]) < part["counts"][s]
        gdst = np.where(live, part["dst_sh"][s] + s * rows, n_pad)
        for k, a in (("indptr", csr["indptr"][s * rows : (s + 1) * rows]),
                     ("in_deg", csr["in_deg"][s * rows : (s + 1) * rows]),
                     ("indices", part["src_sh"][s]), ("dst", gdst)):
            blocks[k].append(torch.from_numpy(
                np.ascontiguousarray(a, np.int32)).to(d))
    # the stable sort keeps each source's edges in destination order
    src_sh, dst_sh = source_sorted(blocks["indices"], blocks.pop("dst"))
    return ShardedGraph(
        **blocks, src_sh=src_sh, dst_sh=dst_sh, counts=[int(c) for c in part["counts"]], base=csr["base"],
        n=int(n), n_pad=int(n_pad), m=int(m),
        m_pad=pad_to_multiple(m, pad_edges), mesh=mesh,
    )


def sharded_graph_abstract(n: int, m: int, shards: int, *, pad_nodes: int,
                           pad_edges: int) -> ShardedGraph:
    """The full-scale graph as ``meta`` tensors (shapes and dtypes only,
    nothing allocated): concatenated over the blocks they are the
    reference's ``indptr`` / ``in_deg`` [n_pad] and ``indices`` / ``src`` /
    ``dst`` [m_pad], the edges split evenly over the blocks: block s holds
    ``counts[s]`` of the m live edges (m / S, the remainder on the first
    blocks) from CSR offset ``base[s]``."""
    from repro_torch.launch.mesh import ShardMesh

    n_pad = pad_to_multiple(n, pad_nodes)
    m_pad = pad_to_multiple(m, pad_edges)
    if n_pad % shards or m_pad % shards:
        raise ValueError(f"n_pad {n_pad} / m_pad {m_pad} not divisible by "
                         f"{shards} shards")

    def blocks(size):
        return [torch.empty((size,), dtype=torch.int32, device="meta")
                for _ in range(shards)]

    counts = even_split(m, shards)
    return ShardedGraph(
        indptr=blocks(n_pad // shards), in_deg=blocks(n_pad // shards),
        indices=blocks(m_pad // shards), src_sh=blocks(m_pad // shards),
        dst_sh=blocks(m_pad // shards),
        counts=counts, base=[int(b) for b in np.cumsum([0] + counts[:-1])],
        n=int(n), n_pad=n_pad, m=int(m), m_pad=m_pad,
        mesh=ShardMesh(["meta"] * shards),
    )


# ---------------------------------------------------------------------------
# The CSR walk sampler
# ---------------------------------------------------------------------------


def csr_uniforms(gen: torch.Generator, *, walks: int, max_len: int,
                 sqrt_c: float, device) -> tuple[Tensor, Tensor]:
    """The production sampler's draws, in the reference's shapes and order:
    ``cont`` (bool, continue w.p. sqrt(c)) then ``pick`` (fp32), each
    ``[max_len - 1, walks]``, from ``gen`` on ``device``."""
    shape = (max_len - 1, walks)
    cont = torch.rand(shape, generator=gen, device=device) < sqrt_c
    pick = torch.rand(shape, generator=gen, device=device)
    return cont, pick


def walks_from_uniforms_csr(g, queries, cont: Tensor, pick: Tensor) -> Tensor:
    """Walks int32 [Q * B, max_len] (sentinel ``n_pad``) from pre-drawn
    ``cont`` / ``pick`` [max_len - 1, Q * B]; walk ``q * B + j`` starts at
    ``queries[q]``.

    ``g`` carries ``mesh``, ``rows``, ``n_pad`` and per block ``indptr``,
    ``in_deg`` (its rows or a full replica), ``indices`` and ``base``
    (``ShardedGraph``, or a ``RingGraph`` with its CSR view).  Each step
    sends the walks' nodes to every block; the block that owns a node
    reads its degree and picks in-neighbour ``floor(pick * deg)`` (fp32,
    clipped to ``[0, max(deg - 1, 0)]``) from its CSR values; dead walks
    stay at ``n_pad``.  Given the reference's uniforms these are the
    reference's walks, bit for bit.
    """
    mesh, rows, n_pad = g.mesh, g.rows, g.n_pad
    dev = mesh.home
    cont = cont.to(dev)
    picks = mesh.broadcast(pick.to(dev, torch.float32))
    q = torch.as_tensor(queries, dtype=torch.int32).reshape(-1).to(dev)
    cur = q.repeat_interleave(cont.shape[1] // q.numel())
    alive = torch.ones_like(cur, dtype=torch.bool)
    sentinel = torch.full_like(cur, n_pad)
    cols = [cur]
    for t in range(cont.shape[0]):
        cc = cur.clamp(0, n_pad - 1)
        owner = cc // rows
        deg, nxt = torch.zeros_like(cur), sentinel
        for s, c_s in enumerate(mesh.broadcast(cc)):
            lr = (c_s - s * rows).clamp(0, rows - 1).long()
            d_s = row_block(g.in_deg[s], s, rows)[lr]
            k = torch.floor(picks[s][t] * d_s.to(torch.float32)).to(torch.int32)
            k = torch.minimum(k.clamp(min=0), (d_s - 1).clamp(min=0))
            vals = g.indices[s]
            at = (g.indptr[s][lr] - g.base[s] + k).clamp(0, vals.shape[0] - 1)
            mine = owner == s
            deg = torch.where(mine, d_s.to(dev), deg)
            nxt = torch.where(mine, vals[at.long()].to(dev), nxt)
        alive = alive & cont[t] & (deg > 0)
        cur = torch.where(alive, nxt, sentinel)
        cols.append(cur)
    return torch.stack(cols, dim=1)


def sample_walks_sharded(
    gen: torch.Generator,
    g,
    queries,
    *,
    walks_per_query: int,
    max_len: int,
    sqrt_c: float,
) -> Tensor:
    """``walks_per_query`` sqrt(c)-walks from each query node over the CSR
    blocks; returns int32 [Q * B, max_len] (sentinel ``n_pad``).  The
    uniforms come from ``gen``, on the mesh's home device."""
    q = torch.as_tensor(queries).numel()
    cont, pick = csr_uniforms(gen, walks=q * walks_per_query, max_len=max_len,
                              sqrt_c=sqrt_c, device=g.mesh.home)
    return walks_from_uniforms_csr(g, queries, cont, pick)


def step_walks(g, queries, gen, uniforms, *, walk_chunk: int, max_len: int,
               sqrt_c: float) -> Tensor:
    """A serve step's walks: drawn from ``gen``, or made from the given
    ``uniforms = (cont, pick)`` (the seam the tests feed)."""
    if uniforms is not None:
        return walks_from_uniforms_csr(g, queries, *uniforms)
    return sample_walks_sharded(gen, g, queries, walks_per_query=walk_chunk,
                                max_len=max_len, sqrt_c=sqrt_c)


# ---------------------------------------------------------------------------
# Walks over the row-sharded ELL table
# ---------------------------------------------------------------------------


def walks_from_uniforms_sharded(st, u, cont: Tensor, pick: Tensor) -> Tensor:
    """Walks [R, max_len] (sentinel ``n``) from pre-drawn uniforms, each step
    taken on the shard that owns the walk's current node.

    ``st`` carries ``in_nbrs`` (one ``[rows, k_max]`` block per shard),
    ``in_deg`` (an ``[n_pad]`` replica per shard), ``n``, ``rows`` and
    ``mesh``.  The walks, uniforms and degrees stay on shard 0's device;
    each step sends the rows and slots to read to every shard and takes
    back the ids from the shard that owns each row.
    """
    mesh = st.mesh
    dev = mesh.home
    n, rows = st.n, st.rows
    r = cont.shape[0]
    cont = cont.to(dev)
    pick = pick.to(dev, torch.float32)
    deg_all = st.in_deg[0]
    cur = torch.as_tensor(u, dtype=torch.int32, device=dev).expand(r)
    cols = [cur]
    alive = torch.ones(r, dtype=torch.bool, device=dev)
    for t in range(cont.shape[1]):
        row = cur.clamp(0, n - 1).long()
        deg = deg_all[row]
        alive = alive & cont[:, t] & (deg > 0)
        k = torch.floor(pick[:, t] * deg.to(torch.float32)).to(torch.int32)
        k = torch.minimum(k.clamp(min=0), (deg - 1).clamp(min=0)).long()
        owner = row // rows
        nxt = torch.full_like(cur, n)
        for s, (rw, kk) in enumerate(zip(mesh.broadcast(row),
                                         mesh.broadcast(k))):
            got = st.in_nbrs[s][(rw - s * rows).clamp(0, rows - 1), kk]
            nxt = torch.where(owner == s, got.to(dev), nxt)
        cur = torch.where(alive, nxt, torch.full_like(nxt, n))
        cols.append(cur)
    return torch.stack(cols, dim=1).to(torch.int32)


# ---------------------------------------------------------------------------
# Lane-batched sharded probe
# ---------------------------------------------------------------------------


def row_ids(mesh, rows: int) -> list[Tensor]:
    """Each shard's global row ids as an [rows, 1] column (for compares)."""
    return [
        (s * rows + torch.arange(rows, dtype=torch.int32, device=d))[:, None]
        for s, d in enumerate(mesh.devices)
    ]


def lane_level(push, *, mesh, rows: int, eps_p: float):
    """The plain level function over all row blocks.

    ``level_fn(scores, total, vecs) -> (scores, total)`` runs, per shard,
    the deposit of finishing columns, unit injection at ``u_p``, pruning at
    ``thr``, then ``push`` (the caller's exchange and renormalized push of
    every block at once), then the ``u_prev`` exclusion: the sequence the
    local serve runs, with injection and exclusion as row-id compares.
    ``vecs[s]`` is shard s's ``(fin, u_p, u_prev, thr)``.
    """
    rids = row_ids(mesh, rows)

    def level_fn(scores, total, vecs):
        prepped, totals = [], []
        for s, (sc, tot, (fin, u_p, _, thr)) in enumerate(
                zip(scores, total, vecs)):
            zero = torch.zeros((), dtype=sc.dtype, device=sc.device)
            tot = tot + torch.where(fin[None, :], sc, zero)
            sc = torch.where(fin[None, :], zero, sc)
            sc = sc + (rids[s] == u_p[None, :]).to(sc.dtype)
            if eps_p > 0.0:
                sc = torch.where(sc > thr[None, :], sc, zero)
            prepped.append(sc)
            totals.append(tot)
        pushed = push(prepped)
        out = [
            torch.where(rids[s] == vecs[s][2][None, :],
                        torch.zeros((), dtype=p.dtype, device=p.device), p)
            for s, p in enumerate(pushed)
        ]
        return out, totals

    return level_fn


def lane_probe_block(
    level_fn,
    pool: Tensor,  # int32 [Q * n_r, L] on shard 0's device (sentinel >= n)
    pool_len: Tensor,  # int32 [Q * n_r]
    *,
    mesh,
    rows: int,
    q: int,
    wq: int,
    n_r: int,
    max_len: int,
    sqrt_c: float,
    eps_p: float,
    sentinel: int,
) -> list[Tensor]:
    """The compacted lane loop over every row block; returns the S
    ``total`` blocks [rows, W].

    The sharded counterpart of ``fused_serve``'s loop: the same lane
    bookkeeping (``core.multisource``), once, on shard 0's device, drives
    ``level_fn(scores, total, vecs)`` over lists of per-shard blocks.
    """
    dev = mesh.home
    w = q * wq
    _, qid = lane_columns(q, wq, dev)
    max_steps = lane_max_steps(n_r, max_len)
    pos = torch.zeros(w, dtype=torch.int32, device=dev)
    widx = torch.zeros(w, dtype=torch.int32, device=dev)
    next_q = torch.zeros(q, dtype=torch.int32, device=dev)
    scores = [torch.zeros((rows, w), device=d) for d in mesh.devices]
    total = [torch.zeros((rows, w), device=d) for d in mesh.devices]
    step = 0
    while True:
        fin, pos, widx, next_q = lane_refill(
            pos, widx, next_q, pool_len, qid, q=q, wq=wq, n_r=n_r
        )
        active, u_p, u_prev = lane_frontier(pool, widx, pos, sentinel)
        thr = lane_thresholds(pos, sqrt_c=sqrt_c, eps_p=eps_p)
        vecs = list(zip(*(mesh.broadcast(x) for x in (fin, u_p, u_prev, thr))))
        scores, total = level_fn(scores, total, vecs)
        pos = torch.where(active, pos - 1, pos)
        step += 1
        if not lane_continue(step, pos, next_q, n_r=n_r, max_steps=max_steps):
            break
    # safety-net flush (no-op unless max_steps was hit)
    return [
        t + torch.where(f[None, :], s, torch.zeros_like(s))
        for t, s, f in zip(total, scores, mesh.broadcast(pos == 1))
    ]


def coo_push(fulls, g, w, *, live=None, edge_chunks: int = 1):
    """One renormalized push of every row block of ``g``: shard s's rows
    ``w[s][v] * sum over the in-edges (u, v) of fulls[s][u]``, where
    ``fulls[s]`` is the gathered ``[n_pad, C]`` frontier on shard s's
    device; returns the per-shard list of ``[rows, C]`` fp32 blocks.

    The name is the push's first form.  On a ``ShardedGraph`` (the route
    follows the graph's type) it is no COO push: each shard runs the
    ``spmm_csr`` kernel over its block's in-CSR (``indptr``, ``indices``,
    ``base``, ``in_deg``), one writer a row in destination order, so there
    are no atomics and no gathered temporary, and ``edge_chunks`` and
    ``live`` are not read.  A graph of destination-partitioned COO buckets
    alone (``core.epoch.ShardEpochGraph``) takes ``bucket_push`` over its
    buckets' first ``live[s]`` edges (by default ``g.counts``) in
    ``edge_chunks`` slices."""
    if isinstance(g, ShardedGraph):
        from repro_torch.kernels.spmm_ell.ops import spmm_csr

        rows = g.rows
        return [spmm_csr(g.indices[s], full, ws, indptr=g.indptr[s],
                         row_len=row_block(g.in_deg[s], s, rows),
                         base=g.base[s], live=int(g.counts[s]))
                for s, (full, ws) in enumerate(zip(fulls, w))]
    if live is None:
        live = [int(c) for c in g.counts]
    return bucket_push(fulls, g.src_sh, g.dst_sh, live, w, rows=g.rows,
                       n_pad=g.n_pad, edge_chunks=edge_chunks)


def bucket_push(fulls, src_sh, dst_sh, live, w, *, rows: int, n_pad: int,
                edge_chunks: int = 1):
    """One renormalized COO push of every row block: shard s gathers the
    sources of its bucket's first ``live[s]`` edges from ``fulls[s]`` (the
    gathered frontier) and adds them into its own rows with ``index_add_``
    (a float atomic per edge and column on the card), scaled by ``w[s]``.
    The live prefix goes in ``edge_chunks`` slices or more: each gathered
    ``[slice, W]`` fp32 block stays under ``GATHER_BUDGET_BYTES``."""
    out = []
    for s, (full, sb, db, c, ws) in enumerate(
            zip(fulls, src_sh, dst_sh, live, w)):
        width = full.shape[1]
        acc = torch.zeros((rows + 1, width), dtype=torch.float32,
                          device=full.device)
        ch = max(1, min(-(-c // edge_chunks),
                        GATHER_BUDGET_BYTES // max(1, width * 4)))
        for a in range(0, c, ch):
            src = sb[a : a + ch].clamp(0, n_pad - 1).long()
            dst = (db[a : a + ch] - s * rows).clamp(0, rows).long()
            acc.index_add_(0, dst, full[src].float())
        out.append(acc[:rows] * ws[:, None])
    return out


def source_sorted(src_sh, dst_sh):
    """Each shard's bucket sorted by source id (stable): frontier rows are
    gathered in ascending address order, and sentinel slots (``n_pad``)
    sort to the tail, so the live prefix stays a prefix.  A derived view:
    the carried buffers keep their stream order."""
    out_s, out_d = [], []
    for sb, db in zip(src_sh, dst_sh):
        perm = torch.argsort(sb, stable=True)
        out_s.append(sb[perm])
        out_d.append(db[perm])
    return out_s, out_d


def probe_lanes_sharded(
    st,
    w: list[Tensor],  # f32 [rows] per shard: push weights of its rows
    pool: Tensor,  # int32 [Q * n_r, L] on shard 0's device (sentinel n)
    pool_len: Tensor,  # int32 [Q * n_r]
    *,
    q: int,
    wq: int,
    n_r: int,
    max_len: int,
    sqrt_c: float,
    eps_p: float,
    sentinel: int,
    use_kernel: bool = True,
    frontier_dtype: str = "float32",
) -> Tensor:
    """Lane-batched telescoped probe with the all-gather push; returns
    ``total`` [n_pad, W] on shard 0's device.

    ``st`` is the sharded graph (``core.epoch.ShardEpochGraph``).  With
    ``use_kernel`` every level launches the ``lane_probe`` kernel once per
    shard: the shard's ELL block gathers from the gathered frontier
    (``row0 = tab0`` = the block's first row), deposit, injection, pruning
    and exclusion fused.  Without it the level is ``lane_level`` with a COO
    push over each shard's source-sorted bucket (its live prefix, read once
    per call).  ``frontier_dtype="bfloat16"`` sends the frontier over the
    exchange in bf16 (widened back on arrival; deposits and the carried
    blocks stay fp32); with one shard there is no exchange and no
    rounding.
    """
    mesh = st.mesh
    rows, n_pad = st.rows, st.n_pad

    def exchange(blocks):
        if rows == n_pad:
            # one shard owns every row: its block IS the frontier
            return blocks
        return mesh.all_gather_rows(blocks, wire=frontier_dtype)

    if use_kernel:
        from repro_torch.kernels.lane_probe.ops import lane_probe_level

        row_len = [deg[s * rows : (s + 1) * rows]
                   for s, deg in enumerate(st.in_deg)]
        spare = [torch.zeros((rows, q * wq), device=d) for d in mesh.devices]

        def level_fn(scores, total, vecs):
            # the deposit reads the exact local block; only the gathered
            # frontier rides the (possibly bf16) exchange
            fulls = exchange(scores)
            out = []
            for s, (fin, u_p, u_prev, thr) in enumerate(vecs):
                o = spare[s]
                lane_probe_level(
                    st.in_nbrs[s], w[s], fulls[s], scores[s], total[s],
                    fin, u_p, u_prev, thr, row_len=row_len[s],
                    row0=s * rows, tab0=s * rows, n_live=sentinel,
                    prune=eps_p > 0.0, out=o, tot=total[s],
                )
                spare[s] = scores[s]
                out.append(o)
            return out, total
    else:
        src_sh, dst_sh = source_sorted(st.src_sh, st.dst_sh)
        live = [int(c) for c in st.counts]

        def push(blocks):
            return bucket_push(exchange(blocks), src_sh, dst_sh, live, w,
                               rows=rows, n_pad=n_pad)

        level_fn = lane_level(push, mesh=mesh, rows=rows, eps_p=eps_p)

    totals = lane_probe_block(
        level_fn, pool, pool_len, mesh=mesh, rows=rows, q=q, wq=wq,
        n_r=n_r, max_len=max_len, sqrt_c=sqrt_c, eps_p=eps_p,
        sentinel=sentinel,
    )
    return mesh.gather_rows(totals)


# ---------------------------------------------------------------------------
# Per-level telescoped probe over a walk matrix
# ---------------------------------------------------------------------------


def push_weights(st, sqrt_c: float) -> list[Tensor]:
    """``sqrt(c) / in_deg`` of each shard's rows (0 where the degree is 0),
    from the shard's own ``in_deg`` replica or row block."""
    out = []
    for s, deg in enumerate(st.in_deg):
        d = row_block(deg, s, st.rows).to(torch.float32)
        out.append(torch.where(d > 0, sqrt_c / d.clamp(min=1.0),
                               torch.zeros_like(d)))
    return out


def walk_rows(col: Tensor, s: int, rows: int) -> tuple[Tensor, Tensor]:
    """Block s's local rows of the walk nodes ``col`` [C] (clamped into the
    block) and which of them lie in the block (sentinels lie in none)."""
    r = col.long() - s * rows
    return r.clamp(0, rows - 1), (r >= 0) & (r < rows)


def inject(sc: Tensor, col: Tensor, s: int, rows: int, cols: Tensor) -> None:
    """``sc[v, j] += 1`` in place where column j's walk node v lies in block
    s: the row-id compare ``sc + (rid == col)`` written as one add per
    column, so no ``[rows, C]`` temporary is made."""
    r, here = walk_rows(col, s, rows)
    sc.index_put_((r, cols), here.to(sc.dtype), accumulate=True)


def exclude(sc: Tensor, col: Tensor, s: int, rows: int, cols: Tensor) -> None:
    """``sc[v, j] = 0`` in place where column j's walk node v lies in block
    s (the compare ``where(rid == col, 0, sc)``, one write per column)."""
    r, here = walk_rows(col, s, rows)
    sc.index_put_((r, cols), torch.where(here, 0.0, sc[r, cols]).to(sc.dtype))


def probe_walks_sharded(
    st,
    walks: Tensor,  # int32 [C, L] (sentinel >= n never reaches a live row)
    *,
    sqrt_c: float,
    eps_p: float = 0.0,
    edge_chunks: int = 8,
    live=None,
) -> Tensor:
    """Telescoped probe of every walk column at once over the row blocks;
    returns scores [n_pad, C] on shard 0's device.

    Injection and exclusion touch one entry per column (``inject`` /
    ``exclude``: the reference's row-id compares, entry for entry); each
    level all-gathers the frontier and calls ``coo_push`` once.  On a
    ``ShardedGraph`` that is the ``spmm_csr`` kernel over each block's
    in-CSR (``edge_chunks`` and ``live`` unused); on a graph with only COO
    buckets (``ShardEpochGraph``) the ``index_add_`` push in
    ``edge_chunks`` slices, ``live`` (host ints, one per shard) bounding
    each bucket (by default ``st.counts``).
    """
    mesh = st.mesh
    rows = st.rows
    c, length = walks.shape
    cols = mesh.broadcast(walks)
    ar = [torch.arange(c, device=d) for d in mesh.devices]
    w = push_weights(st, sqrt_c)
    scores = [torch.zeros((rows, c), device=d) for d in mesh.devices]
    for p in range(length, 1, -1):
        for s, sc in enumerate(scores):
            inject(sc, cols[s][:, p - 1], s, rows, ar[s])
            if eps_p > 0.0:
                sc.masked_fill_(sc <= eps_p / (sqrt_c ** (p - 1)), 0.0)
        fulls = mesh.all_gather_rows(scores) if st.shards > 1 else scores
        with span("serve_step.push"):
            scores = coo_push(fulls, st, w, live=live, edge_chunks=edge_chunks)
        for s, sc in enumerate(scores):
            exclude(sc, cols[s][:, p - 2], s, rows, ar[s])
    return mesh.gather_rows(scores)


# ---------------------------------------------------------------------------
# The production serve step
# ---------------------------------------------------------------------------


def serve_topk(scores: Tensor, query_nodes, *, queries: int, walk_chunk: int,
               top_k: int) -> tuple[Tensor, Tensor]:
    """The steps' epilogue: each query's estimate, the mean of its
    ``walk_chunk`` columns of ``scores`` [n_pad, Q * B] (taken in fp32),
    with its own node set to ``-inf`` by a row compare; returns
    ``(idx int32 [Q, k], vals fp32 [Q, k])``."""
    n_pad = scores.shape[0]
    est = scores.reshape(n_pad, queries, walk_chunk).float().sum(-1) / walk_chunk
    q = torch.as_tensor(query_nodes).reshape(-1).to(est.device, torch.int64)
    rows = torch.arange(n_pad, device=est.device)[:, None]
    est = est.masked_fill(rows == q[None, :], float("-inf"))
    vals, idx = torch.topk(est.T, top_k)
    return idx.to(torch.int32), vals


def make_serve_step(cfg, *, queries: int, walk_chunk: int, max_len: int,
                    top_k: int = 50, edge_chunks: int = 8):
    """The ProbeSim serving step of the production layout (port of
    ``repro.core.distributed.make_serve_step``).

    ``step(sg, query_nodes [Q], gen, *, uniforms=None) -> (topk_idx [Q, k]
    int32, topk_val [Q, k] fp32)`` on the mesh's home device.  One step
    samples ``walk_chunk`` walks per query from ``gen`` (or takes the draws
    ``uniforms = (cont, pick)``, each ``[max_len - 1, Q * walk_chunk]``),
    probes them over ``sg`` (one ``spmm_csr`` launch a level and block:
    ``coo_push``), and ranks the mean over the chunk; a serving engine
    loops steps and folds their means.  ``edge_chunks`` bounds only the
    COO route's gathered slices (``bucket_push``, which a ``ShardedGraph``
    does not take); the CSR route gathers into no temporary.
    """
    sqrt_c = math.sqrt(cfg.c)

    def serve_step(sg: ShardedGraph, query_nodes, gen=None, *, uniforms=None):
        walks = step_walks(sg, query_nodes, gen, uniforms,
                           walk_chunk=walk_chunk, max_len=max_len,
                           sqrt_c=sqrt_c)
        scores = probe_walks_sharded(sg, walks, sqrt_c=sqrt_c,
                                     edge_chunks=edge_chunks)
        return serve_topk(scores, query_nodes, queries=queries,
                          walk_chunk=walk_chunk, top_k=top_k)

    return serve_step
