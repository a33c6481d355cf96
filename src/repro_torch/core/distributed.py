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
  ``index_add_`` push over the shard's source-sorted bucket.
* ``probe_walks_sharded`` — the per-level telescoped probe over a walk
  matrix (the mesh epoch's probe with the kernel off).

``sample_walks_sharded`` and ``make_serve_step`` (the CSR sampler and the
production-mesh serve step) are not ported (ROADMAP queue 1 item 12b).
"""
from __future__ import annotations

import torch

from repro_torch.core.multisource import (
    lane_columns,
    lane_continue,
    lane_frontier,
    lane_max_steps,
    lane_refill,
    lane_thresholds,
)
from repro_torch.graph.structs import GATHER_BUDGET_BYTES

Tensor = torch.Tensor


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP queue 1 item 12b)"
    )


def sample_walks_sharded(*args, **kwargs):
    _not_ported("core.distributed.sample_walks_sharded (the CSR sampler)")


def make_serve_step(*args, **kwargs):
    _not_ported("core.distributed.make_serve_step (the production-mesh step)")


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


def coo_push(fulls, src_sh, dst_sh, live, w, *, rows: int, n_pad: int,
             edge_chunks: int = 1):
    """One renormalized COO push of every row block: shard s gathers the
    sources of its bucket's first ``live[s]`` edges from ``fulls[s]`` (the
    gathered frontier) and adds them into its own rows, scaled by ``w[s]``.
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
            return coo_push(exchange(blocks), src_sh, dst_sh, live, w,
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
    from the shard's own ``in_deg`` replica."""
    out = []
    for s, deg in enumerate(st.in_deg):
        d = deg[s * st.rows : (s + 1) * st.rows].to(torch.float32)
        out.append(torch.where(d > 0, sqrt_c / d.clamp(min=1.0),
                               torch.zeros_like(d)))
    return out


def probe_walks_sharded(
    st,
    walks: Tensor,  # int32 [C, L] (sentinel >= n never reaches a live row)
    *,
    sqrt_c: float,
    eps_p: float = 0.0,
    edge_chunks: int = 8,
    live=None,
) -> Tensor:
    """Telescoped probe of every walk column at once over the sharded COO
    buckets; returns scores [n_pad, C] on shard 0's device.

    Injection and exclusion are row-id compares against each column's walk
    node; each level all-gathers the frontier and pushes every bucket in
    ``edge_chunks`` slices (``coo_push``).  ``live`` (host ints, one per
    shard) bounds each bucket's push; by default it is read from
    ``st.counts`` once.
    """
    mesh = st.mesh
    rows = st.rows
    c, length = walks.shape
    rids = row_ids(mesh, rows)
    cols = mesh.broadcast(walks)
    w = push_weights(st, sqrt_c)
    if live is None:
        live = [int(x) for x in st.counts]
    scores = [torch.zeros((rows, c), device=d) for d in mesh.devices]
    for p in range(length, 1, -1):
        for s in range(mesh.shards):
            sc = scores[s] + (rids[s] == cols[s][:, p - 1][None, :]).float()
            if eps_p > 0.0:
                thresh = eps_p / (sqrt_c ** (p - 1))
                sc = torch.where(sc > thresh, sc, torch.zeros_like(sc))
            scores[s] = sc
        fulls = mesh.all_gather_rows(scores) if st.shards > 1 else scores
        scores = coo_push(fulls, st.src_sh, st.dst_sh, live, w, rows=rows,
                          n_pad=st.n_pad, edge_chunks=edge_chunks)
        scores = [
            torch.where(rids[s] == cols[s][:, p - 2][None, :],
                        torch.zeros_like(sc), sc)
            for s, sc in enumerate(scores)
        ]
    return mesh.gather_rows(scores)
