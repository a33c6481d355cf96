"""The fused update->query *epoch*, local half (port of ``repro.core.epoch``).

ProbeSim's index-free claim means a query is exact against whatever the
graph is NOW, so the serving unit on a dynamic graph is an *epoch*: apply
one update batch to the device-resident mirrors, then serve one query
batch against the just-written buffers, in two stages:

* **apply stage**: ``graph/dynamic.py``'s coordinated path, writing both
  mirrors in place (the port's form of the JAX package's buffer donation);
* **probe stage**: ``core/multisource.py::fused_serve`` on the post-update
  buffers, with the lane-probe kernel on the kernel path.

The JAX package runs both stages in one jitted program with no host
transfer between them.  Here the apply is enqueued on the device and its
host-side results (applied mask, edge count, overflow bit) are read in one
copy after the probe has been enqueued (``settle``); the probe itself still
reads its per-level continue predicate on the host, as every serve does.

The sharded instantiation runs over a :class:`ShardEpochGraph` on a
:class:`~repro_torch.launch.mesh.ShardMesh`: destination-sharded COO
buckets and a row-sharded ELL table, updated shard by shard in place
(``apply_shard_batch``) and probed by the sharded lane probe
(``core/distributed.py``) in ``make_sharded_epoch_step``;
``make_sharded_serve_step`` serves a query batch off the same state.  The
steps are plain functions on tensors (the JAX package compiles each one).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.multisource import (
    fused_serve,
    query_uniforms,
    serve_epilogue,
)
from repro_torch.graph.dynamic import (
    UpdateBatch,
    apply_update_batch_async,
    settle,
)
from repro_torch.graph.partition import pad_to_multiple
from repro_torch.graph.structs import EllGraph, Graph, inv_degree

Tensor = torch.Tensor


def epoch_step(
    g: Graph,
    eg: EllGraph,
    batch: UpdateBatch,
    us,
    *,
    seeds=None,
    uniforms=None,
    n_r: int,
    lanes_q: int,
    max_len: int,
    sqrt_c: float,
    eps_p: float,
    eps_t: float,
    truncation_shift: bool,
    use_kernel: bool = True,
    top_k: int = 0,
):
    """One fused LOCAL epoch: apply the update batch, serve the query batch.

    ``g`` and ``eg`` are written in place.  The probe pushes over ``eg``
    on the kernel path and over the COO mirror ``g`` without it, as the
    JAX package's epoch does.  ``seeds`` (one per query) or
    ``uniforms=(cont, pick)`` fix the walk draws, as in ``fused_serve``.
    Returns ``(g, eg, applied, est, idx, vals)``; ``applied`` is the
    per-op mask on the CPU, ``idx``/``vals`` are None when ``top_k == 0``.
    ``g.version`` / ``g.overflow`` carry the snapshot id and the capacity
    signal.
    """

    pending = apply_update_batch_async(g, eg, batch)
    est, idx, vals = fused_serve(
        g, eg, us,
        seeds=seeds, uniforms=uniforms,
        n_r=n_r, lanes_q=lanes_q, max_len=max_len, sqrt_c=sqrt_c,
        eps_p=eps_p, eps_t=eps_t, truncation_shift=truncation_shift,
        use_kernel=use_kernel, top_k=top_k,
    )
    applied = settle(g, eg, pending)
    return g, eg, applied, est, idx, vals


# ---------------------------------------------------------------------------
# Sharded epoch graph: dst-partitioned COO buckets + row-sharded ELL blocks
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardEpochGraph:
    """Device-resident graph state of the sharded backend.

    The coordinated mirror pair of the local ``(Graph, EllGraph)``, cut
    into S row blocks of ``rows = n_pad / S`` over ``mesh``; every list
    holds one tensor per shard, on that shard's device:

    * ``src_sh`` / ``dst_sh`` int32 ``[E]`` — the shard's COO bucket: every
      edge whose ``dst // rows`` is the shard, GLOBAL ids, in the shard's
      stream (FIFO) order, padded with ``n_pad``;
    * ``counts`` int32 ``[]`` — the bucket's live edge count;
    * ``in_nbrs`` int32 ``[rows, k_max]`` — the shard's rows of the ELL
      in-neighbor table, live slots first, padded with ``n`` (the local
      ELL convention, so the walk sampler reads the same rows);
    * ``in_deg`` int32 ``[n_pad]`` — a full replica on every shard (the
      walk sampler and the push weights read it).

    Updates keep every field equal to :func:`build_shard_epoch_graph` over
    the equivalently updated shard-major host edge list.  The in-place
    writes add onto the padding, so it must be exactly ``n_pad`` in the
    COO buckets and ``n`` in the ELL rows (``check_shard_prefix``).
    """

    src_sh: list
    dst_sh: list
    counts: list
    in_nbrs: list
    in_deg: list
    n: int
    n_pad: int
    rows: int
    shards: int
    capacity: int  # E, per shard
    k_max: int
    mesh: object

    def host_arrays(self) -> dict:
        """Every field as numpy, in the JAX package's layout (``src_sh`` /
        ``dst_sh`` [S, E], ``counts`` [S], ``in_nbrs`` [n_pad, k_max],
        ``in_deg`` [n_pad]).  Raises ``RuntimeError`` if the ``in_deg``
        replicas differ."""
        deg = [d.cpu().numpy().copy() for d in self.in_deg]
        if any(not np.array_equal(deg[0], d) for d in deg[1:]):
            raise RuntimeError("the shards' in_deg replicas differ")
        return dict(
            src_sh=np.stack([x.cpu().numpy() for x in self.src_sh]),
            dst_sh=np.stack([x.cpu().numpy() for x in self.dst_sh]),
            counts=np.array([int(c) for c in self.counts], np.int32),
            in_nbrs=np.concatenate([x.cpu().numpy() for x in self.in_nbrs]),
            in_deg=deg[0],
        )


def check_shard_prefix(st: ShardEpochGraph) -> None:
    """Raise ``ValueError`` unless every shard's first ``counts[s]`` COO
    slots hold edges into its own rows with ids in ``[0, n)`` and the rest
    hold ``n_pad``, its ELL rows obey the live-prefix rule against its
    ``in_deg`` replica, and the replicas agree: the padding the in-place
    updates add onto."""
    from repro_torch.graph.structs import check_live_prefix

    for s in range(st.shards):
        sb, db, c = st.src_sh[s], st.dst_sh[s], int(st.counts[s])
        if sb.shape != (st.capacity,) or db.shape != (st.capacity,):
            raise ValueError(f"shard {s}: COO buckets must be [{st.capacity}]")
        live = torch.arange(st.capacity, device=sb.device) < c
        mine = (db // st.rows) == s
        ok = torch.where(
            live, (sb >= 0) & (sb < st.n) & (db >= 0) & (db < st.n) & mine,
            (sb == st.n_pad) & (db == st.n_pad),
        )
        if not bool(ok.all()):
            raise ValueError(
                f"shard {s}: COO bucket breaks the live-prefix rule (live "
                "edges into this shard's rows first, then n_pad)"
            )
        deg = st.in_deg[s]
        if not torch.equal(deg.to(st.mesh.home), st.in_deg[0]):
            raise ValueError(f"shard {s}: in_deg replica differs from shard 0")
        check_live_prefix(st.in_nbrs[s], deg[s * st.rows : (s + 1) * st.rows],
                          st.n)


def shard_epoch_graph_from_parts(
    src_sh, dst_sh, counts, in_nbrs, in_deg, n: int, *, k_max: int, mesh,
) -> ShardEpochGraph:
    """Place host arrays in the JAX package's layout (``src_sh`` /
    ``dst_sh`` [S, E], ``counts`` [S], ``in_nbrs`` [n_pad, k_max],
    ``in_deg`` [n_pad]) on ``mesh`` and check their padding."""
    s_count = mesh.shards
    n_pad = pad_to_multiple(n, s_count)
    rows = n_pad // s_count
    src_sh = np.asarray(src_sh, np.int32)
    dst_sh = np.asarray(dst_sh, np.int32)
    in_nbrs = np.asarray(in_nbrs, np.int32)
    if src_sh.ndim != 2 or src_sh.shape[0] != s_count:
        raise ValueError(
            f"COO buckets must be [S={s_count}, E], got {src_sh.shape}"
        )
    if in_nbrs.shape != (n_pad, k_max):
        raise ValueError(
            f"in_nbrs must be [n_pad={n_pad}, k_max={k_max}], got "
            f"{in_nbrs.shape}"
        )
    deg = torch.from_numpy(np.array(in_deg, np.int32).reshape(n_pad))
    st = ShardEpochGraph(
        src_sh=[torch.from_numpy(src_sh[s].copy()).to(d)
                for s, d in enumerate(mesh.devices)],
        dst_sh=[torch.from_numpy(dst_sh[s].copy()).to(d)
                for s, d in enumerate(mesh.devices)],
        counts=[torch.tensor(int(c), dtype=torch.int32, device=d)
                for c, d in zip(np.asarray(counts).reshape(-1), mesh.devices)],
        in_nbrs=[
            torch.from_numpy(in_nbrs[s * rows : (s + 1) * rows].copy()).to(d)
            for s, d in enumerate(mesh.devices)
        ],
        in_deg=mesh.replicate(deg),
        n=int(n), n_pad=int(n_pad), rows=int(rows), shards=s_count,
        capacity=int(src_sh.shape[1]), k_max=int(k_max), mesh=mesh,
    )
    check_shard_prefix(st)
    return st


def build_shard_epoch_graph(
    src: np.ndarray,
    dst: np.ndarray,
    n: int,
    *,
    capacity_per_shard: int,
    k_max: int,
    mesh,
) -> ShardEpochGraph:
    """Build the sharded state from a shard-major host edge list.

    ``(src, dst)`` must be in shard-major per-shard-FIFO order (what
    ``ShardedGraphState.to_host_edges`` gives: re-partitioning that order
    is the identity, so incremental updates and this function agree bit for
    bit).  ``k_max`` caps ELL rows; the max in-degree must fit.  Each ELL
    block is filled on its shard's device from the block's edge list (the
    host never holds a ``[rows, k_max]`` table).
    """
    shards = mesh.shards
    src = np.asarray(src, np.int32).reshape(-1)
    dst = np.asarray(dst, np.int32).reshape(-1)
    n_pad = pad_to_multiple(n, shards)
    rows = n_pad // shards
    e = int(capacity_per_shard)
    shard_of = dst // rows
    counts = np.bincount(shard_of, minlength=shards).astype(np.int32)
    if counts.max(initial=0) > e:
        raise ValueError(
            f"shard holds {int(counts.max())} edges > capacity {e}"
        )
    in_deg = np.bincount(dst, minlength=n_pad).astype(np.int32)[:n_pad]
    deg_cap = int(in_deg.max()) if in_deg.size else 0
    if deg_cap > k_max:
        raise ValueError(f"max in-degree {deg_cap} exceeds k_max {k_max}")
    order = np.argsort(shard_of, kind="stable")  # FIFO within shard
    src_o, dst_o = src[order], dst[order]
    starts = np.zeros(shards + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    # ELL rows in per-dst stream order: identical to the local
    # ``ell_from_edges`` rows, since the shard-major order never swaps two
    # edges of one destination
    d_order = np.argsort(dst, kind="stable")
    d_sorted, s_sorted = dst[d_order], src[d_order]
    group_start = np.searchsorted(d_sorted, np.arange(n_pad))
    idx_within = np.arange(len(d_sorted)) - group_start[d_sorted]
    row_start = np.searchsorted(d_sorted, np.arange(shards + 1) * rows)
    src_sh, dst_sh, blocks = [], [], []
    for s, d in enumerate(mesh.devices):
        lo, hi = starts[s], starts[s + 1]
        cs = np.full(e, n_pad, np.int32)
        cd = np.full(e, n_pad, np.int32)
        cs[: hi - lo] = src_o[lo:hi]
        cd[: hi - lo] = dst_o[lo:hi]
        src_sh.append(torch.from_numpy(cs).to(d))
        dst_sh.append(torch.from_numpy(cd).to(d))
        a, b = row_start[s], row_start[s + 1]
        table = torch.full((rows, k_max), n, dtype=torch.int32, device=d)
        at = [torch.from_numpy(x).to(d) for x in (
            (d_sorted[a:b] - s * rows).astype(np.int64),
            idx_within[a:b].astype(np.int64), s_sorted[a:b])]
        table[at[0], at[1]] = at[2]
        blocks.append(table)
    return ShardEpochGraph(
        src_sh=src_sh, dst_sh=dst_sh,
        counts=[torch.tensor(int(c), dtype=torch.int32, device=d)
                for c, d in zip(counts, mesh.devices)],
        in_nbrs=blocks,
        in_deg=mesh.replicate(torch.from_numpy(in_deg)),
        n=int(n), n_pad=int(n_pad), rows=int(rows), shards=shards,
        capacity=e, k_max=int(k_max), mesh=mesh,
    )


# ---------------------------------------------------------------------------
# Sharded apply stage
# ---------------------------------------------------------------------------


def apply_shard_batch(st: ShardEpochGraph, batch: UpdateBatch
                      ) -> tuple[Tensor, Tensor]:
    """Apply a mixed batch to the shard buffers in place, shard by shard.

    Each shard applies the ops whose destination lies in its rows, against
    its own buffers, with ``apply_update_batch``'s semantics: deletes match
    the pre-batch buffers (at most one live copy of a pair per batch) and
    are removed by stable compaction; inserts append in stream order iff
    both the shard's COO bucket and the destination's ELL row have room.
    Every ``in_deg`` replica then takes the applied deltas.  Returns
    ``(applied [B] bool, overflow bool [])`` on shard 0's device; the
    sticky overflow fold and the version are the state owner's.

    Every write adds onto a slot whose value it knows (the padding
    ``n_pad`` / ``n`` past the live prefix, or the row it read), and a
    skipped op adds 0; ids at or above ``n`` are never written.
    """
    mesh = st.mesh
    home = mesh.home
    b = batch.size
    if not batch.has_ops:
        return (torch.zeros(b, dtype=torch.bool, device=home),
                torch.zeros((), dtype=torch.bool, device=home))
    n, n_pad, rows = st.n, st.n_pad, st.rows
    e, k_max = st.capacity, st.k_max
    applied_all = torch.zeros(b, dtype=torch.bool, device=home)
    overflow = torch.zeros((), dtype=torch.bool, device=home)
    zero = torch.zeros((), dtype=torch.int32)
    for s, dev in enumerate(mesh.devices):
        bsrc = batch.src.to(dev)
        bdst = batch.dst.to(dev)
        bins = batch.insert.to(dev)
        sb, db, ell, ideg = st.src_sh[s], st.dst_sh[s], st.in_nbrs[s], st.in_deg[s]
        z = zero.to(dev)
        valid = (bsrc >= 0) & (bsrc < n) & (bdst >= 0) & (bdst < n)
        mine = valid & (bdst // rows == s)
        d_c = torch.where(mine, bdst, z).long()
        d_loc = torch.where(mine, bdst - s * rows, z).long()
        tri = torch.ones((b, b), dtype=torch.bool, device=dev).tril(-1)
        cnt = st.counts[s]
        if batch.has_deletes:
            is_del = mine & ~bins
            same_pair = ((bsrc[None, :] == bsrc[:, None])
                         & (bdst[None, :] == bdst[:, None]) & is_del[None, :])
            del_live = is_del & ~(same_pair & tri).any(dim=1)
            hits = ((sb[None, :] == bsrc[:, None])
                    & (db[None, :] == bdst[:, None]) & del_live[:, None])
            found = hits.any(dim=1)
            pos = hits.to(torch.uint8).argmax(dim=1)
            del_mask = torch.zeros(e + 1, dtype=torch.bool, device=dev)
            del_mask[torch.where(found, pos, e)] = True
            keep = (sb < n_pad) & ~del_mask[:e]
            kint = keep.to(torch.int32)
            kpos = torch.where(keep, torch.cumsum(kint, 0) - kint, e).long()
            for buf in (sb, db):
                comp = torch.full((e + 1,), n_pad, dtype=torch.int32,
                                  device=dev)
                buf.copy_(comp.scatter_(0, kpos, buf)[:e])
            cnt2 = kint.sum(dtype=torch.int32)
            # the ELL rows: the deleted slots of each op's row, then a
            # stable compaction written once per row (its first op)
            rows_g = ell[d_loc]  # [B, k_max] pre-batch rows
            s_c = torch.where(mine, bsrc, torch.full_like(bsrc, n))
            rhit = (rows_g == s_c[:, None]) & found[:, None]
            rfound = rhit.any(dim=1)
            kslot = rhit.to(torch.uint8).argmax(dim=1)
            same_row = (bdst[None, :] == bdst[:, None]) & rfound[None, :]
            urow = rfound & ~(same_row & tri).any(dim=1)
            dmask = torch.zeros((b, k_max + 1), dtype=torch.bool, device=dev)
            dmask.scatter_(1, torch.where(same_row, kslot[None, :], k_max),
                           same_row)
            live_r = (rows_g < n) & ~dmask[:, :k_max]
            lint = live_r.to(torch.int32)
            new_slot = torch.where(live_r, torch.cumsum(lint, 1) - lint, k_max)
            comp = torch.full((b, k_max + 1), n, dtype=torch.int32, device=dev)
            comp = comp.scatter_(1, new_slot.long(), rows_g)[:, :k_max]
            ell.index_add_(0, d_loc,
                           torch.where(urow[:, None], comp - rows_g, z))
            # post-delete in-degrees (each shard reads its own rows only)
            ideg_w = ideg.clone().index_add_(0, torch.where(found, d_c, 0),
                                             -found.to(torch.int32))
        else:
            found = torch.zeros_like(valid)
            cnt2 = cnt
            ideg_w = ideg
        # inserts: append in stream order, coordinated COO + ELL room check
        is_ins = mine & bins
        same_d = (bdst[None, :] == bdst[:, None]) & is_ins[None, :]
        occ = (same_d & tri).sum(dim=1, dtype=torch.int32)
        slot = ideg_w[d_c] + occ
        ok_ell = is_ins & (slot < k_max)
        oint = ok_ell.to(torch.int32)
        cpos = cnt2 + torch.cumsum(oint, 0, dtype=torch.int32) - oint
        ok = ok_ell & (cpos < e)
        at = torch.where(ok, cpos, z).long()
        sb.index_add_(0, at, torch.where(ok, bsrc - n_pad, z))
        db.index_add_(0, at, torch.where(ok, bdst - n_pad, z))
        flat = torch.where(ok, d_loc * k_max + slot, 0).long()
        ell.view(-1).index_add_(0, flat, torch.where(ok, bsrc - n, z))
        cnt.copy_(cnt2 + ok.sum(dtype=torch.int32))
        overflow = overflow | (is_ins & ~ok).any().to(home)
        applied_all = applied_all | torch.where(bins, ok, found).to(home)
    # every replica takes the applied deltas (ops land on exactly one shard)
    ins = batch.insert.to(home)
    dst = batch.dst.to(home)
    dels = applied_all & ~ins
    adds = applied_all & ins
    for rep, a_del, a_add, d in zip(
            st.in_deg, mesh.broadcast(dels), mesh.broadcast(adds),
            mesh.broadcast(dst)):
        rep.index_add_(0, torch.where(a_del, d, 0).long(),
                       -a_del.to(torch.int32))
        rep.index_add_(0, torch.where(a_add, d, 0).long(),
                       a_add.to(torch.int32))
    return applied_all, overflow


# ---------------------------------------------------------------------------
# Sharded serve and epoch steps
# ---------------------------------------------------------------------------


def kernel_weights(st, sqrt_c: float) -> list[Tensor]:
    """The kernel path's push weights of each shard's rows, ``inv_in_deg *
    sqrt(c)`` (the local kernel path's form, so each weight rounds alike
    and a sharded kernel serve equals the local one bit for bit)."""
    return [
        inv_degree(deg[s * st.rows : (s + 1) * st.rows]) * sqrt_c
        for s, deg in enumerate(st.in_deg)
    ]


def sharded_pool(st: ShardEpochGraph, us: Tensor, *, seeds, uniforms,
                 n_r: int, max_len: int, sqrt_c: float) -> Tensor:
    """The batch's walk pool [Q * n_r, max_len] on shard 0's device: the
    uniforms drawn there (or injected), the walks stepped on the shards
    that own their nodes."""
    from repro_torch.core.distributed import walks_from_uniforms_sharded

    q = int(us.shape[0])
    cont, pick = query_uniforms(q, seeds=seeds, uniforms=uniforms, n_r=n_r,
                                max_len=max_len, sqrt_c=sqrt_c,
                                device=st.mesh.home)
    return walks_from_uniforms_sharded(
        st, us.repeat_interleave(n_r),
        cont.reshape(q * n_r, max_len - 1), pick.reshape(q * n_r, max_len - 1),
    )


def make_sharded_serve_step(
    st: ShardEpochGraph,
    *,
    q: int,
    n_r: int,
    lanes_q: int,
    top_k: int,
    max_len: int,
    sqrt_c: float,
    eps_p: float,
    eps_t: float,
    truncation_shift: bool,
    probe: str = "spmd",
    use_kernel: bool = True,
    frontier_dtype: str = "float32",
):
    """The sharded serve step for one (Q, n_r, k) configuration.

    ``step(state, us [Q], seeds=..., uniforms=..., ring=None) -> (est, idx,
    vals)``: the batch's walk pool off the state's ELL blocks, the
    compacted lane probe (``probe_lanes_sharded``, or ``probe_lanes_ring``
    over the :class:`~repro_torch.core.ring.RingGraph` ``ring``), and the
    local serve's epilogue.  The lane schedule is the local one
    (``core.multisource``), so with ``use_kernel`` on the spmd probe a
    sharded serve equals the local kernel serve under the same seeds bit
    for bit; with ``frontier_dtype="bfloat16"`` (spmd only) the estimates
    move by about 1e-3.
    """
    from repro_torch.core.distributed import probe_lanes_sharded, push_weights
    from repro_torch.core.ring import probe_lanes_ring

    if probe not in ("spmd", "ring"):
        raise ValueError(f"probe must be 'spmd' or 'ring', got {probe!r}")
    n, wq = st.n, int(lanes_q)

    def step(state, us, *, seeds=None, uniforms=None, ring=None):
        us = torch.as_tensor(us, dtype=torch.int32).reshape(-1).to(
            state.mesh.home)
        pool = sharded_pool(state, us, seeds=seeds, uniforms=uniforms,
                            n_r=n_r, max_len=max_len, sqrt_c=sqrt_c)
        pool_len = (pool < n).sum(dim=1).to(torch.int32)
        common = dict(q=q, wq=wq, n_r=n_r, max_len=max_len, sqrt_c=sqrt_c,
                      eps_p=eps_p, sentinel=n, use_kernel=use_kernel)
        if probe == "ring":
            if ring is None:
                raise ValueError("probe='ring' needs the RingGraph (ring=)")
            total = probe_lanes_ring(ring, push_weights(state, sqrt_c), pool,
                                     pool_len, **common)
        else:
            w = (kernel_weights(state, sqrt_c) if use_kernel
                 else push_weights(state, sqrt_c))
            total = probe_lanes_sharded(state, w, pool, pool_len,
                                        frontier_dtype=frontier_dtype,
                                        **common)
        return serve_epilogue(
            total[:n].reshape(n, q, wq).sum(dim=2).T, us, n_r=n_r,
            eps_t=eps_t, truncation_shift=truncation_shift, top_k=top_k,
        )

    return step


def make_sharded_epoch_step(
    st: ShardEpochGraph,
    *,
    q: int,
    n_r: int,
    top_k: int,
    max_len: int,
    sqrt_c: float,
    eps_p: float,
    eps_t: float,
    truncation_shift: bool,
    walk_chunk: int,
    edge_chunks: int,
    use_kernel: bool = True,
):
    """The sharded epoch step for one (Q, n_r, k) configuration.

    ``step(state, batch, us=None, seeds=None, uniforms=None) -> (state,
    applied [B] (CPU), overflow (bool), est, idx, vals)``: the batch is
    applied in place (``apply_shard_batch``), the query batch's walks are
    drawn off the updated ELL blocks and probed on the updated buffers,
    and the applied mask and overflow bit are read in one copy after the
    probe is enqueued.  ``q == 0`` applies the batch only.

    With ``use_kernel`` the probe is the lane probe with the kernel, each
    query owning ``min(walk_chunk, n_r)`` lane columns; without it the
    walks go through ``probe_walks_sharded`` in chunks of that many walks a
    query, padded with sentinel walks (exact-zero columns).  The two agree
    up to float summation order, as in the JAX package.
    """
    from repro_torch.core.distributed import probe_lanes_sharded, probe_walks_sharded

    s_count, e = st.shards, st.capacity
    if (s_count * e) % edge_chunks:
        raise ValueError(
            f"per-shard capacity {e} x {s_count} shards must divide "
            f"edge_chunks={edge_chunks} (pad capacity up)"
        )
    n, n_pad = st.n, st.n_pad
    cc = max(1, min(walk_chunk, n_r)) if q else 1
    n_chunks = -(-n_r // cc) if q else 0

    def step(state, batch, us=None, seeds=None, uniforms=None):
        applied, overflow = apply_shard_batch(state, batch)
        est = idx = vals = None
        if q:
            us = torch.as_tensor(us, dtype=torch.int32).reshape(-1).to(
                state.mesh.home)
            pool = sharded_pool(state, us, seeds=seeds, uniforms=uniforms,
                                n_r=n_r, max_len=max_len, sqrt_c=sqrt_c)
            if use_kernel:
                pool_len = (pool < n).sum(dim=1).to(torch.int32)
                total = probe_lanes_sharded(
                    state, kernel_weights(state, sqrt_c), pool, pool_len,
                    q=q, wq=cc, n_r=n_r, max_len=max_len, sqrt_c=sqrt_c,
                    eps_p=eps_p, sentinel=n, use_kernel=True,
                )
                acc = total[:n].reshape(n, q, cc).sum(dim=2).T
            else:
                pool = pool.reshape(q, n_r, max_len)
                if n_chunks * cc != n_r:
                    pad = torch.full((q, n_chunks * cc - n_r, max_len), n,
                                     dtype=torch.int32, device=pool.device)
                    pool = torch.cat([pool, pad], dim=1)
                live = [int(c) for c in state.counts]
                sums = torch.stack([
                    probe_walks_sharded(state, chunk, sqrt_c=sqrt_c,
                                        eps_p=eps_p, edge_chunks=edge_chunks,
                                        live=live).sum(dim=1)
                    for chunk in pool.reshape(q * n_chunks, cc, max_len)
                ])
                acc = sums.reshape(q, n_chunks, n_pad).sum(dim=1)[:, :n]
            est, idx, vals = serve_epilogue(
                acc, us, n_r=n_r, eps_t=eps_t,
                truncation_shift=truncation_shift, top_k=top_k,
            )
        host = torch.cat([applied, overflow[None]]).cpu()
        return state, host[:-1], bool(host[-1]), est, idx, vals

    return step
