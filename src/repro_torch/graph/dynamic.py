"""Dynamic graph maintenance (port of ``repro.graph.dynamic``).

ProbeSim precomputes nothing, so a dynamic graph only needs its two device
representations to absorb updates cheaply:

* COO (``Graph``): an insert appends into the capacity-padded edge buffer;
  a delete removes by stable compaction in the coordinated batch path
  (``apply_update_batch``) or by swap-remove in the per-struct paths
  (``delete_edges``).
* ELL (``EllGraph``): an insert writes slot ``in_deg[dst]`` of row ``dst``;
  a delete compacts (or swap-removes) within the row, so live slots stay
  first in every row: the kernels read slot k of row v only while
  ``k < in_deg[v]`` (``check_live_prefix``).

The contracts of the JAX package hold unchanged (DESIGN.md §5):

**Masked no-op padding.**  Batches are padded with the sentinel id ``n``
(``make_update_batch``); an op with ``src`` or ``dst`` outside ``[0, n)``
changes nothing, and an all-sentinel batch leaves the graph bit-identical.

**Explicit overflow, never a silent drop.**  An insert with no room (COO
buffer full, or the destination's ELL row at ``k_max``) is skipped in both
mirrors and sets the sticky ``overflow`` flag; ``regrow`` is the recovery
path, and ``apply_update_batch`` returns the per-op ``applied`` mask so the
skipped ops can be retried.

**Versioned snapshots.**  ``version`` advances by exactly one per batch
that changed the graph, on both mirrors of the coordinated path.

How the port differs in form, not in result:

* **In place.**  The JAX package returns new arrays and donates the old
  ones to its jitted epoch; here every update writes the tensors of the
  mirrors it is given, updates their host fields (``num_edges``,
  ``version``, ``overflow``) and returns the same objects.  A caller that
  must keep a snapshot copies it first (``GraphHandle.copy``).
* **Every skipped write is an add of zero.**  The JAX package sends a write
  it skips out of bounds and lets the scatter drop it.  Here each scatter
  is an add (``index_add_``, ``scatter_add_``): a live write adds
  ``new - old`` onto a slot whose old value it knows (a sentinel ``n`` past
  the live prefix, or the row it just read), and a skipped one adds 0 at a
  clamped index.  So no write
  needs a scratch row, two writes that meet on one element sum exactly
  (int32), and no op selects with boolean-mask indexing (``x[mask]``),
  which would read the mask's size on the host.  This relies on the
  padding invariants the structs document: exactly ``n`` at every COO
  position ``>= num_edges`` and at every ELL slot ``>= in_deg[v]``.  The
  constructors and ``GraphHandle.set_mirrors`` enforce them
  (``check_coo_prefix``, ``check_live_prefix``), and the array
  constructors turn a padding id above ``n`` into ``n``.
* **``in_deg`` is written only by versioned in-place ops** (``index_add_``),
  so its ``_version`` moves with every batch that has a live op, and the
  kernels' chunk plan (``kernels/ell_plan.py::plan_of``, keyed on the tensor
  and its ``_version``) is rebuilt before the next launch.  A batch with no
  live op (``has_ops=False``) writes nothing, so it keeps the plan.
* **One host read per batch.**  The snapshot fields live on the host; the
  coordinated path reads the applied mask, the new edge count and the
  overflow bit in one device-to-host copy (``settle``), which the fused
  epoch (``core/epoch.py``) makes only after the probe is enqueued.  The
  enqueue itself moves nothing between host and device: no host scalar
  becomes a tensor by copy, and the ELL writes go through a flat
  ``index_add_``, since ``index_put_`` with ``accumulate=True`` reads its
  indices' range on the host on CUDA.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.graph.structs import (
    EllGraph,
    Graph,
    ell_from_edges,
    graph_from_edges,
    graph_to_host_edges,
    resolve_device,
)

Tensor = torch.Tensor


@dataclasses.dataclass
class UpdateBatch:
    """Fixed-size padded edge-update batch.

    Sentinel entries (``src`` or ``dst`` outside ``[0, n)``, as
    ``make_update_batch`` pads) are no-ops; ``insert[i]`` selects insert
    (True) or delete (False) for op i.  ``has_deletes`` and ``has_ops`` are
    host facts: an insert-only batch skips the delete phase (no O(capacity)
    matching or compaction), and a batch without one live op writes nothing.
    """

    src: Tensor  # int32 [B]
    dst: Tensor  # int32 [B]
    insert: Tensor  # bool [B]
    has_deletes: bool = True
    has_ops: bool = True

    @property
    def size(self) -> int:
        return int(self.src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.src.device


def make_update_batch(
    src,
    dst,
    insert,
    *,
    batch_size: int,
    n: int,
    device="cuda",
) -> UpdateBatch:
    """Host helper: pad an edge-op list to ``batch_size`` with sentinel no-ops
    and place it on ``device``.

    ``insert`` is a scalar bool (whole batch) or a per-edge bool array.
    """
    dev = resolve_device(device)
    src = np.asarray(src, dtype=np.int32).reshape(-1)
    dst = np.asarray(dst, dtype=np.int32).reshape(-1)
    b = src.shape[0]
    if dst.shape[0] != b:
        raise ValueError(f"src/dst length mismatch: {b} vs {dst.shape[0]}")
    if b > batch_size:
        raise ValueError(f"{b} ops exceed batch_size {batch_size}")
    ins = np.broadcast_to(np.asarray(insert, dtype=bool), (b,))
    pad = batch_size - b

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return UpdateBatch(
        src=put(np.concatenate([src, np.full(pad, n, np.int32)])),
        dst=put(np.concatenate([dst, np.full(pad, n, np.int32)])),
        insert=put(np.concatenate([ins, np.zeros(pad, bool)])),
        has_deletes=bool((~ins).any()),
        has_ops=bool(((src >= 0) & (src < n) & (dst >= 0) & (dst < n)).any()),
    )


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------


def _valid_mask(src: Tensor, dst: Tensor, n: int) -> Tensor:
    """True for real ops; sentinel-padded (masked no-op) entries are False."""
    return (src >= 0) & (src < n) & (dst >= 0) & (dst < n)


def _lower(b: int, device) -> Tensor:
    """bool [B, B]: True where j < i (the batch's earlier ops)."""
    return torch.ones((b, b), dtype=torch.bool, device=device).tril(-1)


def _occurrence_index(x: Tensor, valid: Tensor) -> Tensor:
    """occ[i] = #{j < i : x[j] == x[i] and valid[j]} (O(B^2); batches small)."""
    eq = (x[None, :] == x[:, None]) & valid[None, :]
    return (eq & _lower(x.shape[0], x.device)).sum(dim=1)


def _first_true(mask: Tensor) -> Tensor:
    """Index of the first True along the last dim (0 where there is none)."""
    return mask.to(torch.uint8).argmax(dim=-1)


def _ops(src, dst, device) -> tuple[Tensor, Tensor]:
    """A per-struct path's ops as int32 tensors of their own: the update
    writes the mirror in place, and the caller's arrays may be views of it."""
    return tuple(torch.as_tensor(x, dtype=torch.int32, device=device)
                 .reshape(-1).clone() for x in (src, dst))


def _i32(x: Tensor) -> Tensor:
    return x.to(torch.int32)


def _add_slots(table: Tensor, rows: Tensor, slots: Tensor, vals: Tensor) -> None:
    """``table[rows[i], slots[i]] += vals[i]``, through the flat view."""
    table.view(-1).index_add_(0, rows.long() * table.shape[1] + slots, vals)


# ---------------------------------------------------------------------------
# Per-struct updates (fast paths; each bumps its own struct only)
# ---------------------------------------------------------------------------


def insert_edges(g: Graph, src, dst) -> Graph:
    """Append a batch of edges (src[i] -> dst[i]) to the COO buffer, in place.

    Sentinel entries are no-ops.  Inserts past ``capacity`` are skipped and
    set the sticky ``overflow`` flag (no silent drop).
    """
    src, dst = _ops(src, dst, g.device)
    n, cap = g.n, g.capacity
    valid = _valid_mask(src, dst, n)
    vint = _i32(valid)
    pos = g.num_edges + torch.cumsum(vint, 0) - vint  # exclusive prefix
    ok = valid & (pos < cap)
    at = pos.clamp(max=cap - 1)
    g.src.index_add_(0, at, torch.where(ok, src - n, 0).to(torch.int32))
    g.dst.index_add_(0, at, torch.where(ok, dst - n, 0).to(torch.int32))
    g.in_deg.index_add_(0, dst.clamp(0, n - 1), _i32(ok))
    g.out_deg.index_add_(0, src.clamp(0, n - 1), _i32(ok))
    added, any_ok, ovf = torch.stack(
        [ok.sum(), ok.any(), (valid & ~ok).any()]).tolist()
    g.num_edges += int(added)
    g.version += int(any_ok)
    g.overflow = g.overflow or bool(ovf)
    return g


def insert_edges_ell(eg: EllGraph, src, dst) -> EllGraph:
    """Mirror insertion into the ELL in-neighbor table, in place (same
    contracts)."""
    src, dst = _ops(src, dst, eg.device)
    n, k_max = eg.n, eg.k_max
    valid = _valid_mask(src, dst, n)
    occ = _occurrence_index(dst, valid)
    dst_c = dst.clamp(0, n - 1).long()
    slot = eg.in_deg[dst_c] + occ
    ok = valid & (slot < k_max)
    _add_slots(eg.in_nbrs, dst_c, slot.clamp(max=k_max - 1),
               torch.where(ok, src - n, 0).to(torch.int32))
    eg.in_deg.index_add_(0, dst_c, _i32(ok))
    any_ok, ovf = torch.stack([ok.any(), (valid & ~ok).any()]).tolist()
    eg.version += int(any_ok)
    eg.overflow = eg.overflow or bool(ovf)
    return eg


def delete_edges(g: Graph, src, dst) -> Graph:
    """Swap-remove a batch of edges, in place (one op after another; batches
    are small).

    Sentinel entries and edges not present are no-ops.  Removes the first
    match per op.  Each step moves the last live edge into the hole and
    stamps the sentinel at the old last position.
    """
    src, dst = _ops(src, dst, g.device)
    n = g.n
    valid = _valid_mask(src, dst, n)
    ne = torch.full((1,), g.num_edges, dtype=torch.int64, device=g.device)
    founds = []
    for i in range(src.shape[0]):
        s, d, v = src[i], dst[i], valid[i]
        match = (g.src == s) & (g.dst == d) & v
        found = match.any().reshape(1)
        pos = _first_true(match).reshape(1)
        last = (ne - 1).clamp(min=0)
        for buf in (g.src, g.dst):
            moved = buf[last]
            buf.index_put_((pos,), torch.where(found, moved, buf[pos]))
            buf.index_put_((last,), torch.where(found, n, buf[last]).to(buf.dtype))
        g.in_deg.index_add_(0, d.clamp(0, n - 1).reshape(1), -_i32(found))
        g.out_deg.index_add_(0, s.clamp(0, n - 1).reshape(1), -_i32(found))
        ne = ne - found.long()
        founds.append(found)
    if founds:
        ne_h, any_found = torch.cat(
            [ne, torch.cat(founds).any().reshape(1).long()]).tolist()
        g.num_edges = int(ne_h)
        g.version += int(any_found)
    return g


def delete_edges_ell(eg: EllGraph, src, dst) -> EllGraph:
    """Swap-remove within ELL rows, in place (one op after another; same
    contracts)."""
    src, dst = _ops(src, dst, eg.device)
    n, k_max = eg.n, eg.k_max
    valid = _valid_mask(src, dst, n)
    founds = []
    for i in range(src.shape[0]):
        s, v = src[i], valid[i]
        d_c = torch.where(v, dst[i], 0).long().reshape(1)
        row = eg.in_nbrs[d_c][0]
        match = (row == s) & v
        found = match.any()
        k = _first_true(match).reshape(1)
        last = (eg.in_deg[d_c] - 1).clamp(0, k_max - 1).long()
        new = row.clone()
        new.index_put_((k,), row[last])
        new.index_put_((last,), torch.full_like(last, n, dtype=new.dtype))
        eg.in_nbrs.index_put_((d_c,), torch.where(found, new, row)[None, :])
        eg.in_deg.index_add_(0, d_c, -_i32(found).reshape(1))
        founds.append(found.reshape(1))
    if founds:
        eg.version += int(torch.cat(founds).any())
    return eg


# ---------------------------------------------------------------------------
# Coordinated batch application (the epoch's update path)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PendingApply:
    """What ``apply_update_batch_async`` leaves on the device for ``settle``:
    the per-op applied mask, the new COO edge count and the batch's
    overflow bit."""

    applied: Tensor  # bool [B]
    num_edges: Tensor  # int64 scalar
    overflow: Tensor  # bool scalar


def apply_update_batch_async(
    g: Graph, eg: EllGraph, batch: UpdateBatch
) -> PendingApply:
    """Enqueue one mixed batch's writes to BOTH mirrors; read nothing back.

    The tensors of ``g`` and ``eg`` hold the post-batch snapshot once the
    enqueued work runs; their host fields still hold the pre-batch values
    until ``settle``.  See ``apply_update_batch`` for the semantics.
    """
    n, cap, k_max = g.n, g.capacity, eg.k_max
    dev = eg.device
    b = batch.size
    if not batch.has_ops:
        no = torch.zeros((), dtype=torch.bool, device=dev)
        return PendingApply(
            applied=torch.zeros(b, dtype=torch.bool, device=dev),
            num_edges=torch.full((), g.num_edges, device=dev), overflow=no)
    src_b = batch.src.to(device=dev, dtype=torch.int32)
    dst_b = batch.dst.to(device=dev, dtype=torch.int32)
    insert = batch.insert.to(device=dev, dtype=torch.bool)
    valid = _valid_mask(src_b, dst_b, n)
    is_ins = valid & insert
    s_c = torch.where(valid, src_b, 0)
    d_c = torch.where(valid, dst_b, 0)
    d_l = d_c.long()
    tri = _lower(b, dev)

    if batch.has_deletes:
        # ---- phase 1: deletes (match against pre-batch buffers, compact) --
        is_del = valid & ~insert
        # at most one copy of a pair per batch: later duplicates are no-ops
        same_pair = ((src_b[None, :] == src_b[:, None])
                     & (dst_b[None, :] == dst_b[:, None]) & is_del[None, :])
        del_live = is_del & ~(same_pair & tri).any(dim=1)
        hits = ((g.src[None, :] == s_c[:, None])
                & (g.dst[None, :] == d_c[:, None]) & del_live[:, None])
        found = hits.any(dim=1)
        pos = _first_true(hits)
        marked = torch.zeros(cap, dtype=torch.int32, device=dev)
        marked.index_add_(0, pos, _i32(found))
        keep = (g.src < n) & (marked == 0)
        kint = _i32(keep)
        kpos = torch.cumsum(kint, 0) - kint  # exclusive prefix: stable
        for buf in (g.src, g.dst):
            comp = torch.full_like(buf, n)
            comp.index_add_(0, kpos, torch.where(keep, buf - n, 0).to(torch.int32))
            buf.copy_(comp)
        ne = kint.sum()
        g.in_deg.index_add_(0, d_l, -_i32(found))
        g.out_deg.index_add_(0, s_c.long(), -_i32(found))

        # ELL mirror: mark each op's deleted slot in the batch's own copy of
        # its row ([B, k_max]; every op that deletes from row d marks its
        # slot in each batch row read from d), compact those rows, and let
        # the first op of each row write it back
        rows = eg.in_nbrs[d_l]  # [B, k_max] pre-batch rows
        rhit = (rows == s_c[:, None]) & found[:, None]
        rfound = rhit.any(dim=1)
        kslot = _first_true(rhit)
        same_row = (d_c[None, :] == d_c[:, None]) & rfound[None, :]
        dmark = torch.zeros_like(rows)
        dmark.scatter_add_(1, kslot[None, :].expand(b, b), _i32(same_row))
        first_row = ((dst_b[None, :] == dst_b[:, None]) & rfound[None, :]) & tri
        urow = rfound & ~first_row.any(dim=1)
        live = (rows < n) & (dmark == 0)
        lint = _i32(live)
        new_slot = torch.cumsum(lint, 1) - lint  # exclusive prefix per row
        comp = torch.full_like(rows, n)
        comp.scatter_add_(1, new_slot, torch.where(live, rows - n, 0).to(torch.int32))
        eg.in_nbrs.index_add_(
            0, d_l, torch.where(urow[:, None], comp - rows, 0).to(torch.int32))
        eg.in_deg.index_add_(0, d_l, -_i32(rfound))
    else:
        # insert-only batch (host fact): append, nothing to match
        found = torch.zeros_like(valid)
        ne = g.num_edges

    # ---- phase 2: inserts (append; coordinated room check) ----------------
    # ELL slot: row end + #same-dst insert predecessors in the batch.
    # Counting every insert predecessor (not just applied ones) is exact: a
    # predecessor fails only if its slot or position already overflowed, in
    # which case this op's larger slot or position overflows too.
    same_d = (dst_b[None, :] == dst_b[:, None]) & is_ins[None, :]
    occ = (same_d & tri).sum(dim=1)
    slot = eg.in_deg[d_l] + occ
    ok_ell = is_ins & (slot < k_max)
    oint = _i32(ok_ell)
    cpos = ne + torch.cumsum(oint, 0) - oint
    ok = ok_ell & (cpos < cap)
    at = cpos.clamp(max=cap - 1)
    g.src.index_add_(0, at, torch.where(ok, s_c - n, 0).to(torch.int32))
    g.dst.index_add_(0, at, torch.where(ok, d_c - n, 0).to(torch.int32))
    _add_slots(eg.in_nbrs, d_l, slot.clamp(max=k_max - 1),
               torch.where(ok, s_c - n, 0).to(torch.int32))
    g.in_deg.index_add_(0, d_l, _i32(ok))
    g.out_deg.index_add_(0, s_c.long(), _i32(ok))
    eg.in_deg.index_add_(0, d_l, _i32(ok))
    return PendingApply(
        applied=torch.where(insert, ok, found),
        num_edges=ne + ok.sum(),
        overflow=(is_ins & ~ok).any(),
    )


def settle(g: Graph, eg: EllGraph, pending: PendingApply) -> Tensor:
    """Read a pending batch's results in one device-to-host copy and update
    both mirrors' host fields; returns the applied mask (bool [B], CPU)."""
    vals = torch.cat([
        _i32(pending.applied),
        _i32(pending.num_edges).reshape(1),
        _i32(pending.overflow).reshape(1),
    ]).cpu()
    applied = vals[:-2].bool()
    bump = int(applied.any())
    g.num_edges = int(vals[-2])
    ovf = bool(vals[-1])
    for x in (g, eg):
        x.version += bump
        x.overflow = x.overflow or ovf
    return applied


def apply_update_batch(
    g: Graph, eg: EllGraph, batch: UpdateBatch
) -> tuple[Graph, EllGraph, Tensor]:
    """Apply a mixed insert/delete batch to BOTH mirrors, in place.

    The consistency-preserving path of the epoch: an insert applies iff
    there is room in *both* the COO buffer and the destination's ELL row,
    so the mirrors never diverge.  Returns ``(g, eg, applied)`` (the same
    mirror objects, updated) where ``applied[i]`` (bool, on the CPU) says
    op i changed the graph; skipped inserts set the sticky ``overflow``
    flag on both mirrors and can be retried after ``regrow``.  ``version``
    advances by exactly one on both mirrors iff any op applied.

    Two phases, no per-op loop:

    1. **deletes**: every requested edge is matched against the pre-batch
       buffers at once ([B, capacity] compare), marked, and removed by a
       *stable compaction* of the COO buffer and of each touched ELL row;
    2. **inserts**: appended en bloc at the compacted tail and the row ends,
       with the coordinated room check.

    So deletes apply before inserts within one batch; a delete never sees
    an edge inserted by the same batch (the session cuts its epoch batches
    at such conflicts), and at most one copy of a (src, dst) pair is
    deleted per batch.  Because compaction is stable and inserts append,
    both mirrors stay BIT-IDENTICAL to ``graph_from_edges`` /
    ``ell_from_edges`` rebuilt from the equally updated host edge list.
    """
    pending = apply_update_batch_async(g, eg, batch)
    return g, eg, settle(g, eg, pending)


# ---------------------------------------------------------------------------
# Host-side regrow / compaction (the overflow recovery path)
# ---------------------------------------------------------------------------


def regrow(
    g: Graph,
    eg: EllGraph,
    *,
    capacity: int | None = None,
    k_max: int | None = None,
    growth: float = 2.0,
) -> tuple[Graph, EllGraph]:
    """Pull the live edges to the host and rebuild both mirrors with headroom.

    The recovery path for ``overflow``: ``capacity`` defaults to ``growth``
    x the old one, ``k_max`` to max(growth x old, max in-degree + 1).
    ``version`` is kept (a representation change, not a graph change) and
    ``overflow`` is cleared on both mirrors.  The new mirrors live on the
    old ones' device.

    Rebuilding re-packs ELL rows in edge-list order, so walks sampled on
    the regrown graph draw another (equally valid) neighbour permutation
    than on the incrementally kept table: determinism is per snapshot
    representation, not per logical graph.
    """
    src, dst = graph_to_host_edges(g)
    n = g.n
    if capacity is None:
        capacity = max(int(g.capacity * growth), g.capacity + 1)
    if capacity < len(src):
        raise ValueError(f"capacity {capacity} < live edges {len(src)}")
    if k_max is None:
        deg_cap = int(np.bincount(dst, minlength=n).max()) if len(dst) else 0
        k_max = max(int(eg.k_max * growth), deg_cap + 1, 1)
    g2 = graph_from_edges(src, dst, n, capacity=capacity, device=g.device)
    eg2 = ell_from_edges(src, dst, n, k_max=k_max, device=eg.device)
    g2.version, eg2.version = g.version, eg.version
    return g2, eg2
