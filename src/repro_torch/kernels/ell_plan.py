"""Work plan of the ELL kernels: each row's live slots cut into chunks.

``lane_probe.cu``, ``spmm_ell.cu`` and ``probe_push.cu`` read slot k of
row v only when ``k < row_len[v]`` (callers pass ``in_deg``: live slots
come first in every ELL table the port builds or accepts).  ``spmm_csr``
runs the same plan over an in-CSR block, whose row v holds its
``in_deg[v]`` ids from ``indptr[v] - base``.  One thread
block runs one chunk of the plan; there are two kinds:

* a **packed** chunk is a run of consecutive short rows (``row_len <=
  chunk_slots``), cut where the running cost ``sum(row_len + ROW_COST)``
  crosses a multiple of ``chunk_slots``.  ``ROW_COST`` charges each row's
  own traffic (lane_probe reads and writes four W-wide rows per output row,
  against one W-wide gather per slot), so a chunk of empty rows stays
  small and a block never runs for only three gathers;
* a **split** chunk is one piece of ``chunk_slots`` slots of a long row.
  Each piece writes an fp32 partial sum; the row's last-arriving block adds
  the pieces in piece order and stores the row (no float atomics, so equal
  inputs give equal bits).  Arrival counters and partial sums are
  allocated for each launch, so a plan holds no state that launches share.

``CHUNK_SLOTS = 128``, measured: on the HepPh table
(``tools/ell_chunk_sweep.py`` over 64 to 2,048 slots on the H100) the
level time falls as chunks shrink down to 128, and rises again at 64.  Small chunks give about 17 blocks per
SM, so the hub row's 270 pieces and the packed runs balance across the card,
and each slot group walks only a few rows.  A chunk's ids take at most
``2 * chunk_slots`` ints of shared memory.

The plan is built on the device from ``row_len`` (a few small launches and
two host reads).  The wrappers look it up with ``plan_of``, which keeps the
last ``CACHED_PLANS`` plans keyed on the ``row_len`` tensor itself, so a
graph's ``in_deg`` (or a row slice of it) is planned once, not once per
level.  ``build_plan.builds`` counts the builds.
"""
from __future__ import annotations

import collections
import dataclasses
import threading

import torch

Tensor = torch.Tensor

CHUNK_SLOTS = 128
CACHED_PLANS = 8
ROW_COST = 4
THREADS = 256  # threads per block of the three kernels (kThreads, ell_chunks.cuh)


@dataclasses.dataclass
class EllPlan:
    """Chunks of one row range; every tensor int32 on the rows' device.

    ``chunks[j] = (0, a, b, 0)`` is a packed chunk of the short rows
    ``short_rows[a:b]``; ``(1 + l, k0, k1, p)`` is piece p (global piece
    index) holding slots ``[k0, k1)`` of the long row ``long_rows[l]``.
    Split chunks come first.  ``short_ptr`` is the exclusive running sum of
    the short rows' lengths; the pieces of long row l are
    ``long_first[l] .. long_first[l + 1] - 1``.
    """

    chunks: Tensor      # [n_chunks, 4]
    short_rows: Tensor  # [S]
    short_ptr: Tensor   # [S + 1]
    long_rows: Tensor   # [L]
    long_first: Tensor  # [L + 1]
    row_len: Tensor     # the [R] lengths it was built from (kept alive)
    version: int        # row_len._version at build time
    k_max: int
    chunk_slots: int
    n_pieces: int
    max_slots: int      # most ids one chunk stages in shared memory
    max_rows: int       # most rows of one packed chunk

    @property
    def n_chunks(self) -> int:
        return int(self.chunks.shape[0])

    @property
    def n_long(self) -> int:
        return int(self.long_rows.shape[0])


def build_plan(row_len: Tensor, k_max: int, *,
               chunk_slots: int = CHUNK_SLOTS) -> EllPlan:
    """The chunk plan of rows with ``min(max(row_len, 0), k_max)`` slots."""
    if row_len.dim() != 1 or row_len.dtype != torch.int32:
        raise ValueError(f"row_len must be int32 [R], got {row_len.dtype} "
                         f"{tuple(row_len.shape)}")
    if chunk_slots < 1:
        raise ValueError("chunk_slots must be >= 1")
    build_plan.builds += 1
    dev = row_len.device
    c = int(chunk_slots)
    ln = row_len.to(torch.int64).clamp(0, int(k_max))
    long = ln > c
    short_rows = torch.nonzero(~long).flatten()
    long_rows = torch.nonzero(long).flatten()

    # packed chunks: a new chunk wherever the running cost crosses k * c
    sl = ln[short_rows]
    short_ptr = torch.zeros(sl.numel() + 1, dtype=torch.int64, device=dev)
    torch.cumsum(sl, 0, out=short_ptr[1:])
    cost = sl + ROW_COST
    cid = (torch.cumsum(cost, 0) - cost) // c
    first = torch.ones_like(cid, dtype=torch.bool)
    first[1:] = cid[1:] != cid[:-1]
    a = torch.nonzero(first).flatten()
    b = torch.cat([a[1:], a.new_full((min(1, a.numel()),), sl.numel())])

    # split chunks: ceil(len / c) pieces per long row
    pieces = (ln[long_rows] + c - 1) // c
    long_first = torch.zeros(pieces.numel() + 1, dtype=torch.int64, device=dev)
    torch.cumsum(pieces, 0, out=long_first[1:])
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    n_pieces, max_slots, max_rows, live = (int(x) for x in torch.cat([
        long_first[-1:],
        torch.cat([zero, short_ptr[b] - short_ptr[a]]).max().reshape(1),
        torch.cat([zero, b - a]).max().reshape(1),
        short_ptr[-1:] + ln[long_rows].sum().reshape(1),
    ]).tolist())
    if live >= 2**31:
        raise ValueError(f"{live} live slots: more than int32 offsets hold")
    owner = torch.repeat_interleave(
        torch.arange(pieces.numel(), device=dev), pieces, output_size=n_pieces)
    p = torch.arange(n_pieces, device=dev)
    k0 = (p - long_first[owner]) * c
    split = torch.stack(
        [1 + owner, k0, torch.minimum(k0 + c, ln[long_rows][owner]), p], dim=1)
    packed = torch.stack([torch.zeros_like(a), a, b, torch.zeros_like(a)], dim=1)
    if n_pieces:
        max_slots = max(max_slots, c)
    return EllPlan(
        chunks=torch.cat([split, packed]).to(torch.int32).contiguous(),
        short_rows=short_rows.to(torch.int32),
        short_ptr=short_ptr.to(torch.int32),
        long_rows=long_rows.to(torch.int32),
        long_first=long_first.to(torch.int32),
        row_len=row_len,
        version=row_len._version,
        k_max=int(k_max),
        chunk_slots=c,
        n_pieces=n_pieces,
        max_slots=max_slots,
        max_rows=max_rows,
    )


build_plan.builds = 0


_plans: collections.OrderedDict = collections.OrderedDict()
# kernels launch from the service's collector and straggler worker threads
# too: one lock makes each lookup, build and eviction whole
_plans_lock = threading.Lock()


def plan_of(row_len: Tensor, k_max: int, *,
            chunk_slots: int | None = None) -> EllPlan:
    """The plan of ``row_len`` at ``chunk_slots`` (by default
    ``CHUNK_SLOTS``, read at the call), built on first use.

    Keyed on the tensor's memory (device, address, shape, stride) with the
    table width; a plan holds its ``row_len``, so that memory cannot be
    reused while the plan is kept, and it is rebuilt when ``row_len`` was
    written in place since (``_version``).  Safe to call from several
    threads: a plan is built once per change of ``row_len``.
    """
    slots = CHUNK_SLOTS if chunk_slots is None else int(chunk_slots)
    key = (row_len.device, row_len.data_ptr(), tuple(row_len.shape),
           row_len.stride(), int(k_max), slots)
    with _plans_lock:
        plan = _plans.get(key)
        if plan is None or plan.version != row_len._version:
            plan = _plans[key] = build_plan(row_len, k_max, chunk_slots=slots)
        _plans.move_to_end(key)
        while len(_plans) > CACHED_PLANS:
            _plans.popitem(last=False)
        return plan


def clear_plans() -> None:
    """Forget every kept plan (the next launch of each row range builds)."""
    with _plans_lock:
        _plans.clear()


def launch_layout(width: int, itemsize: int, *ptrs: int) -> tuple[int, int, int]:
    """``(vec, tc, tiles)`` of a launch over ``width`` columns.

    ``vec`` columns per thread: the widest of 16 bytes, 8, 4, ... that
    divides ``width`` and the alignment of every row pointer; ``tc`` column
    threads per slot group: the least power of two covering ``width / vec``
    (at most ``THREADS``), so a block holds ``THREADS / tc`` slot groups and
    no thread idles when ``width / vec`` is a power of two; ``tiles`` column
    tiles along the grid's y axis.
    """
    vec = max(1, 16 // itemsize)
    while vec > 1 and (width % vec or any(p % (vec * itemsize) for p in ptrs)):
        vec //= 2
    cv = -(-width // vec)
    tc = 1
    while tc < min(cv, THREADS):
        tc *= 2
    return vec, tc, -(-cv // tc)


def launch_args(plan: EllPlan, width: int,
                tiles: int) -> tuple[list, tuple[Tensor, Tensor]]:
    """The plan's pointers and ints in the kernels' argument order, and the
    launch's own scratch they point into (keep it alive until the launch is
    enqueued): zeroed arrival counters, one per (long row, column tile),
    and the fp32 piece sums."""
    dev = plan.chunks.device
    counters = torch.zeros(max(1, plan.n_long * tiles), dtype=torch.int32,
                           device=dev)
    partial = torch.empty((max(1, plan.n_pieces), max(1, width)),
                          dtype=torch.float32, device=dev)
    ptrs = [plan.chunks, plan.short_rows, plan.short_ptr, plan.long_rows,
            plan.long_first, counters, partial]
    return ([x.data_ptr() for x in ptrs]
            + [plan.n_chunks, plan.max_slots, plan.max_rows]), (counters, partial)

