"""Public op: one fused compacted-lane probe level, on the card or the CPU.

``lane_probe_level`` runs deposit + inject + prune + ELL push + exclusion
for one level of the compacted lane schedule (core/multisource.py) in one
pass::

    tot[v, c] = total[v, c] + (fin[c] ? dep[v, c] : 0)
    out[v, c] = w[v] · Σ_{k < row_len[v]} eff(nbrs[v, k], c),  0 if u_prev[c] == row0 + v
    eff(x, c) = (fin[c] ? 0 : table[x - row0 + tab0, c]) + [x == u_p[c]],
                0 if pruned (<= thr[c]) or x >= n_live

It equals the Pallas kernel's function whenever each row's live slots come
first (``row_len = in_deg``).  Given CUDA tensors it launches
``csrc/lane_probe.cu`` (which replaces the Pallas kernel
``src/repro/kernels/lane_probe/lane_probe.py``) over the chunk plan of
``row_len`` (``kernels/ell_plan.py``, built on the first launch with that
``row_len`` tensor and kept), or raises; given CPU tensors it runs the plain version
(``ref.py``).  There is no fallback from the card to the plain version.

Storage dtype follows ``table`` (float32, or bfloat16 with fp32
accumulation); ``dep`` and ``total`` must match it.  Neighbor ids are
global: id x reads table row ``x - row0 + tab0``.  ``out=`` and ``tot=``
name destinations: ``out`` may not overlap any input, ``tot`` may be
``total`` itself (each element is read and rewritten by one thread) but
overlap nothing else.

``lane_probe_level.launches`` counts kernel launches (not plain-version
calls); set it to 0 to start a count.  Under a ``roofline.analysis``
counter a call counts as one op of ``lane_probe_work`` on every route.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ell_plan import launch_args, launch_layout, plan_of
from repro_torch.kernels.lane_probe.ref import lane_probe_level_ref
from repro_torch.roofline.analysis import counted_op, lane_probe_work

Tensor = torch.Tensor

_SYMBOLS = {torch.float32: "lane_probe_level_f32",
            torch.bfloat16: "lane_probe_level_bf16"}
_fns: dict = {}


def _kernel(dtype):
    fn = _fns.get(dtype)
    if fn is None:
        fn = _build.bind(_build.load("lane_probe"), _SYMBOLS[dtype], 18, 14)
        _fns[dtype] = fn
    return fn


def _check(nbrs, weights, table, dep, total, fin, u_p, u_prev, thr,
           row_len) -> None:
    r, _ = nbrs.shape
    w = table.shape[1]
    dev = table.device
    if table.dtype not in _SYMBOLS:
        raise TypeError(f"lane_probe: storage dtype {table.dtype} not supported")
    want = {
        "nbrs": (nbrs, torch.int32, (r, nbrs.shape[1])),
        "weights": (weights, torch.float32, (r,)),
        "dep": (dep, table.dtype, (r, w)),
        "total": (total, table.dtype, (r, w)),
        "fin": (fin, torch.int32, (w,)),
        "u_p": (u_p, torch.int32, (w,)),
        "u_prev": (u_prev, torch.int32, (w,)),
        "thr": (thr, torch.float32, (w,)),
        "row_len": (row_len, torch.int32, (r,)),
    }
    for name, (x, dtype, shape) in want.items():
        if x.device != dev:
            raise ValueError(f"lane_probe: {name} on {x.device}, table on {dev}")
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"lane_probe: {name} must be {dtype} {shape}, "
                f"got {x.dtype} {tuple(x.shape)}"
            )
        if not x.is_contiguous():
            raise ValueError(f"lane_probe: {name} must be contiguous")
    if not table.is_contiguous():
        raise ValueError("lane_probe: table must be contiguous")


def _overlaps(a: Tensor, b: Tensor) -> bool:
    """Whether the memory spans of two tensors intersect."""
    if a.device != b.device or a.numel() == 0 or b.numel() == 0:
        return False
    a0, b0 = a.data_ptr(), b.data_ptr()
    return (a0 < b0 + b.numel() * b.element_size()
            and b0 < a0 + a.numel() * a.element_size())


def _destinations(out, tot, table, dep, total, r, w):
    """Check ``out=`` / ``tot=`` (or allocate them); returns (out, tot, inplace)."""
    for name, x, dtype in (("out", out, table.dtype), ("tot", tot, total.dtype)):
        if x is None:
            continue
        if (x.device != table.device or x.dtype != dtype
                or tuple(x.shape) != (r, w) or not x.is_contiguous()):
            raise ValueError(
                f"lane_probe: {name}= must be contiguous {dtype} {(r, w)} on "
                f"{table.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    inplace = tot is not None and tot.data_ptr() == total.data_ptr()
    if out is not None:
        for name, x in (("table", table), ("dep", dep), ("total", total),
                        ("tot", tot)):
            if x is not None and _overlaps(out, x):
                raise ValueError(f"lane_probe: out= overlaps {name}")
    if tot is not None:
        for name, x in (("table", table), ("dep", dep)) + (
                () if inplace else (("total", total),)):
            if _overlaps(tot, x):
                raise ValueError(f"lane_probe: tot= overlaps {name}")
    if out is None:
        out = torch.empty((r, w), dtype=table.dtype, device=table.device)
    if tot is None:
        tot = torch.empty((r, w), dtype=total.dtype, device=table.device)
    return out, tot, inplace


def _work(nbrs, weights, table, dep, total, fin, *_, row_len, n_live,
          tot=None, **__):
    inplace = tot is not None and tot.data_ptr() == total.data_ptr()
    return lane_probe_work(nbrs, row_len, n_live, table.shape[1], fin,
                           tot_inplace=inplace, itemsize=table.element_size())


@counted_op("lane_probe_level", _work)
def lane_probe_level(
    nbrs: Tensor,     # int32 [R, K] global in-neighbor ids (sentinel >= n_live)
    weights: Tensor,  # f32 [R] push weights (inv_in_deg * sqrt_c)
    table: Tensor,    # [T, W] gather source (full frontier or own block)
    dep: Tensor,      # [R, W] pre-level scores of these rows (deposit source)
    total: Tensor,    # [R, W] per-column accumulator
    fin: Tensor,      # bool [W] columns depositing this level
    u_p: Tensor,      # int32 [W] injection ids (>= n_live: no-op)
    u_prev: Tensor,   # int32 [W] exclusion ids (>= n_live: no-op)
    thr: Tensor,      # f32 [W] prune thresholds (ignored unless ``prune``)
    *,
    row_len: Tensor,  # int32 [R] slots read per row (in_deg of the rows)
    row0: int,
    tab0: int,
    n_live: int,
    prune: bool,
    out: Tensor | None = None,
    tot: Tensor | None = None,
) -> tuple[Tensor, Tensor]:
    """Returns ``(scores_out [R, W], total_out [R, W])`` for one level."""
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lane_probe: no kernel for device {table.device}")
    r, k = nbrs.shape
    t, w = table.shape
    out, tot, inplace = _destinations(out, tot, table, dep, total, r, w)
    if table.device.type == "cpu":
        o, s = lane_probe_level_ref(
            nbrs, weights, table, dep, total, fin, u_p, u_prev, thr,
            row_len=row_len, row0=row0, tab0=tab0, n_live=n_live, prune=prune,
        )
        return out.copy_(o), tot.copy_(s)
    fin = fin.to(torch.int32)
    _check(nbrs, weights, table, dep, total, fin, u_p, u_prev, thr, row_len)
    if r == 0 or w == 0:
        return out, tot
    # the launch goes to the tensors' card, whichever is current (the
    # sharded backend drives one block per card from one thread)
    with torch.cuda.device(table.device):
        plan = plan_of(row_len, k)
        vec, tc, tiles = launch_layout(
            w, table.element_size(), table.data_ptr(), dep.data_ptr(),
            total.data_ptr(), out.data_ptr(), tot.data_ptr())
        pargs, scratch = launch_args(plan, w, tiles)  # lives past the call
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = _kernel(table.dtype)(
            nbrs.data_ptr(), weights.data_ptr(), table.data_ptr(),
            dep.data_ptr(), total.data_ptr(), fin.data_ptr(), u_p.data_ptr(),
            u_prev.data_ptr(), thr.data_ptr(), out.data_ptr(), tot.data_ptr(),
            *pargs, k, t, w, int(row0), int(tab0), int(n_live),
            int(bool(prune)), int(inplace), vec, tc, tiles, stream,
        )
    _build.check(rc, "lane_probe")
    lane_probe_level.launches += 1
    return out, tot


lane_probe_level.launches = 0
