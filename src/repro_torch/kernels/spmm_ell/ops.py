"""Public op: ELL SpMM over the row extent, on the card or the CPU.

    out[v, b] = w[v] · Σ_{k < row_len[v]} scores[min(nbrs[v, k], n), b]

* ``spmm_ell_padded`` — scores arrive as [n + 1, B] with the zero dump row
  baked in (the probe's buffers), returns [R, B];
* ``spmm_ell``        — [n, B] or [n] scores; appends the dump row.

It equals the Pallas kernel's function whenever each row's live slots come
first (``row_len = in_deg``).  Given CUDA tensors ``spmm_ell_padded``
launches ``csrc/spmm_ell.cu`` (which replaces the Pallas kernel
``src/repro/kernels/spmm_ell/spmm_ell.py``) over the chunk plan of
``row_len`` (``kernels/ell_plan.py``, built on the first launch with that
``row_len`` tensor and kept), or raises; given CPU tensors it runs the plain version
(``ref.py``).  Storage may be float32, float16 or bfloat16; accumulation
is fp32.  ``spmm_ell_padded.launches`` counts kernel launches.  Under a
``roofline.analysis`` counter either call counts as one op of
``spmm_work`` on every route.

* ``spmm_csr``        — the same sum over the rows of an in-CSR block,
  ``out[v] = w[v] * sum_{k < row_len[v]} scores[indices[indptr[v] - base + k]]``:
  the production serve step's push (``core/distributed.py::coo_push``).
  Replaces no Pallas kernel (the JAX package's push is a segment sum).
  Given CUDA tensors it launches ``spmm_csr_f32`` of ``csrc/spmm_ell.cu``
  over the chunk plan of ``row_len`` with ``launch_layout``'s full-row
  column tiles, or raises; given CPU tensors it runs ``spmm_csr_ref``;
  ``meta`` tensors give a ``meta`` result.  fp32 only.
  ``spmm_csr.launches`` counts kernel launches; under a counter a call is
  one op of ``csr_work``, counted from shapes and the host int ``live``, so
  a ``meta`` step counts what a real one does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ell_plan import launch_args, launch_layout, plan_of
from repro_torch.kernels.spmm_ell.ref import spmm_csr_ref, spmm_ell_padded_ref
from repro_torch.roofline.analysis import Work, counted_op, spmm_work

Tensor = torch.Tensor

_SYMBOLS = {torch.float32: "spmm_ell_f32", torch.float16: "spmm_ell_f16",
            torch.bfloat16: "spmm_ell_bf16"}
_fns: dict = {}


def _kernel(dtype):
    fn = _fns.get(dtype)
    if fn is None:
        fn = _build.bind(_build.load("spmm_ell"), _SYMBOLS[dtype], 11, 9)
        _fns[dtype] = fn
    return fn


def _csr_kernel():
    fn = _fns.get("csr")
    if fn is None:
        fn = _fns["csr"] = _build.bind(_build.load("spmm_ell"), "spmm_csr_f32",
                                       12, 9)
    return fn


def _padded_work(nbrs, scores, weights, *, row_len):
    return spmm_work(nbrs, row_len, scores.shape[0] - 1, scores.shape[1],
                     itemsize=scores.element_size())


def _work(nbrs, scores, weights, *, row_len):
    b = 1 if scores.dim() == 1 else scores.shape[1]
    return spmm_work(nbrs, row_len, scores.shape[0], b,
                     itemsize=scores.element_size())


@counted_op("spmm_ell_padded", _padded_work)
def spmm_ell_padded(nbrs: Tensor, scores: Tensor, weights: Tensor, *,
                    row_len: Tensor) -> Tensor:
    """out[v] = w[v] * sum_{k < row_len[v]} scores[nbrs[v, k]]; scores
    [n + 1, B], row n zero.

    ``nbrs`` is [R, K] (R = n on the probe path, fewer for a row slice),
    ``weights`` and ``row_len`` [R]; slot ids >= n address the dump row,
    which MUST be zero.  Returns [R, B].
    """
    if scores.device.type == "cpu":
        return spmm_ell_padded_ref(nbrs, scores, weights, row_len=row_len)
    if scores.device.type != "cuda":
        raise ValueError(f"spmm_ell: no kernel for device {scores.device}")
    if scores.dtype not in _SYMBOLS:
        raise TypeError(f"spmm_ell: dtype {scores.dtype} not supported")
    if scores.dim() != 2 or nbrs.dim() != 2:
        raise ValueError("spmm_ell: nbrs and scores must be 2-D")
    r, k = nbrs.shape
    n, b = scores.shape[0] - 1, scores.shape[1]
    for name, x, dtype, shape in (
        ("nbrs", nbrs, torch.int32, (r, k)),
        ("weights", weights, torch.float32, (r,)),
        ("scores", scores, scores.dtype, (n + 1, b)),
        ("row_len", row_len, torch.int32, (r,)),
    ):
        if x.device != scores.device or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"spmm_ell: {name} must be {dtype} {shape} on {scores.device}, "
                f"got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"spmm_ell: {name} must be contiguous")
    out = torch.empty((r, b), dtype=scores.dtype, device=scores.device)
    if r == 0 or b == 0:
        return out
    plan = plan_of(row_len, k)
    vec, tc, tiles = launch_layout(b, scores.element_size(), scores.data_ptr(),
                                   out.data_ptr())
    pargs, scratch = launch_args(plan, b, tiles)  # scratch lives past the call
    stream = torch.cuda.current_stream(scores.device).cuda_stream
    rc = _kernel(scores.dtype)(
        nbrs.data_ptr(), scores.data_ptr(), weights.data_ptr(), out.data_ptr(),
        *pargs, k, n, b, vec, tc, tiles, stream,
    )
    _build.check(rc, "spmm_ell")
    spmm_ell_padded.launches += 1
    return out


spmm_ell_padded.launches = 0


@counted_op("spmm_ell", _work)
def spmm_ell(nbrs: Tensor, scores: Tensor, weights: Tensor, *,
             row_len: Tensor) -> Tensor:
    """out[v] = w[v] * sum_{k < row_len[v]} scores[nbrs[v, k]]; scores [n, B]
    or [n].

    Appends the zero dump row and defers to ``spmm_ell_padded``.
    """
    squeeze = scores.dim() == 1
    if squeeze:
        scores = scores[:, None]
    padded = torch.cat([scores, scores.new_zeros((1, scores.shape[1]))], dim=0)
    out = spmm_ell_padded(nbrs, padded, weights, row_len=row_len)
    return out[:, 0] if squeeze else out


def csr_work(indices, scores, weights, *, indptr, row_len, base, live):
    """One spmm_csr call, from shapes and ``live`` (the block's live edges):
    the live ids once, indptr / row_len / weights once, the [n, B] frontier
    read once (every row some edge may read), the [R, B] output written
    once; an add per live edge and column and a weight per row and column."""
    r, (n, b) = row_len.shape[0], scores.shape
    item = scores.element_size()
    return Work(flops=live * b + r * b,
                bytes=4 * live + 12 * r + n * b * item + r * b * item)


def launch_csr(indices, scores, weights, indptr, row_len, base, out, *, vec,
               tc, tiles, chunk_slots: int | None = None) -> None:
    """Launch spmm_csr_f32 over checked tensors with the given column
    layout (``launch_layout``'s ``vec``, ``tc``, ``tiles``) and the chunk
    plan of ``row_len`` at ``chunk_slots`` (by default ``CHUNK_SLOTS``)."""
    n, b = scores.shape
    # the launch goes to the tensors' card, whichever is current (coo_push
    # drives one block per card from one thread)
    with torch.cuda.device(scores.device):
        plan = plan_of(row_len, max(1, indices.shape[0]), chunk_slots=chunk_slots)
        pargs, scratch = launch_args(plan, b, tiles)  # lives past the call
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        rc = _csr_kernel()(
            indices.data_ptr(), indptr.data_ptr(), scores.data_ptr(),
            weights.data_ptr(), out.data_ptr(), *pargs, int(base), n, b, vec,
            tc, tiles, stream,
        )
    _build.check(rc, "spmm_csr")


@counted_op("spmm_csr", csr_work)
def spmm_csr(indices: Tensor, scores: Tensor, weights: Tensor, *,
             indptr: Tensor, row_len: Tensor, base: int, live: int) -> Tensor:
    """out[v] = w[v] * sum_{k < row_len[v]} scores[indices[indptr[v] - base
    + k]]; scores [n, B] fp32, ids >= n skipped.

    ``indices`` [E] int32 is the block's in-neighbour lists, each row's ids
    together, from global CSR offset ``base``; ``indptr`` (global offsets),
    ``row_len`` and ``weights`` are [R].  ``live`` (host int, the block's
    live edges) only sizes the counted work.  Returns [R, B] fp32.
    """
    dev = scores.device
    if dev.type == "cpu":
        return spmm_csr_ref(indices, scores, weights, indptr=indptr,
                            row_len=row_len, base=base)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"spmm_csr: no kernel for device {dev}")
    if scores.dtype != torch.float32:
        raise TypeError(f"spmm_csr: dtype {scores.dtype} not supported")
    if scores.dim() != 2 or indices.dim() != 1:
        raise ValueError("spmm_csr: scores must be 2-D and indices 1-D")
    r = row_len.shape[0]
    n, b = scores.shape
    for name, x, dtype, shape in (
        ("indices", indices, torch.int32, tuple(indices.shape)),
        ("weights", weights, torch.float32, (r,)),
        ("indptr", indptr, torch.int32, (r,)),
        ("row_len", row_len, torch.int32, (r,)),
    ):
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"spmm_csr: {name} must be {dtype} {shape} on {dev}, "
                f"got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"spmm_csr: {name} must be contiguous")
    if not scores.is_contiguous():
        raise ValueError("spmm_csr: scores must be contiguous")
    out = torch.empty((r, b), dtype=scores.dtype, device=dev)
    if dev.type == "meta" or r == 0 or b == 0:
        return out
    vec, tc, tiles = launch_layout(b, scores.element_size(), scores.data_ptr(),
                                   out.data_ptr())
    launch_csr(indices, scores, weights, indptr, row_len, base, out, vec=vec,
               tc=tc, tiles=tiles)
    spmm_csr.launches += 1
    return out


spmm_csr.launches = 0
