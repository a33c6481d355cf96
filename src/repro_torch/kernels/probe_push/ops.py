"""Public op: the fused PROBE push level over the row extent, on the card or
the CPU.

    out[v, b] = w[v] · Σ_{k < row_len[v]} prune(scores[clip(nbrs[v, k], 0, n), b]),
    then out[exclude[b], b] = 0 where exclude[b] < n

It equals the Pallas kernel's function whenever each row's live slots come
first (``row_len = in_deg``).  Given CUDA tensors ``probe_push`` launches
``csrc/probe_push.cu`` (which replaces the Pallas kernel
``src/repro/kernels/probe_push/probe_push.py``, ``_kernel``) over the chunk
plan of ``row_len`` (``kernels/ell_plan.py``, shared with ``spmm_ell`` and
``lane_probe`` through ``plan_of``), or raises; given CPU tensors it runs
the plain version (``ref.py``).  The reference wrapper's tile conditions
(``n % 128``, ``B % 8``) do not apply, and the kernel reads the unpadded
``[n, B]`` scores (a sentinel slot is skipped, so no zero row is needed).
Storage is float32, float16 or bfloat16; sums are fp32.
``probe_push.launches`` counts kernel launches.  Under a
``roofline.analysis`` counter a call counts as one op of
``spmm_work(push=True)`` on every route.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ell_plan import launch_args, launch_layout, plan_of
from repro_torch.kernels.probe_push.ref import probe_push_ref
from repro_torch.roofline.analysis import counted_op, spmm_work

Tensor = torch.Tensor

_SYMBOLS = {torch.float32: "probe_push_f32", torch.float16: "probe_push_f16",
            torch.bfloat16: "probe_push_bf16"}
_fns: dict = {}


def _kernel(dtype):
    fn = _fns.get(dtype)
    if fn is None:
        fn = _build.bind(_build.load("probe_push"), _SYMBOLS[dtype], 12, 9,
                         n_floats=1)
        _fns[dtype] = fn
    return fn


def _work(nbrs, scores, weights, exclude, *, row_len, **_):
    return spmm_work(nbrs, row_len, scores.shape[0], scores.shape[1], push=True,
                     itemsize=scores.element_size())


@counted_op("probe_push", _work)
def probe_push(
    nbrs: Tensor,  # int32 [n, K], sentinel = n
    scores: Tensor,  # [n, B]
    weights: Tensor,  # f32 [n]
    exclude: Tensor,  # int32 [B]
    *,
    prune_thresh: float = 0.0,
    row_len: Tensor,  # int32 [n], the rows' in-degree
) -> Tensor:
    """prune(scores) pushed over slots k < row_len[v] of the ELL table,
    weighted, columns excluded; returns [n, B] in the scores' dtype."""
    if scores.device.type == "cpu":
        return probe_push_ref(nbrs, scores, weights, exclude, prune_thresh,
                              row_len=row_len)
    if scores.device.type != "cuda":
        raise ValueError(f"probe_push: no kernel for device {scores.device}")
    if scores.dtype not in _SYMBOLS:
        raise TypeError(f"probe_push: dtype {scores.dtype} not supported")
    if scores.dim() != 2 or nbrs.dim() != 2:
        raise ValueError("probe_push: nbrs and scores must be 2-D")
    n, b = scores.shape
    k = nbrs.shape[1]
    for name, x, dtype, shape in (
        ("nbrs", nbrs, torch.int32, (n, k)),
        ("weights", weights, torch.float32, (n,)),
        ("exclude", exclude, torch.int32, (b,)),
        ("scores", scores, scores.dtype, (n, b)),
        ("row_len", row_len, torch.int32, (n,)),
    ):
        if x.device != scores.device or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"probe_push: {name} must be {dtype} {shape} on {scores.device}, "
                f"got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"probe_push: {name} must be contiguous")
    out = torch.empty((n, b), dtype=scores.dtype, device=scores.device)
    if n == 0 or b == 0:
        return out
    plan = plan_of(row_len, k)
    vec, tc, tiles = launch_layout(b, scores.element_size(), scores.data_ptr(),
                                   out.data_ptr())
    pargs, scratch = launch_args(plan, b, tiles)  # scratch lives past the call
    stream = torch.cuda.current_stream(scores.device).cuda_stream
    rc = _kernel(scores.dtype)(
        nbrs.data_ptr(), scores.data_ptr(), weights.data_ptr(),
        exclude.data_ptr(), out.data_ptr(), *pargs, k, n, b, vec, tc, tiles,
        float(prune_thresh), stream,
    )
    _build.check(rc, "probe_push")
    probe_push.launches += 1
    return out


probe_push.launches = 0
