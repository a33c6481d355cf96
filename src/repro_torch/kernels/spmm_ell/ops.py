"""Public op: ELL SpMM, on the card or the CPU.

* ``spmm_ell_padded`` — scores arrive as [n + 1, B] with the zero dump row
  baked in (the probe's buffers), returns [n, B];
* ``spmm_ell``        — [n, B] or [n] scores; appends the dump row.

Given CUDA tensors ``spmm_ell_padded`` launches ``csrc/spmm_ell.cu``
(which replaces the Pallas kernel ``src/repro/kernels/spmm_ell/spmm_ell.py``)
for any shape, or raises; given CPU tensors it runs the plain version
(``ref.py``).  Storage may be float32, float16 or bfloat16; accumulation
is fp32.  ``spmm_ell_padded.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.spmm_ell.ref import spmm_ell_padded_ref

Tensor = torch.Tensor

_SYMBOLS = {torch.float32: "spmm_ell_f32", torch.float16: "spmm_ell_f16",
            torch.bfloat16: "spmm_ell_bf16"}
_fns: dict = {}


def _kernel(dtype):
    fn = _fns.get(dtype)
    if fn is None:
        fn = _build.bind(_build.load("spmm_ell"), _SYMBOLS[dtype], 4, 4)
        _fns[dtype] = fn
    return fn


def spmm_ell_padded(nbrs: Tensor, scores: Tensor, weights: Tensor) -> Tensor:
    """out[v] = w[v] * sum_k scores[nbrs[v, k]]; scores [n + 1, B], row n zero.

    ``nbrs`` is [R, K] (R = n on the probe path, fewer for a row slice) and
    ``weights`` [R]; slot ids >= n address the dump row, which MUST be zero.
    Returns [R, B].
    """
    if scores.device.type == "cpu":
        return spmm_ell_padded_ref(nbrs, scores, weights)
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
    stream = torch.cuda.current_stream(scores.device).cuda_stream
    rc = _kernel(scores.dtype)(
        nbrs.data_ptr(), scores.data_ptr(), weights.data_ptr(), out.data_ptr(),
        r, k, n, b, stream,
    )
    _build.check(rc, "spmm_ell")
    spmm_ell_padded.launches += 1
    return out


spmm_ell_padded.launches = 0


def spmm_ell(nbrs: Tensor, scores: Tensor, weights: Tensor) -> Tensor:
    """out[v] = w[v] * sum_k scores[nbrs[v, k]]; scores [n, B] or [n].

    Appends the zero dump row and defers to ``spmm_ell_padded``.
    """
    squeeze = scores.dim() == 1
    if squeeze:
        scores = scores[:, None]
    padded = torch.cat([scores, scores.new_zeros((1, scores.shape[1]))], dim=0)
    out = spmm_ell_padded(nbrs, padded, weights)
    return out[:, 0] if squeeze else out
