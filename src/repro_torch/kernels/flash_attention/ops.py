"""Public op: flash attention in the model's ``[B, S, H, dh]`` layout.

Given CUDA tensors ``flash_attention`` launches a kernel of
``csrc/flash_attention.cu`` (which replaces the Pallas kernel
``src/repro/kernels/flash_attention/flash_attention.py``, ``_kernel``) or
raises; given CPU tensors it runs the plain version (``ref.py``, fp32
probabilities).  ``route`` picks the kernel from the dtype and head width
alone:

* ``"tensor_core"`` (bf16 with ``dh % 8 == 0``): ``flash_tc_kernel``, wgmma
  fed by TMA.  p is rounded to bf16 before the p v product, as
  ``attention_ref(probs_dtype=torch.bfloat16)`` and the model's
  ``attn_probs_dtype = "bfloat16"`` do.  TMA needs 16-byte row strides
  (hence ``dh % 8``) and 16-byte-aligned base pointers.
* ``"simt"`` (fp32, and bf16 with ``dh % 8 != 0``): ``flash_kernel`` on the
  CUDA cores, p in fp32.

Both take any S and T and any head width up to ``MAX_HEAD_DIM``; the
reference wrapper's tile conditions (``S % bq``, ``T % bk``) do not apply.
Causal attention needs S == T (the mask is ``row >= col`` with no offset),
as in the Pallas kernel.  Softmax statistics and accumulation are fp32.
``flash_attention.launches`` counts kernel launches of either route,
``flash_attention.tc_launches`` those of the tensor-core route.  A CUDA
tensor on a route launches that route's kernel or raises; nothing falls
back to the other.  ``meta`` tensors take the meta route: the checks,
then an empty output of the right shape and dtype (a dry-run's step),
nothing computed.  Under a ``roofline.analysis`` counter a call counts as
one op of ``flash_work`` on every route.

The kernel has no backward, as the reference's Pallas kernel has none: on a
CUDA or ``meta`` tensor a call with grad enabled and any of q / k / v
requiring grad raises ``RuntimeError`` (its output, written through raw
pointers, would carry no ``grad_fn`` and autograd would drop every
attention gradient).  Training runs the plain ``sdpa``; the CPU route is
``attention_ref``, differentiable as it is.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.roofline.analysis import counted_op, flash_work

Tensor = torch.Tensor

MAX_HEAD_DIM = 128
_SYMBOLS = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}
_TC_SYMBOL = "flash_attention_bf16_tc"
_fns: dict = {}


def route(dtype: torch.dtype, dh: int) -> str:
    """The kernel that a CUDA call with this dtype and head width launches:
    ``"tensor_core"`` for bf16 with ``dh % 8 == 0``, else ``"simt"``."""
    return "tensor_core" if dtype == torch.bfloat16 and dh % 8 == 0 else "simt"


def _kernel(symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        fn = _build.bind(_build.load("flash_attention"), symbol, 4, 7, n_floats=1)
        _fns[symbol] = fn
    return fn


def _check(q: Tensor, k: Tensor, v: Tensor, causal: bool) -> None:
    if q.dtype not in _SYMBOLS:
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, S|T, H, dh]")
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype or tuple(x.shape) != (B, T, Hkv, dh):
            raise ValueError(
                f"flash_attention: {name} must be {q.dtype} {(B, T, Hkv, dh)} on "
                f"{q.device}, got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    if T == 0:
        raise ValueError("flash_attention: no keys (T = 0)")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention: H = {H} is not a multiple of Hkv = {Hkv}")
    if not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head width {dh} not in [1, {MAX_HEAD_DIM}]")
    if causal and S != T:
        raise ValueError(f"flash_attention: causal needs S == T, got {S} != {T}")
    if max(B, H) > 65535:
        raise ValueError("flash_attention: B and H must be at most 65535")
    if route(q.dtype, dh) == "tensor_core" and -(-S // 128) > 65535:
        raise ValueError("flash_attention: S must be at most 65535 * 128")


def _work(q, k, v, *, causal=True, scale=None):
    return flash_work(q.shape, k.shape, causal=causal, dtype=q.dtype)


@counted_op("flash_attention", _work)
def flash_attention(
    q: Tensor,  # [B, S, H, dh]
    k: Tensor,  # [B, T, Hkv, dh]
    v: Tensor,  # [B, T, Hkv, dh]
    *,
    causal: bool = True,
    scale: float | None = None,
) -> Tensor:
    """softmax(q k^T * scale [+ causal mask]) v per head; output [B, S, H, dh]
    in q's dtype."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, scale=scale)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "flash_attention: the kernel has no backward (the reference's has "
            "none either), and q / k / v require grad; train through the plain "
            "sdpa (use_kernel=False) or call it under torch.no_grad()")
    if q.device.type == "meta":
        _check(q, k, v, causal)
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    _check(q, k, v, causal)
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    tensor_core = route(q.dtype, dh) == "tensor_core"
    if tensor_core:
        for name, x in (("q", q), ("k", k), ("v", v), ("out", out)):
            if x.data_ptr() % 16:
                raise ValueError(f"flash_attention: {name} is not 16-byte aligned "
                                 "(the tensor-core route loads it with TMA)")
    symbol = _TC_SYMBOL if tensor_core else _SYMBOLS[q.dtype]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel(symbol)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, T, H, Hkv, dh, int(bool(causal)), float(scale), stream,
    )
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    if tensor_core:
        flash_attention.tc_launches += 1
    return out


flash_attention.launches = 0
flash_attention.tc_launches = 0
