"""Shared model building blocks (port of ``repro.models.common``).

Parameters travel as nested dicts of tensors in the reference's layouts, so
a function here takes what its JAX counterpart takes.  The reference's
logical-sharding helpers (``constrain``, the mesh axis helpers) are the
identity on one device and are not ported.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def dense_init(gen: torch.Generator | None, d_in: int, d_out: int, dtype,
               scale: float | None = None) -> Tensor:
    """N(0, 1) * scale (default 1/sqrt(d_in)), drawn in fp32 on the
    generator's device, then cast; with no generator, its shape and dtype
    as a ``meta`` tensor."""
    if gen is None:
        return torch.empty((d_in, d_out), dtype=dtype, device="meta")
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device)
    return (w * s).to(dtype)


def rms_norm(x: Tensor, gamma: Tensor, eps: float = 1e-5) -> Tensor:
    """RMS norm in fp32, cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * gamma.float()).to(dt)


def swiglu(x: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor) -> Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def rope_frequencies(d_head: int, theta: float, device=None) -> Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta**exps)  # [d_head/2]


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: [..., S, H, dh] (dh even); positions: broadcastable to [..., S].

    Split-half rotation with fp32 angles, cast back to x's dtype."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, x.device)
    angles = positions[..., :, None, None].float() * freqs  # [..., S, 1, dh/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def count_params(params: Any) -> int:
    """Elements of every parameter: of a module, or of a nested dict of
    tensors."""
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return params.numel()


def cast_tree(params: Any, dtype) -> Any:
    """Floating leaves of a nested dict cast to ``dtype`` (others as they are)."""
    if isinstance(params, dict):
        return {k: cast_tree(v, dtype) for k, v in params.items()}
    return params.to(dtype) if params.is_floating_point() else params

