"""Plain PyTorch version of flash attention (``csrc/flash_attention.cu``).

Softmax attention in the model's ``[B, S, H, dh]`` layout, GQA-aware
(query head h reads kv head ``h // (H / Hkv)``), fp32 throughout, causal
positions masked with ``-1e30`` (``row >= col`` keeps), output in q's
dtype.  ``probs_dtype`` is the type the normalised probabilities and v
are rounded to before the p v product (as in the model's ``sdpa``):
fp32 is the function's definition and the CPU path's, bf16 the
tensor-core kernel's rounding of p.  Queries run in chunks of ``chunk_q``
rows, so a 32k prefill holds a ``[chunk_q, T]`` logits buffer per head
instead of ``[S, T]``.  Used by the CPU path of ``ops.flash_attention``
and by the on-card comparison.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

NEG_INF = -1e30


def attention_ref(
    q: Tensor,  # [B, S, H, dh]
    k: Tensor,  # [B, T, Hkv, dh]
    v: Tensor,  # [B, T, Hkv, dh]
    *,
    causal: bool = True,
    scale: float | None = None,
    chunk_q: int = 1024,
    probs_dtype: torch.dtype = torch.float32,
) -> Tensor:
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = scale if scale is not None else dh**-0.5
    kf, vp = k.float(), v.float().to(probs_dtype)
    out = torch.empty((B, S, H, v.shape[-1]), dtype=q.dtype, device=q.device)
    cols = torch.arange(T, device=q.device)
    for r0 in range(0, S, chunk_q):
        qg = q[:, r0 : r0 + chunk_q].float()
        bq = qg.shape[1]
        qg = qg.reshape(B, bq, Hkv, g, dh)
        logits = torch.einsum("bsngd,btnd->bngst", qg, kf) * scale
        if causal:
            rows = torch.arange(r0, r0 + bq, device=q.device)
            logits.masked_fill_(~(rows[:, None] >= cols[None, :]), NEG_INF)
        p = torch.softmax(logits, dim=-1).to(probs_dtype)
        del logits
        o = torch.einsum("bngst,btnd->bsngd", p, vp).float()
        out[:, r0 : r0 + bq] = o.reshape(B, bq, H, -1).to(q.dtype)
    return out
