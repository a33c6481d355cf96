"""GQA attention for prefill and decode (port of ``repro.models.transformer.attention``).

Decode is cache-resident: k/v are cached per kv head, ``[B, S_max, Hkv,
dh]``.  Unlike the reference, which returns a new cache, ``gqa_decode``
writes the new position into the cache in place: the ``decode_32k`` cache
of Llama-3.2-1B is 8.6 GB, and a copy per layer per step would double it.

The flash-attention kernel is switchable via ``use_kernel`` (prefill
shapes); the plain PyTorch path is the oracle.  MLA waits for a later slice
(ROADMAP queue 1 item 14).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import apply_rope

Tensor = torch.Tensor

NEG_INF = -1e30


def sdpa(
    q: Tensor,  # [B, S, H, dh]
    k: Tensor,  # [B, T, Hkv, dh]
    v: Tensor,  # [B, T, Hkv, dhv]
    *,
    causal_offset: int | None = 0,
    kv_len: Tensor | None = None,
    scale: float | None = None,
    use_kernel: bool = False,
    chunk_q: int = 1024,
    probs_dtype=torch.float32,
) -> Tensor:
    """Grouped-query scaled-dot-product attention (plain or the flash kernel).

    Long sequences (S > chunk_q, S a multiple of chunk_q) run query chunks
    one after another, so the peak logits buffer is [*, chunk_q, T] instead
    of [*, S, T] (a 32k prefill would otherwise need 32768^2 x heads x 4 B).
    ``use_kernel`` sends causal prefill (``causal_offset == 0``, S > 1) to
    ``kernels.flash_attention``; decode (S == 1, ``kv_len``) stays plain."""
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    if use_kernel and causal_offset is not None and S > 1:
        if causal_offset != 0 or kv_len is not None:
            raise ValueError("the flash kernel takes causal_offset 0 and no kv_len")
        from repro_torch.kernels.flash_attention.ops import flash_attention

        return flash_attention(q, k, v, causal=True, scale=scale)

    kf = k.float()
    vf = v.float()
    cols = torch.arange(T, device=q.device)

    def block(q_blk: Tensor, row0: int) -> Tensor:
        # q_blk: [B, bq, H, dh]; rows are global positions row0..row0+bq
        bq = q_blk.shape[1]
        qg = q_blk.reshape(B, bq, Hkv, group, dh).float()
        logits = torch.einsum("bsngd,btnd->bngst", qg, kf) * scale
        if causal_offset is not None:
            rows = row0 + torch.arange(bq, device=q.device)[:, None] + causal_offset
            logits.masked_fill_(~(cols[None, :] <= rows), NEG_INF)
        if kv_len is not None:
            valid = cols[None, :] < kv_len[:, None]  # [B, T]
            logits.masked_fill_(~valid[:, None, None, None], NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(probs_dtype)
        del logits
        out = torch.einsum("bngst,btnd->bsngd", probs, vf.to(probs_dtype)).float()
        return out.reshape(B, bq, H, v.shape[-1]).to(q.dtype)

    if S <= chunk_q or S % chunk_q != 0:
        return block(q, 0)
    out = torch.empty((B, S, H, v.shape[-1]), dtype=q.dtype, device=q.device)
    for r0 in range(0, S, chunk_q):
        out[:, r0 : r0 + chunk_q] = block(q[:, r0 : r0 + chunk_q], r0)
    return out


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


def _proj(x: Tensor, w: Tensor) -> Tensor:
    """einsum("bsd,dhk->bshk") as one matmul; the result is contiguous."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).view(*x.shape[:-1], h, k)


def _out(o: Tensor, wo: Tensor) -> Tensor:
    """einsum("bshk,hkd->bsd")."""
    h, k, d = wo.shape
    return o.reshape(*o.shape[:-2], h * k) @ wo.reshape(h * k, d)


def init_gqa(gen: torch.Generator | None, cfg, dtype) -> dict:
    from repro_torch.models.common import dense_init

    d, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    return dict(
        wq=dense_init(gen, d, H * dh, dtype).reshape(d, H, dh),
        wk=dense_init(gen, d, Hkv * dh, dtype).reshape(d, Hkv, dh),
        wv=dense_init(gen, d, Hkv * dh, dtype).reshape(d, Hkv, dh),
        wo=dense_init(gen, H * dh, d, dtype).reshape(H, dh, d),
    )


def _probs_dtype(cfg):
    return torch.bfloat16 if cfg.attn_probs_dtype == "bfloat16" else torch.float32


def gqa_forward(
    p: dict,
    x: Tensor,  # [B, S, D]
    positions: Tensor,  # [B, S]
    cfg,
    *,
    use_kernel: bool = False,
) -> Tensor:
    q = apply_rope(_proj(x, p["wq"]), positions, cfg.rope_theta)
    k = apply_rope(_proj(x, p["wk"]), positions, cfg.rope_theta)
    v = _proj(x, p["wv"])
    o = sdpa(q, k, v, causal_offset=0, use_kernel=use_kernel,
             probs_dtype=_probs_dtype(cfg))
    return _out(o, p["wo"])


def gqa_init_cache(cfg, batch: int, s_max: int, dtype, device) -> dict:
    Hkv, dh = cfg.n_kv_heads, cfg.d_head
    return dict(
        k=torch.zeros((batch, s_max, Hkv, dh), dtype=dtype, device=device),
        v=torch.zeros((batch, s_max, Hkv, dh), dtype=dtype, device=device),
    )


def gqa_decode(
    p: dict,
    cache: dict,
    x: Tensor,  # [B, 1, D]
    position: Tensor,  # [B] current position (== cache fill length)
    cfg,
) -> tuple[dict, Tensor]:
    """One decode step; writes k/v at ``position`` into ``cache`` in place
    and returns ``(cache, out [B, 1, D])``."""
    B = x.shape[0]
    q = apply_rope(_proj(x, p["wq"]), position[:, None], cfg.rope_theta)
    k_new = apply_rope(_proj(x, p["wk"]), position[:, None], cfg.rope_theta)
    v_new = _proj(x, p["wv"])
    bidx = torch.arange(B, device=x.device)
    pos = position.long()
    cache["k"][bidx, pos] = k_new[:, 0]
    cache["v"][bidx, pos] = v_new[:, 0]
    o = sdpa(q, cache["k"], cache["v"], causal_offset=None, kv_len=position + 1)
    return cache, _out(o, p["wo"])
