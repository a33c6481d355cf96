"""Attention for prefill and decode: GQA (llama / yi / qwen) and MLA
(DeepSeek-V2); port of ``repro.models.transformer.attention``.

Decode is cache-resident:

* GQA caches k/v per kv head, ``[B, S_max, Hkv, dh]``;
* MLA caches the compressed latent ``c_kv`` ``[B, S_max, r]`` and the shared
  rope key ``[B, S_max, d_rope]``, and decodes in the absorbed form (q
  projected into the latent space; values expanded only after the
  attention-weighted latent sum).

Unlike the reference, which returns a new cache, ``gqa_decode`` and
``mla_decode`` write the new position into the cache in place: the
``decode_32k`` cache of Llama-3.2-1B is 8.6 GB, and a copy per layer per
step would double it.

The flash-attention kernel is switchable via ``use_kernel`` (prefill
shapes); the plain PyTorch path is the oracle.  The kernel takes v of q's
head width only, so MLA's prefill (q / k of width ``dn + dr``, v of ``dv``)
runs the plain path and ``sdpa`` refuses the kernel there, as the
reference's wrapper does (ROADMAP queue 1 item 14).
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
    ``kernels.flash_attention``; decode (S == 1, ``kv_len``) stays plain.
    ``use_kernel`` with v's width other than q's, or above the kernel's
    ``MAX_HEAD_DIM``, raises ``ValueError`` on every device."""
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    if use_kernel:
        from repro_torch.kernels.flash_attention.ops import MAX_HEAD_DIM

        dv = v.shape[-1]
        if dv != dh or dv > MAX_HEAD_DIM:
            raise ValueError(
                f"sdpa: the flash kernel takes q / k / v of one head width up to "
                f"{MAX_HEAD_DIM}, got q / k {dh} and v {dv} (MLA's widths run the "
                "plain path: use_kernel=False; ROADMAP queue 1 item 14)")
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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------


def init_mla(gen: torch.Generator | None, cfg, dtype) -> dict:
    """The kv down-projection ``w_dkv [d, r]``, the shared rope key ``w_kr
    [d, dr]``, the up-projections ``w_uk [r, H, dn]`` / ``w_uv [r, H, dv]``,
    ``wo [H, dv, d]``, and q: ``wq [d, H, dn + dr]``, or with ``q_lora_rank``
    ``w_dq [d, q_lora]`` and ``w_uq [q_lora, H, dn + dr]``."""
    from repro_torch.models.common import dense_init

    d, H, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    p = dict(
        w_dkv=dense_init(gen, d, r, dtype),
        w_kr=dense_init(gen, d, dr, dtype),
        w_uk=dense_init(gen, r, H * dn, dtype).reshape(r, H, dn),
        w_uv=dense_init(gen, r, H * dv, dtype).reshape(r, H, dv),
        wo=dense_init(gen, H * dv, d, dtype).reshape(H, dv, d),
    )
    if cfg.q_lora_rank:
        p["w_dq"] = dense_init(gen, d, cfg.q_lora_rank, dtype)
        p["w_uq"] = dense_init(gen, cfg.q_lora_rank, H * (dn + dr), dtype).reshape(
            cfg.q_lora_rank, H, dn + dr)
    else:
        p["wq"] = dense_init(gen, d, H * (dn + dr), dtype).reshape(d, H, dn + dr)
    return p


def _mla_q(p: dict, x: Tensor, positions: Tensor, cfg) -> tuple[Tensor, Tensor]:
    """(q_nope [B, S, H, dn], q_rope [B, S, H, dr] with rope applied)."""
    dn = cfg.qk_nope_head_dim
    if cfg.q_lora_rank:
        q = _proj(x @ p["w_dq"], p["w_uq"])
    else:
        q = _proj(x, p["wq"])
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _rope_key(p: dict, x: Tensor, positions: Tensor, cfg) -> Tensor:
    """The rope key shared by the heads, [B, S, 1, dr]."""
    return apply_rope((x @ p["w_kr"])[:, :, None, :], positions, cfg.rope_theta)


def mla_forward(
    p: dict,
    x: Tensor,  # [B, S, D]
    positions: Tensor,  # [B, S]
    cfg,
    *,
    use_kernel: bool = False,
) -> Tensor:
    """Prefill MLA: the latent is expanded to per-head k and v, and the
    plain ``sdpa`` runs with q / k of width dn + dr and v of width dv
    (``use_kernel=True`` raises there: the kernel takes one width)."""
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_nope, q_rope = _mla_q(p, x, positions, cfg)
    c_kv = x @ p["w_dkv"]  # [B, S, r]
    k_rope = _rope_key(p, x, positions, cfg)
    k_nope = _proj(c_kv, p["w_uk"])
    v = _proj(c_kv, p["w_uv"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:3], dr)], dim=-1)
    o = sdpa(q, k, v, causal_offset=0, scale=1.0 / math.sqrt(dn + dr),
             use_kernel=use_kernel, probs_dtype=_probs_dtype(cfg))
    return _out(o, p["wo"])


def mla_init_cache(cfg, batch: int, s_max: int, dtype, device) -> dict:
    return dict(
        c_kv=torch.zeros((batch, s_max, cfg.kv_lora_rank), dtype=dtype, device=device),
        k_rope=torch.zeros((batch, s_max, cfg.qk_rope_head_dim), dtype=dtype,
                           device=device),
    )


def mla_decode(
    p: dict,
    cache: dict,
    x: Tensor,  # [B, 1, D]
    position: Tensor,  # [B]
    cfg,
) -> tuple[dict, Tensor]:
    """Absorbed-form MLA decode; writes ``c_kv`` / ``k_rope`` at ``position``
    into ``cache`` in place and returns ``(cache, out [B, 1, D])``.

    score[t] = <W_uk^T q_nope, c_t> + <q_rope, k_rope_t>, in fp32
    out      = W_uv (sum_t p_t c_t)
    so the per-step work and cache traffic scale with r + dr, not H * dh."""
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    B = x.shape[0]
    q_nope, q_rope = _mla_q(p, x, position[:, None], cfg)  # [B, 1, H, *]
    bidx = torch.arange(B, device=x.device)
    pos = position.long()
    cache["c_kv"][bidx, pos] = (x @ p["w_dkv"])[:, 0]
    cache["k_rope"][bidx, pos] = _rope_key(p, x, position[:, None], cfg)[:, 0, 0]
    c_kv = cache["c_kv"].float()  # [B, T, r]
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], p["w_uk"])  # [B, H, r]
    scores = torch.bmm(q_lat.float(), c_kv.transpose(1, 2))
    scores += torch.bmm(q_rope[:, 0].float(), cache["k_rope"].float().transpose(1, 2))
    scores *= 1.0 / math.sqrt(dn + dr)
    T = c_kv.shape[1]
    valid = torch.arange(T, device=x.device)[None, :] < (position + 1)[:, None]
    scores.masked_fill_(~valid[:, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    o_lat = torch.bmm(probs, c_kv)  # [B, H, r]
    o = torch.einsum("bhr,rhk->bhk", o_lat, p["w_uv"].float())
    out = _out(o.to(x.dtype), p["wo"])[:, None]
    return cache, out
