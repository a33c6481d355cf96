"""Mixture-of-Experts FFN with shared experts, DeepSeek-V2 / Qwen-MoE style
(port of ``repro.models.transformer.moe``).

Sort-based capacity dispatch, as in the reference: the token->expert
assignments are sorted by expert id (stably), ranked within their expert's
group and dropped past the capacity C.  Expert weights are stacked
``[E, ...]`` and the three expert products are batched matmuls.  Every
shape is static (no ``nonzero``, no boolean-mask indexing, no ``.item()``),
so the step runs on ``meta`` in a dry-run and makes no host sync on the card.

Two things differ in form from the reference, not in result:

* **The ``[E, C]`` buffers are gathered, not scattered.**  The reference
  writes every assignment with ``.set`` and clips a dropped one's rank to
  ``C - 1``, so in an expert whose group is larger than C the dropped
  assignments write the sentinel T onto the slot of the token kept at rank
  ``C - 1``.  With jax on the CPU the last of those duplicate writes wins, so
  such an expert keeps only ``C - 1`` tokens, while its gate buffer (an
  ``.add`` of zeros for the dropped ones) keeps the gate at ``C - 1``.
  Neither XLA nor ``index_put_`` on the card defines which duplicate wins.
  Here slot ``(e, r)`` reads the sorted assignment at ``group_start[e] + r``
  when ``r`` is below the group's size and C, and slot ``C - 1`` of every
  overflowing expert reads the sentinel: the reference's CPU result, with no
  duplicate write.
* **The combine has no atomics.**  Each kept (token, k) pair owns one slot,
  so each token gathers its K expert rows through a ``[T, K]`` slot map (the
  zero row for a dropped pair) and sums them in k order in the experts'
  dtype.  An ``index_add_`` would add in a different order from run to run
  on the card; this way two runs are bitwise equal.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

import repro_torch.models.common as cm

Tensor = torch.Tensor


def _normal(gen: torch.Generator | None, shape: tuple, dtype, scale: float) -> Tensor:
    """N(0, 1) drawn in fp32, cast to ``dtype``, times ``scale`` (the
    reference's order); a ``meta`` tensor without a generator."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    w = torch.randn(shape, generator=gen, device=gen.device).to(dtype)
    return w * scale


def init_moe(gen: torch.Generator | None, cfg, dtype) -> dict:
    """The router (fp32 whatever ``dtype`` is), the stacked experts
    ``w_gate`` / ``w_up`` ``[E, d, f]`` and ``w_down`` ``[E, f, d]``, and the
    shared experts' SwiGLU at width ``d_ff_shared or n_shared * d_ff_expert``."""
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff_expert, m.n_routed
    p = dict(
        router=cm.dense_init(gen, d, E, torch.float32),
        w_gate=_normal(gen, (E, d, f), dtype, d**-0.5),
        w_up=_normal(gen, (E, d, f), dtype, d**-0.5),
        w_down=_normal(gen, (E, f, d), dtype, f**-0.5),
    )
    shared_w = m.d_ff_shared or m.n_shared * m.d_ff_expert
    if shared_w:
        p["shared"] = dict(
            w_gate=cm.dense_init(gen, d, shared_w, dtype),
            w_up=cm.dense_init(gen, d, shared_w, dtype),
            w_down=cm.dense_init(gen, shared_w, d, dtype),
        )
    return p


def _capacity(tokens: int, cfg) -> int:
    m = cfg.moe
    c = int(tokens * m.top_k / m.n_routed * m.capacity_factor)
    return max(8, (c + 7) // 8 * 8)


def dispatch(top_i: Tensor, top_p: Tensor, E: int, C: int):
    """The sort-based dispatch of ``top_i`` / ``top_p`` ``[T, K]``.

    Returns ``buf`` ``[E, C]`` (token ids, T for an empty or dropped slot),
    ``gate_buf`` ``[E, C]`` fp32, ``slot`` ``[T, K]`` (``e * C + rank`` of a
    pair whose row reaches the output, ``E * C`` otherwise) and ``count``
    ``[E]`` (assignments per expert, dropped ones included)."""
    T, K = top_i.shape
    dev = top_i.device
    e_flat = top_i.reshape(-1)
    sort_idx = torch.argsort(e_flat, stable=True)  # the reference relies on a stable sort
    e_sorted = e_flat[sort_idx]
    experts = torch.arange(E, device=dev)
    group_start = torch.searchsorted(e_sorted, experts)
    count = torch.searchsorted(e_sorted, experts, right=True) - group_start
    # slot (e, r) reads sorted assignment group_start[e] + r
    ranks = torch.arange(C, device=dev)
    src = (group_start[:, None] + ranks[None, :]).clamp_(max=T * K - 1)  # [E, C]
    filled = ranks[None, :] < count[:, None].clamp(max=C)
    pos = sort_idx[src]  # flat (token, k) index of each slot
    # the gates of every filled slot, slot C - 1 of an overflowing expert
    # included (the reference adds 0 for its dropped assignments) ...
    gate_buf = torch.where(filled, top_p.reshape(-1)[pos], 0.0)
    # ... but that slot's token row is the sentinel's
    live = filled.clone()
    live[:, C - 1] &= count <= C
    buf = torch.where(live, pos // K, T)
    # the slot map: each sorted assignment's slot, put back in (token, k) order
    rank = torch.arange(T * K, device=dev) - group_start[e_sorted]
    slot_sorted = e_sorted * C + rank
    reach = (rank < C) & ~((rank == C - 1) & (count[e_sorted] > C))
    slot_sorted = torch.where(reach, slot_sorted, E * C)
    slot = torch.empty_like(slot_sorted).scatter_(0, sort_idx, slot_sorted)
    return buf, gate_buf, slot.view(T, K), count


def moe_forward(p: dict, x: Tensor, cfg) -> tuple[Tensor, Tensor]:
    """x: [B, S, D] -> (out [B, S, D], aux_loss fp32 scalar)."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    K = m.top_k
    E = m.n_routed
    C = _capacity(T, cfg)
    xf = x.reshape(T, D)

    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, K, dim=-1)  # [T, K]
    if m.norm_topk_prob:
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)

    buf, gate_buf, slot, count = dispatch(top_i, top_p, E, C)
    xa = torch.cat([xf, xf.new_zeros((1, D))], dim=0)  # sentinel T -> zero row
    xe = xa[buf]  # [E, C, D]
    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"])  # [E, C, D]
    ye = ye * gate_buf[..., None].to(ye.dtype)

    rows = torch.cat([ye.reshape(E * C, D), ye.new_zeros((1, D))], dim=0)
    out = rows[slot[:, 0]]
    for k in range(1, K):
        out = out + rows[slot[:, k]]
    out = out.view(B, S, D)

    if "shared" in p:  # always-on shared experts
        sh = p["shared"]
        out = out + cm.swiglu(x, sh["w_gate"], sh["w_up"], sh["w_down"])

    # load-balance aux loss (Switch): E * sum_e f_e * P_e
    assign_frac = count.float() / T / K
    prob_frac = probs.mean(dim=0)
    aux = E * torch.sum(assign_frac * prob_frac) * m.router_aux_weight
    return out, aux

