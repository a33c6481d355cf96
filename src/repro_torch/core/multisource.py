"""Fused multi-query ProbeSim serving path, port of ``repro.core.multisource``.

``multi_source`` answers a batch of Q single-source queries in one step:

* **query batching across lane columns** — Q queries share one [n + 1, W]
  score buffer; each query owns a contiguous block of W/Q lane columns, so
  every probe level is one kernel launch for the whole batch;
* **pooled walk sampling** — the entire walk pool (Q x n_r walks) is drawn
  at once, each query from its own generator;
* **compacted walk scheduling** — each lane column runs the telescoped
  probe of its own walk at its own position; a finished column deposits
  its estimate into a per-column accumulator and is refilled with the next
  walk of its query's pool, so push work is ``n_r * E[len - 1]`` column
  levels per query rather than ``n_r * (max_len - 1)``;
* **baked sentinel dump row** — buffers are [n + 1, W] with row n the dump
  row, so sentinel scatter/gather indices need no clipping;
* **epilogue** — per-query lane-block sum, 1/n_r, diagonal fix-up, top-k.

With ``use_kernel`` (the default) each level is one launch of the fused
lane-probe kernel (``kernels/lane_probe``) against the ELL table, each row
read up to its ``in_deg``, writing into two score buffers that take turns;
without it, the level is the JAX package's kernel-off composition (scatter
inject, ``push_level_padded``, scatter exclude) over the push graph ``g``.

The JAX package runs the level loop as a ``lax.while_loop``; here it is a
Python loop that reads the continue predicate (``lane_continue``) on the
host after every level — one small device-to-host read per level.  The JAX
package also pipelines pool sampling against the first level (an XLA
scheduling detail, bit-identical by construction); the port draws the whole
pool at once.

Randomness contract: query q's walks depend only on its own seed (or on
the uniforms injected through ``uniforms=``), so a batched call equals Q
single-query calls with the same per-query seeds.
"""
from __future__ import annotations

import torch

from repro_torch.core.params import ProbeSimParams
from repro_torch.core.probe import push_level_padded
from repro_torch.core.walks import (
    batch_uniforms,
    derive_seed,
    make_generator,
    walks_from_uniforms,
)
from repro_torch.graph.structs import EllGraph, Graph
from repro_torch.spans import span

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Lane-compaction helpers (the JAX package's, verbatim in torch)
# ---------------------------------------------------------------------------


def lane_columns(q: int, wq: int, device) -> tuple[Tensor, Tensor]:
    """Column ids [W] and the owning query of each lane column [W]."""
    cols = torch.arange(q * wq, device=device)
    return cols, (cols // wq).to(torch.int32)


def lane_max_steps(n_r: int, max_len: int) -> int:
    """Safety-net trip bound for the compacted loop (it exits early)."""
    return n_r * max_len + max_len + 8


def lane_continue(step: int, pos: Tensor, next_q: Tensor, *, n_r: int,
                  max_steps: int) -> bool:
    """Loop-continue predicate: walks in flight or pools undrained."""
    if step >= max_steps:
        return False
    return bool(((pos >= 1).any() | (next_q < n_r).any()).item())


def lane_refill(pos, widx, next_q, pool_len, qid, *, q, wq, n_r):
    """Finished-column detection plus sticky per-query refill from the pool.

    Pure [W]-vector arithmetic.  Returns ``(fin, pos, widx, next_q)``;
    ``fin`` marks the columns whose walk just finished (the level deposits
    their scores into ``total``).  Refill pulls walks from each query's
    pool partition in pool order.
    """
    w = q * wq
    fin = pos == 1
    pos = torch.where(fin, torch.zeros_like(pos), pos)
    idle = (pos == 0).to(torch.int32).reshape(q, wq)
    rank = (torch.cumsum(idle, dim=1, dtype=torch.int32) - idle).reshape(w)
    take = (pos == 0) & (rank < (n_r - next_q)[qid])
    new_widx = qid * n_r + torch.minimum(
        next_q[qid] + rank, torch.full_like(rank, n_r - 1)
    )
    widx = torch.where(take, new_widx, widx)
    pos = torch.where(take, pool_len[new_widx.long()], pos)
    next_q = next_q + take.to(torch.int32).reshape(q, wq).sum(dim=1, dtype=torch.int32)
    return fin, pos, widx, next_q


def lane_frontier(pool, widx, pos, sentinel: int):
    """Per-column ``(active, u_p, u_prev)`` at each column's own position;
    inactive columns get ``sentinel``."""
    active = pos >= 2
    wl = widx.long()
    sent = torch.full_like(pos, sentinel)
    u_p = torch.where(active, pool[wl, (pos - 1).clamp(min=0).long()], sent)
    u_prev = torch.where(active, pool[wl, (pos - 2).clamp(min=0).long()], sent)
    return active, u_p, u_prev


def lane_thresholds(pos, *, sqrt_c: float, eps_p: float):
    """Per-column prune threshold ``eps_p / sqrt(c)^(pos - 1)`` as [W] f32."""
    base = torch.tensor(sqrt_c, dtype=torch.float32, device=pos.device)
    return eps_p * torch.pow(base, (1 - pos).to(torch.float32))


# ---------------------------------------------------------------------------
# The fused serve step
# ---------------------------------------------------------------------------


def fused_serve(
    g: Graph | EllGraph,
    eg: EllGraph,
    us,
    *,
    seeds=None,
    uniforms: tuple[Tensor, Tensor] | None = None,
    n_r: int,
    lanes_q: int,
    max_len: int,
    sqrt_c: float,
    eps_p: float,
    eps_t: float,
    truncation_shift: bool,
    use_kernel: bool = True,
    top_k: int = 0,
    kernel_dtype: str = "float32",
):
    """One fused serve step: pool -> compacted probe -> estimates.

    ``seeds`` (Q ints) seed each query's walk generator; alternatively
    ``uniforms=(cont, pick)``, each ``[Q, n_r, max_len - 1]``, injects the
    draws (the seam the parity tests feed the JAX package's draws
    through).  ``kernel_dtype="bfloat16"`` stores the lane buffers in bf16
    on the kernel path (fp32 accumulation).  Returns ``(est, topk_idx,
    topk_vals)``; the top-k outputs are None when ``top_k == 0``.
    """
    dev = eg.device
    n = eg.n
    us = torch.as_tensor(us, dtype=torch.int32, device=dev).reshape(-1)
    q = int(us.shape[0])
    wq = int(lanes_q)
    w = q * wq
    cols, qid = lane_columns(q, wq, dev)
    dtype = (
        torch.bfloat16
        if (use_kernel and kernel_dtype == "bfloat16")
        else torch.float32
    )

    # --- walk pool: all Q x n_r walks at once -----------------------------
    with span("fused_serve.draw"):
        cont, pick = query_uniforms(q, seeds=seeds, uniforms=uniforms, n_r=n_r,
                                    max_len=max_len, sqrt_c=sqrt_c, device=dev)
        pool = walks_from_uniforms(
            eg,
            us.repeat_interleave(n_r),
            cont.reshape(q * n_r, max_len - 1),
            pick.reshape(q * n_r, max_len - 1),
        )  # [Q * n_r, max_len]
        pool_len = (pool < n).sum(dim=1).to(torch.int32)

    # --- one probe level: deposit + inject + prune + push + exclude -------
    if use_kernel:
        from repro_torch.kernels.lane_probe.ops import lane_probe_level

        ell = g if isinstance(g, EllGraph) else eg
        w_push = ell.inv_in_deg * sqrt_c
        spare = [torch.zeros((n + 1, w), dtype=dtype, device=dev)]

        def level_fn(scores, total, fin, u_p, u_prev, thr):
            # Two [n + 1, W] score buffers take turns: the level reads one
            # and writes rows [0, n) of the other, so row n of both stays
            # zero.  The deposit goes into total[:n] in place: each element
            # is read and rewritten by one thread only.
            out = spare.pop()
            lane_probe_level(
                ell.in_nbrs, w_push, scores, scores[:n], total[:n],
                fin, u_p, u_prev, thr, row_len=ell.in_deg,
                row0=0, tab0=0, n_live=n, prune=eps_p > 0.0,
                out=out[:n], tot=total[:n],
            )
            spare.append(scores)
            return out, total
    else:
        ones = torch.ones(w, dtype=dtype, device=dev)
        zero = torch.zeros((), dtype=dtype, device=dev)

        def level_fn(scores, total, fin, u_p, u_prev, thr):
            total = total + torch.where(fin[None, :], scores, zero)
            scores = torch.where(fin[None, :], zero, scores)
            scores = scores.index_put((u_p.long(), cols), ones, accumulate=True)
            if eps_p > 0.0:
                scores = torch.where(scores > thr[None, :], scores, zero)
            scores = push_level_padded(g, scores, sqrt_c, use_kernel=False)
            scores[u_prev.long(), cols] = 0.0  # exclusion mask
            return scores, total

    # --- compacted probe loop ---------------------------------------------
    # pos: current walk position per column (1/0 = finished/idle); widx:
    # walk id in the flattened pool; next_q: per-query pool cursor.
    max_steps = lane_max_steps(n_r, max_len)
    pos = torch.zeros(w, dtype=torch.int32, device=dev)
    widx = torch.zeros(w, dtype=torch.int32, device=dev)
    next_q = torch.zeros(q, dtype=torch.int32, device=dev)
    scores = torch.zeros((n + 1, w), dtype=dtype, device=dev)
    total = torch.zeros((n + 1, w), dtype=dtype, device=dev)
    step = 0
    while True:
        with span("fused_serve.level"):
            fin, pos, widx, next_q = lane_refill(
                pos, widx, next_q, pool_len, qid, q=q, wq=wq, n_r=n_r
            )
            active, u_p, u_prev = lane_frontier(pool, widx, pos, n)
            thr = lane_thresholds(pos, sqrt_c=sqrt_c, eps_p=eps_p)
            scores, total = level_fn(scores, total, fin, u_p, u_prev, thr)
            pos = torch.where(active, pos - 1, pos)
        step += 1
        with span("fused_serve.continue"):
            more = lane_continue(step, pos, next_q, n_r=n_r, max_steps=max_steps)
        if not more:
            break
    with span("fused_serve.epilogue"):
        # safety-net flush (no-op unless max_steps was hit)
        total = total + torch.where((pos == 1)[None, :], scores, torch.zeros_like(scores))

        # --- per-query segment reduction + epilogue -----------------------
        return serve_epilogue(
            total[:n].float().reshape(n, q, wq).sum(dim=2).T, us, n_r=n_r,
            eps_t=eps_t, truncation_shift=truncation_shift, top_k=top_k,
        )


def query_uniforms(q: int, *, seeds, uniforms, n_r: int, max_len: int,
                   sqrt_c: float, device) -> tuple[Tensor, Tensor]:
    """The walk draws of a Q-query batch, ``[Q, n_r, max_len - 1]`` each:
    drawn from one generator per seed on ``device``, or the injected
    ``uniforms=(cont, pick)`` moved there."""
    if uniforms is None:
        if seeds is None or len(seeds) != q:
            raise ValueError("fused_serve needs one seed per query")
        gens = [make_generator(s, device) for s in seeds]
        return batch_uniforms(
            gens, n_r=n_r, max_len=max_len, sqrt_c=sqrt_c, device=device
        )
    cont, pick = (torch.as_tensor(x).to(device) for x in uniforms)
    if tuple(cont.shape) != (q, n_r, max_len - 1):
        raise ValueError(
            f"uniforms must be [Q={q}, n_r={n_r}, {max_len - 1}], "
            f"got {tuple(cont.shape)}"
        )
    return cont, pick


def serve_epilogue(acc: Tensor, us: Tensor, *, n_r: int, eps_t: float,
                   truncation_shift: bool, top_k: int):
    """Per-query sums ``acc`` [Q, n] -> ``(est, topk_idx, topk_vals)``:
    1/n_r, the truncation shift, the diagonal fix-up and top-k (None when
    ``top_k == 0``)."""
    est = acc / n_r
    if truncation_shift:
        est = torch.where(est > 0, est + eps_t / 2, est)
    rows = torch.arange(est.shape[0], device=est.device)
    est[rows, us.long()] = 1.0
    if top_k > 0:
        idx, vals = topk_rows(est, us, top_k)
        return est, idx, vals
    return est, None, None


def topk_rows(est: Tensor, us: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """Top-k of each row of est [Q, n] with the query node excluded; ties
    break toward the lower node id (as ``lax.top_k`` does)."""
    masked = est.clone()
    masked[torch.arange(est.shape[0], device=est.device), us.long()] = -torch.inf
    vals, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    return idx[:, :k].to(torch.int32), vals[:, :k]


def query_seeds(seed: int | None, seeds, q: int) -> list[int]:
    """Per-query seeds: ``seeds`` as given, else Q streams split from ``seed``."""
    if seeds is not None:
        seeds = [int(s) for s in seeds]
        if len(seeds) != q:
            raise ValueError(f"{len(seeds)} seeds for {q} queries")
        return seeds
    if seed is None:
        raise ValueError("multi_source needs `seed` or per-query `seeds`")
    return [derive_seed(seed, i) for i in range(q)]


def _serve(seed, g, eg, us, params, *, lanes, use_kernel, kernel_dtype, n_r,
           seeds, uniforms, top_k):
    us = torch.as_tensor(us, dtype=torch.int32).reshape(-1)
    q = int(us.shape[0])
    return fused_serve(
        g, eg, us,
        seeds=None if uniforms is not None else query_seeds(seed, seeds, q),
        uniforms=uniforms,
        n_r=int(n_r or params.n_r),
        lanes_q=max(1, lanes // q),
        max_len=params.max_len,
        sqrt_c=params.sqrt_c,
        eps_p=params.eps_p,
        eps_t=params.eps_t,
        truncation_shift=params.truncation_shift,
        use_kernel=use_kernel,
        top_k=top_k,
        kernel_dtype=kernel_dtype,
    )


def multi_source(
    seed: int | None,
    g: Graph | EllGraph,
    eg: EllGraph,
    us,
    params: ProbeSimParams,
    *,
    lanes: int = 256,
    use_kernel: bool = True,
    kernel_dtype: str = "float32",
    n_r: int | None = None,
    seeds=None,
    uniforms: tuple[Tensor, Tensor] | None = None,
) -> Tensor:
    """Fused multi-query single-source SimRank: estimates [Q, n].

    ``g`` is the push representation (COO or ELL), ``eg`` the ELL table used
    for walk sampling.  ``lanes`` is the total lane-column width shared by
    the batch.  ``n_r`` overrides ``params.n_r``.  Pass per-query ``seeds``
    for batch-vs-serial determinism; otherwise ``seed`` is split into Q
    streams.  ``uniforms`` injects pre-drawn walk randomness instead.
    """
    est, _, _ = _serve(
        seed, g, eg, us, params, lanes=lanes, use_kernel=use_kernel,
        kernel_dtype=kernel_dtype, n_r=n_r, seeds=seeds, uniforms=uniforms,
        top_k=0,
    )
    return est


def multi_source_topk(
    seed: int | None,
    g: Graph | EllGraph,
    eg: EllGraph,
    us,
    k: int,
    params: ProbeSimParams,
    *,
    lanes: int = 256,
    use_kernel: bool = True,
    kernel_dtype: str = "float32",
    n_r: int | None = None,
    seeds=None,
    uniforms: tuple[Tensor, Tensor] | None = None,
) -> tuple[Tensor, Tensor]:
    """Fused batched top-k (paper Def. 2): (nodes [Q, k], estimates [Q, k]).

    The query node itself is excluded.
    """
    _, idx, vals = _serve(
        seed, g, eg, us, params, lanes=lanes, use_kernel=use_kernel,
        kernel_dtype=kernel_dtype, n_r=n_r, seeds=seeds, uniforms=uniforms,
        top_k=int(k),
    )
    return idx, vals
