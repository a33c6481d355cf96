"""Effectiveness under churn: pooled ground-truth checkpoints on the
frozen live window (paper §6.2 protocol, ``core/pooling.py``; port of
``repro.streams.churn``).

When the graph churns faster than any exact oracle can follow, quality is
judged the way the paper judges billion-edge runs: freeze the live
window, pool the candidates returned by the system under test together
with a fresh-rebuild scout (a from-scratch session over the frozen
window, so the pool contains whatever a non-stale system would have
found), score the pool with the high-precision Monte Carlo expert, and
report precision@k / NDCG of the served answers against the expert's
best-k.  A stale or under-budgeted server scores low because the scout
put the right candidates in the pool.

Randomness: the expert's draws for served query i come from the generator
``make_generator(derive_seed(seed, i), device)``, the port's counterpart of
the reference's ``fold_in(key, i)``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.api.handle import GraphHandle
from repro_torch.api.session import SimRankSession
from repro_torch.api.spec import QuerySpec
from repro_torch.core.pooling import evaluate_with_pool
from repro_torch.core.walks import derive_seed, make_generator

__all__ = ["churn_checkpoint", "frozen_window_handle"]


def _pow2(x: int) -> int:
    return 1 << max(0, int(np.ceil(np.log2(max(1, x)))))


def frozen_window_handle(
    src: np.ndarray, dst: np.ndarray, n: int, *, device="cuda"
) -> GraphHandle:
    """A from-scratch handle over the frozen window on ``device``, with
    pow-2 rounded capacity / k_max (the reference's shapes)."""
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    k_max = int(np.bincount(dst, minlength=n).max()) + 1 if len(dst) else 1
    return GraphHandle.from_edges(
        src, dst, n,
        capacity=_pow2(max(len(src), 16)),
        k_max=_pow2(k_max),
        device=device,
    )


def churn_checkpoint(
    seed: int,
    src: np.ndarray,
    dst: np.ndarray,
    n: int,
    served: dict[int, np.ndarray],
    k: int,
    *,
    sqrt_c: float,
    expert_r: int = 2_000,
    fresh_budget: int = 2_048,
    max_len: int = 16,
    c: float | None = None,
    device="cuda",
) -> dict:
    """Pooled effectiveness of ``served`` top-k lists on one frozen window.

    ``served`` maps query node -> the top-k node ids the live system
    answered with (through whatever transport it serves).  Returns mean
    precision@k / NDCG over the queries plus the mean pool size.  The
    frozen window, the scout and the expert run on ``device``.
    """
    if not served:
        raise ValueError("churn_checkpoint needs at least one served query")
    handle = frozen_window_handle(src, dst, n, device=device)
    cc = c if c is not None else sqrt_c * sqrt_c
    scout = SimRankSession(
        handle, c=cc, top_k=min(k, n - 1), seed=7, batch_q=len(served),
    )
    tickets = {
        u: scout.submit(QuerySpec(
            kind="topk", node=int(u), k=k, budget_walks=fresh_budget,
        ))
        for u in served
    }
    scout.drain()
    prec, ndcg, pools = [], [], []
    for i, (u, nodes) in enumerate(sorted(served.items())):
        fresh = np.asarray(tickets[u].envelope.topk_nodes)[:k]
        out = evaluate_with_pool(
            make_generator(derive_seed(seed, i), device),
            handle.eg,
            int(u),
            {"stream": np.asarray(nodes)[:k], "fresh": fresh},
            k,
            expert_r=expert_r,
            sqrt_c=sqrt_c,
            max_len=max_len,
        )
        prec.append(out["stream"]["precision"])
        ndcg.append(out["stream"]["ndcg"])
        pools.append(len(np.union1d(np.asarray(nodes)[:k], fresh)))
    return dict(
        queries=len(served),
        live_edges=int(len(src)),
        precision_at_k=float(np.mean(prec)),
        ndcg_at_k=float(np.mean(ndcg)),
        pool_size=float(np.mean(pools)),
    )
