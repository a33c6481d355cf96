"""Pooling evaluation (paper §6.2) — the billion-edge effectiveness protocol,
port of ``repro.core.pooling``.

When ground truth is unobtainable (Power Method needs O(n^2)), merge the
top-k candidates returned by all competing systems into a pool, score every
pooled node with a high-precision single-pair Monte Carlo "expert"
(:func:`~repro_torch.core.montecarlo.mc_pool_scores`), and take the best k
pooled nodes as the reference ranking.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.metrics import kendall_tau, ndcg_at_k, precision_at_k
from repro_torch.core.montecarlo import mc_pool_scores
from repro_torch.graph.structs import EllGraph


def build_pool(candidate_lists: dict[str, np.ndarray]) -> np.ndarray:
    """Union of every system's top-k lists, duplicates removed."""
    pool = np.unique(np.concatenate([np.asarray(v) for v in candidate_lists.values()]))
    return pool.astype(np.int32)


def pooled_ground_truth(
    gen: torch.Generator,
    eg: EllGraph,
    u: int,
    pool: np.ndarray,
    k: int,
    *,
    expert_r: int = 10_000,
    max_len: int = 24,
    sqrt_c: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Expert-scored pool -> (best-k nodes, full per-pool-node scores)."""
    scores = mc_pool_scores(
        gen, eg, int(u), np.asarray(pool, dtype=np.int32),
        r=expert_r, max_len=max_len, sqrt_c=sqrt_c,
    ).cpu().numpy()
    order = np.argsort(-scores, kind="stable")
    return pool[order[:k]], scores


def evaluate_with_pool(
    gen: torch.Generator,
    eg: EllGraph,
    u: int,
    candidate_lists: dict[str, np.ndarray],
    k: int,
    *,
    expert_r: int = 10_000,
    sqrt_c: float,
    max_len: int = 24,
) -> dict[str, dict[str, float]]:
    """Precision@k / NDCG@k / Kendall tau for every system against the pool."""
    pool = build_pool(candidate_lists)
    best_k, pool_scores = pooled_ground_truth(
        gen, eg, u, pool, k, expert_r=expert_r, max_len=max_len, sqrt_c=sqrt_c
    )
    # full-graph score lookup (0 outside the pool: those were never returned)
    truth = np.zeros(eg.n, dtype=np.float64)
    truth[pool] = pool_scores
    out = {}
    for name, nodes in candidate_lists.items():
        nodes = np.asarray(nodes)[:k]
        out[name] = dict(
            precision=precision_at_k(nodes, best_k),
            ndcg=ndcg_at_k(nodes, truth, best_k),
            kendall=kendall_tau(nodes, truth),
        )
    return out
