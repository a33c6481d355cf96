"""Evaluation metrics for single-source / top-k SimRank (paper §6).

A copy of ``repro.core.metrics`` (numpy; pinned equal by
``tests/test_torch_baselines.py``).
"""
from __future__ import annotations

import numpy as np


def abs_error(est: np.ndarray, truth: np.ndarray, exclude: int | None = None) -> float:
    """AbsError = max_v |s(u,v) - s~(u,v)| (paper §6.1), excluding u itself."""
    est = np.asarray(est, dtype=np.float64).copy()
    truth = np.asarray(truth, dtype=np.float64).copy()
    if exclude is not None:
        est[exclude] = truth[exclude]
    return float(np.abs(est - truth).max())


def precision_at_k(pred_nodes: np.ndarray, true_nodes: np.ndarray) -> float:
    """|V_k ∩ V'_k| / k."""
    k = len(true_nodes)
    return len(set(pred_nodes.tolist()) & set(true_nodes.tolist())) / max(k, 1)


def ndcg_at_k(
    pred_nodes: np.ndarray, truth_scores: np.ndarray, true_nodes: np.ndarray
) -> float:
    """NDCG@k with gains 2^s - 1 and log2(i+1) discounts (paper §6.1)."""
    k = len(pred_nodes)
    discounts = 1.0 / np.log2(np.arange(k) + 2.0)
    gains_pred = (2.0 ** truth_scores[pred_nodes] - 1.0) @ discounts
    gains_best = (2.0 ** truth_scores[true_nodes] - 1.0) @ discounts
    return float(gains_pred / gains_best) if gains_best > 0 else 1.0


def kendall_tau(
    pred_nodes: np.ndarray, truth_scores: np.ndarray
) -> float:
    """Kendall tau-b between the predicted order and the true-score order of
    the predicted set (the paper's tau_k over the returned list)."""
    s = truth_scores[pred_nodes]
    k = len(s)
    if k < 2:
        return 1.0
    concordant = discordant = 0
    for i in range(k):
        for j in range(i + 1, k):
            # predicted order says i ranks above j
            if s[i] > s[j]:
                concordant += 1
            elif s[i] < s[j]:
                discordant += 1
    total = k * (k - 1) / 2
    return float((concordant - discordant) / total) if total else 1.0
