"""Reverse-reachability prefix tree (paper Alg. 3), host-side builder.

A copy of ``repro.core.tree`` (numpy; pinned equal by
``tests/test_torch_graph.py``).

Batches the n_r sampled walks by deduplicating shared prefixes.  The device
consumes the tree as per-depth padded arrays (static shapes), processed
deepest-first by ``probe_tree_levels`` — one batched SpMM per depth with
column width = (padded) number of distinct prefixes at that depth, which is
typically far below n_r at shallow depths (bounded by |I(u)| at depth 0).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class PrefixTree:
    # per depth d (walk position p = d + 2):
    nodes: list[np.ndarray]  # int32 [W_d] graph node of the prefix end
    weights: list[np.ndarray]  # float32 [W_d] #walks sharing the prefix
    parent: list[np.ndarray]  # int32 [W_d] column index at depth d-1 (0 at d=0)
    parent_node: list[np.ndarray]  # int32 [W_d] graph node of the parent prefix end
    n_r: int
    total_columns: int


def _pad(arr: np.ndarray, width: int, fill) -> np.ndarray:
    out = np.full(width, fill, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


def build_prefix_tree(
    walks: np.ndarray, n: int, pad_to: int = 8
) -> PrefixTree:
    """Build the dedup tree from walks [n_r, L] (sentinel = n)."""
    walks = np.asarray(walks)
    n_r, L = walks.shape
    nodes, weights, parents, parent_nodes = [], [], [], []
    prev_index: dict[bytes, int] = {}  # prefix(<=p_len-1) bytes -> column id
    total = 0
    for p_len in range(2, L + 1):
        alive = walks[:, p_len - 1] < n
        if not alive.any():
            break
        rows = walks[alive, :p_len].astype(np.int32)
        uniq, counts = np.unique(rows, axis=0, return_counts=True)
        W = uniq.shape[0]
        node_d = uniq[:, -1].astype(np.int32)
        pnode_d = uniq[:, -2].astype(np.int32)
        if p_len == 2:
            par_d = np.zeros(W, dtype=np.int32)
        else:
            par_d = np.array(
                [prev_index[uniq[i, : p_len - 1].tobytes()] for i in range(W)],
                dtype=np.int32,
            )
        prev_index = {uniq[i].tobytes(): i for i in range(W)}
        width = max(pad_to, ((W + pad_to - 1) // pad_to) * pad_to)
        nodes.append(_pad(node_d, width, n))
        weights.append(_pad(counts.astype(np.float32), width, 0.0))
        parents.append(_pad(par_d, width, 0))
        parent_nodes.append(_pad(pnode_d, width, n))
        total += W
    return PrefixTree(
        nodes=nodes,
        weights=weights,
        parent=parents,
        parent_node=parent_nodes,
        n_r=n_r,
        total_columns=total,
    )


def tree_stats(tree: PrefixTree) -> dict:
    widths = [int((w > 0).sum()) for w in tree.weights]
    return dict(
        depths=len(widths),
        widths=widths,
        total_columns=tree.total_columns,
        dedup_ratio=(
            sum(int(w.sum()) for w in tree.weights) / max(tree.total_columns, 1)
        ),
    )
