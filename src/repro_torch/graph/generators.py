"""Synthetic graph generators (host-side, numpy).

A copy of ``repro.graph.generators`` (the port imports nothing of
``repro``; ``tests/test_torch_graph.py`` pins the two equal).  The paper's
SNAP/LAW datasets are replaced by synthetic graphs with matched (n, m, degree-skew): a discrete power-law
configuration model for the web/social graphs and Erdos-Renyi for controls.
Also ships the paper's Figure-1 toy graph, reconstructed exactly from the
running example in Section 3.2 (verified against Table 2 to 5e-4, which is
Table-2's own rounding).
"""
from __future__ import annotations

import numpy as np

TOY_NODES = "abcdefgh"

# Directed edges of the paper's Figure-1 toy graph.  All but one edge are
# forced by the worked PROBE example (scores 0.167/0.5/0.25/0.115/0.153/...);
# the remaining in-neighbor of b is pinned to `e` by matching Table 2 with
# the Power Method at c = 0.25.
TOY_EDGES = [
    ("a", "b"), ("a", "c"),
    ("b", "a"), ("b", "c"), ("b", "d"), ("b", "e"),
    ("c", "a"), ("c", "f"), ("c", "g"), ("c", "h"),
    ("d", "f"), ("d", "g"), ("d", "h"),
    ("e", "b"), ("e", "f"), ("e", "g"), ("e", "h"),
    ("g", "c"), ("g", "e"),
    ("h", "f"),
]

# Table 2 of the paper: SimRank of every node w.r.t. a, decay c = 0.25.
TOY_TABLE2 = {
    "a": 1.0, "b": 0.0096, "c": 0.049, "d": 0.131,
    "e": 0.070, "f": 0.041, "g": 0.051, "h": 0.051,
}


def toy_graph() -> tuple[np.ndarray, np.ndarray, int]:
    """The paper's Figure-1 graph as (src, dst, n)."""
    idx = {ch: i for i, ch in enumerate(TOY_NODES)}
    src = np.array([idx[s] for s, _ in TOY_EDGES], dtype=np.int32)
    dst = np.array([idx[d] for _, d in TOY_EDGES], dtype=np.int32)
    return src, dst, len(TOY_NODES)


def _dedupe(src: np.ndarray, dst: np.ndarray, n: int):
    """Remove self-loops and duplicate edges."""
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = src.astype(np.int64) * n + dst
    _, first = np.unique(key, return_index=True)
    first.sort()
    return src[first], dst[first]


def powerlaw_graph(
    n: int,
    m: int,
    seed: int = 0,
    alpha: float = 2.1,
    max_deg: int | None = None,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Directed power-law graph via a Zipf configuration model.

    Node popularity ~ Zipf(alpha); each edge picks (src, dst) independently
    from the popularity distribution (dst) and uniform (src), giving the
    heavy-tailed *in*-degree profile that dominates SimRank workloads
    (web graphs / social follows).  Self-loops and duplicates are dropped, so
    the realized m is slightly below the request.
    """
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n + 1, dtype=np.float64)
    probs = ranks ** (-alpha)
    probs /= probs.sum()
    perm = rng.permutation(n)  # decouple popularity from node id
    # oversample to compensate dedup loss
    m_try = int(m * 1.15) + 16
    dst = perm[rng.choice(n, size=m_try, p=probs)]
    src = rng.integers(0, n, size=m_try)
    src, dst = _dedupe(src.astype(np.int32), dst.astype(np.int32), n)
    if max_deg is not None:
        # clip in-degree at max_deg (keep first max_deg edges per dst)
        order = np.argsort(dst, kind="stable")
        dsts = dst[order]
        start = np.searchsorted(dsts, np.arange(n))
        within = np.arange(len(dsts)) - start[dsts]
        keep = order[within < max_deg]
        keep.sort()
        src, dst = src[keep], dst[keep]
    if len(src) > m:
        src, dst = src[:m], dst[:m]
    return src.astype(np.int32), dst.astype(np.int32), n


def erdos_renyi_graph(
    n: int, m: int, seed: int = 0
) -> tuple[np.ndarray, np.ndarray, int]:
    rng = np.random.default_rng(seed)
    m_try = int(m * 1.1) + 16
    src = rng.integers(0, n, size=m_try, dtype=np.int64)
    dst = rng.integers(0, n, size=m_try, dtype=np.int64)
    src, dst = _dedupe(src.astype(np.int32), dst.astype(np.int32), n)
    if len(src) > m:
        src, dst = src[:m], dst[:m]
    return src.astype(np.int32), dst.astype(np.int32), n


def bipartite_graph(
    n_users: int, n_items: int, m: int, seed: int = 0, alpha: float = 1.8
) -> tuple[np.ndarray, np.ndarray, int]:
    """User->item bipartite interaction graph (recsys retrieval example).

    Nodes [0, n_users) are users, [n_users, n_users+n_items) items.  Edges run
    both directions (u->i and i->u) so SimRank's in-neighbor recursion sees
    co-consumption structure.
    """
    rng = np.random.default_rng(seed)
    n = n_users + n_items
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    probs = ranks ** (-alpha)
    probs /= probs.sum()
    m_half = m // 2
    items = rng.choice(n_items, size=int(m_half * 1.2) + 16, p=probs) + n_users
    users = rng.integers(0, n_users, size=len(items))
    u, i = _dedupe(users.astype(np.int32), items.astype(np.int32), n)
    if len(u) > m_half:
        u, i = u[:m_half], i[:m_half]
    src = np.concatenate([u, i])
    dst = np.concatenate([i, u])
    return src.astype(np.int32), dst.astype(np.int32), n


# Synthetic stand-ins for the paper's datasets (Table 3) at their published
# (n, m); ``paper_dataset(name, scale)`` down-scales them.
PAPER_DATASETS = {
    # name: (n, m, kind)   -- small graphs (ground truth via Power Method)
    "wiki-vote": (7_155, 103_689, "powerlaw"),
    "hepth": (9_877, 25_998, "er"),
    "as": (26_475, 106_762, "powerlaw"),
    "hepph": (34_546, 421_578, "powerlaw"),
    # large graphs, CPU-scaled by default factor in loaders
    "livejournal": (4_847_571, 68_993_773, "powerlaw"),
    "it-2004": (41_291_594, 1_150_725_436, "powerlaw"),
    "twitter": (41_652_230, 1_468_365_182, "powerlaw"),
    "friendster": (68_349_466, 2_586_147_869, "powerlaw"),
}


def paper_dataset(
    name: str, scale: float = 1.0, seed: int = 0
) -> tuple[np.ndarray, np.ndarray, int]:
    """Synthetic stand-in for a paper dataset, optionally down-scaled."""
    n, m, kind = PAPER_DATASETS[name]
    n = max(int(n * scale), 64)
    m = max(int(m * scale), 256)
    if kind == "er":
        return erdos_renyi_graph(n, m, seed=seed)
    return powerlaw_graph(n, m, seed=seed)
