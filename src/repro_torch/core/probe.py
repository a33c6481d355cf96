"""PROBE — the paper's deterministic reverse-push (Alg. 2), port of ``repro.core.probe``.

* ``probe_prefix_reference`` / ``estimate_walk_reference`` — literal
  Algorithm 2 for one walk prefix / one walk (host loops; the oracle that
  reproduces the paper's worked example).
* ``probe_walks_telescoped`` — the batched form.  One PROBE push level is
  the linear operator T_p(s) = mask_{u_{p-1}}(M s) with
  M[v, x] = sqrt(c)/|I(v)| for x in I(v), so Alg. 1's per-walk sum of
  per-prefix probes telescopes into l - 1 pushes per walk:

      sum_{i=2..l} (T_2 ∘ ... ∘ T_i)(e_{u_i})
        = T_2( e_{u_2} + T_3( e_{u_3} + ... T_l(e_{u_l}) ... ) )

  A batch of B walks is a score matrix S[n + 1, B] (row n = sentinel dump
  row), one batched push per level.
* ``probe_tree_levels`` — Alg. 3 prefix-tree batching + telescoping.

Pruning rule 2 is a per-level threshold: an entry at position p faces p - 1
more pushes, each scaling by <= sqrt(c), so entries with
``score * sqrt(c)^(p-1) <= eps_p`` are dropped.

With an ``EllGraph`` and ``use_kernel`` (the default) every push is the
ELL-SpMM op (``kernels/spmm_ell``) over each row's ``in_deg`` slots: its
CUDA kernel on the card, its plain version on the CPU.  A COO ``Graph`` pushes through ``push_coo``.
"""
from __future__ import annotations

import torch

from repro_torch.graph.structs import (
    EllGraph,
    Graph,
    push_coo,
    push_ell,
    push_ell_padded,
)

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# One push level
# ---------------------------------------------------------------------------


def push_level(
    g: Graph | EllGraph,
    scores: Tensor,
    sqrt_c: float,
    *,
    use_kernel: bool = True,
) -> Tensor:
    """new[v] = sqrt(c)/|I(v)| * sum_{x in I(v)} scores[x];  scores [n] or [n,B]."""
    w = g.inv_in_deg * sqrt_c
    if isinstance(g, EllGraph):
        if use_kernel:
            from repro_torch.kernels.spmm_ell.ops import spmm_ell

            return spmm_ell(g.in_nbrs, scores, w, row_len=g.in_deg)
        return push_ell(g, scores, weights=w)
    return push_coo(g, scores, weights=w)


def push_level_padded(
    g: Graph | EllGraph,
    scores: Tensor,
    sqrt_c: float,
    *,
    use_kernel: bool = True,
) -> Tensor:
    """One push level on an [n + 1, B] score buffer with a baked dump row.

    Row n is the sentinel dump row: scatter writes addressed by sentinel
    walk positions land there between pushes.  The row is zeroed before the
    gather, so sentinel neighbor slots read an exact zero, and a fresh
    [n + 1, B] buffer with a zero dump row is returned.
    """
    n = g.n
    w = g.inv_in_deg * sqrt_c
    scores = scores.clone()
    scores[n] = 0.0
    if isinstance(g, EllGraph):
        if use_kernel:
            from repro_torch.kernels.spmm_ell.ops import spmm_ell_padded

            out = spmm_ell_padded(g.in_nbrs, scores, w, row_len=g.in_deg)
        else:
            out = push_ell_padded(g, scores, weights=w)
    else:
        out = push_coo(g, scores[:n], weights=w)
    return torch.cat([out, out.new_zeros((1,) + tuple(out.shape[1:]))], dim=0)


# ---------------------------------------------------------------------------
# Reference: literal Algorithm 2
# ---------------------------------------------------------------------------


def probe_prefix_reference(
    g: Graph | EllGraph,
    prefix,
    sqrt_c: float,
    eps_p: float = 0.0,
) -> Tensor:
    """Deterministic PROBE of one partial walk ``prefix`` = (u_1, ..., u_i).

    Returns Score [n] = first-meeting probability of every v w.r.t. prefix
    (host loop — oracle only).
    """
    prefix = [int(x) for x in torch.as_tensor(prefix).reshape(-1).tolist()]
    i = len(prefix)
    scores = torch.zeros(g.n, dtype=torch.float32, device=g.device)
    scores[prefix[i - 1]] = 1.0
    for j in range(i - 1):
        if eps_p > 0.0:
            # rule applies before descending from H_j: score * sqrt_c^(i-j-1)
            thresh = eps_p / (sqrt_c ** (i - j - 1))
            scores = torch.where(scores > thresh, scores, torch.zeros_like(scores))
        scores = push_level(g, scores, sqrt_c, use_kernel=False)
        # exclusion: no score lands on u_{i-j-1}
        scores[prefix[i - j - 2]] = 0.0
    return scores


def estimate_walk_reference(
    g: Graph | EllGraph,
    walk,
    sqrt_c: float,
    eps_p: float = 0.0,
) -> Tensor:
    """s~_k for one walk (Alg. 1 inner loop): sum of probes over prefixes."""
    walk = torch.as_tensor(walk).reshape(-1)
    live = int((walk < g.n).sum())
    total = torch.zeros(g.n, dtype=torch.float32, device=g.device)
    for i in range(2, live + 1):
        total = total + probe_prefix_reference(g, walk[:i], sqrt_c, eps_p)
    return total


# ---------------------------------------------------------------------------
# Telescoped batched probe
# ---------------------------------------------------------------------------


def probe_walks_telescoped(
    g: Graph | EllGraph,
    walks: Tensor,  # int32 [B, max_len], sentinel = n
    *,
    sqrt_c: float,
    eps_p: float = 0.0,
    max_len: int | None = None,
    use_kernel: bool = True,
) -> Tensor:
    """Batched telescoped probe.  Returns per-walk estimates [n, B].

    Column k equals  sum_{i=2..l_k} Score(., W_k(u, i))  — the complete
    inner loop of Algorithm 1 for walk k.
    """
    n = g.n
    walks = walks.to(g.device)
    b, length = walks.shape
    if max_len is not None:
        length = max_len
    cols = torch.arange(b, device=g.device)
    ones = torch.ones(b, dtype=torch.float32, device=g.device)
    scores = torch.zeros((n + 1, b), dtype=torch.float32, device=g.device)
    for p in range(length, 1, -1):  # 1-indexed walk positions L .. 2
        u_p = walks[:, p - 1].long()  # sentinel n -> dump row
        u_prev = walks[:, p - 2].long()
        scores = scores.index_put((u_p, cols), ones, accumulate=True)
        if eps_p > 0.0:
            thresh = eps_p / (sqrt_c ** (p - 1))
            scores = torch.where(scores > thresh, scores, torch.zeros_like(scores))
        scores = push_level_padded(g, scores, sqrt_c, use_kernel=use_kernel)
        scores[u_prev, cols] = 0.0  # exclusion; sentinel writes hit the dump row
    return scores[:n]


def probe_tree_levels(
    g: Graph | EllGraph,
    level_nodes,  # per depth d: int32 [W_d] graph node ids
    level_weights,  # per depth d: float32 [W_d] (walk counts)
    level_parent,  # per depth d: int32 [W_d] parent col at d-1
    level_parent_node,  # per depth d: int32 [W_d] parent graph node
    *,
    sqrt_c: float,
    eps_p: float = 0.0,
    use_kernel: bool = True,
) -> Tensor:
    """Batch algorithm (paper Alg. 3) + telescoping over the prefix tree.

    Levels are ordered deepest-first; depth 0 entries are the children of
    the root (position 2 in walk coordinates).  Each level: inject weights,
    prune, push, mask at the parent's graph node, then merge children
    columns into parent columns.  Returns the summed estimate vector [n]
    (divide by n_r outside).
    """
    n = g.n
    dev = g.device

    def as_t(x, dtype):
        return torch.as_tensor(x, device=dev).to(dtype)

    carry = None  # [n, W_d] for the current deepest level
    for d in range(len(level_nodes) - 1, -1, -1):
        nodes = as_t(level_nodes[d], torch.int64)
        wts = as_t(level_weights[d], torch.float32)
        w_cols = nodes.shape[0]
        cols = torch.arange(w_cols, device=dev)
        inject = torch.zeros((n, w_cols), dtype=torch.float32, device=dev)
        inject.index_put_(
            (nodes.clamp(0, n - 1), cols),
            torch.where(nodes < n, wts, torch.zeros_like(wts)),
            accumulate=True,
        )
        scores = inject if carry is None else carry + inject
        if eps_p > 0.0:
            # position p = d + 2 -> p + 1 pushes remain; pruning the summed
            # column at the per-walk threshold is the conservative side
            thresh = eps_p / (sqrt_c ** (d + 1))
            scores = torch.where(scores > thresh, scores, torch.zeros_like(scores))
        scores = push_level(g, scores, sqrt_c, use_kernel=use_kernel)
        # mask at the parent's graph node, per column
        pn = as_t(level_parent_node[d], torch.int64)
        ok = pn < n
        rows = pn.clamp(0, n - 1)
        scores[rows, cols] = torch.where(
            ok, torch.zeros_like(wts), scores[rows, cols]
        )
        # merge into parent columns
        if d > 0:
            w_parent = len(level_nodes[d - 1])
            carry = torch.zeros((n, w_parent), dtype=torch.float32, device=dev)
            carry.index_add_(1, as_t(level_parent[d], torch.int64), scores)
        else:
            carry = scores.sum(dim=1, keepdim=True)
    return carry[:, 0]
