"""TSF baseline (Shao et al., PVLDB'15) — two-stage random-walk framework,
port of ``repro.core.tsf``.

Index stage: R_g "one-way graphs", each sampling ONE in-neighbor per node
(a functional pointer array).  Query stage: walks inside a one-way graph are
deterministic pointer chases; each one-way graph is reused R_q times for the
query-side randomness.

Faithful to the paper's description *including its two known biases* (which
ProbeSim's §2.3 criticizes and our experiments reproduce):

1. it estimates  sum_i Pr[walks meet at step i]  — an over-estimate of
   s(u, v) = Pr[first meet] when walks can meet multiple times;
2. it assumes one-way-graph walks are acyclic, which fails on cyclic/
   undirected graphs.

The index is a dense [R_g, n] int32 array — the "two-to-three orders of
magnitude larger than the graph" space cost shows up naturally.  The JAX
package gathers it from ``in_nbrs`` broadcast to [R_g, n, K] (R_g x 4.77 GB
at HepPh size if materialized); here it is gathered as ``in_nbrs[v, k[g,
v]]`` directly.  The query stage runs every one-way graph and query walk
together: the candidate walks of graph g do not depend on the query walk,
so step i counts, for each v, the query walks of g standing where v's walk
stands (a histogram of the query walks' positions, gathered at v's).

Each entry point has a ``*_from_uniforms`` form that takes the draws
instead, the seam the tests feed the JAX package's uniforms through.
"""
from __future__ import annotations

import torch

from repro_torch.graph.structs import EllGraph

Tensor = torch.Tensor


def _pick(eg: EllGraph, nodes: Tensor, uni: Tensor) -> Tensor:
    """A uniform in-neighbor of each node (sentinel n for a sentinel node or
    one without in-neighbors), ``floor(uni * deg)`` in float32."""
    n = eg.n
    rows = nodes.clamp(0, n - 1).long()
    deg = eg.in_deg[rows]
    k = torch.floor(uni * deg.to(torch.float32)).to(torch.int32)
    k = torch.minimum(k.clamp(min=0), (deg - 1).clamp(min=0))
    nxt = eg.in_nbrs.reshape(-1)[rows * eg.k_max + k.long()]
    return torch.where((nodes < n) & (deg > 0), nxt, torch.full_like(nxt, n))


def build_oneway_index_from_uniforms(eg: EllGraph, uni: Tensor) -> Tensor:
    """One-way graphs from uniforms [R_g, n]: nxt[g, v] = sampled in-neighbor
    of v (sentinel n if none), int32."""
    v = torch.arange(eg.n, dtype=torch.int32, device=eg.device)
    return _pick(eg, v.expand(uni.shape[0], -1), uni.to(eg.device)).to(torch.int32)


def build_oneway_index(gen: torch.Generator, eg: EllGraph, *, r_g: int) -> Tensor:
    """R_g one-way graphs: nxt[g, v] = sampled in-neighbor (sentinel n if none)."""
    uni = torch.rand((r_g, eg.n), generator=gen, device=eg.device)
    return build_oneway_index_from_uniforms(eg, uni)


def tsf_single_source_from_uniforms(
    index: Tensor, eg: EllGraph, u: int, uni: Tensor, *, c: float
) -> Tensor:
    """TSF single-source estimate [n] from the query walks' uniforms
    ``uni`` [R_g, R_q, t]: query walk q of one-way graph g takes its step i
    with ``uni[g, q, i]``."""
    n = eg.n
    r_g, r_q, t = uni.shape
    uni = uni.to(eg.device)
    index = index.to(eg.device)
    u_cur = torch.full((r_g, r_q), int(u), dtype=torch.int32, device=eg.device)
    v_cur = torch.arange(n, dtype=torch.int32, device=eg.device).expand(r_g, n)
    gid = torch.arange(r_g, device=eg.device)[:, None]
    score = torch.zeros(n, dtype=torch.float32, device=eg.device)
    for i in range(t):
        u_cur = _pick(eg, u_cur, uni[:, :, i])
        v_idx = v_cur.clamp(0, n - 1).long()
        v_cur = torch.where(v_cur < n, index[gid, v_idx],
                            torch.full_like(v_cur, n))
        # hist[g, w]: query walks of graph g at node w (row n: ended walks)
        hist = torch.zeros((r_g, n + 1), dtype=torch.int32, device=eg.device)
        hist.scatter_add_(1, u_cur.long(), torch.ones_like(u_cur))
        hist[:, n] = 0
        meets = hist.gather(1, v_cur.long()).sum(dim=0)  # [n], exact counts
        score += meets.to(torch.float32) * (c ** (i + 1.0))
    est = score / (r_g * r_q)
    est[int(u)] = 1.0
    return est


def tsf_single_source(
    gen: torch.Generator,
    index: Tensor,
    eg: EllGraph,
    u: int,
    *,
    r_q: int,
    t: int,
    c: float,
) -> Tensor:
    """TSF single-source estimate [n].

    For each one-way graph: chase u's walk r_q times with fresh query-side
    randomness (u's walk re-samples in-neighbors; the candidate side v
    follows the one-way pointers deterministically).  Meeting at step i
    contributes c^i (the over-estimating sum over i).
    """
    uni = torch.rand((index.shape[0], r_q, t), generator=gen, device=eg.device)
    return tsf_single_source_from_uniforms(index, eg, u, uni, c=c)
