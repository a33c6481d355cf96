"""Randomized PROBE (paper Alg. 4) — O(n) per level in expectation, port of
``repro.core.probe_random``.

Instead of deterministically pushing mass along every out-edge, every node x
samples ONE uniform in-edge (v, x); x enters the next frontier iff v is in
the current frontier and an independent Bernoulli(sqrt(c)) succeeds.  The
membership probability of v in the final frontier is exactly the
deterministic PROBE score (paper Lemma 5), so returning indicator scores
gives an unbiased Bernoulli estimator.

The per-node sampling is a dense vectorized operation over all n nodes
(gather one random in-neighbor per node from the ELL table + boolean
mask).  Prefixes of one walk are boolean columns stepped synchronously by
walk position, with independent randomness per prefix.  The JAX package
probes one walk at a time; here a chunk of W walks steps together as a
``[W, n, L-1]`` frontier, each walk drawing from its own generator.

Each entry point has a ``*_from_uniforms`` form that takes the draws
instead (the edge-pick uniforms, and the Bernoulli uniforms that succeed
iff < sqrt(c)), the seam the tests feed the JAX package's uniforms through.
"""
from __future__ import annotations

from collections.abc import Callable, Sequence

import torch

from repro_torch.graph.structs import EllGraph

Tensor = torch.Tensor


def _sample_in_nbrs(eg: EllGraph, edge_u: Tensor) -> Tensor:
    """One uniform in-neighbor of every node x per column: ``edge_u`` is
    [..., n, cols] (or [n]); returns the picked ids, sentinel n where x has
    no in-neighbor."""
    n, k_max = eg.n, eg.k_max
    deg = eg.in_deg if edge_u.dim() == 1 else eg.in_deg[:, None]
    k = torch.floor(edge_u * deg.to(torch.float32)).to(torch.int32)
    k = torch.minimum(k.clamp(min=0), (deg - 1).clamp(min=0))
    rows = torch.arange(n, device=eg.device, dtype=torch.int64)
    if edge_u.dim() > 1:
        rows = rows[:, None]
    v = eg.in_nbrs.reshape(-1)[rows * k_max + k.long()]
    return torch.where(deg > 0, v, torch.full_like(v, n))


def randomized_probe_prefix_from_uniforms(
    eg: EllGraph, prefix: Sequence[int], edge_u: Tensor, bern_u: Tensor,
    *, sqrt_c: float,
) -> Tensor:
    """Algorithm 4 for one concrete prefix (u_1..u_i); ``edge_u`` and
    ``bern_u`` are float32 [i - 1, n].  Returns {0,1} scores [n]."""
    n = eg.n
    prefix = [int(x) for x in prefix]
    i = len(prefix)
    frontier = torch.zeros(n, dtype=torch.bool, device=eg.device)
    frontier[prefix[i - 1]] = True
    for j in range(i - 1):
        v = _sample_in_nbrs(eg, edge_u[j].to(eg.device))
        picked = frontier[v.clamp(0, n - 1).long()] & (v < n)
        frontier = picked & (bern_u[j].to(eg.device) < sqrt_c)
        frontier[prefix[i - j - 2]] = False  # u_{i-j-1} cannot enter
    return frontier.to(torch.float32)


def randomized_probe_prefix(
    gen: torch.Generator, eg: EllGraph, prefix: Sequence[int], *, sqrt_c: float
) -> Tensor:
    """Faithful Algorithm 4 for a single prefix; returns {0,1} scores [n]."""
    i = len(prefix)
    shape = (max(i - 1, 0), eg.n)
    edge_u = torch.rand(shape, generator=gen, device=eg.device)
    bern_u = torch.rand(shape, generator=gen, device=eg.device)
    return randomized_probe_prefix_from_uniforms(
        eg, prefix, edge_u, bern_u, sqrt_c=sqrt_c
    )


def _probe_walks(
    eg: EllGraph, walks: Tensor, draw: Callable[[int], tuple[Tensor, Tensor]],
    sqrt_c: float,
) -> Tensor:
    """All prefixes of W walks [W, L], stepped synchronously by position.

    Column i - 2 holds prefix i (i = 2..L): it activates at position i and
    steps down to position 1.  ``draw(s)`` gives step s's (position
    p = L - s) edge and Bernoulli uniforms, [W, n, L - 1] each.  Returns
    s~_k [W, n]: each walk's sum of per-prefix indicator scores.
    """
    n = eg.n
    w, length = walks.shape
    ncols = length - 1
    walks = walks.to(eg.device).long()
    frontier = torch.zeros((w, n, ncols), dtype=torch.bool, device=eg.device)
    cols = torch.arange(ncols, device=eg.device)
    lanes = torch.arange(w, device=eg.device)
    for s, p in enumerate(range(length, 1, -1)):
        u_p, u_prev = walks[:, p - 1], walks[:, p - 2]
        # activate column p-2 with e_{u_p} (a dead walk's sentinel: no-op)
        rows = u_p.clamp(0, n - 1)
        frontier[lanes, rows, p - 2] |= u_p < n
        edge_u, bern_u = draw(s)
        v = _sample_in_nbrs(eg, edge_u)  # [W, n, ncols]
        picked = torch.gather(frontier, 1, v.clamp(0, n - 1).long()) & (v < n)
        # only columns already active (i >= p) step; others stay empty
        frontier = picked & (bern_u < sqrt_c) & (cols >= p - 2)
        # exclusion at u_{p-1}
        rows = u_prev.clamp(0, n - 1)
        frontier[lanes, rows, :] &= (u_prev >= n)[:, None]
    return frontier.to(torch.float32).sum(dim=2)


def randomized_probe_walks_from_uniforms(
    eg: EllGraph, walks: Tensor, edge_u: Tensor, bern_u: Tensor,
    *, sqrt_c: float,
) -> Tensor:
    """Per-walk randomized scores [W, n] of walks [W, L] from the given
    uniforms, float32 [W, L - 1, n, L - 1] each (step s at [:, s])."""
    edge_u = edge_u.to(eg.device)
    bern_u = bern_u.to(eg.device)
    return _probe_walks(
        eg, walks, lambda s: (edge_u[:, s], bern_u[:, s]), sqrt_c
    )


def randomized_probe_walks(
    gens: Sequence[torch.Generator], eg: EllGraph, walks: Tensor,
    *, sqrt_c: float,
) -> Tensor:
    """Per-walk randomized scores [W, n] of walks [W, L]; walk w draws from
    ``gens[w]`` alone, so its scores do not depend on its chunk mates."""
    n, ncols = eg.n, walks.shape[1] - 1

    def draw(_s):
        edge = [torch.rand((n, ncols), generator=g, device=eg.device)
                for g in gens]
        bern = [torch.rand((n, ncols), generator=g, device=eg.device)
                for g in gens]
        return torch.stack(edge), torch.stack(bern)

    return _probe_walks(eg, walks, draw, sqrt_c)


def randomized_probe_walk(
    gen: torch.Generator, eg: EllGraph, walk: Tensor, *, sqrt_c: float
) -> Tensor:
    """All prefixes of one walk [L] (sentinel = n): s~_k [n], the sum of
    per-prefix indicator scores."""
    return randomized_probe_walks([gen], eg, walk[None], sqrt_c=sqrt_c)[0]
