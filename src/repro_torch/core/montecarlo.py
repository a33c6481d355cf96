"""Monte Carlo SimRank baselines (Fogaras & Racz; paper §2.2), port of
``repro.core.montecarlo``.

* ``mc_single_pair`` — estimate s(u, v) by sampling r pairs of
  sqrt(c)-walks and counting meets.  r >= 1/(2 eps^2) ln(2/delta) gives
  |err| <= eps w.p. 1-delta.
* ``mc_pool_scores`` — the pooling "expert": single-pair scores of u
  against every node of a pool.
* ``mc_single_source`` — the index-free MC baseline the paper compares
  against: one walk from *every* node per trial, s(u, v) estimated as the
  meet frequency between u's walk i and v's walk i (the unbiased coupling
  used in [6]).  The trials run together as an ``[r, n]`` state.

Each entry point draws from one ``torch.Generator``; each has a
``*_from_uniforms`` form that takes the draws instead, the seam the tests
feed the JAX package's uniforms through (as ``core/walks.py`` does).
"""
from __future__ import annotations

from collections.abc import Callable

import torch

from repro_torch.core.walks import walk_uniforms, walks_from_uniforms
from repro_torch.graph.structs import EllGraph

Tensor = torch.Tensor
Uniforms = tuple[Tensor, Tensor]  # (cont, pick) of core.walks.walk_uniforms


def _meet_rate(wu: Tensor, wv: Tensor, n: int) -> Tensor:
    """Fraction of the walk pairs (rows, last dim = position) that meet.
    Means here multiply by the float32 reciprocal of the count, as XLA's
    compiled mean does, so they equal the JAX package's bit for bit."""
    same = (wu == wv) & (wu < n)
    meets = same.any(dim=-1).to(torch.float32)
    return meets.sum(dim=-1) * (1.0 / meets.shape[-1])


def mc_single_pair_from_uniforms(
    eg: EllGraph, u: int, v: int, uni_u: Uniforms, uni_v: Uniforms
) -> Tensor:
    """s(u, v) from the r walk pairs the given uniforms make."""
    wu = walks_from_uniforms(eg, u, *uni_u)
    wv = walks_from_uniforms(eg, v, *uni_v)
    return _meet_rate(wu, wv, eg.n)


def mc_single_pair(
    gen: torch.Generator,
    eg: EllGraph,
    u: int,
    v: int,
    *,
    r: int,
    max_len: int,
    sqrt_c: float,
) -> Tensor:
    """Estimate s(u, v) from r independent sqrt(c)-walk pairs."""
    kw = dict(n_r=r, max_len=max_len, sqrt_c=sqrt_c, device=eg.device)
    uni_u = walk_uniforms(gen, **kw)
    uni_v = walk_uniforms(gen, **kw)
    return mc_single_pair_from_uniforms(eg, u, v, uni_u, uni_v)


def mc_pool_scores_from_uniforms(
    eg: EllGraph, u: int, pool: Tensor, uni_u: Uniforms, uni_pool: Uniforms,
    *, batch: int = 64,
) -> Tensor:
    """Pool scores [P] from u's uniforms ([r, L-1] each) and the pool's
    ([P, r, L-1] each), ``batch`` pool nodes' walks at a time."""
    wu = walks_from_uniforms(eg, u, *uni_u)
    pool = torch.as_tensor(pool, dtype=torch.int32, device=eg.device).reshape(-1)
    cont, pick = uni_pool
    r = cont.shape[1]
    out = []
    for a in range(0, pool.shape[0], batch):
        vs = pool[a : a + batch]
        b = vs.shape[0]
        wv = walks_from_uniforms(
            eg, vs.repeat_interleave(r), cont[a : a + b].reshape(b * r, -1),
            pick[a : a + b].reshape(b * r, -1),
        ).reshape(b, r, -1)
        out.append(_meet_rate(wu[None], wv, eg.n))
    return torch.cat(out) if out else torch.zeros(0, device=eg.device)


def mc_pool_scores(
    gen: torch.Generator,
    eg: EllGraph,
    u: int,
    pool,
    *,
    r: int,
    max_len: int,
    sqrt_c: float,
    batch: int = 64,
) -> Tensor:
    """Single-pair MC scores s(u, v) [P] for every v in the pool (the
    'expert'); ``batch`` bounds how many pool nodes' walks exist at once."""
    pool = torch.as_tensor(pool, dtype=torch.int32, device=eg.device).reshape(-1)
    kw = dict(max_len=max_len, sqrt_c=sqrt_c, device=eg.device)
    uni_u = walk_uniforms(gen, n_r=r, **kw)
    cont, pick = walk_uniforms(gen, n_r=pool.shape[0] * r, **kw)
    return mc_pool_scores_from_uniforms(
        eg, u, pool, uni_u,
        (cont.reshape(-1, r, max_len - 1), pick.reshape(-1, r, max_len - 1)),
        batch=batch,
    )


def _single_source_meets(
    eg: EllGraph, u: int, wu: Tensor,
    draw: Callable[[int], tuple[Tensor, Tensor]], sqrt_c: float,
) -> Tensor:
    """The MC single-source estimate [n]: trial t pairs u's walk ``wu[t]``
    with one walk from every node, stepped together as an [r, n] state;
    ``draw(p)`` gives step p's continue uniforms and pick uniforms [r, n]."""
    n = eg.n
    r, steps = wu.shape
    cur = torch.arange(n, dtype=torch.int32, device=eg.device).expand(r, n)
    meet = torch.zeros((r, n), dtype=torch.bool, device=eg.device)
    alive = torch.ones((r, n), dtype=torch.bool, device=eg.device)
    for p in range(steps):
        up = wu[:, p : p + 1]
        meet |= alive & (cur == up) & (up < n)
        cont_u, pick = draw(p)
        row = cur.clamp(0, n - 1).long()
        deg = eg.in_deg[row]
        alive = alive & (cont_u < sqrt_c) & (deg > 0)
        k = torch.floor(pick * deg.to(torch.float32)).to(torch.int32)
        k = torch.minimum(k.clamp(min=0), (deg - 1).clamp(min=0))
        nxt = eg.in_nbrs[row, k.long()]
        cur = torch.where(alive, nxt, torch.full_like(nxt, n))
    est = meet.to(torch.float32).sum(dim=0) * (1.0 / r)
    est[u] = 1.0
    return est


def mc_single_source_from_uniforms(
    eg: EllGraph, u: int, uni_u: Uniforms, cont_u: Tensor, pick: Tensor,
    *, sqrt_c: float,
) -> Tensor:
    """The MC single-source estimate from u's walk uniforms ([r, L-1] each)
    and the per-trial uniforms of the walks from every node: ``cont_u``
    (continue iff < sqrt_c) and ``pick``, float32 [r, L, n]."""
    wu = walks_from_uniforms(eg, u, *uni_u)
    cont_u = cont_u.to(eg.device)
    pick = pick.to(eg.device)
    return _single_source_meets(
        eg, u, wu, lambda p: (cont_u[:, p], pick[:, p]), sqrt_c
    )


def mc_single_source(
    gen: torch.Generator,
    eg: EllGraph,
    u: int,
    *,
    r: int,
    max_len: int,
    sqrt_c: float,
) -> Tensor:
    """MC single-source baseline: walks from ALL nodes; s~(u, v) [n].

    Memory/time O(n * r): this is the 'considerable query overhead' method
    the paper improves on — implemented for the Figure-4 comparison.  Each
    step's [r, n] uniforms are drawn when the step runs.
    """
    n = eg.n
    uni_u = walk_uniforms(gen, n_r=r, max_len=max_len, sqrt_c=sqrt_c,
                          device=eg.device)
    wu = walks_from_uniforms(eg, u, *uni_u)

    def draw(_p):
        return (torch.rand((r, n), generator=gen, device=eg.device),
                torch.rand((r, n), generator=gen, device=eg.device))

    return _single_source_meets(eg, u, wu, draw, sqrt_c)
