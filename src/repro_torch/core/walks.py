"""Vectorized sqrt(c)-walk generation (paper Def. 3), port of ``repro.core.walks``.

A sqrt(c)-walk from u follows a uniformly random **in**-neighbor at each step
and terminates with probability 1 - sqrt(c) per step (or at a node with no
in-neighbors).  A batch of walks is a dense int32 matrix
``walks[n_r, max_len]`` with ``walks[:, 0] = u`` and sentinel ``n`` after
termination.  Walks are truncated at ``max_len`` = l_t (Pruning rule 1).

Randomness is split in two, as in the JAX package:

* ``walk_uniforms`` draws every (walk, step) uniform from one explicit
  ``torch.Generator``;
* ``walks_from_uniforms`` turns given uniforms into walks,
  ``next = in_nbrs[v, floor(pick * deg(v))]`` with the product taken in
  float32.  Given the JAX package's ``(cont, pick)`` it returns the JAX
  package's walks bit for bit — the seam the parity tests use, since torch
  and JAX draw different numbers from the same seed.

Query q's walks depend only on its own generator, so a batch equals Q
separate calls with the same per-query generators.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graph.structs import EllGraph

Tensor = torch.Tensor


def derive_seed(seed: int, *path: int) -> int:
    """The seed of stream ``path`` under ``seed`` (63-bit, collision-free in
    practice): how sessions, batches, walk chunks and escalation rounds split
    one seed.  ``SeedSequence`` hashes each int as its 32-bit words, so
    ``derive_seed(s, a, b)`` equals no ``derive_seed(s, i)`` with i < 2^32."""
    state = np.random.SeedSequence(
        [int(seed), *(int(i) for i in path)]
    ).generate_state(1, np.uint64)[0]
    return int(state) & ((1 << 63) - 1)


def make_generator(seed: int, device) -> torch.Generator:
    """A fresh generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen


def walk_uniforms(
    gen: torch.Generator,
    *,
    n_r: int,
    max_len: int,
    sqrt_c: float,
    device=None,
) -> tuple[Tensor, Tensor]:
    """Draw the per-(walk, step) randomness for ``n_r`` walks up front.

    Returns ``(cont, pick)``, both [n_r, max_len - 1]: the continue/stop
    coins (bool, continue w.p. sqrt(c)) and the neighbor-pick uniforms
    (float32), drawn on the generator's device unless ``device`` says
    otherwise.
    """
    dev = gen.device if device is None else torch.device(device)
    shape = (n_r, max_len - 1)
    cont = torch.rand(shape, generator=gen, device=dev) < sqrt_c
    pick = torch.rand(shape, generator=gen, device=dev)
    return cont, pick


def walks_from_uniforms(eg: EllGraph, u, cont: Tensor, pick: Tensor) -> Tensor:
    """Materialize walks [R, max_len] from pre-drawn uniforms.

    ``u`` is one source node or an int tensor [R] of per-row sources.
    """
    n = eg.n
    dev = eg.device
    r = cont.shape[0]
    cont = cont.to(dev)
    pick = pick.to(dev, torch.float32)
    u_col = torch.as_tensor(u, dtype=torch.int32, device=dev).expand(r)
    cols = [u_col]
    cur = u_col
    alive = torch.ones(r, dtype=torch.bool, device=dev)
    for t in range(cont.shape[1]):
        row = cur.clamp(0, n - 1).long()
        deg = eg.in_deg[row]
        alive = alive & cont[:, t] & (deg > 0)
        k = torch.floor(pick[:, t] * deg.to(torch.float32)).to(torch.int32)
        k = torch.minimum(k.clamp(min=0), (deg - 1).clamp(min=0))
        nxt = eg.in_nbrs[row, k.long()]
        cur = torch.where(alive, nxt, torch.full_like(nxt, n))
        cols.append(cur)
    return torch.stack(cols, dim=1).to(torch.int32)


def sample_walks(
    gen: torch.Generator,
    eg: EllGraph,
    u,
    *,
    n_r: int,
    max_len: int,
    sqrt_c: float,
) -> Tensor:
    """Sample ``n_r`` sqrt(c)-walks from node ``u`` with one generator.

    Returns int32 [n_r, max_len]; walks[:, 0] == u; sentinel = n.
    """
    cont, pick = walk_uniforms(
        gen, n_r=n_r, max_len=max_len, sqrt_c=sqrt_c, device=eg.device
    )
    return walks_from_uniforms(eg, u, cont, pick)


def batch_uniforms(
    gens, *, n_r: int, max_len: int, sqrt_c: float, device
) -> tuple[Tensor, Tensor]:
    """Per-query uniforms stacked to [Q, n_r, max_len - 1], one generator each."""
    draws = [
        walk_uniforms(g, n_r=n_r, max_len=max_len, sqrt_c=sqrt_c, device=device)
        for g in gens
    ]
    return (
        torch.stack([c for c, _ in draws]),
        torch.stack([p for _, p in draws]),
    )


def sample_walks_batch(
    gens,
    eg: EllGraph,
    us,
    *,
    n_r: int,
    max_len: int,
    sqrt_c: float,
) -> Tensor:
    """Sample ``n_r`` walks from each of Q sources, one generator per query.

    ``gens`` is a sequence of Q generators; ``us`` int [Q].  Returns int32
    [Q, n_r, max_len].  All Q pools are materialized in one pass.
    """
    us = torch.as_tensor(us, dtype=torch.int32, device=eg.device).reshape(-1)
    q = us.shape[0]
    cont, pick = batch_uniforms(
        gens, n_r=n_r, max_len=max_len, sqrt_c=sqrt_c, device=eg.device
    )
    walks = walks_from_uniforms(
        eg,
        us.repeat_interleave(n_r),
        cont.reshape(q * n_r, -1),
        pick.reshape(q * n_r, -1),
    )
    return walks.reshape(q, n_r, max_len)


def walk_lengths(walks: Tensor, n: int) -> Tensor:
    """Number of live nodes per walk (l in the paper)."""
    return (walks < n).sum(dim=-1).to(torch.int32)
