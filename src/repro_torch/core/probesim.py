"""ProbeSim single-source & top-k drivers (paper Alg. 1 + Alg. 3 + §4),
port of ``repro.core.probesim``.

Variants (all estimate the same unbiased quantity):

* ``reference``   — literal Alg. 1/2, host loops (oracle; small inputs).
* ``telescoped``  — the fused serve path (default): the Q = 1 case of
                    ``core.multisource.multi_source``.
* ``tree``        — Alg. 3 prefix-tree batching + telescoping, per walk
                    chunk.
* ``auto``        — per chunk, the tree when walks share prefixes enough
                    (dedup ratio >= 1.5), else the telescoped batch.
* ``randomized``  — Alg. 4 Bernoulli probes, O(n) per level; a chunk of
                    walks steps together (``core.probe_random``).

Each walk chunk and each query draws from its own generator, seeded from
``seed`` by ``derive_seed``; the randomized variant draws its walk pool
from ``derive_seed(seed, 0)`` and walk k's Bernoulli probes from
``derive_seed(seed, 10_000 + k)``, as the JAX package folds its key.
"""
from __future__ import annotations

import torch

from repro_torch.core.multisource import multi_source, topk_rows
from repro_torch.core.params import ProbeSimParams, make_params
from repro_torch.core.probe import (
    estimate_walk_reference,
    probe_tree_levels,
    probe_walks_telescoped,
)
from repro_torch.core.probe_random import randomized_probe_walks
from repro_torch.core.tree import build_prefix_tree, tree_stats
from repro_torch.core.walks import derive_seed, make_generator, sample_walks
from repro_torch.graph.structs import EllGraph, Graph

Tensor = torch.Tensor


def _walk_chunks(n_r: int, chunk: int) -> list[int]:
    return [min(chunk, n_r - a) for a in range(0, n_r, chunk)]


def single_source(
    seed: int,
    g: Graph | EllGraph,
    eg: EllGraph,
    u: int,
    params: ProbeSimParams,
    *,
    variant: str = "telescoped",
    walk_chunk: int = 512,
    use_kernel: bool = True,
) -> Tensor:
    """Approximate single-source SimRank: returns estimates [n] (entry u = 1).

    ``g`` is the push representation (COO or ELL), ``eg`` the ELL table used
    for walk sampling (they may be the same object).
    """
    n = eg.n
    dev = eg.device
    sqrt_c = params.sqrt_c
    total = torch.zeros(n, dtype=torch.float32, device=dev)

    if variant == "telescoped":
        return multi_source(
            seed, g, eg, [u], params, lanes=walk_chunk, use_kernel=use_kernel,
        )[0]
    if variant == "reference":
        walks = sample_walks(
            make_generator(derive_seed(seed, 0), dev), eg, u,
            n_r=params.n_r, max_len=params.max_len, sqrt_c=sqrt_c,
        )
        for k in range(params.n_r):
            total = total + estimate_walk_reference(
                g, walks[k], sqrt_c, eps_p=params.eps_p
            )
    elif variant in ("tree", "auto"):
        for ci, b in enumerate(_walk_chunks(params.n_r, walk_chunk)):
            walks = sample_walks(
                make_generator(derive_seed(seed, ci), dev), eg, u,
                n_r=b, max_len=params.max_len, sqrt_c=sqrt_c,
            )
            tree = build_prefix_tree(walks.cpu().numpy(), n)
            if not tree.nodes:  # every walk terminated at u immediately
                continue
            if variant == "auto" and tree_stats(tree)["dedup_ratio"] < 1.5:
                total = total + probe_walks_telescoped(
                    g, walks, sqrt_c=sqrt_c, eps_p=params.eps_p,
                    use_kernel=use_kernel,
                ).sum(dim=1)
                continue
            total = total + probe_tree_levels(
                g, tree.nodes, tree.weights, tree.parent, tree.parent_node,
                sqrt_c=sqrt_c, eps_p=params.eps_p, use_kernel=use_kernel,
            )
    elif variant == "randomized":
        walks = sample_walks(
            make_generator(derive_seed(seed, 0), dev), eg, u,
            n_r=params.n_r, max_len=params.max_len, sqrt_c=sqrt_c,
        )
        for a in range(0, params.n_r, walk_chunk):
            b = min(a + walk_chunk, params.n_r)
            gens = [make_generator(derive_seed(seed, 10_000 + k), dev)
                    for k in range(a, b)]
            total = total + randomized_probe_walks(
                gens, eg, walks[a:b], sqrt_c=sqrt_c
            ).sum(dim=0)
    else:
        raise ValueError(f"unknown variant {variant!r}")

    est = total / params.n_r
    if params.truncation_shift:
        est = torch.where(est > 0, est + params.eps_t / 2, est)
    est[u] = 1.0
    return est


def topk(
    seed: int,
    g: Graph | EllGraph,
    eg: EllGraph,
    u: int,
    k: int,
    params: ProbeSimParams,
    **kwargs,
) -> tuple[Tensor, Tensor]:
    """Approximate top-k query (paper Def. 2): (nodes [k], estimates [k])."""
    est = single_source(seed, g, eg, u, params, **kwargs)
    us = torch.tensor([u], device=est.device)
    idx, vals = topk_rows(est[None, :], us, k)
    return idx[0], vals[0]


def single_source_simple(
    seed: int,
    eg,
    u: int,
    *,
    n: int | None = None,
    c: float = 0.6,
    eps_a: float = 0.1,
    delta: float = 0.01,
    **kwargs,
) -> Tensor:
    """DEPRECATED convenience wrapper — prefer a ``GraphHandle``.

    The legacy form takes a bare ``EllGraph`` and silently uses it as BOTH
    the push and the gather representation (i.e. it is exactly
    ``single_source(seed, eg, eg, u, ...)`` — correct, but it forfeits the
    COO push mirror without saying so).  Pass a
    :class:`repro_torch.api.GraphHandle` instead and the mirror choice is
    explicit: the handle's COO ``g`` pushes, its ELL ``eg`` gathers.
    """
    from repro_torch.api.handle import GraphHandle  # local: core <-> api layering

    if isinstance(eg, GraphHandle):
        params = make_params(n or eg.n, c=c, eps_a=eps_a, delta=delta)
        return single_source(seed, eg.g, eg.eg, u, params, **kwargs)
    import warnings

    warnings.warn(
        "single_source_simple(eg) uses the ELL table as both the push and "
        "gather mirror; pass a repro_torch.api.GraphHandle (explicit mirrors) "
        "or call single_source / SimRankSession.query directly",
        DeprecationWarning,
        stacklevel=2,
    )
    params = make_params(n or eg.n, c=c, eps_a=eps_a, delta=delta)
    return single_source(seed, eg, eg, u, params, **kwargs)
