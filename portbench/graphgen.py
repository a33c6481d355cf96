"""Seeded graphs made on the device: a Zipf configuration model.

The model is the one of ``repro_torch.graph.generators.powerlaw_graph``,
drawn with a torch generator on the run's device instead of numpy on the
host (51.7 s on the host at ``twitter32``, which every run would pay):

* destination popularity ~ Zipf(alpha) over a seeded permutation of the
  nodes, source uniform;
* self-loops dropped, then duplicates (the first draw of each pair kept);
* the first ``max_deg`` edges of each destination kept (draw order);
* draws go on, in rounds, until ``m`` edges are kept; the result is cut to
  exactly ``m``.

A round appends its draws to the edges kept so far and filters the whole
again, which keeps the same edges as filtering one long stream of draws.
Edges stay in draw order.  The same seed on the same device gives the same
graph; it does not match numpy's bit for bit.
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

MAX_ROUNDS = 64


def popularity_cdf(n: int, alpha: float, device) -> Tensor:
    """The Zipf(alpha) law over ranks 1..n as a float64 CDF [n]."""
    ranks = torch.arange(1, n + 1, dtype=torch.float64, device=device)
    probs = ranks.pow(-float(alpha))
    cdf = torch.cumsum(probs, 0)
    return cdf / cdf[-1]


def draw_dst(cdf: Tensor, perm: Tensor, count: int, gen: torch.Generator) -> Tensor:
    """``count`` destinations by popularity: rank by inverse CDF, node by
    the permutation."""
    u = torch.rand(count, dtype=torch.float64, device=cdf.device, generator=gen)
    rank = torch.searchsorted(cdf, u).clamp(max=cdf.numel() - 1)
    return perm[rank]


def first_of_runs(sorted_keys: Tensor) -> Tensor:
    """bool mask: the first element of each run of equal sorted keys."""
    first = torch.ones_like(sorted_keys, dtype=torch.bool)
    first[1:] = sorted_keys[1:] != sorted_keys[:-1]
    return first


def keep_edges(src: Tensor, dst: Tensor, n: int, max_deg: int) -> tuple[Tensor, Tensor]:
    """Drop self-loops, then repeats of a pair, then each destination's
    edges past its first ``max_deg``; the survivors in draw order."""
    keep = src != dst
    src, dst = src[keep], dst[keep]
    skey, order = torch.sort(src * n + dst, stable=True)
    pos, _ = torch.sort(order[first_of_runs(skey)])
    src, dst = src[pos], dst[pos]
    sdst, order = torch.sort(dst, stable=True)
    start = torch.searchsorted(sdst, sdst, right=False)
    within = torch.arange(sdst.numel(), device=src.device) - start
    pos, _ = torch.sort(order[within < max_deg])
    return src[pos], dst[pos]


def zipf_graph(n: int, m: int, *, alpha: float, max_deg: int,
               gen: torch.Generator) -> dict:
    """The graph of exactly ``m`` edges on ``gen``'s device: ``src``/``dst``
    int64 [m] in draw order, the popularity ``cdf`` and ``perm``, and ``m``.
    Raises when the law and the cap cannot hold ``m`` edges."""
    dev = gen.device
    perm = torch.randperm(n, device=dev, generator=gen)
    cdf = popularity_cdf(n, alpha, dev)
    src = torch.empty(0, dtype=torch.int64, device=dev)
    dst = torch.empty(0, dtype=torch.int64, device=dev)
    rate = 0.6  # kept edges per draw, updated from each round
    for _ in range(MAX_ROUNDS):
        need = m - src.numel()
        if need <= 0:
            break
        tries = min(int(math.ceil(1.1 * need / rate)), 4 * m) + 16
        new_dst = draw_dst(cdf, perm, tries, gen)
        new_src = torch.randint(0, n, (tries,), device=dev, generator=gen)
        had = src.numel()
        src, dst = keep_edges(torch.cat([src, new_src]), torch.cat([dst, new_dst]),
                              n, max_deg)
        rate = max((src.numel() - had) / tries, 1e-3)
    if src.numel() < m:
        raise RuntimeError(f"the Zipf({alpha}) law under the cap {max_deg} kept "
                           f"{src.numel()} of {m} edges in {MAX_ROUNDS} rounds")
    src, dst = src[:m], dst[:m]
    return dict(src=src, dst=dst, cdf=cdf, perm=perm, n=n, m=int(src.numel()))
