"""What every entry shares: the error budget and the configuration's graph.

A configuration states its size (``n``, ``m``), its error guarantee
(``c``, ``eps_a``, ``delta``) and its degree law (``graph``: the model,
its ``alpha`` and the in-degree cap ``max_deg``).  The graph is made on
the device from the seed and holds exactly ``m`` edges; a run stops
before its window if it does not.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench import traffic
from portbench.graphgen import zipf_graph
from portbench.reference import simrank as ref


def budget(n: int, c: float, eps_a: float, delta: float) -> dict:
    """The error budget (paper Thm 1-2, split 1/2, 1/4, 1/4 over sampling,
    pruning and truncation): walks ``n_r``, walk length ``max_len``, prune
    threshold ``eps_p``."""
    sqrt_c = math.sqrt(c)
    eps = eps_a * 0.5
    eps_t = 2.0 * eps_a * 0.25
    return dict(
        sqrt_c=sqrt_c,
        eps_p=eps_a * 0.25 * (1.0 - sqrt_c) / (1.0 + eps),
        n_r=int(math.ceil(3.0 * c / eps**2 * math.log(n / delta))),
        max_len=max(2, int(math.ceil(math.log(eps_t) / math.log(sqrt_c)))),
    )


def make_graph(cfg: dict, seed: int, device) -> dict:
    """The configuration's graph from ``seed``: host edge lists ``src_h`` /
    ``dst_h`` (int32, draw order), ``m``, and ``candidates`` (the nodes
    with an in-neighbour, which queries start from)."""
    g, n, m = cfg["graph"], cfg["n"], cfg["m"]
    gen = torch.Generator(device=device)
    gen.manual_seed(traffic.walk_seed(seed, traffic.GRAPH))
    out = zipf_graph(n, m, alpha=g["alpha"], max_deg=g["max_deg"], gen=gen)
    if out["m"] != m:
        raise RuntimeError(f"{cfg['name']}: the graph holds {out['m']} edges, "
                           f"the configuration states {m}")
    src_h = out["src"].cpu().numpy().astype(np.int32)
    dst_h = out["dst"].cpu().numpy().astype(np.int32)
    deg = np.bincount(dst_h, minlength=n)
    return dict(src_h=src_h, dst_h=dst_h, m=out["m"],
                candidates=np.flatnonzero(deg >= 1))


def device_edges(src, dst, device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.as_tensor(np.asarray(src), dtype=torch.int64, device=device),
            torch.as_tensor(np.asarray(dst), dtype=torch.int64, device=device))


def reference_graph(graph: dict, n: int, device) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """The reference's own in-CSR of ``make_graph``'s edge list, with the
    edges on ``device``."""
    src, dst = device_edges(graph["src_h"], graph["dst_h"], device)
    return ref.in_csr(src, dst, n), src, dst
