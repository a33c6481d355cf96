"""Power Method for SimRank (Jeh & Widom) — the exact oracle, port of
``repro.core.power``.

The correct formulation (paper Eq. 10):  S = (c P^T S P) v I  with the
element-wise maximum against I, iterated from S = I.  O(n^2) memory — the
paper uses 55 iterations for 1e-12 accuracy on its four small datasets.

The JAX package builds a dense ``P`` and runs two dense ``[n, n]``
products an iteration.  At HepPh size (n = 34,546) that is about 1.65e14
flop an iteration (computed), so here ``P^T`` is a sparse CSR matrix built
from the live COO edges and an iteration is two sparse-times-dense
products: ``X = P^T S`` and ``P^T X^T``, which is ``P^T S P`` because S
stays symmetric.  S >= 0, so ``maximum(S, I)`` is a clamp of the diagonal
to at least 1, done in place.  Peak memory is about three ``[n, n]``
float32 buffers.  TF32 would spoil the oracle: no product here runs on
the tensor cores.

Also provides the *truncated* power method single-source row, which is
exactly the accuracy envelope of the TopSim family (paper §2.3: TopSim-SM's
estimate equals the Power Method with T iterations, error up to c^T).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.graph.structs import Graph

Tensor = torch.Tensor


def _transition_t(g: Graph) -> Tensor:
    """``P^T`` as CSR: row v holds 1/|I(v)| at column x for every live edge
    x -> v (parallel edges sum), on the graph's device."""
    n, m = g.n, g.num_edges
    src = g.src[:m].long()
    dst = g.dst[:m].long()
    vals = g.inv_in_deg[dst]
    with warnings.catch_warnings():  # torch warns that sparse CSR is "beta"
        warnings.filterwarnings("ignore", "Sparse", UserWarning)
        coo = torch.sparse_coo_tensor(torch.stack([dst, src]), vals, (n, n))
        return coo.coalesce().to_sparse_csr()


def simrank_power(g: Graph, *, c: float = 0.6, iters: int = 55) -> Tensor:
    """All-pairs SimRank S [n, n] float32 by the Power Method."""
    n = g.n
    pt = _transition_t(g)
    s = torch.eye(n, dtype=torch.float32, device=g.device)
    for _ in range(iters):
        x = torch.sparse.mm(pt, s)  # P^T S
        del s
        s = torch.sparse.mm(pt, x.T)  # P^T (P^T S)^T = P^T S P
        del x
        s.mul_(c)
        s.diagonal().clamp_(min=1.0)
    return s


def simrank_power_host(
    src: np.ndarray, dst: np.ndarray, n: int, *, c: float = 0.6, iters: int = 55
) -> np.ndarray:
    """Numpy variant for host-side test fixtures (a copy of the JAX
    package's)."""
    A = np.zeros((n, n), dtype=np.float64)
    np.add.at(A, (src, dst), 1.0)
    in_deg = A.sum(axis=0)
    P = A / np.maximum(in_deg[None, :], 1.0)
    S = np.eye(n)
    for _ in range(iters):
        S = np.maximum(c * (P.T @ S @ P), np.eye(n))
    return S


def simrank_truncated_single_source(
    g: Graph, u: int, *, c: float = 0.6, iters: int = 3
) -> Tensor:
    """s_T(u, .) [n] — Power Method truncated at T iterations (TopSim
    accuracy).

    This is the estimate quality of TopSim-SM with walk depth T (paper §2.3);
    the absolute error can reach c^T (= 0.216 at T=3, c=0.6), which is the
    effect the paper's Figure 4 demonstrates.
    """
    return simrank_power(g, c=c, iters=iters)[int(u)].clone()
