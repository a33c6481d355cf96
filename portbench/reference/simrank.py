"""Plain reference of ProbeSim's single-source estimates (paper Alg. 1-2).

Written from the paper's definitions in plain PyTorch, with nothing of the
program imported.  It works out again, from the benchmark's own edge list
and walk seeds, everything the program derives:

* the in-neighbour order of every node, by a stable sort of the edge list
  on the destination;
* the walk draws: one torch generator per seed, ``cont`` (continue with
  probability sqrt(c)) then ``pick``, in the shape the entry draws them;
* the sqrt(c)-walks: step to in-neighbour ``floor(pick * deg)`` (the
  product in fp32), stop at a node with no in-neighbour or on a failed
  coin;
* the telescoped probe of each walk (w_0 = u, ..., w_{l-1}): for p = l down
  to 2, add 1 at w_{p-1}, zero every score at or under the prune threshold
  eps_p / sqrt(c)^(p-1) (when pruning), push ``s'(v) = sqrt(c) / deg(v) *
  sum over in-neighbours x of s(x)``, zero w_{p-2}; the walk's last vector
  is its estimate, and a query's estimate is the mean over its walks;
* top-k with the query node left out.

It computes in float64 (``dtype``), or stores each level's scores in
``store`` (bfloat16 for the control) with float32 sums.  Columns run in
lockstep from the longest walk down, so a level only touches the walks
still running.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

EDGE_CHUNK_BYTES = 1 << 29  # bytes of one gathered [edges, columns] block


def in_csr(src: Tensor, dst: Tensor, n: int) -> dict:
    """In-neighbour lists: ``indptr`` [n + 1], ``deg`` [n], ``nbrs`` [m]
    (int64), each row in edge-list order."""
    order = torch.argsort(dst, stable=True)
    deg = torch.bincount(dst, minlength=n)[:n]
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=src.device)
    torch.cumsum(deg, 0, out=indptr[1:])
    return dict(indptr=indptr, deg=deg, nbrs=src[order].long(), n=n)


def draw(seed: int, walks: int, steps: int, sqrt_c: float, device, *,
         steps_first: bool) -> tuple[Tensor, Tensor]:
    """The walk draws of one generator seeded ``seed``: ``cont`` (bool) and
    ``pick`` (fp32), returned as [walks, steps].  ``steps_first`` draws each
    as [steps, walks] (the production sampler's layout)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    shape = (steps, walks) if steps_first else (walks, steps)
    cont = torch.rand(shape, generator=gen, device=device) < sqrt_c
    pick = torch.rand(shape, generator=gen, device=device)
    if steps_first:
        return cont.T, pick.T
    return cont, pick


def walks_from(csr: dict, starts: Tensor, cont: Tensor, pick: Tensor,
               sentinel: int) -> Tensor:
    """Walks int64 [R, steps + 1] from ``starts`` [R]; ``sentinel`` after
    the walk ends."""
    n = csr["n"]
    cur = starts.long()
    alive = torch.ones_like(cur, dtype=torch.bool)
    cols = [cur]
    for t in range(cont.shape[1]):
        row = cur.clamp(0, n - 1)
        deg = csr["deg"][row]
        alive = alive & cont[:, t] & (deg > 0)
        k = torch.floor(pick[:, t].float() * deg.float()).long()
        k = torch.minimum(k.clamp(min=0), (deg - 1).clamp(min=0))
        at = (csr["indptr"][row] + k).clamp(max=max(csr["nbrs"].numel() - 1, 0))
        nxt = csr["nbrs"][at] if csr["nbrs"].numel() else cur
        cur = torch.where(alive, nxt, torch.full_like(cur, sentinel))
        cols.append(cur)
    return torch.stack(cols, dim=1)


def probe_sum(csr: dict, src: Tensor, dst: Tensor, walks: Tensor, *,
              sqrt_c: float, eps_p: float, dtype=torch.float64,
              store=None) -> Tensor:
    """Sum over the walks [C, L] of their telescoped probe vectors: [n].

    ``src``/``dst`` are the edges (any order); ``store`` rounds each
    level's scores to that dtype (the control's storage)."""
    n = csr["n"]
    dev = walks.device
    length = (walks < n).sum(dim=1)
    order = torch.argsort(length, descending=True, stable=True)
    walks, length = walks[order], length[order]
    deg = csr["deg"].to(dtype)
    w = torch.where(deg > 0, sqrt_c / deg.clamp(min=1), torch.zeros_like(deg))
    src, dst = src.long(), dst.long()
    c = walks.shape[0]
    s = torch.zeros((n + 1, c), dtype=dtype, device=dev)
    chunk = max(1, EDGE_CHUNK_BYTES // max(1, c * s.element_size()))
    for p in range(walks.shape[1], 1, -1):
        act = int((length >= p).sum())
        if act == 0:
            continue
        cols = torch.arange(act, device=dev)
        sub = s[:, :act].contiguous()
        sub[walks[:act, p - 1], cols] += 1.0
        if eps_p > 0.0:
            sub = torch.where(sub > eps_p / sqrt_c ** (p - 1), sub,
                              torch.zeros_like(sub))
        if store is not None:
            sub = sub.to(store).to(dtype)
        out = torch.zeros_like(sub)
        for a in range(0, src.numel(), chunk):
            out.index_add_(0, dst[a : a + chunk], sub[src[a : a + chunk]])
        out[:n] *= w[:, None]
        out[walks[:act, p - 2], cols] = 0.0
        out[n] = 0.0
        if store is not None:
            out = out.to(store).to(dtype)
        s[:, :act] = out
    return s[:n].sum(dim=1)


def topk_excluding(est: Tensor, u: int, k: int) -> tuple[Tensor, Tensor]:
    """Top-k (values, ids) of ``est`` [n] with node ``u`` left out."""
    e = est.clone()
    e[u] = -torch.inf
    return torch.topk(e, k)
