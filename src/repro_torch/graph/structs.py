"""Graph data structures for GPU-resident ProbeSim (port of ``repro.graph.structs``).

Two device representations, both capacity-padded:

* ``Graph`` — COO edge list (``src``, ``dst``) padded with the sentinel node
  id ``n``; per-node in/out degrees.  This is the *push* representation: a
  PROBE level is ``index_add_(dst, scores[src] * w)``.
* ``EllGraph`` — padded in-neighbor table ``in_nbrs[n, k_max]`` (ELL format).
  This is the *gather* representation the lane-probe and ELL-SpMM kernels
  consume, and the O(1) in-neighbor sampler of sqrt(c)-walk generation.  The
  sentinel id ``n`` doubles as the row index of the *dump row* in
  ``[n + 1, B]`` score buffers: serving buffers bake that extra zero row in
  at construction, so sentinel gathers and scatters need no per-push
  masking (``push_ell_padded``).

``CsrGraph`` is a host CSR (numpy) that the GNN neighbour sampler
(``graph/sampler.py``) reads.

Node ids are stored int32, as in the JAX package; they are cast to int64
only where torch indexing needs it.  Every constructor takes an explicit
``device`` (default ``"cuda"``); the CPU is used only when asked for.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

Tensor = torch.Tensor

# Bytes one chunk of a plain ``[rows, K, B]`` gather may take: the ELL table
# of a skewed graph has K close to n, so gathering it whole would need
# n * K * B * 4 bytes (about a terabyte at HepPh size).
GATHER_BUDGET_BYTES = 1 << 28


def resolve_device(device) -> torch.device:
    """The device an entry point was asked for; never falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def inv_degree(in_deg: Tensor) -> Tensor:
    """1/|I(v)| with 0 for dangling nodes (float32 [n])."""
    d = in_deg.to(torch.float32)
    return torch.where(d > 0, 1.0 / d.clamp(min=1.0), torch.zeros_like(d))


@dataclasses.dataclass
class Graph:
    """COO graph, capacity padded.  Padding edges have src = dst = n.

    ``version`` counts applied update batches and ``overflow`` is the sticky
    capacity flag of the dynamic-graph path; both are host values here.
    """

    src: Tensor  # int32 [capacity]
    dst: Tensor  # int32 [capacity]
    in_deg: Tensor  # int32 [n]
    out_deg: Tensor  # int32 [n]
    num_edges: int
    n: int
    capacity: int
    version: int = 0
    overflow: bool = False

    @property
    def device(self) -> torch.device:
        return self.src.device

    @property
    def inv_in_deg(self) -> Tensor:
        return inv_degree(self.in_deg)

    def edge_mask(self) -> Tensor:
        """bool [capacity]: True for real (non-padding) edges."""
        return self.src < self.n


@dataclasses.dataclass
class EllGraph:
    """Padded in-neighbor table (ELL).  in_nbrs[v, k] = k-th in-neighbor of v
    for k < in_deg[v], else sentinel n: live slots come first, which is what
    lets the kernels stop each row at ``in_deg[v]`` (``check_live_prefix``)."""

    in_nbrs: Tensor  # int32 [n, k_max], padded with n
    in_deg: Tensor  # int32 [n]
    n: int
    k_max: int
    version: int = 0
    overflow: bool = False

    @property
    def device(self) -> torch.device:
        return self.in_nbrs.device

    @property
    def inv_in_deg(self) -> Tensor:
        return inv_degree(self.in_deg)


def check_live_prefix(in_nbrs: Tensor, in_deg: Tensor, n: int) -> None:
    """Raise unless ``0 <= in_deg[v] <= K``, ``0 <= in_nbrs[v, k] < n`` for
    ``k < in_deg[v]`` and ``in_nbrs[v, k] == n`` past it: the row extent the
    kernels read, and the exact sentinel the in-place updates add onto.
    Checked on the table's device in row chunks of about
    ``GATHER_BUDGET_BYTES``; one host read."""
    r, k = in_nbrs.shape
    if in_deg.shape != (r,):
        raise ValueError(f"in_deg must be [{r}], got {tuple(in_deg.shape)}")
    bad = ((in_deg < 0) | (in_deg > k)).any()
    slots = torch.arange(k, device=in_nbrs.device)
    step = max(1, GATHER_BUDGET_BYTES // max(1, k))
    for a in range(0, r, step):
        x = in_nbrs[a : a + step]
        live = slots[None, :] < in_deg[a : a + step, None]
        bad |= torch.where(live, (x < 0) | (x >= n), x != n).any()
    if bool(bad):
        raise ValueError(
            "ELL table breaks the live-prefix rule: some row has a sentinel or "
            "an id outside [0, n) before in_deg[v], anything but n at or after "
            "it, or in_deg outside [0, K]"
        )


def check_coo_prefix(src: Tensor, dst: Tensor, num_edges: int, n: int) -> None:
    """Raise unless both ends of every edge at a position ``< num_edges`` lie
    in ``[0, n)`` and every later position holds ``n`` at both ends: the
    padding the in-place updates write over.  One host read."""
    cap = src.shape[0]
    if dst.shape != (cap,) or not 0 <= num_edges <= cap:
        raise ValueError(
            f"COO buffers {tuple(src.shape)} / {tuple(dst.shape)} with "
            f"num_edges {num_edges}"
        )
    live = torch.arange(cap, device=src.device) < num_edges
    ok = torch.where(live, (src >= 0) & (src < n) & (dst >= 0) & (dst < n),
                     (src == n) & (dst == n))
    if not bool(ok.all()):
        raise ValueError(
            "COO buffer breaks the live-prefix rule: the live edges are not "
            "exactly the first num_edges positions, or the padding is not n"
        )


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------


def graph_from_edges(
    src: np.ndarray,
    dst: np.ndarray,
    n: int,
    capacity: int | None = None,
    *,
    device="cuda",
) -> Graph:
    """Build a COO ``Graph`` from host edge arrays on ``device``.

    ``capacity`` reserves head-room for dynamic insertions (defaults to m).
    """
    dev = resolve_device(device)
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    m = src.shape[0]
    if capacity is None:
        capacity = m
    if capacity < m:
        raise ValueError(f"capacity {capacity} < num edges {m}")
    pad = capacity - m
    src_p = np.concatenate([src, np.full(pad, n, dtype=np.int32)])
    dst_p = np.concatenate([dst, np.full(pad, n, dtype=np.int32)])
    in_deg = np.bincount(dst, minlength=n).astype(np.int32)[:n]
    out_deg = np.bincount(src, minlength=n).astype(np.int32)[:n]
    return Graph(
        src=torch.from_numpy(src_p).to(dev),
        dst=torch.from_numpy(dst_p).to(dev),
        in_deg=torch.from_numpy(in_deg).to(dev),
        out_deg=torch.from_numpy(out_deg).to(dev),
        num_edges=int(m),
        n=int(n),
        capacity=int(capacity),
    )


def ell_from_edges(
    src: np.ndarray,
    dst: np.ndarray,
    n: int,
    k_max: int | None = None,
    *,
    device="cuda",
) -> EllGraph:
    """Pack in-neighbors into an ELL table.  k_max defaults to max in-degree.

    The slot of each edge is computed on the host (O(m)); the [n, k_max]
    table is filled on ``device``, so a table of several GB never exists in
    host memory.
    """
    dev = resolve_device(device)
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    in_deg = np.bincount(dst, minlength=n).astype(np.int32)[:n]
    deg_cap = int(in_deg.max()) if in_deg.size else 0
    if k_max is None:
        k_max = max(deg_cap, 1)
    if deg_cap > k_max:
        raise ValueError(f"max in-degree {deg_cap} exceeds k_max {k_max}")
    # stable counting fill: position of each edge within its dst group
    order = np.argsort(dst, kind="stable")
    d_sorted = dst[order]
    s_sorted = src[order]
    group_start = np.searchsorted(d_sorted, np.arange(n))
    idx_within = np.arange(len(d_sorted)) - group_start[d_sorted]
    table = torch.full((n, k_max), n, dtype=torch.int32, device=dev)
    table[
        torch.from_numpy(d_sorted.astype(np.int64)).to(dev),
        torch.from_numpy(idx_within.astype(np.int64)).to(dev),
    ] = torch.from_numpy(s_sorted).to(dev)
    return EllGraph(
        in_nbrs=table,
        in_deg=torch.from_numpy(in_deg).to(dev),
        n=int(n),
        k_max=int(k_max),
    )


class CsrGraph:
    """Host-side CSR (numpy; a copy of ``repro.graph.structs.CsrGraph``).
    indptr[n+1], indices[m] sorted by row."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray, n: int):
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.indices = np.asarray(indices, dtype=np.int32)
        self.n = int(n)

    @property
    def m(self) -> int:
        return int(self.indices.shape[0])

    def degree(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int32)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]


def csr_from_edges(src: np.ndarray, dst: np.ndarray, n: int, by: str = "dst") -> CsrGraph:
    """Host CSR grouped by ``dst`` (in-CSR, default) or ``src`` (out-CSR)."""
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    key, val = (dst, src) if by == "dst" else (src, dst)
    order = np.argsort(key, kind="stable")
    counts = np.bincount(key, minlength=n)[:n]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CsrGraph(indptr, val[order], n)


def graph_to_host_edges(g: Graph) -> tuple[np.ndarray, np.ndarray]:
    """Extract the real (non-padding) edges to host numpy: copies, never
    views of a CPU mirror, which updates write in place."""
    m = int(g.num_edges)
    return (g.src[:m].to("cpu", copy=True).numpy(),
            g.dst[:m].to("cpu", copy=True).numpy())


# ---------------------------------------------------------------------------
# Propagation primitives
# ---------------------------------------------------------------------------


def _row_weights(weights: Tensor, out: Tensor) -> Tensor:
    return weights.reshape((weights.shape[0],) + (1,) * (out.dim() - 1))


def push_coo(g: Graph, scores: Tensor, weights: Tensor | None = None) -> Tensor:
    """One propagation level over the COO edges.

    ``new[v] = sum_{x in I(v)} scores[x] * w[v]`` where ``w`` defaults to 1.
    ``scores`` is [n, ...] or [n]; returns the same shape.  Padding edges
    add into the sentinel row, which is dropped.
    """
    live = g.src < g.n
    msgs = scores[g.src.clamp(0, g.n - 1).long()]
    msgs = torch.where(
        live.reshape((-1,) + (1,) * (msgs.dim() - 1)),
        msgs,
        torch.zeros((), dtype=msgs.dtype, device=msgs.device),
    )
    out = torch.zeros(
        (g.n + 1,) + tuple(scores.shape[1:]), dtype=msgs.dtype,
        device=msgs.device,
    )
    out.index_add_(0, g.dst.long(), msgs)
    out = out[: g.n]
    if weights is not None:
        out = out * _row_weights(weights, out)
    return out


def gather_sum(
    nbrs: Tensor,
    scores: Tensor,
    weights: Tensor | None,
    *,
    clip: int | None = None,
) -> Tensor:
    """``w[v] * sum_k scores[nbrs[v, k]]`` in row chunks of bounded size.

    ``nbrs`` indexes rows of ``scores`` (clipped to ``[0, clip]`` when
    ``clip`` is given).  Each chunk gathers ``[rows, K, ...]`` and reduces
    over K, so peak memory stays near ``GATHER_BUDGET_BYTES`` whatever the
    table's width.
    """
    r, k = nbrs.shape
    tail = tuple(scores.shape[1:])
    row_bytes = max(1, k * int(np.prod(tail, dtype=np.int64)) * scores.element_size())
    step = max(1, GATHER_BUDGET_BYTES // row_bytes)
    out = torch.empty((r,) + tail, dtype=scores.dtype, device=scores.device)
    for a in range(0, r, step):
        idx = nbrs[a : a + step].long()
        if clip is not None:
            idx = idx.clamp(0, clip)
        out[a : a + step] = scores[idx].sum(dim=1)
    if weights is not None:
        out = out * _row_weights(weights, out)
    return out


def push_ell(eg: EllGraph, scores: Tensor, weights: Tensor | None = None) -> Tensor:
    """Gather-based propagation level over the ELL in-neighbor table.

    ``new[v] = w[v] * sum_{k < in_deg[v]} scores[in_nbrs[v, k]]``.
    ``scores``: [n] or [n, B].
    """
    padded = torch.cat(
        [scores, scores.new_zeros((1,) + tuple(scores.shape[1:]))], dim=0
    )
    return push_ell_padded(eg, padded, weights)


def push_ell_padded(
    eg: EllGraph, scores: Tensor, weights: Tensor | None = None
) -> Tensor:
    """``push_ell`` over a score buffer with the sentinel dump row baked in.

    ``scores`` is [n + 1, ...] and row n (the dump row) MUST be zero: the
    ELL sentinel id ``n`` then gathers an exact zero.  Returns [n, ...].
    """
    return gather_sum(eg.in_nbrs, scores, weights)
