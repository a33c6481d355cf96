"""Message-passing GNN layers on the segment-sum substrate (port of
``repro.models.gnn.layers``).

All layers consume COO edges (src, dst int32 [E], mask bool [E]) over a
padded node table [N, d]: the same gather / scatter-add shape as the
ProbeSim push.  A segment sum is ``index_add_`` into N + 1 rows of zeros
with the last row dropped, so a destination id may be N (the sentinel);
ids outside [0, N] raise where the reference's drop silently.  Padded edges
point at a real node with ``mask`` false: their zero messages still land
there.  A gather is ``gather_rows`` (``index_select``), whose backward is an
``index_add_`` too.  On the card ``index_add_`` sums in an undefined order
(atomics), so a step is bitwise repeatable only under
``torch.use_deterministic_algorithms(True)``.

Parameters are dicts of tensors in the reference's layouts, so a layer
takes what its JAX counterpart takes.  An ``init_*`` draws from a
``torch.Generator`` on its device (with no generator: ``meta`` tensors of
the shapes).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

import repro_torch.models.common as cm

Tensor = torch.Tensor


def _device(gen: torch.Generator | None) -> torch.device:
    return gen.device if gen is not None else torch.device("meta")


def gather_rows(x: Tensor, idx: Tensor) -> Tensor:
    """``x[idx]`` along dim 0 through ``index_select``: its backward is an
    ``index_add_`` (atomics on the card).  Advanced indexing's backward is a
    sorted ``index_put_`` that adds each index's duplicates one after
    another: with 46 M padding edges on one node it took 13 s a call on an
    H100 at ogbn-products' size."""
    return torch.index_select(x, 0, idx)


def scatter_sum(values: Tensor, dst: Tensor, num_nodes: int) -> Tensor:
    """segment-sum messages [E, ...] into nodes [N, ...] (sentinel dst dropped)."""
    out = values.new_zeros((num_nodes + 1,) + tuple(values.shape[1:]))
    return out.index_add_(0, dst, values)[:num_nodes]


def degree(dst: Tensor, mask: Tensor, num_nodes: int) -> Tensor:
    return scatter_sum(mask.to(torch.float32), dst, num_nodes)


def _masked(mask: Tensor, x: Tensor) -> Tensor:
    """``x`` where the edge is live, else 0 (``mask`` [E] against [E, ...])."""
    return torch.where(mask.reshape(mask.shape + (1,) * (x.dim() - 1)), x, 0.0)


# ---------------------------------------------------------------------------
# GCN (Kipf & Welling) — symmetric-normalized SpMM
# ---------------------------------------------------------------------------


def init_gcn_layer(gen, d_in: int, d_out: int, dtype) -> dict:
    return dict(
        w=cm.dense_init(gen, d_in, d_out, dtype),
        b=torch.zeros((d_out,), dtype=dtype, device=_device(gen)),
    )


def gcn_layer(p: dict, h: Tensor, src: Tensor, dst: Tensor, mask: Tensor, *,
              act=F.relu) -> Tensor:
    n = h.shape[0]
    # +self loop; the reference also adds degree(src) * 0.0, an exact zero
    deg = degree(dst, mask, n) + 1.0
    inv_sqrt = torch.rsqrt(deg)
    hw = h @ p["w"]
    s = src.clamp(0, n - 1)
    msg = _masked(mask, gather_rows(hw, s) * gather_rows(inv_sqrt, s)[:, None])
    agg = scatter_sum(msg, dst, n) * inv_sqrt[:, None]
    out = agg + hw * (inv_sqrt * inv_sqrt)[:, None] + p["b"]  # self loop
    return act(out) if act is not None else out


# ---------------------------------------------------------------------------
# GIN (Xu et al.) — sum aggregation + MLP, learnable eps
# ---------------------------------------------------------------------------


def init_gin_layer(gen, d_in: int, d_out: int, dtype) -> dict:
    dev = _device(gen)
    w1 = cm.dense_init(gen, d_in, d_out, dtype)
    w2 = cm.dense_init(gen, d_out, d_out, dtype)
    return dict(
        w1=w1,
        b1=torch.zeros((d_out,), dtype=dtype, device=dev),
        w2=w2,
        b2=torch.zeros((d_out,), dtype=dtype, device=dev),
        eps=torch.zeros((), dtype=torch.float32, device=dev),
    )


def gin_layer(p: dict, h: Tensor, src: Tensor, dst: Tensor, mask: Tensor) -> Tensor:
    n = h.shape[0]
    msg = _masked(mask, gather_rows(h, src.clamp(0, n - 1)))
    agg = scatter_sum(msg, dst, n)
    z = (1.0 + p["eps"]) * h + agg
    z = F.relu(z @ p["w1"] + p["b1"])
    return z @ p["w2"] + p["b2"]


# ---------------------------------------------------------------------------
# GatedGCN (Bresson & Laurent; benchmarking-GNNs config) — edge gates
# ---------------------------------------------------------------------------


def init_gatedgcn_layer(gen, d: int, dtype) -> dict:
    dev = _device(gen)
    p = {k: cm.dense_init(gen, d, d, dtype) for k in ("A", "B", "C", "U", "V")}
    p["ln_h"] = torch.ones((d,), dtype=dtype, device=dev)
    p["ln_e"] = torch.ones((d,), dtype=dtype, device=dev)
    return p


def gatedgcn_layer(
    p: dict,
    h: Tensor,  # [N, d]
    e: Tensor,  # [E, d] edge features
    src: Tensor,
    dst: Tensor,
    mask: Tensor,
) -> tuple[Tensor, Tensor]:
    n = h.shape[0]
    s = src.clamp(0, n - 1)
    d_ = dst.clamp(0, n - 1)
    # edge update: e' = e + ReLU(LN(A h_i + B h_j + C e))
    e_raw = gather_rows(h @ p["A"], d_) + gather_rows(h @ p["B"], s) + e @ p["C"]
    e_new = e + F.relu(cm.rms_norm(e_raw, p["ln_e"]))
    gate = _masked(mask, torch.sigmoid(e_new))
    # normalized gated aggregation
    vh = h @ p["V"]
    num = scatter_sum(gate * gather_rows(vh, s), dst, n)
    den = scatter_sum(gate, dst, n) + 1e-6
    h_raw = h @ p["U"] + num / den
    h_new = h + F.relu(cm.rms_norm(h_raw, p["ln_h"]))
    return h_new, e_new


# ---------------------------------------------------------------------------
# GAT (Velickovic et al., arXiv:1710.10903) — bonus arch: the SDDMM +
# segment-softmax regime
# ---------------------------------------------------------------------------


def segment_softmax(scores: Tensor, segments: Tensor, num_segments: int,
                    mask: Tensor) -> Tensor:
    """Softmax of edge scores [E] (or [E, H], each column apart) within each
    segment.  Masked scores are -1e30; a segment's max starts at -inf
    (``scatter_reduce``'s amax without ``self``), and a max that is not
    finite (an empty segment) is replaced by 0, as ``jax.ops.segment_max``
    gives.  The max is a constant of the backward: the softmax does not
    change with it, so its gradient is zero (the reference differentiates
    it, to rounding)."""
    scores = torch.where(mask.reshape(mask.shape + (1,) * (scores.dim() - 1)),
                         scores, -1e30)
    idx = segments.long().reshape(segments.shape + (1,) * (scores.dim() - 1))
    seg_max = scores.new_full((num_segments,) + tuple(scores.shape[1:]),
                              float("-inf")).scatter_reduce_(
        0, idx.expand_as(scores), scores.detach(), "amax", include_self=False)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    seg = segments.clamp(0, num_segments - 1)
    ex = _masked(mask, torch.exp(scores - gather_rows(seg_max, seg)))
    denom = ex.new_zeros(seg_max.shape).index_add_(0, segments, ex)
    return ex / torch.clamp(gather_rows(denom, seg), min=1e-16)


def init_gat_layer(gen, d_in: int, d_out: int, heads: int, dtype) -> dict:
    w = cm.dense_init(gen, d_in, heads * d_out, dtype).reshape(d_in, heads, d_out)
    if gen is None:
        a = [torch.empty((heads, d_out), dtype=dtype, device="meta") for _ in range(2)]
    else:
        a = [(torch.randn((heads, d_out), generator=gen, device=gen.device) * 0.1)
             .to(dtype) for _ in range(2)]
    return dict(w=w, a_src=a[0], a_dst=a[1])


def gat_layer(
    p: dict, h: Tensor, src: Tensor, dst: Tensor, mask: Tensor,
    *, negative_slope: float = 0.2, concat: bool = True,
) -> Tensor:
    n = h.shape[0]
    s = src.clamp(0, n - 1)
    d_ = dst.clamp(0, n - 1)
    d_in, heads, d_out = p["w"].shape
    hw = (h @ p["w"].reshape(d_in, heads * d_out)).reshape(n, heads, d_out)
    # SDDMM: per-edge attention logits from source and destination halves
    e_src = gather_rows((hw * p["a_src"]).sum(-1), s)  # [E, H]
    e_dst = gather_rows((hw * p["a_dst"]).sum(-1), d_)
    logits = F.leaky_relu(e_src + e_dst, negative_slope)
    # per-head segment softmax over incoming edges of each destination
    # (sentinel dst scatters into the dropped tail)
    alpha = segment_softmax(logits, dst, n + 1, mask)  # [E, H]
    msgs = gather_rows(hw, s) * alpha[..., None]  # [E, H, F]
    out = scatter_sum(msgs.reshape(msgs.shape[0], -1), dst, n).reshape(n, heads, d_out)
    return out.reshape(n, -1) if concat else out.mean(dim=1)
