"""Plain PyTorch version of the ELL SpMM (``csrc/spmm_ell.cu``).

``out[v] = weights[v] * sum_k scores[clip(nbrs[v, k], 0, n)]`` over scores
with the zero dump row at index n, gathered in row chunks under
``GATHER_BUDGET_BYTES`` (K may be close to n).  Sums are fp32 whatever the
storage dtype, as in the kernel.  Used by the CPU path of
``ops.spmm_ell_padded`` and by the on-card comparison only.
"""
from __future__ import annotations

import torch

from repro_torch.graph.structs import gather_sum

Tensor = torch.Tensor


def spmm_ell_padded_ref(nbrs: Tensor, scores: Tensor, weights: Tensor) -> Tensor:
    """nbrs [R, K], scores [n + 1, B] with row n zero, weights [R] -> [R, B]
    in the storage dtype of ``scores``, accumulated in fp32."""
    out = gather_sum(nbrs, scores.float(), weights, clip=scores.shape[0] - 1)
    return out.to(scores.dtype)


def spmm_ell_ref(nbrs: Tensor, scores: Tensor, weights: Tensor) -> Tensor:
    """scores [n, B] or [n] (no dump row) -> same shape."""
    squeeze = scores.dim() == 1
    if squeeze:
        scores = scores[:, None]
    padded = torch.cat([scores, scores.new_zeros((1, scores.shape[1]))], dim=0)
    out = spmm_ell_padded_ref(nbrs, padded, weights)
    return out[:, 0] if squeeze else out
