"""Plain PyTorch version of the fused PROBE push level (``csrc/probe_push.cu``).

1. prune:  s = where(s > thresh, s, 0)   (only when thresh > 0; no abs)
2. push:   t[v] = w[v] * sum_{k < row_len[v]} s[clip(nbrs[v, k], 0, n)]
           (row n is zero)
3. mask:   t[exclude[b], b] = 0 where exclude[b] < n

The push is ``spmm_ell_padded_ref``: row chunks under
``GATHER_BUDGET_BYTES``, each cut to its longest extent, slots past
``row_len`` read as the zero row, sums in fp32 whatever the storage dtype,
as the kernel does; the threshold is compared in fp32.  With ``row_len =
in_deg`` on a table whose live slots come first it equals the JAX
package's ``probe_push_ref``.  Used by the CPU path of ``ops.probe_push``
and by the on-card comparison only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.spmm_ell.ref import spmm_ell_padded_ref

Tensor = torch.Tensor


def probe_push_ref(
    nbrs: Tensor,  # int32 [n, K], sentinel = n
    scores: Tensor,  # [n, B]
    weights: Tensor,  # f32 [n] (= sqrt_c / in_deg)
    exclude: Tensor,  # int32 [B] per-column excluded row (>= n: none)
    prune_thresh: float = 0.0,  # pruning-rule-2 threshold for this level
    *,
    row_len: Tensor,  # int32 [n]: slots k < row_len[v] of row v are read
) -> Tensor:
    n, b = scores.shape
    s = scores.float()
    if prune_thresh > 0.0:
        s = torch.where(s > prune_thresh, s, torch.zeros_like(s))
    padded = torch.cat([s, s.new_zeros((1, b))], dim=0)
    out = spmm_ell_padded_ref(nbrs, padded, weights, row_len=row_len)
    ok = exclude < n
    cols = torch.arange(b, device=scores.device)[ok]
    out[exclude[ok].long().clamp(0, n - 1), cols] = 0.0
    return out.to(scores.dtype)
