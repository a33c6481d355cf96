"""Plain PyTorch version of the ELL SpMM (``csrc/spmm_ell.cu``).

``out[v] = weights[v] * sum_{k < row_len[v]} scores[clip(nbrs[v, k], 0, n)]``
over scores with the zero dump row at index n, gathered in row chunks
under ``GATHER_BUDGET_BYTES``, each chunk cut to its longest extent.  Sums
are fp32 whatever the storage dtype, as in the kernel.  With ``row_len =
in_deg`` on a table whose live slots come first it equals the JAX
package's ``spmm_ell_ref``.  Used by the CPU path of
``ops.spmm_ell_padded`` and by the on-card comparison only.
"""
from __future__ import annotations

import torch

from repro_torch.graph.structs import GATHER_BUDGET_BYTES

Tensor = torch.Tensor


def row_chunks(row_len: Tensor, k: int, slot_bytes: int, budget: int):
    """``(a, b, kk)``: consecutive row chunks ``[a, b)`` whose gathered
    ``[b - a, kk, ...]`` block (``slot_bytes`` per slot) stays under
    ``budget`` bytes, ``kk`` the chunk's longest extent ``min(row_len, k)``.
    One host read of ``row_len``; the plain versions of both ELL kernels
    gather over these chunks."""
    lens = [max(x, 1) for x in row_len.clamp(0, k).tolist()]
    a, r = 0, len(lens)
    while a < r:
        b, kk = a + 1, lens[a]
        while (b < r and (b + 1 - a) * max(kk, lens[b]) * slot_bytes
               <= budget):
            kk, b = max(kk, lens[b]), b + 1
        yield a, b, min(kk, k)
        a = b


def spmm_ell_padded_ref(nbrs: Tensor, scores: Tensor, weights: Tensor, *,
                        row_len: Tensor) -> Tensor:
    """nbrs [R, K], scores [n + 1, B] with row n zero, weights [R],
    row_len [R] -> [R, B] in the storage dtype of ``scores``, accumulated in
    fp32."""
    r, k = nbrs.shape
    n = scores.shape[0] - 1
    s = scores.float()
    out = torch.zeros((r,) + tuple(s.shape[1:]), dtype=torch.float32,
                      device=scores.device)
    for a, b, kk in row_chunks(row_len, k, s[0].numel() * 4, GATHER_BUDGET_BYTES):
        idx = nbrs[a:b, :kk].long().clamp(0, n)
        cut = torch.arange(kk, device=idx.device)[None, :] >= row_len[a:b, None]
        out[a:b] = s[torch.where(cut, n, idx)].sum(dim=1)
    out = out * weights.reshape((r,) + (1,) * (out.dim() - 1))
    return out.to(scores.dtype)


def spmm_ell_ref(nbrs: Tensor, scores: Tensor, weights: Tensor, *,
                 row_len: Tensor) -> Tensor:
    """scores [n, B] or [n] (no dump row) -> same shape."""
    squeeze = scores.dim() == 1
    if squeeze:
        scores = scores[:, None]
    padded = torch.cat([scores, scores.new_zeros((1, scores.shape[1]))], dim=0)
    out = spmm_ell_padded_ref(nbrs, padded, weights, row_len=row_len)
    return out[:, 0] if squeeze else out
