"""Plain PyTorch versions of the ELL and CSR SpMMs (``csrc/spmm_ell.cu``).

``out[v] = weights[v] * sum_{k < row_len[v]} scores[clip(nbrs[v, k], 0, n)]``
over scores with the zero dump row at index n, gathered in row chunks
under ``GATHER_BUDGET_BYTES``, each chunk cut to its longest extent.  Sums
are fp32 whatever the storage dtype, as in the kernel.  With ``row_len =
in_deg`` on a table whose live slots come first it equals the JAX
package's ``spmm_ell_ref``.  Used by the CPU path of
``ops.spmm_ell_padded`` and by the on-card comparison only.

``spmm_csr_ref`` is the same sum over the rows of an in-CSR block: each
row's ids in slot order, gathered in edge slices under
``GATHER_BUDGET_BYTES`` and added into the row in that order (the CPU's
``index_add_`` is sequential), fp32.
"""
from __future__ import annotations

import torch

from repro_torch.graph.structs import GATHER_BUDGET_BYTES

Tensor = torch.Tensor


# padding a chunk may gather past twice its live slots, in bytes, by the
# device of ``row_len``: a hub row starts a chunk of its own instead of
# widening its neighbours' rows to its extent (a zero slot adds nothing to
# a row's sum; torch may group the additions by the extent, so a cut may
# move the last bits).  A chunk costs the card about ten launches, worth
# some MB of traffic; on the CPU it costs a few Python calls
CHUNK_WASTE_BYTES = {"cuda": 8 << 20, "cpu": 0}


def row_chunks(row_len: Tensor, k: int, slot_bytes: int, budget: int):
    """``(a, b, kk)``: consecutive row chunks ``[a, b)`` whose gathered
    ``[b - a, kk, ...]`` block (``slot_bytes`` per slot) stays under
    ``budget`` bytes and gathers at most twice its rows' extents plus
    the device's CHUNK_WASTE_BYTES, ``kk`` the chunk's longest extent
    ``min(row_len, k)``.  One host read of ``row_len``; the plain versions
    of both ELL kernels gather over these chunks."""
    waste = CHUNK_WASTE_BYTES["cuda" if row_len.is_cuda else "cpu"]
    lens = [max(x, 1) for x in row_len.clamp(0, k).tolist()]
    a, r = 0, len(lens)
    while a < r:
        b, kk, live = a + 1, lens[a], lens[a]
        while b < r:
            slots = (b + 1 - a) * max(kk, lens[b])
            if (slots * slot_bytes > budget
                    or (slots - 2 * (live + lens[b])) * slot_bytes > waste):
                break
            kk, live, b = max(kk, lens[b]), live + lens[b], b + 1
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


def spmm_csr_ref(indices: Tensor, scores: Tensor, weights: Tensor, *,
                 indptr: Tensor, row_len: Tensor, base: int) -> Tensor:
    """indices [E] (the block's in-neighbour lists), scores [n, B], weights,
    indptr and row_len [R] -> [R, B]:
    ``out[v] = w[v] * sum_{k < row_len[v]} scores[indices[indptr[v] - base + k]]``,
    ids >= n skipped; fp32 sums (float64 ones for float64 ``scores``),
    stored in the dtype of ``scores``."""
    r = row_len.shape[0]
    n, b = scores.shape
    dev = scores.device
    lens = row_len.long().clamp(min=0)
    first = torch.cumsum(lens, 0) - lens
    total = int(lens.sum())
    out = torch.zeros((r, b), dtype=torch.promote_types(scores.dtype, torch.float32),
                      device=dev)
    step = max(1, GATHER_BUDGET_BYTES // max(1, b * 4))
    for a in range(0, total, step):
        e = torch.arange(a, min(a + step, total), device=dev)
        row = torch.searchsorted(first, e, right=True) - 1
        src = indices[indptr.long()[row] - base + (e - first[row])].long()
        keep = src < n
        out.index_add_(0, row[keep], scores[src[keep]].to(out.dtype))
    return (out * weights[:, None]).to(scores.dtype)
