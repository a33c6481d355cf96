"""Plain PyTorch version of the fused lane-probe level (``csrc/lane_probe.cu``).

Mirrors the kernel element for element: the same deposit, inject, prune,
sentinel mask, row extent (slot k of row v counts only if
``k < row_len[v]``), weighted gather-sum and exclusion.  With
``row_len = in_deg`` on a table whose live slots come first it equals the
JAX package's ``lane_probe_level_ref``.  It materializes the gathered
``[rows, K', W]`` block (K' the chunk's longest extent), so rows are
processed in chunks under ``GATHER_BUDGET_BYTES`` (``row_chunks``).  The
CPU path of ``ops.lane_probe_level`` and the on-card comparison use it;
the card's serve path never does.
"""
from __future__ import annotations

import torch

from repro_torch.graph.structs import GATHER_BUDGET_BYTES
from repro_torch.kernels.spmm_ell.ref import row_chunks

Tensor = torch.Tensor


def lane_probe_level_ref(
    nbrs: Tensor,     # int32 [R, K] global neighbor ids
    weights: Tensor,  # f32 [R]
    table: Tensor,    # [T, W] gather source (f32 or bf16 storage)
    dep: Tensor,      # [R, W] pre-level scores of these rows
    total: Tensor,    # [R, W] accumulator rows
    fin: Tensor,      # bool/int32 [W]
    u_p: Tensor,      # int32 [W]
    u_prev: Tensor,   # int32 [W]
    thr: Tensor,      # f32 [W]
    *,
    row_len: Tensor,  # int32 [R]
    row0: int,
    tab0: int,
    n_live: int,
    prune: bool,
) -> tuple[Tensor, Tensor]:
    r, k = nbrs.shape
    t, w = table.shape
    fin = fin.to(torch.bool)
    zero = torch.zeros((), dtype=torch.float32, device=table.device)

    # deposit: fp32 accumulate, storage-dtype store
    tot = total.float() + torch.where(fin[None, :], dep.float(), zero)

    # the finished lanes zeroed once on the table, and a zero row ``t`` that
    # every dead slot (sentinel id or past the row's extent) reads: the
    # same terms as zeroing the gathered block, in fewer passes over it
    src = torch.zeros((t + 1, w), dtype=torch.float32, device=table.device)
    src[:t] = torch.where(fin[None, :], zero, table)
    out = torch.zeros((r, w), dtype=torch.float32, device=table.device)
    for a, b, kk in row_chunks(row_len, k, w * 4, GATHER_BUDGET_BYTES):
        idx = nbrs[a:b, :kk]
        addr = (idx.long() - int(row0) + int(tab0)).clamp(0, t - 1)
        cut = torch.arange(kk, device=table.device)[None, :] >= row_len[a:b, None]
        dead = (idx >= n_live) | cut
        addr = torch.where(dead, t, addr)
        inject = idx[:, :, None] == u_p[None, None, :]
        inject &= ~dead[:, :, None]  # a dead slot injects nothing
        eff = src[addr] + inject  # [rows, K', W]
        if prune:
            eff = torch.where(eff > thr[None, None, :], eff, zero)
        out[a:b] = eff.sum(dim=1) * weights[a:b, None]

    gids = int(row0) + torch.arange(r, dtype=torch.int32, device=table.device)
    out = torch.where(u_prev[None, :] == gids[:, None], zero, out)
    return out.to(table.dtype), tot.to(total.dtype)
