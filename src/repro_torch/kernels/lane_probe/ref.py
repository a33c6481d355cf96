"""Plain PyTorch version of the fused lane-probe level (``csrc/lane_probe.cu``).

Mirrors the kernel, and the JAX package's ``lane_probe_level_ref``, element
for element: the same deposit, inject, prune, sentinel mask, weighted
gather-sum and exclusion.  It materializes the gathered ``[rows, K, W]``
block, so rows are processed in chunks under ``GATHER_BUDGET_BYTES``.  The
CPU path of ``ops.lane_probe_level`` and the on-card comparison use it; the
card's serve path never does.
"""
from __future__ import annotations

import torch

from repro_torch.graph.structs import GATHER_BUDGET_BYTES

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

    out = torch.empty((r, w), dtype=torch.float32, device=table.device)
    step = max(1, GATHER_BUDGET_BYTES // max(1, k * w * 4))
    for a in range(0, r, step):
        idx = nbrs[a : a + step]
        addr = (idx.long() - int(row0) + int(tab0)).clamp(0, t - 1)
        rows = table[addr].float()  # [rows, K, W]
        idx = idx[:, :, None]
        eff = torch.where(fin[None, None, :], zero, rows) + (
            idx == u_p[None, None, :]
        ).float()
        if prune:
            eff = torch.where(eff > thr[None, None, :], eff, zero)
        eff = torch.where(idx >= n_live, zero, eff)
        out[a : a + step] = eff.sum(dim=1) * weights[a : a + step, None]

    gids = int(row0) + torch.arange(r, dtype=torch.int32, device=table.device)
    out = torch.where(u_prev[None, :] == gids[:, None], zero, out)
    return out.to(table.dtype), tot.to(total.dtype)
