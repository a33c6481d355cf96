"""GNN model drivers (port of ``repro.models.gnn.model``): init / forward /
loss for GCN, GIN, GatedGCN, GAT and NequIP, and the carriers of the
reference's parameter tree.

Input convention (all shapes padded and fixed):
    feats   [N, d_feat] float  (N includes a padding tail)
    pos     [N, 3]             (nequip only)
    src/dst [E] int32, mask [E] bool
    labels  [N] int32 (node classification) or [G] (graph classification)
    energy  [G] float (nequip)
    graph_ids [N] int32 (batched_graphs readout)

Parameters are the reference's ``init_gnn`` tree: nested dicts (and the
``layers`` list) of tensors, so ``training/`` and ``checkpoint/`` flatten
them in jax's leaf order and either package restores the other's
checkpoint.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

import repro_torch.models.common as cm
from repro_torch.models.gnn import layers as L
from repro_torch.models.gnn.nequip import init_nequip, nequip_forward
from repro_torch.training.tree import tree_map

Tensor = torch.Tensor

GAT_HEADS = 4


def init_gnn(gen: torch.Generator | None, cfg, d_feat: int) -> dict:
    """Parameters drawn from ``gen`` on its device (the reference's
    distributions, not its draws); with no generator, ``meta`` tensors of
    the shapes."""
    dtype = cm.dtype_of(cfg.param_dtype)
    if cfg.conv == "nequip":
        return init_nequip(gen, cfg, d_feat, dtype)
    p: dict = {"layers": []}
    d_in = d_feat
    for _ in range(cfg.n_layers):
        if cfg.conv == "gcn":
            p["layers"].append(L.init_gcn_layer(gen, d_in, cfg.d_hidden, dtype))
        elif cfg.conv == "gat":
            p["layers"].append(L.init_gat_layer(gen, d_in, cfg.d_hidden // GAT_HEADS,
                                                GAT_HEADS, dtype))
        elif cfg.conv == "gin":
            p["layers"].append(L.init_gin_layer(gen, d_in, cfg.d_hidden, dtype))
        elif cfg.conv == "gatedgcn":
            if d_in != cfg.d_hidden:
                p["in_proj"] = cm.dense_init(gen, d_in, cfg.d_hidden, dtype)
            p["layers"].append(L.init_gatedgcn_layer(gen, cfg.d_hidden, dtype))
        else:
            raise ValueError(cfg.conv)
        d_in = cfg.d_hidden
    p["head"] = cm.dense_init(gen, cfg.d_hidden, cfg.n_classes, dtype)
    return p


def gnn_forward(params: dict, batch: dict, cfg, *, n_graphs: int = 1) -> Tensor:
    """Returns node logits [N, n_classes], graph logits [G, n_classes] with
    ``graph_ids``, or NequIP's energies [G]."""
    feats = batch["feats"]
    src, dst, mask = batch["src"], batch["dst"], batch["mask"]
    if cfg.conv == "nequip":
        return nequip_forward(params, feats, batch["pos"], src, dst, mask, cfg,
                              graph_ids=batch.get("graph_ids"), n_graphs=n_graphs)
    h = feats
    if "in_proj" in params:
        h = h @ params["in_proj"]
    if cfg.conv == "gatedgcn":
        e = h.new_zeros((src.shape[0], cfg.d_hidden)) + 0.1
        for lp in params["layers"]:
            h, e = L.gatedgcn_layer(lp, h, e, src, dst, mask)
    else:
        for i, lp in enumerate(params["layers"]):
            last = i == cfg.n_layers - 1
            if cfg.conv == "gcn":
                h = L.gcn_layer(lp, h, src, dst, mask, act=None if last else F.relu)
            elif cfg.conv == "gat":
                h = L.gat_layer(lp, h, src, dst, mask)
                if not last:
                    h = F.elu(h)
            else:
                h = L.gin_layer(lp, h, src, dst, mask)
    logits = h @ params["head"]
    if batch.get("graph_ids") is not None:
        logits = L.scatter_sum(logits, batch["graph_ids"], n_graphs)
    return logits


def gnn_loss(params: dict, batch: dict, cfg, *, n_graphs: int = 1):
    """(loss, metrics): NequIP's energy MSE, else the masked mean NLL of
    the labels."""
    out = gnn_forward(params, batch, cfg, n_graphs=n_graphs)
    if cfg.conv == "nequip":
        loss = torch.mean((out - batch["energy"]) ** 2)
        return loss, dict(mse=loss)
    labels = batch["labels"]
    lmask = batch.get("label_mask")
    if lmask is None:
        lmask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    logz = torch.logsumexp(out, dim=-1)
    gold = out.gather(-1, labels.clamp(min=0).long()[:, None])[:, 0]
    nll = ((logz - gold) * lmask).sum() / torch.clamp(lmask.sum(), min=1.0)
    return nll, dict(nll=nll)


def gnn_from_params(params, cfg, device="cuda") -> dict:
    """The port's parameter tree from the reference's ``init_gnn`` tree as
    numpy arrays (the layouts are the same; every leaf is copied)."""
    from repro_torch.graph.structs import resolve_device

    dev = resolve_device(device)
    dtype = cm.dtype_of(cfg.param_dtype)

    def leaf(a):
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        # GIN's eps (the one scalar leaf) is fp32 whatever the parameter dtype
        return t.to(dev, dtype if t.dim() else torch.float32)

    return tree_map(leaf, params)


def gnn_to_params(params: dict) -> dict:
    """The reference's ``init_gnn`` tree as numpy (the inverse of
    ``gnn_from_params``; bf16 leaves upcast to fp32)."""
    return tree_map(lambda t: t.detach().to("cpu", torch.float32, copy=True).numpy(),
                    params)
