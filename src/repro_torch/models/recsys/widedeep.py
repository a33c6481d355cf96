"""Wide & Deep (Cheng et al., arXiv:1606.07792; port of
``repro.models.recsys.widedeep``).

Wide: a linear model over the categorical ids, one scalar weight table a
field.  Deep: per-field dense embeddings (dim 32) concatenated with the
dense features, through an MLP 1024-512-256.  Output: the CTR logit.

Parameters are the reference's ``init_widedeep`` tree: a dict of tensors
(``embed`` [F, V, D], ``wide`` [F, V], ``wide_dense`` [n_dense, 1],
``bias`` [], ``mlp`` a list of ``{w, b}``, ``head`` [d, 1]), so
``training/`` and ``checkpoint/`` flatten it in jax's leaf order and either
package restores the other's checkpoint.

Lookups.  The per-field gather ``embed[f, ids[:, f]]`` reads row
``f * V + id`` of the flattened ``[F * V, D]`` table through ``lookup``,
an ``index_select`` whose backward is an ``index_add_``.  ``recsys_batch``
draws Zipf ids (one row takes about 18 % of a field's lookups);
``x[idx]`` would differentiate into a sorted ``index_put_`` that adds a
row's duplicates one after another, and ``F.embedding``'s sorted backward
took 7.66 ms of a train step at batch 65,536 against ``index_add_``'s
0.84 ms (NVIDIA H100 80GB HBM3, 700 W).  The gradient of a table is dense,
as the reference's is, and AdamW decays and moves every row: no sparse
gradient, no lazy optimizer.

Out-of-range ids follow the reference.  In ``deep_tower`` and the wide
term (jax's advanced indexing) a negative id wraps once (``id + V``), then
every id reads its row clamped into ``[0, V - 1]``, and an id still out of
range after the wrap gets no gradient; ``embedding_bag`` and
``retrieval_scores`` clip with no wrap (the reference's ``.clip``, whose
gradient goes to the clipped row).  A segment outside ``[0, num_bags)`` is
dropped, as ``jax.ops.segment_sum`` drops it.  The reference's sharding
constraint on the gathered rows is the identity on one device and has no
counterpart.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

import repro_torch.models.common as cm
from repro_torch.models.gnn.layers import scatter_sum
from repro_torch.training.tree import tree_map

Tensor = torch.Tensor


def lookup(table: Tensor, idx: Tensor) -> Tensor:
    """Rows ``idx`` (in range) of ``table`` [N, D]: ``[*idx.shape, D]``."""
    return table.index_select(0, idx.reshape(-1)).reshape(tuple(idx.shape)
                                                          + (table.shape[1],))


def embedding_bag(
    table: Tensor,  # [V, D]
    ids: Tensor,  # [T] int flat ids
    segments: Tensor,  # [T] int bag index
    num_bags: int,
    *,
    mode: str = "sum",
    weights: Tensor | None = None,
) -> Tensor:
    """torch.nn.EmbeddingBag with the reference's rules: gather the rows of
    ``ids`` (clipped into the table), scale by ``weights``, sum each bag
    (segments outside ``[0, num_bags)`` dropped); ``mode="mean"`` divides
    each bag by its count (at least 1)."""
    rows = lookup(table, ids.clamp(0, table.shape[0] - 1))
    if weights is not None:
        rows = rows * weights[:, None]
    seg = torch.where((segments >= 0) & (segments < num_bags), segments, num_bags)
    out = scatter_sum(rows, seg, num_bags)
    if mode == "mean":
        cnt = scatter_sum(torch.ones(ids.shape, dtype=torch.float32, device=ids.device),
                          seg, num_bags)
        out = out / torch.clamp(cnt, min=1.0)[:, None]
    return out


def init_widedeep(gen: torch.Generator | None, cfg) -> dict:
    """Parameters drawn from ``gen`` on its device (the reference's
    distributions, not its draws: tables N(0, 0.01^2), dense layers
    ``dense_init``, biases 0); with no generator, ``meta`` tensors of the
    shapes."""
    dtype = cm.dtype_of(cfg.param_dtype)
    dev = torch.device("meta") if gen is None else gen.device
    F_, V, D = cfg.n_sparse, cfg.vocab_per_field, cfg.embed_dim

    def table(shape):
        if gen is None:
            return torch.empty(shape, dtype=dtype, device=dev)
        # scaled in place: the embed table alone is 5.12 GB at full width
        return torch.randn(shape, generator=gen, device=dev).mul_(0.01).to(dtype)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    p: dict = dict(
        embed=table((F_, V, D)),
        wide=table((F_, V)),
        wide_dense=cm.dense_init(gen, cfg.n_dense, 1, dtype),
        bias=zeros(()),
    )
    d_in = F_ * D + cfg.n_dense
    mlp = []
    for width in cfg.mlp:
        mlp.append(dict(w=cm.dense_init(gen, d_in, width, dtype), b=zeros((width,))))
        d_in = width
    p["mlp"] = mlp
    p["head"] = cm.dense_init(gen, d_in, 1, dtype)
    return p


def field_gather(table: Tensor, ids: Tensor) -> Tensor:
    """``table[arange(F)[None, :], ids]`` by jax's indexing rules: ``table``
    [F, V, *rest], ``ids`` [B, F] -> [B, F, *rest], row ``f * V + id`` of
    the flattened table.  A negative id wraps once; the read clamps into the
    field, but the gradient of an id still outside ``[0, V)`` after the
    wrap is dropped, as jax's scatter drops an out-of-bounds update."""
    F_, V = table.shape[0], table.shape[1]
    wrapped = torch.where(ids < 0, ids + V, ids)
    rows = wrapped.clamp(0, V - 1).long() + torch.arange(F_, device=ids.device) * V
    rest = tuple(table.shape[2:])
    out = lookup(table.reshape(F_ * V, -1), rows)
    if table.requires_grad and torch.is_grad_enabled():
        inside = (wrapped >= 0) & (wrapped < V)
        out = torch.where(inside[..., None], out, out.detach())
    return out.reshape(tuple(ids.shape) + rest)


def deep_tower(p: dict, sparse_ids: Tensor, dense: Tensor, cfg) -> Tensor:
    """[B, F] ids + [B, n_dense] -> deep representation [B, mlp[-1]]."""
    B = sparse_ids.shape[0]
    emb = field_gather(p["embed"], sparse_ids)  # [B, F, D]
    x = torch.cat([emb.reshape(B, -1), dense], dim=-1)
    for layer in p["mlp"]:
        x = F.relu(x @ layer["w"] + layer["b"])
    return x


def widedeep_forward(p: dict, batch: dict, cfg) -> Tensor:
    """CTR logits [B]."""
    sparse_ids, dense = batch["sparse_ids"], batch["dense"]
    wide = field_gather(p["wide"], sparse_ids).sum(dim=1)  # [B]
    wide = wide + (dense @ p["wide_dense"])[:, 0]
    deep = deep_tower(p, sparse_ids, dense, cfg)
    logit = (deep @ p["head"])[:, 0]
    return logit + wide + p["bias"]


def widedeep_loss(p: dict, batch: dict, cfg):
    """(mean binary cross-entropy of the logits, ``dict(bce=...)``), in the
    reference's form: ``max(l, 0) - l * y + log1p(exp(-|l|))``."""
    logits = widedeep_forward(p, batch, cfg)
    y = batch["labels"].to(torch.float32)
    loss = torch.mean(torch.maximum(logits, torch.zeros_like(logits)) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))
    return loss, dict(bce=loss)


def retrieval_scores(p: dict, batch: dict, cfg, *, field: int = 0) -> Tensor:
    """One query against ``cand_ids`` [n_candidates] (the retrieval_cand
    shape): the query tower's first ``embed_dim`` features dotted with the
    candidates' rows of table ``field``, one batched product."""
    deep = deep_tower(p, batch["sparse_ids"], batch["dense"], cfg)  # [1, d]
    cand_ids = batch["cand_ids"].clamp(0, cfg.vocab_per_field - 1)
    cand = lookup(p["embed"][field], cand_ids)  # [nc, D]
    q = deep[:, : cfg.embed_dim]  # [1, D]
    return (q @ cand.T)[0]  # [n_candidates]


def widedeep_from_params(params, device="cuda") -> dict:
    """The port's parameter tree from the reference's ``init_widedeep``
    tree as numpy arrays (the layouts are the same; every leaf is copied
    in fp32, the configs' ``param_dtype``)."""
    from repro_torch.graph.structs import resolve_device

    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(dev),
                    params)


def widedeep_to_params(params: dict) -> dict:
    """The reference's ``init_widedeep`` tree as numpy in fp32 (the inverse
    of ``widedeep_from_params``)."""
    return tree_map(lambda t: t.detach().to("cpu", torch.float32, copy=True).numpy(),
                    params)
