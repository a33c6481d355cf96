"""Deterministic synthetic batch generators for every family (a copy of
``repro.data.synthetic``: pure numpy, pinned equal by the tests).

Determinism matters for fault tolerance: any host can regenerate any batch
from (seed, step), so restart-after-failure needs no data-state beyond the
step counter (checkpointed)."""
from __future__ import annotations

import numpy as np


def lm_batch(seed: int, step: int, batch: int, seq: int, vocab: int) -> dict:
    rng = np.random.default_rng((seed, step))
    # a Zipf token stream with some local structure (repeated n-grams)
    toks = rng.zipf(1.3, size=(batch, seq + 1)).clip(0, vocab - 1)
    return dict(
        tokens=toks[:, :-1].astype(np.int32),
        targets=toks[:, 1:].astype(np.int32),
    )


def gnn_full_graph_batch(
    seed: int, n: int, m: int, d_feat: int, n_classes: int
) -> dict:
    from repro_torch.graph.generators import powerlaw_graph

    rng = np.random.default_rng(seed)
    src, dst, n = powerlaw_graph(n, m, seed=seed)
    e = len(src)
    pad = m - e
    return dict(
        feats=rng.normal(size=(n, d_feat)).astype(np.float32),
        src=np.concatenate([src, np.full(pad, n - 1, np.int32)]).astype(np.int32),
        dst=np.concatenate([dst, np.full(pad, n - 1, np.int32)]).astype(np.int32),
        mask=np.concatenate([np.ones(e, bool), np.zeros(pad, bool)]),
        labels=rng.integers(0, n_classes, n).astype(np.int32),
        label_mask=np.ones(n, np.float32),
    )


def molecule_batch(
    seed: int, step: int, batch: int, nodes: int, edges: int, d_feat: int,
    with_pos: bool = True,
) -> dict:
    rng = np.random.default_rng((seed, step))
    N, E = batch * nodes, batch * edges
    offs = np.repeat(np.arange(batch) * nodes, edges)
    src = rng.integers(0, nodes, E) + offs
    dst = rng.integers(0, nodes, E) + offs
    out = dict(
        feats=rng.normal(size=(N, d_feat)).astype(np.float32),
        src=src.astype(np.int32),
        dst=dst.astype(np.int32),
        mask=np.ones(E, bool),
        graph_ids=np.repeat(np.arange(batch), nodes).astype(np.int32),
    )
    if with_pos:
        out["pos"] = (rng.normal(size=(N, 3)) * 2.0).astype(np.float32)
        out["energy"] = rng.normal(size=(batch,)).astype(np.float32)
    else:
        out["labels"] = rng.integers(0, 2, batch).astype(np.int32)
        out["label_mask"] = np.ones(batch, np.float32)
    return out


def recsys_batch(
    seed: int, step: int, batch: int, n_sparse: int, vocab: int, n_dense: int
) -> dict:
    rng = np.random.default_rng((seed, step))
    ids = rng.zipf(1.2, size=(batch, n_sparse)).clip(0, vocab - 1)
    return dict(
        sparse_ids=ids.astype(np.int32),
        dense=rng.normal(size=(batch, n_dense)).astype(np.float32),
        labels=rng.integers(0, 2, batch).astype(np.int32),
    )
