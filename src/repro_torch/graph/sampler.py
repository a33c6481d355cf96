"""Layer-wise uniform neighbor sampler (GraphSAGE-style) for minibatch GNNs
(a pinned numpy copy of ``repro.graph.sampler``).

Host-side (numpy) sampling over in-CSR, emitting **fixed-shape** padded
blocks so the device step sees the same shapes every step:

  frontier_0 = seeds                                  [B]
  hop h:   for every node in frontier_{h-1} sample fanout_h in-neighbors
           (with replacement if deg > fanout; sentinel-padded if deg == 0)
  edges_h: COO (src_pos, dst_pos) into the *node table*  [|frontier_{h-1}| * f_h]

The node table concatenates [seeds, hop1 samples, hop2 samples, ...]; node
features are gathered once by the data pipeline.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.graph.structs import CsrGraph


@dataclass
class SampledBlocks:
    nodes: np.ndarray  # int32 [N_table]  global node ids (sentinel = n)
    edge_src: list[np.ndarray]  # per hop: int32 positions into nodes
    edge_dst: list[np.ndarray]  # per hop: int32 positions into nodes
    edge_mask: list[np.ndarray]  # per hop: bool (live edge)
    seed_count: int
    frontier_sizes: list[int]


def block_shapes(batch: int, fanouts: tuple[int, ...]) -> dict:
    """Static shapes of the padded sample for (batch, fanouts)."""
    frontier = batch
    table = batch
    edges = []
    for f in fanouts:
        edges.append(frontier * f)
        table += frontier * f
        frontier = frontier * f
    return dict(table=table, edges=edges)


def sample_blocks(
    csr_in: CsrGraph,
    seeds: np.ndarray,
    fanouts: tuple[int, ...],
    rng: np.random.Generator,
) -> SampledBlocks:
    n = csr_in.n
    seeds = np.asarray(seeds, dtype=np.int32)
    batch = len(seeds)
    nodes = [seeds]
    pos_of_frontier = np.arange(batch, dtype=np.int32)
    frontier = seeds
    table_len = batch
    edge_src, edge_dst, edge_mask = [], [], []
    sizes = [batch]
    for f in fanouts:
        fr = np.clip(frontier, 0, n - 1).astype(np.int64)
        alive = frontier < n  # sentinel nodes from dead branches sample nothing
        deg = (csr_in.indptr[fr + 1] - csr_in.indptr[fr]).astype(np.int64)
        deg = np.where(alive, deg, 0)
        # sample f in-neighbors per frontier node (with replacement)
        r = rng.integers(0, 1 << 62, size=(len(frontier), f))
        idx = csr_in.indptr[fr][:, None] + (r % np.maximum(deg, 1)[:, None])
        idx = np.minimum(idx, max(csr_in.m - 1, 0))  # deg==0 rows are masked
        samp = csr_in.indices[idx].astype(np.int32)  # [F, f]
        live = (deg > 0)[:, None] & np.ones((1, f), dtype=bool)
        samp = np.where(live, samp, n)
        new_pos = table_len + np.arange(samp.size, dtype=np.int32)
        # edge: sampled in-neighbor (src) -> frontier node (dst)
        edge_src.append(new_pos)
        edge_dst.append(np.repeat(pos_of_frontier, f).astype(np.int32))
        edge_mask.append(live.reshape(-1))
        nodes.append(samp.reshape(-1))
        pos_of_frontier = new_pos
        frontier = samp.reshape(-1)
        table_len += samp.size
        sizes.append(samp.size)
    return SampledBlocks(
        nodes=np.concatenate(nodes).astype(np.int32),
        edge_src=edge_src,
        edge_dst=edge_dst,
        edge_mask=edge_mask,
        seed_count=batch,
        frontier_sizes=sizes,
    )
