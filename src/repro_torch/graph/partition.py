"""Graph partitioning over the row blocks of a device list (copy of
``repro.graph.partition``, pinned equal by ``tests/test_torch_sharded.py``).

Model-axis layout (used by the sharded backend):

* nodes are range-partitioned into ``num_shards`` equal blocks of
  ``n_pad / num_shards`` rows (n padded up);
* each shard owns the **in-edges of its node block** (destination
  partitioning): a propagation level gathers remote source scores (an
  all-gather of the frontier blocks, ``launch/mesh.py``) and scatters
  strictly locally; ``core/ring.py`` passes the blocks around a ring
  instead.

Edge shards are padded to the max shard size so the result is a rectangular
[S, E_shard] array.  Pure numpy: nothing here touches a device.
"""
from __future__ import annotations

import numpy as np


def pad_to_multiple(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def partition_edges_by_dst(
    src: np.ndarray,
    dst: np.ndarray,
    n: int,
    num_shards: int,
) -> dict:
    """Destination-partitioned edge shards.

    Returns dict with:
      src_sh   int32 [S, E]  global source ids (padding = n_pad)
      dst_sh   int32 [S, E]  *local* destination ids in [0, rows) (padding = rows)
      counts   int64 [S]     live edges per shard
      n_pad    int           padded node count
      rows     int           rows per shard (= n_pad / S)
    """
    n_pad = pad_to_multiple(n, num_shards)
    rows = n_pad // num_shards
    shard_of = dst // rows
    order = np.argsort(shard_of, kind="stable")
    src_o, dst_o = src[order], dst[order]
    shard_o = shard_of[order]
    counts = np.bincount(shard_o, minlength=num_shards).astype(np.int64)
    e_max = int(counts.max()) if len(src) else 1
    src_sh = np.full((num_shards, e_max), n_pad, dtype=np.int32)
    dst_sh = np.full((num_shards, e_max), rows, dtype=np.int32)
    starts = np.zeros(num_shards + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    for s in range(num_shards):
        lo, hi = starts[s], starts[s + 1]
        src_sh[s, : hi - lo] = src_o[lo:hi]
        dst_sh[s, : hi - lo] = dst_o[lo:hi] - s * rows
    return dict(src_sh=src_sh, dst_sh=dst_sh, counts=counts, n_pad=n_pad, rows=rows)


def partition_nodes(
    values: np.ndarray, num_shards: int, fill=0
) -> np.ndarray:
    """Split a per-node array into [S, rows] blocks (padding with ``fill``)."""
    n = values.shape[0]
    n_pad = pad_to_multiple(n, num_shards)
    rows = n_pad // num_shards
    out = np.full((n_pad,) + values.shape[1:], fill, dtype=values.dtype)
    out[:n] = values
    return out.reshape((num_shards, rows) + values.shape[1:])


def partition_edges_2d(
    src: np.ndarray,
    dst: np.ndarray,
    n: int,
    num_shards: int,
) -> dict:
    """2-D edge partition for the ring push (``core/ring.py``).

    Bucket (dst_shard, src_block): edges whose destination lives in
    dst_shard's rows and whose source lives in src_block's rows.  The ring
    schedule processes bucket (me, r) while the rows of block r are resident,
    then passes the row block on — collective volume equals one full frontier
    pass per level but overlaps with the per-bucket gather/scatter compute.

    Returns:
      src_sh  int32 [S, S, E]  source ids relative to their src block
      dst_sh  int32 [S, S, E]  destination ids relative to the dst shard
      n_pad, rows, e_max
    """
    n_pad = pad_to_multiple(n, num_shards)
    rows = n_pad // num_shards
    dshard = dst // rows
    sblock = src // rows
    key = dshard.astype(np.int64) * num_shards + sblock
    order = np.argsort(key, kind="stable")
    src_o, dst_o, key_o = src[order], dst[order], key[order]
    counts = np.bincount(key_o, minlength=num_shards * num_shards)
    e_max = max(int(counts.max()), 8)
    e_max = pad_to_multiple(e_max, 8)
    src_sh = np.full((num_shards, num_shards, e_max), rows, dtype=np.int32)
    dst_sh = np.full((num_shards, num_shards, e_max), rows, dtype=np.int32)
    starts = np.zeros(num_shards * num_shards + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    for ds in range(num_shards):
        for sb in range(num_shards):
            k = ds * num_shards + sb
            lo, hi = starts[k], starts[k + 1]
            src_sh[ds, sb, : hi - lo] = src_o[lo:hi] - sb * rows
            dst_sh[ds, sb, : hi - lo] = dst_o[lo:hi] - ds * rows
    return dict(src_sh=src_sh, dst_sh=dst_sh, n_pad=n_pad, rows=rows,
                e_max=e_max, counts=counts.reshape(num_shards, num_shards))


def partition_ops_by_dst(
    dst: np.ndarray, n_pad: int, num_shards: int
) -> tuple[np.ndarray, np.ndarray]:
    """Re-partition a stream of edge ops onto destination shards.

    The dynamic-update analogue of :func:`partition_edges_by_dst`: maps
    each op to ``shard = dst // rows`` under the same range partition the
    static build used, so shard-wise update application lands every op on
    the shard that owns its destination row block.

    Returns ``(shard_of [len(dst)], shard_ids)`` — the per-op shard and
    the sorted unique shards touched (iterate those to apply per shard).
    """
    rows = n_pad // num_shards
    shard_of = np.asarray(dst) // rows
    return shard_of, np.unique(shard_of)


def edge_balance_stats(counts: np.ndarray) -> dict:
    """Load-balance diagnostics for a destination partition."""
    c = np.asarray(counts, dtype=np.float64)
    return dict(
        max=float(c.max()),
        mean=float(c.mean()),
        imbalance=float(c.max() / max(c.mean(), 1.0)),
    )
