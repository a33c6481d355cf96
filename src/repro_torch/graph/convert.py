"""State carried across: build the port's graphs from another system's arrays.

The JAX package keeps the same COO + ELL mirror pair (``Graph``,
``EllGraph``, ``GraphHandle``).  These constructors take that state as
plain numpy arrays (``np.asarray`` of each field) and rebuild the port's
mirrors from it verbatim — slot order, ``version`` and ``overflow``
included — so both packages can be run on the same graph snapshot,
including one produced by dynamic updates.  Padding is the one exception:
the JAX package's updates overwrite a padding slot, while the port's add
onto the sentinel ``n`` they expect there, so any id above ``n`` becomes
``n`` and the live-prefix rules (``check_coo_prefix``,
``check_live_prefix``) are checked once, on ``device``.

The sharded state converts the same way: ``shard_epoch_graph_from_arrays``
takes the JAX package's ``ShardEpochGraph`` fields and
``ring_graph_from_arrays`` its ``RingGraph`` buckets, placed on a
``ShardMesh``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graph.structs import (
    EllGraph,
    Graph,
    check_coo_prefix,
    check_live_prefix,
    resolve_device,
)


def _i32(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.int32)).to(dev)


def graph_from_arrays(
    *,
    src,
    dst,
    n: int,
    in_deg=None,
    out_deg=None,
    num_edges: int | None = None,
    version: int = 0,
    overflow: bool = False,
    device="cuda",
) -> Graph:
    """COO ``Graph`` from padded ``src``/``dst`` (ids ``>= n`` = padding).

    The live edges must be the first ``num_edges`` positions; degrees and
    the edge count default to those of the live edges.  A buffer that
    breaks the rule raises ``ValueError``.
    """
    dev = resolve_device(device)
    src = np.minimum(np.asarray(src, np.int32).reshape(-1), n)
    dst = np.minimum(np.asarray(dst, np.int32).reshape(-1), n)
    live = src < n
    if in_deg is None:
        in_deg = np.bincount(dst[live], minlength=n)[:n]
    if out_deg is None:
        out_deg = np.bincount(src[live], minlength=n)[:n]
    g = Graph(
        src=_i32(src, dev),
        dst=_i32(dst, dev),
        in_deg=_i32(in_deg, dev),
        out_deg=_i32(out_deg, dev),
        num_edges=int(live.sum() if num_edges is None else num_edges),
        n=int(n),
        capacity=int(src.shape[0]),
        version=int(version),
        overflow=bool(overflow),
    )
    check_coo_prefix(g.src, g.dst, g.num_edges, g.n)
    return g


def ell_from_arrays(
    *,
    in_nbrs,
    in_deg,
    n: int,
    version: int = 0,
    overflow: bool = False,
    device="cuda",
) -> EllGraph:
    """``EllGraph`` from an ``[n, k_max]`` in-neighbor table and degrees.

    The table was built elsewhere, so its ids above ``n`` become ``n`` and
    the live-prefix rule the kernels and updates rely on (an id in
    ``[0, n)`` exactly when ``k < in_deg[v]``, ``n`` after it) is checked
    once, on ``device``; a table that breaks it raises ``ValueError``.
    """
    dev = resolve_device(device)
    in_nbrs = np.minimum(np.asarray(in_nbrs, np.int32), n)
    if in_nbrs.ndim != 2 or in_nbrs.shape[0] != n:
        raise ValueError(f"in_nbrs must be [n={n}, k_max], got {in_nbrs.shape}")
    table, deg = _i32(in_nbrs, dev), _i32(in_deg, dev)
    check_live_prefix(table, deg, n)
    return EllGraph(
        in_nbrs=table,
        in_deg=deg,
        n=int(n),
        k_max=int(in_nbrs.shape[1]),
        version=int(version),
        overflow=bool(overflow),
    )


def handle_from_arrays(
    *,
    src,
    dst,
    in_nbrs,
    in_deg,
    n: int,
    out_deg=None,
    num_edges: int | None = None,
    version: int = 0,
    overflow: bool = False,
    device="cuda",
):
    """``GraphHandle`` (COO + ELL mirrors) from one snapshot's arrays."""
    from repro_torch.api.handle import GraphHandle

    return GraphHandle(
        g=graph_from_arrays(
            src=src, dst=dst, n=n, in_deg=in_deg, out_deg=out_deg,
            num_edges=num_edges, version=version, overflow=overflow,
            device=device,
        ),
        eg=ell_from_arrays(
            in_nbrs=in_nbrs, in_deg=in_deg, n=n, version=version,
            overflow=overflow, device=device,
        ),
    )


def shard_epoch_graph_from_arrays(
    *,
    src_sh,
    dst_sh,
    counts,
    in_nbrs,
    in_deg,
    n: int,
    mesh,
):
    """``core.epoch.ShardEpochGraph`` on ``mesh`` from the JAX package's
    fields: COO buckets ``[S, E]`` (global ids, padding ``n_pad``),
    ``counts`` [S], the ELL table ``[n_pad, k_max]`` (padding ``n``) and
    ``in_deg`` [n_pad].  Padding ids above the sentinels become the
    sentinels, and the padding rules are checked
    (``core.epoch.check_shard_prefix``)."""
    from repro_torch.core.epoch import shard_epoch_graph_from_parts
    from repro_torch.graph.partition import pad_to_multiple

    n_pad = pad_to_multiple(int(n), mesh.shards)
    in_nbrs = np.minimum(np.asarray(in_nbrs, np.int32), n)
    return shard_epoch_graph_from_parts(
        np.minimum(np.asarray(src_sh, np.int32), n_pad),
        np.minimum(np.asarray(dst_sh, np.int32), n_pad),
        counts, in_nbrs, in_deg, int(n), k_max=int(in_nbrs.shape[1]),
        mesh=mesh,
    )


def ring_graph_from_arrays(*, src_sh, dst_sh, in_deg, n: int, mesh):
    """``core.ring.RingGraph`` on ``mesh`` from the JAX package's ring
    buckets ``[S, S, E]`` (block-relative ids, padding ``rows``) and
    ``in_deg`` [n_pad].  The JAX package's sampling CSR (``indptr``,
    ``indices``) and edge count have no counterpart: the port samples off
    the ELL blocks."""
    from repro_torch.core.ring import ring_graph_from_parts

    return ring_graph_from_parts(src_sh, dst_sh, in_deg, int(n), mesh)
