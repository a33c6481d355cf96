"""State carried across: build the port's graphs from another system's arrays.

The JAX package keeps the same COO + ELL mirror pair (``Graph``,
``EllGraph``, ``GraphHandle``).  These constructors take that state as
plain numpy arrays (``np.asarray`` of each field) and rebuild the port's
mirrors from it verbatim — padding, slot order, ``version`` and
``overflow`` included — so both packages can be run on the same graph
snapshot, including one produced by dynamic updates.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graph.structs import (
    EllGraph,
    Graph,
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
    """COO ``Graph`` from padded ``src``/``dst`` (sentinel ``n`` = padding).

    Degrees and the edge count default to those of the live edges.
    """
    dev = resolve_device(device)
    src = np.asarray(src, np.int32).reshape(-1)
    dst = np.asarray(dst, np.int32).reshape(-1)
    live = src < n
    if in_deg is None:
        in_deg = np.bincount(dst[live], minlength=n)[:n]
    if out_deg is None:
        out_deg = np.bincount(src[live], minlength=n)[:n]
    return Graph(
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

    The table was built elsewhere, so the live-prefix rule the kernels rely
    on (``in_nbrs[v, k] < n`` exactly when ``k < in_deg[v]``) is checked
    once, on ``device``; a table that breaks it raises ``ValueError``.
    """
    dev = resolve_device(device)
    in_nbrs = np.asarray(in_nbrs, np.int32)
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
