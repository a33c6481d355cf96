"""`GraphHandle` — one object owning the coordinated COO + ELL mirror pair
(port of ``repro.api.handle``).

ProbeSim needs the graph twice: the COO ``Graph`` is the *push*
representation and the ELL ``EllGraph`` the *gather* representation (the
kernels' table and the walk sampler).  The handle owns both plus the
snapshot metadata (``version``, ``overflow``) and the recovery path
(``regrow``):

    h = GraphHandle.from_edges(src, dst, n, capacity=m + 1024, k_max=64,
                               device="cuda")
    h.apply_batch(batch)      # coordinated update of BOTH mirrors, in place
    if h.overflow:
        h.regrow()            # compaction + 2x buffers, clears the flag

``apply_batch`` writes the mirrors' tensors in place (``graph/dynamic.py``),
so whoever holds ``h.g`` / ``h.eg`` sees the new snapshot; ``copy()`` is
the way to keep an old one; ``shard()`` places a snapshot's edges in the
destination row blocks of the sharded backend.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.graph.dynamic import (
    UpdateBatch,
    apply_update_batch,
    regrow as _regrow,
)
from repro_torch.graph.structs import (
    EllGraph,
    Graph,
    check_coo_prefix,
    check_live_prefix,
    ell_from_edges,
    graph_from_edges,
    graph_to_host_edges,
)


@dataclasses.dataclass
class GraphHandle:
    """Owner of the coordinated ``(Graph, EllGraph)`` mirror pair."""

    g: Graph
    eg: EllGraph

    def __post_init__(self) -> None:
        if self.g.n != self.eg.n:
            raise ValueError(
                f"mirror mismatch: COO n={self.g.n} vs ELL n={self.eg.n}"
            )
        if self.g.device != self.eg.device:
            raise ValueError(
                f"mirror mismatch: COO on {self.g.device}, ELL on {self.eg.device}"
            )

    @classmethod
    def from_edges(
        cls,
        src: np.ndarray,
        dst: np.ndarray,
        n: int,
        *,
        capacity: int | None = None,
        k_max: int | None = None,
        device="cuda",
    ) -> "GraphHandle":
        """Build BOTH mirrors from one host edge list on ``device``.

        ``capacity`` (COO buffer) and ``k_max`` (ELL row width) reserve
        headroom for dynamic insertions.
        """
        return cls(
            g=graph_from_edges(src, dst, n, capacity=capacity, device=device),
            eg=ell_from_edges(src, dst, n, k_max=k_max, device=device),
        )

    def copy(self) -> "GraphHandle":
        """Deep device copy (buffers nobody else references).

        ``SimRankSession`` copies its handle at construction because its
        epochs write the mirrors in place.
        """
        return GraphHandle(g=_clone(self.g), eg=_clone(self.eg))

    @property
    def device(self):
        return self.eg.device

    @property
    def n(self) -> int:
        return self.g.n

    @property
    def capacity(self) -> int:
        return self.g.capacity

    @property
    def k_max(self) -> int:
        return self.eg.k_max

    @property
    def num_edges(self) -> int:
        return int(self.g.num_edges)

    @property
    def version(self) -> int:
        """Snapshot id: +1 per applied update batch (mirrors in lockstep)."""
        return int(self.eg.version)

    @property
    def overflow(self) -> bool:
        """Sticky capacity signal."""
        return bool(self.g.overflow)

    def to_host_edges(self) -> tuple[np.ndarray, np.ndarray]:
        """The live (non-padding) edge list on host."""
        return graph_to_host_edges(self.g)

    def apply_batch(self, batch: UpdateBatch):
        """Apply a padded update batch to BOTH mirrors (coordinated path).

        Writes the owned mirrors in place and returns the per-op ``applied``
        mask (bool, on the CPU).  An insert applies iff both mirrors have
        room; skips set the sticky ``overflow`` flag (never a silent drop):
        see graph/dynamic.py for the full contracts.
        """
        self.g, self.eg, applied = apply_update_batch(self.g, self.eg, batch)
        return applied

    def regrow(
        self,
        *,
        capacity: int | None = None,
        k_max: int | None = None,
        growth: float = 2.0,
    ) -> None:
        """Compact live edges and rebuild both mirrors with headroom.

        Keeps ``version`` (a representation change is not a graph change)
        and clears ``overflow`` on both mirrors.  The old mirrors are
        released once the new ones are built.
        """
        self.g, self.eg = _regrow(
            self.g, self.eg, capacity=capacity, k_max=k_max, growth=growth
        )

    def set_mirrors(
        self,
        g: Graph | None = None,
        eg: EllGraph | None = None,
        *,
        copy: bool = True,
    ) -> None:
        """Replace owned mirror(s) with externally built ones, safely.

        Validates ``n``, the device and the padding the in-place updates
        add onto (``check_coo_prefix``, ``check_live_prefix``), and (by
        default) own-copies the buffers: a handle whose mirrors are written
        in place by epochs must never share tensors with the caller.  Direct
        field assignment skips all of this; use it only with buffers the
        handle may own outright.
        """
        for x, what in ((g, "COO"), (eg, "ELL")):
            if x is None:
                continue
            if x.n != self.n:
                raise ValueError(f"{what} mirror n={x.n} != handle n={self.n}")
            if x.device != self.device:
                raise ValueError(
                    f"{what} mirror on {x.device}, handle on {self.device}"
                )
        if g is not None:
            check_coo_prefix(g.src, g.dst, g.num_edges, g.n)
        if eg is not None:
            check_live_prefix(eg.in_nbrs, eg.in_deg, eg.n)
        if g is not None:
            self.g = _clone(g) if copy else g
        if eg is not None:
            self.eg = _clone(eg) if copy else eg

    def shard(
        self,
        *,
        shards: int | None = None,
        mesh=None,
        capacity_per_shard: int | None = None,
    ):
        """Destination-partitioned copy of this handle's live edges.

        Returns a :class:`repro_torch.api.backend.ShardedGraphState`: per-shard
        host edge buffers (``partition_edges_by_dst`` layout, with this
        handle's spare COO capacity spread over the shards as headroom),
        from which the sharded backend builds its device state.  It starts
        at this handle's ``version`` and does not follow later updates of
        the handle: it is a placement of the current snapshot, as ``copy()``
        is.  ``shards`` defaults to the size of ``mesh`` (a ``ShardMesh``),
        else to the number of visible CUDA devices.
        """
        from repro_torch.api.backend import ShardedGraphState
        from repro_torch.graph.partition import pad_to_multiple

        if shards is None:
            shards = (mesh.shards if mesh is not None
                      else max(torch.cuda.device_count(), 1))
        src, dst = self.to_host_edges()
        if capacity_per_shard is None and self.capacity > len(src):
            # carry the handle's insertion headroom over, spread per shard
            rows = pad_to_multiple(self.n, shards) // shards
            per_shard_live = (
                int(np.bincount(dst // rows, minlength=shards).max())
                if len(dst) else 0
            )
            spare = self.capacity - len(src)
            capacity_per_shard = per_shard_live + max(spare // shards, 1)
        return ShardedGraphState(
            src, dst, self.n,
            shards=shards,
            capacity_per_shard=capacity_per_shard,
            version=self.version,
        )


def _clone(x):
    """A mirror whose tensors are fresh copies (host fields as they are)."""
    return dataclasses.replace(
        x,
        **{
            f.name: getattr(x, f.name).clone()
            for f in dataclasses.fields(x)
            if isinstance(getattr(x, f.name), torch.Tensor)
        },
    )
