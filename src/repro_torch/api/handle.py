"""`GraphHandle` — one object owning the coordinated COO + ELL mirror pair
(port of ``repro.api.handle``).

ProbeSim needs the graph twice: the COO ``Graph`` is the *push*
representation and the ELL ``EllGraph`` the *gather* representation (the
kernels' table and the walk sampler).  The handle owns both plus the
snapshot metadata (``version``, ``overflow``):

    h = GraphHandle.from_edges(src, dst, n, device="cuda")

Dynamic updates (``apply_batch``, ``regrow``) and mesh placement
(``shard``) are not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.structs import (
    EllGraph,
    Graph,
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
        """Deep device copy (buffers nobody else references)."""

        def clone(x):
            return dataclasses.replace(
                x,
                **{
                    f.name: getattr(x, f.name).clone()
                    for f in dataclasses.fields(x)
                    if hasattr(getattr(x, f.name), "clone")
                },
            )

        return GraphHandle(g=clone(self.g), eg=clone(self.eg))

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

    def apply_batch(self, batch):
        raise NotImplementedError(
            "dynamic updates are not ported yet (ROADMAP queue 1 item 8)"
        )

    def regrow(self, **kwargs):
        raise NotImplementedError(
            "regrow is not ported yet (ROADMAP queue 1 item 8)"
        )

    def shard(self, **kwargs):
        raise NotImplementedError(
            "sharded placement is not ported yet (ROADMAP queue 1 item 12)"
        )
