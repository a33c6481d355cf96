"""Execution backends under :class:`~repro_torch.api.session.SimRankSession`
(port of ``repro.api.backend``, local backend only).

The session owns specs, seeds, queues, tickets, stats and envelopes, and
asks its ``Backend`` to serve (``serve_one`` for a one-shot single-node
spec, ``serve_batch`` for a fused multi-query batch), to apply updates
(``apply_ops``, ``regrow``) and, where it sets ``supports_epoch``, to run
the fused update->query epoch (``epoch_batch``), and to name the graph's
hub nodes (``hub_nodes``) for the accuracy controller's probe cache.
:class:`LocalBackend` does all of it on the device of its
:class:`GraphHandle` through the core entry points.  The sharded backend is
not ported yet (ROADMAP queue 1 item 12).
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.api.handle import GraphHandle
from repro_torch.api.spec import QuerySpec
from repro_torch.core.epoch import epoch_step
from repro_torch.core.multisource import multi_source, multi_source_topk
from repro_torch.core.params import ProbeSimParams
from repro_torch.core.probesim import single_source, topk
from repro_torch.graph.dynamic import UpdateBatch, make_update_batch


def _hub_nodes_from_degrees(deg: np.ndarray, percentile: float) -> frozenset:
    """Nodes at or above the ``percentile``-th in-degree among positive
    degrees — the hub set the accuracy controller's probe cache targets
    (PRSim's power-law analysis: a few heavy hitters absorb most query
    traffic on skewed graphs, so their probe rows are worth sharing)."""
    if not 0.0 <= percentile <= 100.0:
        raise ValueError(f"percentile must be in [0, 100], got {percentile}")
    deg = np.asarray(deg)
    pos = deg[deg > 0]
    if pos.size == 0:
        return frozenset()
    thr = max(float(np.percentile(pos, percentile)), 1.0)
    return frozenset(int(u) for u in np.flatnonzero(deg >= thr))


@runtime_checkable
class Backend(Protocol):
    """What the session needs from an execution substrate.

    Updates arrive as homogeneous sub-batches (one ``insert`` flag per
    call, duplicate delete pairs already split by the session) and return
    a per-op applied mask with ``GraphHandle.apply_batch`` semantics: an
    unapplied insert means capacity overflow (sticky ``overflow``, recover
    with ``regrow``), an unapplied delete means the edge was absent.
    Backends that set ``supports_epoch`` also run the fused epoch
    (``epoch_batch``: one padded ``UpdateBatch`` applied, then one query
    batch served on the new buffers) and make their graph state exclusively
    owned on request (``own_buffers``), since epochs write it in place.
    """

    name: str
    supports_epoch: bool
    variants: tuple[str, ...]

    @property
    def n(self) -> int: ...

    @property
    def version(self) -> int: ...

    @property
    def overflow(self) -> bool: ...

    def host_in_degrees(self) -> np.ndarray: ...

    def hub_nodes(self, percentile: float) -> frozenset: ...

    def dispatch_label(self, variant: str) -> str: ...

    def batch_dispatch_label(self, q: int) -> str: ...

    def epoch_dispatch_label(self) -> str: ...

    def serve_one(self, spec: QuerySpec, seed: int, *, variant: str,
                  n_r: int) -> dict: ...

    def serve_batch(self, kind: str, us, seeds, *, seed=None, k: int = 0,
                    n_r: int) -> tuple: ...

    def apply_ops(self, src: np.ndarray, dst: np.ndarray,
                  insert: bool) -> np.ndarray: ...

    def regrow(self, **kwargs) -> None: ...

    def to_host_edges(self) -> tuple[np.ndarray, np.ndarray]: ...

    def own_buffers(self) -> None: ...

    def epoch_batch(self, batch: UpdateBatch, us, seeds, *, n_r: int,
                    top_k: int, lanes: int | None = None,
                    use_kernel: bool | None = None) -> tuple: ...


class LocalBackend:
    """Single-device execution over an owned :class:`GraphHandle`.

    One-shot specs delegate to ``single_source``/``topk`` (so an explicit
    seed reproduces those calls exactly); batched specs run the fused
    multi-query step; updates go through the coordinated both-mirrors path
    in pow-2 bucketed batches; epochs run ``core.epoch.epoch_step`` on the
    handle's mirrors, in place.  ``use_kernel`` (default True) serves every
    probe level through the lane-probe kernel on the ELL mirror;
    ``kernel_dtype="bfloat16"`` stores its lane buffers in bf16 (queries
    only: epochs serve in fp32, as the JAX package's do).
    """

    name = "local"
    supports_epoch = True
    variants = ("auto", "telescoped", "tree", "reference", "randomized")

    def __init__(
        self,
        handle: GraphHandle,
        *,
        params: ProbeSimParams,
        walk_chunk: int = 256,
        use_kernel: bool = True,
        kernel_dtype: str = "float32",
    ):
        if not isinstance(handle, GraphHandle):
            raise TypeError("LocalBackend takes a GraphHandle")
        if kernel_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"kernel_dtype must be 'float32' or 'bfloat16', "
                f"got {kernel_dtype!r}"
            )
        self.handle = handle
        self.params = params
        self.walk_chunk = walk_chunk
        self.use_kernel = use_kernel
        self.kernel_dtype = kernel_dtype
        self._hubs: tuple | None = None  # ((version, percentile), frozenset)

    # -- snapshot state ------------------------------------------------------

    @property
    def n(self) -> int:
        return self.handle.n

    @property
    def version(self) -> int:
        return self.handle.version

    @property
    def overflow(self) -> bool:
        return self.handle.overflow

    def host_in_degrees(self) -> np.ndarray:
        return self.handle.eg.in_deg.cpu().numpy()

    def hub_nodes(self, percentile: float) -> frozenset:
        """High in-degree hub set, cached per (graph version, percentile):
        one device read per graph version."""
        ck = (self.version, float(percentile))
        if self._hubs is None or self._hubs[0] != ck:
            self._hubs = (
                ck, _hub_nodes_from_degrees(self.host_in_degrees(), percentile)
            )
        return self._hubs[1]

    def dispatch_label(self, variant: str) -> str:
        """Envelope ``variant`` field: the variant, verbatim."""
        return variant

    def batch_dispatch_label(self, q: int) -> str:
        return f"local[fused,Q={int(q)}]"

    def epoch_dispatch_label(self) -> str:
        """Envelope ``variant`` for epoch results (the fused local path)."""
        return "telescoped"

    def to_host_edges(self) -> tuple[np.ndarray, np.ndarray]:
        return self.handle.to_host_edges()

    # -- queries -------------------------------------------------------------

    def serve_one(self, spec: QuerySpec, seed: int, *, variant: str,
                  n_r: int) -> dict:
        """One single-node spec via ``single_source`` / ``topk``."""
        g, eg = self.handle.g, self.handle.eg
        p = (
            self.params
            if n_r == self.params.n_r
            else dataclasses.replace(self.params, n_r=n_r)
        )
        kw = dict(variant=variant, walk_chunk=self.walk_chunk,
                  use_kernel=self.use_kernel)
        if spec.kind == "single_source":
            est = single_source(seed, g, eg, spec.node, p, **kw)
            return dict(scores=est.cpu().numpy())
        idx, vals = topk(seed, g, eg, spec.node, spec.k, p, **kw)
        return dict(topk_nodes=idx.cpu().numpy(), topk_scores=vals.cpu().numpy())

    def serve_batch(self, kind: str, us, seeds, *, seed=None, k: int = 0,
                    n_r: int) -> tuple:
        """One fused multi-query dispatch; returns ``(est, idx, vals)`` as
        host arrays (est for single_source, idx/vals for topk — the unused
        side is None).  Exactly one of ``seeds`` (per-query streams) /
        ``seed`` (split into Q streams) is set."""
        g, eg = self.handle.g, self.handle.eg
        us = torch.as_tensor(np.asarray(us, np.int32))
        common = dict(
            lanes=self.walk_chunk, n_r=n_r, seeds=seeds,
            use_kernel=self.use_kernel, kernel_dtype=self.kernel_dtype,
        )
        if kind == "topk":
            idx, vals = multi_source_topk(seed, g, eg, us, k, self.params, **common)
            return None, idx.cpu().numpy(), vals.cpu().numpy()
        est = multi_source(seed, g, eg, us, self.params, **common)
        return est.cpu().numpy(), None, None

    # -- updates -------------------------------------------------------------

    def apply_ops(self, src: np.ndarray, dst: np.ndarray,
                  insert: bool) -> np.ndarray:
        """Apply one homogeneous sub-batch through the coordinated
        both-mirrors path, padded to the next power of two (as the JAX
        package pads, so the two see the same batches)."""
        bucket = 1 << (int(src.shape[0]) - 1).bit_length()
        batch = make_update_batch(src, dst, insert, batch_size=bucket,
                                  n=self.handle.n, device=self.handle.device)
        return self.handle.apply_batch(batch).numpy()[: src.shape[0]]

    def regrow(self, **kwargs) -> None:
        self.handle.regrow(**kwargs)

    # -- fused epochs --------------------------------------------------------

    def own_buffers(self) -> None:
        """Deep-copy the handle, so epochs write no tensor a caller holds."""
        self.handle = self.handle.copy()

    def epoch_batch(self, batch: UpdateBatch, us, seeds, *, n_r: int,
                    top_k: int, lanes: int | None = None,
                    use_kernel: bool | None = None) -> tuple:
        """One fused local epoch (``core.epoch.epoch_step``) over the owned
        mirrors, written in place.  ``us=None`` applies the batch only.
        Returns ``(applied [B], est, idx, vals)`` as host arrays (est for
        ``top_k == 0``, idx/vals otherwise; the unused side is None)."""
        h = self.handle
        if us is None:
            return h.apply_batch(batch).numpy(), None, None, None
        p = self.params
        q = len(us)
        h.g, h.eg, applied, est, idx, vals = epoch_step(
            h.g, h.eg, batch, torch.as_tensor(np.asarray(us, np.int32)),
            seeds=seeds,
            n_r=n_r,
            lanes_q=max(1, (lanes or self.walk_chunk) // q),
            max_len=p.max_len,
            sqrt_c=p.sqrt_c,
            eps_p=p.eps_p,
            eps_t=p.eps_t,
            truncation_shift=p.truncation_shift,
            use_kernel=self.use_kernel if use_kernel is None else use_kernel,
            top_k=top_k,
        )
        if top_k:
            return applied.numpy(), None, idx.cpu().numpy(), vals.cpu().numpy()
        return applied.numpy(), est.cpu().numpy(), None, None
