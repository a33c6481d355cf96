"""Execution backends under :class:`~repro_torch.api.session.SimRankSession`
(port of ``repro.api.backend``, local backend only).

The session owns specs, seeds, queues, tickets, stats and envelopes, and
asks its ``Backend`` only to serve: ``serve_one`` for a one-shot
single-node spec, ``serve_batch`` for a fused multi-query batch.
:class:`LocalBackend` serves on the device of its :class:`GraphHandle`
through the core entry points.  The sharded backend, the update stage and
the fused epoch stage are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.api.handle import GraphHandle
from repro_torch.api.spec import QuerySpec
from repro_torch.core.multisource import multi_source, multi_source_topk
from repro_torch.core.params import ProbeSimParams
from repro_torch.core.probesim import single_source, topk


@runtime_checkable
class Backend(Protocol):
    """What the session needs from an execution substrate."""

    name: str
    variants: tuple[str, ...]

    @property
    def n(self) -> int: ...

    @property
    def version(self) -> int: ...

    @property
    def overflow(self) -> bool: ...

    def host_in_degrees(self) -> np.ndarray: ...

    def dispatch_label(self, variant: str) -> str: ...

    def batch_dispatch_label(self, q: int) -> str: ...

    def serve_one(self, spec: QuerySpec, seed: int, *, variant: str,
                  n_r: int) -> dict: ...

    def serve_batch(self, kind: str, us, seeds, *, seed=None, k: int = 0,
                    n_r: int) -> tuple: ...

    def to_host_edges(self) -> tuple[np.ndarray, np.ndarray]: ...


class LocalBackend:
    """Single-device execution over an owned :class:`GraphHandle`.

    One-shot specs delegate to ``single_source``/``topk`` (so an explicit
    seed reproduces those calls exactly); batched specs run the fused
    multi-query step.  ``use_kernel`` (default True) serves every probe
    level through the lane-probe kernel on the ELL mirror;
    ``kernel_dtype="bfloat16"`` stores its lane buffers in bf16.
    """

    name = "local"
    variants = ("auto", "telescoped", "tree", "reference")

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

    def dispatch_label(self, variant: str) -> str:
        """Envelope ``variant`` field: the variant, verbatim."""
        return variant

    def batch_dispatch_label(self, q: int) -> str:
        return f"local[fused,Q={int(q)}]"

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
