"""The fused update->query *epoch*, local half (port of ``repro.core.epoch``).

ProbeSim's index-free claim means a query is exact against whatever the
graph is NOW, so the serving unit on a dynamic graph is an *epoch*: apply
one update batch to the device-resident mirrors, then serve one query
batch against the just-written buffers, in two stages:

* **apply stage**: ``graph/dynamic.py``'s coordinated path, writing both
  mirrors in place (the port's form of the JAX package's buffer donation);
* **probe stage**: ``core/multisource.py::fused_serve`` on the post-update
  buffers, with the lane-probe kernel on the kernel path.

The JAX package runs both stages in one jitted program with no host
transfer between them.  Here the apply is enqueued on the device and its
host-side results (applied mask, edge count, overflow bit) are read in one
copy after the probe has been enqueued (``settle``); the probe itself still
reads its per-level continue predicate on the host, as every serve does.

The mesh instantiation (``ShardEpochGraph`` and the sharded steps) is not
ported yet (ROADMAP queue 1 item 12).
"""
from __future__ import annotations

from repro_torch.core.multisource import fused_serve
from repro_torch.graph.dynamic import (
    UpdateBatch,
    apply_update_batch_async,
    settle,
)
from repro_torch.graph.structs import EllGraph, Graph


def epoch_step(
    g: Graph,
    eg: EllGraph,
    batch: UpdateBatch,
    us,
    *,
    seeds=None,
    uniforms=None,
    n_r: int,
    lanes_q: int,
    max_len: int,
    sqrt_c: float,
    eps_p: float,
    eps_t: float,
    truncation_shift: bool,
    use_kernel: bool = True,
    top_k: int = 0,
):
    """One fused LOCAL epoch: apply the update batch, serve the query batch.

    ``g`` and ``eg`` are written in place.  The probe pushes over ``eg``
    on the kernel path and over the COO mirror ``g`` without it, as the
    JAX package's epoch does.  ``seeds`` (one per query) or
    ``uniforms=(cont, pick)`` fix the walk draws, as in ``fused_serve``.
    Returns ``(g, eg, applied, est, idx, vals)``; ``applied`` is the
    per-op mask on the CPU, ``idx``/``vals`` are None when ``top_k == 0``.
    ``g.version`` / ``g.overflow`` carry the snapshot id and the capacity
    signal.
    """

    pending = apply_update_batch_async(g, eg, batch)
    est, idx, vals = fused_serve(
        g, eg, us,
        seeds=seeds, uniforms=uniforms,
        n_r=n_r, lanes_q=lanes_q, max_len=max_len, sqrt_c=sqrt_c,
        eps_p=eps_p, eps_t=eps_t, truncation_shift=truncation_shift,
        use_kernel=use_kernel, top_k=top_k,
    )
    applied = settle(g, eg, pending)
    return g, eg, applied, est, idx, vals
