"""Execution backends under :class:`~repro_torch.api.session.SimRankSession`
(port of ``repro.api.backend``).

The session owns specs, seeds, queues, tickets, stats and envelopes, and
asks its ``Backend`` to serve (``serve_one`` for a one-shot single-node
spec, ``serve_batch`` for a fused multi-query batch), to apply updates
(``apply_ops``, ``regrow``) and, where it sets ``supports_epoch``, to run
the fused update->query epoch (``epoch_batch``), and to name the graph's
hub nodes (``hub_nodes``) for the accuracy controller's probe cache.

* :class:`LocalBackend` does all of it on the device of its
  :class:`GraphHandle` through the core entry points.
* :class:`ShardedBackend` does it over a
  :class:`~repro_torch.launch.mesh.ShardMesh`: the graph cut into
  destination row blocks (:class:`ShardedGraphState` on the host, a
  carried :class:`~repro_torch.core.epoch.ShardEpochGraph` on the
  devices), served by the sharded lane probe (all-gather ``"spmd"`` or
  ``"ring"`` push) and updated shard-wise with ``GraphHandle.apply_batch``'s
  version and overflow semantics.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.api.handle import GraphHandle
from repro_torch.api.spec import QuerySpec
from repro_torch.core.epoch import (
    build_shard_epoch_graph,
    epoch_step,
    make_sharded_epoch_step,
    make_sharded_serve_step,
)
from repro_torch.core.multisource import (
    multi_source,
    multi_source_topk,
    query_seeds,
)
from repro_torch.core.params import ProbeSimParams
from repro_torch.core.probesim import single_source, topk
from repro_torch.graph.dynamic import UpdateBatch, make_update_batch
from repro_torch.graph.partition import pad_to_multiple, partition_ops_by_dst
from repro_torch.launch.mesh import ShardMesh


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


# ---------------------------------------------------------------------------
# Sharded graph state: dst-partitioned host buffers
# ---------------------------------------------------------------------------


class ShardedGraphState:
    """Destination-partitioned edge state with GraphHandle-style dynamics.

    The authoritative copy is a pair of host buffers ``[S, E]`` (global
    src/dst ids, per-shard FIFO order, ``counts[s]`` live entries each,
    padding -1): the layout of ``partition_edges_by_dst`` plus capacity
    headroom.  Updates are applied *shard-wise*: a batch is re-partitioned
    by destination shard (``dst // rows``) and each shard appends or
    deletes in its own buffer, with ``GraphHandle.apply_batch``'s
    semantics:

    * an insert applies iff its shard has room; a skipped insert sets the
      sticky ``overflow`` flag and is reported unapplied (never dropped);
    * a delete removes at most one live copy of its (src, dst) pair per
      batch, by stable compaction, with a per-op found mask;
    * ``version`` advances by exactly one per batch that changed the
      graph; ``regrow`` doubles per-shard capacity, clears ``overflow``
      and keeps ``version``.

    ``mutations`` counts every buffer or geometry change; device mirrors
    (the backend's epoch graph, the ring layout) are keyed on it.  The
    partition is deterministic and per-shard order is FIFO, so mirrors
    built from :meth:`to_host_edges` after any sequence of updates equal
    the incrementally updated ones.
    """

    def __init__(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        n: int,
        *,
        shards: int,
        capacity_per_shard: int | None = None,
        version: int = 0,
    ):
        src = np.asarray(src, np.int32).reshape(-1)
        dst = np.asarray(dst, np.int32).reshape(-1)
        self.n = int(n)
        self.shards = int(shards)
        self.n_pad = pad_to_multiple(self.n, self.shards)
        self.rows = self.n_pad // self.shards
        shard_of = dst // self.rows
        counts = np.bincount(shard_of, minlength=self.shards).astype(np.int64)
        e_cap = int(capacity_per_shard or 0)
        e_cap = max(e_cap, int(counts.max()) if len(src) else 1, 1)
        self._src_sh = np.full((self.shards, e_cap), -1, dtype=np.int32)
        self._dst_sh = np.full((self.shards, e_cap), -1, dtype=np.int32)
        self._counts = counts
        order = np.argsort(shard_of, kind="stable")  # FIFO within shard
        src_o, dst_o = src[order], dst[order]
        starts = np.zeros(self.shards + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        for s in range(self.shards):
            lo, hi = starts[s], starts[s + 1]
            self._src_sh[s, : hi - lo] = src_o[lo:hi]
            self._dst_sh[s, : hi - lo] = dst_o[lo:hi]
        self.version = int(version)
        self.overflow = False
        self._ring = None  # (mutations, mesh, RingGraph) cache
        self.mutations = 0

    # -- snapshot ------------------------------------------------------------

    @property
    def capacity_per_shard(self) -> int:
        return self._src_sh.shape[1]

    @property
    def num_edges(self) -> int:
        return int(self._counts.sum())

    def to_host_edges(self) -> tuple[np.ndarray, np.ndarray]:
        """Live edges, shard-major with per-shard FIFO order: the fixpoint
        of the partitioner, so a state rebuilt from them has identical
        buffers and device mirrors."""
        src = np.concatenate(
            [self._src_sh[s, : self._counts[s]] for s in range(self.shards)]
        )
        dst = np.concatenate(
            [self._dst_sh[s, : self._counts[s]] for s in range(self.shards)]
        )
        return src, dst

    def host_in_degrees(self) -> np.ndarray:
        _, dst = self.to_host_edges()
        return np.bincount(dst, minlength=self.n)[: self.n]

    def copy(self) -> "ShardedGraphState":
        """Deep copy (buffers nobody else references)."""
        st = ShardedGraphState(
            *self.to_host_edges(), self.n,
            shards=self.shards,
            capacity_per_shard=self.capacity_per_shard,
            version=self.version,
        )
        st.overflow = self.overflow
        return st

    # -- shard-wise updates --------------------------------------------------

    def _changed(self) -> None:
        self._ring = None
        self.mutations += 1

    def apply_ops(
        self, src: np.ndarray, dst: np.ndarray, insert: bool
    ) -> np.ndarray:
        """Apply one re-partitioned homogeneous batch; per-op applied mask."""
        src = np.asarray(src, np.int32).reshape(-1)
        dst = np.asarray(dst, np.int32).reshape(-1)
        applied = np.zeros(src.shape[0], dtype=bool)
        if src.shape[0] == 0:
            return applied
        shard_of, touched = partition_ops_by_dst(
            dst, self.n_pad, self.shards
        )
        for s in touched:
            idx = np.where(shard_of == s)[0]
            if insert:
                free = self.capacity_per_shard - int(self._counts[s])
                take = idx[:free]
                c = int(self._counts[s])
                self._src_sh[s, c : c + len(take)] = src[take]
                self._dst_sh[s, c : c + len(take)] = dst[take]
                self._counts[s] += len(take)
                applied[take] = True
                if len(take) < len(idx):
                    self.overflow = True  # sticky; skipped ops stay unapplied
            else:
                # first live (FIFO) match per pair, one copy per pair per
                # batch: stable argsort + searchsorted in one pass
                c = int(self._counts[s])
                live_s = self._src_sh[s, :c]
                live_d = self._dst_sh[s, :c]
                base = np.int64(self.n + 1)
                live_keys = live_s.astype(np.int64) * base + live_d
                op_keys = src[idx].astype(np.int64) * base + dst[idx]
                first_of_pair = np.zeros(len(idx), dtype=bool)
                first_of_pair[np.unique(op_keys, return_index=True)[1]] = True
                order = np.argsort(live_keys, kind="stable")
                pos = np.searchsorted(live_keys[order], op_keys)
                cand = np.where(first_of_pair & (pos < c))[0]
                hit = cand[live_keys[order[pos[cand]]] == op_keys[cand]]
                if len(hit):
                    kill = np.zeros(c, dtype=bool)
                    kill[order[pos[hit]]] = True
                    applied[idx[hit]] = True
                    keep = ~kill  # stable compaction: FIFO order preserved
                    nk = int(keep.sum())
                    self._src_sh[s, :nk] = live_s[keep]
                    self._dst_sh[s, :nk] = live_d[keep]
                    self._src_sh[s, nk:c] = -1
                    self._dst_sh[s, nk:c] = -1
                    self._counts[s] = nk
        if applied.any():
            self.version += 1  # once per batch that changed the graph
            self._changed()
        return applied

    def replay_applied(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        insert: np.ndarray,
        applied: np.ndarray,
    ) -> None:
        """Mirror a device-applied epoch batch into the host buffers.

        Replays the device's per-op decisions (``core.epoch.
        apply_shard_batch``): applied deletes first (first live FIFO match
        per op), then applied inserts (append in stream order).  ``version``
        advances once iff anything applied; the caller folds the device's
        overflow bit into the sticky flag.
        """
        src = np.asarray(src).astype(np.int64, copy=False)
        dst = np.asarray(dst).astype(np.int64, copy=False)
        insert = np.asarray(insert, bool)
        applied = np.asarray(applied, bool)
        if not applied.any():
            return
        for i in np.where(applied & ~insert)[0]:
            s, d = int(src[i]), int(dst[i])
            sh = d // self.rows
            c = int(self._counts[sh])
            hit = np.where(
                (self._src_sh[sh, :c] == s) & (self._dst_sh[sh, :c] == d)
            )[0]
            if not len(hit):  # the device said applied: the edge was live
                raise RuntimeError(
                    f"epoch replay: delete ({s}, {d}) not found on host "
                    f"shard {sh} — device/host state diverged"
                )
            j = int(hit[0])
            self._src_sh[sh, j : c - 1] = self._src_sh[sh, j + 1 : c].copy()
            self._dst_sh[sh, j : c - 1] = self._dst_sh[sh, j + 1 : c].copy()
            self._src_sh[sh, c - 1] = -1
            self._dst_sh[sh, c - 1] = -1
            self._counts[sh] -= 1
        for i in np.where(applied & insert)[0]:
            s, d = int(src[i]), int(dst[i])
            sh = d // self.rows
            c = int(self._counts[sh])
            if c >= self.capacity_per_shard:
                raise RuntimeError(
                    f"epoch replay: shard {sh} full on host but the device "
                    "applied an insert — device/host state diverged"
                )
            self._src_sh[sh, c] = s
            self._dst_sh[sh, c] = d
            self._counts[sh] += 1
        self.version += 1
        self._changed()

    def ensure_capacity(self, capacity_per_shard: int) -> None:
        """Grow per-shard buffers to at least ``capacity_per_shard``;
        never clears ``overflow`` and never touches ``version``."""
        new_cap = int(capacity_per_shard)
        if new_cap <= self.capacity_per_shard:
            return
        grown_s = np.full((self.shards, new_cap), -1, dtype=np.int32)
        grown_d = np.full((self.shards, new_cap), -1, dtype=np.int32)
        grown_s[:, : self.capacity_per_shard] = self._src_sh
        grown_d[:, : self.capacity_per_shard] = self._dst_sh
        self._src_sh, self._dst_sh = grown_s, grown_d
        self._changed()

    def regrow(self, *, capacity_per_shard: int | None = None,
               growth: float = 2.0) -> None:
        """Double (or set) per-shard capacity; clears ``overflow``,
        keeps ``version`` and the per-shard FIFO order."""
        new_cap = int(
            capacity_per_shard
            or max(int(self.capacity_per_shard * growth),
                   self.capacity_per_shard + 1)
        )
        if new_cap > self.capacity_per_shard:
            self.ensure_capacity(new_cap)
        self.overflow = False

    # -- device mirrors ------------------------------------------------------

    def ring_graph(self, mesh):
        """The ring layout of the live edges on ``mesh``, rebuilt after
        any change (it has no incremental maintenance)."""
        from repro_torch.core.ring import build_ring_graph

        if (self._ring is None or self._ring[0] != self.mutations
                or self._ring[1] is not mesh):
            src, dst = self.to_host_edges()
            self._ring = (self.mutations, mesh,
                          build_ring_graph(src, dst, self.n, mesh=mesh))
        return self._ring[2]


# ---------------------------------------------------------------------------
# Sharded backend
# ---------------------------------------------------------------------------


class ShardedBackend:
    """Sharded execution: dst-partitioned graph, sharded lane probe.

    Built from a :class:`GraphHandle` (``GraphHandle.shard`` does this) or
    a :class:`ShardedGraphState`.  ``shards`` is the row-partition count;
    ``mesh`` (a :class:`~repro_torch.launch.mesh.ShardMesh` of ``shards``
    devices) defaults to one shard per visible CUDA device.

    Serving is lane-batched: one step per query batch draws the whole
    pool off the carried :class:`~repro_torch.core.epoch.ShardEpochGraph`
    (keyed on the host ``mutations`` counter, so repeated drains reuse the
    device state), runs the compacted lane probe with the all-gather push
    (``probe="spmd"``) or the ring (``probe="ring"``), and reduces per
    query with the local epilogue; each query owns ``walk_chunk // Q``
    lane columns, as on the local backend.  ``use_kernel`` (default True)
    runs every level through the ``lane_probe`` kernel;
    ``frontier_dtype="bfloat16"`` sends the spmd exchange in bf16.

    Epochs (``supports_epoch``) apply the batch to the carried device
    state shard by shard and probe it through the spmd push in one step
    (``core.epoch.make_sharded_epoch_step``); the host state replays the
    applied mask afterwards, so it stays authoritative, and any host-path
    change (``apply_ops``, ``regrow``) makes the next step rebuild the
    device state from it, bit for bit equal to the carried one.
    """

    name = "sharded"
    supports_epoch = True
    variants = ("auto", "telescoped")

    def __init__(
        self,
        state: ShardedGraphState | GraphHandle,
        *,
        params: ProbeSimParams,
        shards: int | None = None,
        mesh: ShardMesh | None = None,
        walk_chunk: int = 128,
        probe: str = "spmd",
        edge_chunks: int = 4,
        capacity_per_shard: int | None = None,
        use_kernel: bool = True,
        frontier_dtype: str = "float32",
    ):
        if probe not in ("spmd", "ring"):
            raise ValueError(f"probe must be 'spmd' or 'ring', got {probe!r}")
        if frontier_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"frontier_dtype must be 'float32' or 'bfloat16', "
                f"got {frontier_dtype!r}"
            )
        if mesh is not None and not isinstance(mesh, ShardMesh):
            raise ValueError(
                f"ShardedBackend needs a ShardMesh (one device per row block "
                f"of the 'model' axis); got {type(mesh).__name__}"
            )
        if isinstance(state, GraphHandle):
            state = state.shard(
                shards=shards, mesh=mesh,
                capacity_per_shard=capacity_per_shard,
            )
        if shards is not None and shards != state.shards:
            raise ValueError(
                f"shards={shards} != state partitioned into {state.shards}"
            )
        if mesh is None:
            mesh = ShardMesh(shards=state.shards)
        if mesh.shards != state.shards:
            raise ValueError(
                f"mesh model extent {mesh.shards} != shards {state.shards}"
            )
        self.state = state
        self.params = params
        self.walk_chunk = int(walk_chunk)
        self.probe = probe
        self.edge_chunks = int(edge_chunks)
        self.use_kernel = bool(use_kernel)
        self.frontier_dtype = frontier_dtype
        self.mesh = mesh
        # the carried device state and the host mutation count it matches
        self._epoch_graph = None
        self._epoch_sync = -1
        self._hubs: tuple | None = None  # ((version, percentile), frozenset)

    # -- snapshot state ------------------------------------------------------

    @property
    def n(self) -> int:
        return self.state.n

    @property
    def version(self) -> int:
        return self.state.version

    @property
    def overflow(self) -> bool:
        return self.state.overflow

    def host_in_degrees(self) -> np.ndarray:
        return self.state.host_in_degrees()

    def hub_nodes(self, percentile: float) -> frozenset:
        """High in-degree hub set, cached per (graph version, percentile)."""
        ck = (self.version, float(percentile))
        if self._hubs is None or self._hubs[0] != ck:
            self._hubs = (
                ck, _hub_nodes_from_degrees(self.host_in_degrees(), percentile)
            )
        return self._hubs[1]

    def dispatch_label(self, variant: str) -> str:
        """Envelope ``variant`` field: the sharded path that served."""
        return f"sharded[{self.probe}]"

    def batch_dispatch_label(self, q: int) -> str:
        """The dispatch label with the batch's query count."""
        return f"sharded[{self.probe},Q={int(q)}]"

    def epoch_dispatch_label(self) -> str:
        """Epochs always probe through the spmd push (the ring layout has
        no incremental maintenance), so a ring backend stamps spmd on
        them."""
        return "sharded[spmd]"

    def to_host_edges(self) -> tuple[np.ndarray, np.ndarray]:
        return self.state.to_host_edges()

    # -- updates (shard-wise) ------------------------------------------------

    def apply_ops(
        self, src: np.ndarray, dst: np.ndarray, insert: bool
    ) -> np.ndarray:
        return self.state.apply_ops(src, dst, insert)

    def regrow(self, **kwargs) -> None:
        # GraphHandle.regrow's keywords mapped onto per-shard capacity; the
        # ELL width is re-derived from the degrees on the next rebuild
        kwargs.pop("k_max", None)
        cap = kwargs.pop("capacity", None)
        if cap is not None and "capacity_per_shard" not in kwargs:
            kwargs["capacity_per_shard"] = pad_to_multiple(
                int(cap), self.state.shards
            ) // self.state.shards
        if "capacity_per_shard" in kwargs:
            # an even split can undershoot the hot shard: always add room
            kwargs["capacity_per_shard"] = max(
                int(kwargs["capacity_per_shard"]),
                self.state.capacity_per_shard + 1,
            )
        self.state.regrow(**kwargs)

    # -- fused epochs (device-resident shard buffers) ------------------------

    def own_buffers(self) -> None:
        """Deep-copy the graph state so epochs never write caller buffers."""
        self.state = self.state.copy()
        self._epoch_graph = None
        self._epoch_sync = -1

    def _epoch_graph_state(self):
        """The carried device state, rebuilt when the host state moved.

        A rebuild rounds the per-shard capacity up to the edge-chunk
        multiple (growing the host buffers to match, so the device and
        host room checks agree) and sizes the ELL width to the largest
        in-degree plus 8: an ELL-full insert reports unapplied, sets
        ``overflow``, and the regrow that follows rebuilds wider.
        """
        if (
            self._epoch_graph is not None
            and self._epoch_sync == self.state.mutations
        ):
            return self._epoch_graph
        self._epoch_graph = None  # let the old blocks go before the new ones
        cap = pad_to_multiple(
            max(self.state.capacity_per_shard, self.edge_chunks),
            self.edge_chunks,
        )
        self.state.ensure_capacity(cap)
        src, dst = self.state.to_host_edges()
        deg_cap = (
            int(np.bincount(dst, minlength=self.state.n).max())
            if len(dst) else 0
        )
        self._epoch_graph = build_shard_epoch_graph(
            src, dst, self.state.n,
            capacity_per_shard=self.state.capacity_per_shard,
            k_max=max(deg_cap + 8, 16),
            mesh=self.mesh,
        )
        self._epoch_sync = self.state.mutations
        return self._epoch_graph

    def epoch_batch(self, batch: UpdateBatch, us, seeds, *, n_r: int,
                    top_k: int, lanes: int | None = None,
                    use_kernel: bool | None = None) -> tuple:
        """One fused sharded epoch: the batch applied to the carried device
        state shard by shard, then the query batch probed on it; the
        applied mask is replayed into the host state.  Same return contract
        as ``LocalBackend.epoch_batch``.  (``lanes`` is ignored: each query
        owns ``min(walk_chunk, n_r)`` lane columns, as in the JAX
        package.)"""
        st = self._epoch_graph_state()
        q = 0 if us is None else len(us)
        uk = self.use_kernel if use_kernel is None else bool(use_kernel)
        p = self.params
        step = make_sharded_epoch_step(
            st, q=q, n_r=n_r if q else 1, top_k=top_k if q else 0,
            max_len=p.max_len, sqrt_c=p.sqrt_c, eps_p=p.eps_p,
            eps_t=p.eps_t, truncation_shift=p.truncation_shift,
            walk_chunk=self.walk_chunk, edge_chunks=self.edge_chunks,
            use_kernel=uk,
        )
        b_src = batch.src.cpu().numpy()
        b_dst = batch.dst.cpu().numpy()
        b_ins = batch.insert.cpu().numpy()
        _, applied, overflow, est, idx, vals = step(st, batch, us,
                                                     seeds=seeds)
        applied = applied.numpy()
        self.state.replay_applied(b_src, b_dst, b_ins, applied)
        if overflow:
            self.state.overflow = True
        self._epoch_sync = self.state.mutations  # carried: still in sync
        if top_k and q:
            return applied, None, idx.cpu().numpy(), vals.cpu().numpy()
        if q:
            return applied, est.cpu().numpy(), None, None
        return applied, None, None, None

    # -- queries -------------------------------------------------------------

    def serve_one(self, spec: QuerySpec, seed: int, *, variant: str,
                  n_r: int) -> dict:
        est, idx, vals = self.serve_batch(
            spec.kind, [spec.node], [int(seed)], k=spec.k or 0, n_r=n_r,
        )
        if spec.kind == "single_source":
            return dict(scores=est[0])
        return dict(topk_nodes=idx[0], topk_scores=vals[0])

    def serve_batch(self, kind: str, us, seeds, *, seed=None, k: int = 0,
                    n_r: int) -> tuple:
        """One lane-batched sharded step per query batch, against the
        carried device state; returns ``(est, idx, vals)`` as host arrays
        (the unused side None).  Exactly one of ``seeds`` / ``seed`` is
        set."""
        us = np.asarray(us, np.int32).reshape(-1)
        q = us.shape[0]
        seeds = query_seeds(seed, seeds, q)
        st = self._epoch_graph_state()
        ring = (self.state.ring_graph(self.mesh) if self.probe == "ring"
                else None)
        p = self.params
        step = make_sharded_serve_step(
            st, q=q, n_r=int(n_r), lanes_q=max(1, self.walk_chunk // q),
            top_k=int(k), max_len=p.max_len, sqrt_c=p.sqrt_c,
            eps_p=p.eps_p, eps_t=p.eps_t,
            truncation_shift=p.truncation_shift, probe=self.probe,
            use_kernel=self.use_kernel, frontier_dtype=self.frontier_dtype,
        )
        est, idx, vals = step(st, torch.from_numpy(us), seeds=seeds,
                              ring=ring)
        if kind == "single_source":
            return est.cpu().numpy(), None, None
        return None, idx.cpu().numpy(), vals.cpu().numpy()
