"""Architecture API of the port: one bundle per (arch x shape) cell.

``build(arch, shape_name, smoke=..., device=..., mesh=...)`` returns an
``ArchBundle`` exposing, as the reference's ``repro.arch`` does:

* ``init(gen)``     -> the state tuple: ``(model,)`` for prefill,
  ``(model, caches)`` for decode, drawn from a ``torch.Generator`` (on a
  ``meta`` bundle ``init()`` gives the shapes alone, as ``meta`` tensors);
  ``(graph,)`` for the ProbeSim family;
* ``input_specs()`` -> dict[name, TensorSpec] of the step's batch;
* ``step``          -> the serving step (prefill: ``step(model, batch)`` ->
  next-token logits [B, V]; decode: ``step(model, caches, batch)`` ->
  ``(caches, logits [B, V])``, caches updated in place; ProbeSim:
  ``step(graph, batch)`` -> ``(topk_idx [Q, k], topk_val [Q, k])``);
* ``model_flops()`` -> MODEL_FLOPS of one step.

The LM family's serving shapes (dense GQA, and the MoE / MLA configs
``deepseek-v2-lite-16b`` and ``qwen2-moe-a2.7b``) and the ProbeSim family
(the paper's own config, ``probesim``) are ported.  Training, the GNN and recsys families
and the sharding specs wait (ROADMAP queue 1 item 14).  The port runs on
the card unless asked otherwise: ``device`` defaults to "cuda" and
``use_kernel`` to True (the flash kernel on prefill; MLA's prefill needs
``use_kernel=False``: the kernel refuses its head widths).  The ProbeSim
bundles run on ``mesh`` (a ``ShardMesh``), by default one block on
``device``: the port's form of the reference's ambient mesh.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import (
    ProbeSimConfig,
    ShapeSpec,
    TransformerConfig,
    family_of,
    get_config,
    shapes_for,
)
from repro_torch.graph.structs import resolve_device

NOT_PORTED = "ROADMAP queue 1 item 14"


@dataclass(frozen=True)
class TensorSpec:
    shape: tuple[int, ...]
    dtype: torch.dtype


@dataclass
class ArchBundle:
    arch: str
    cfg: Any
    shape: ShapeSpec
    step: Callable
    init: Callable  # fn(gen) -> state tuple
    input_specs: Callable  # fn() -> dict[str, TensorSpec] (nested under "batch")
    model_flops: Callable  # fn() -> float
    notes: str = ""


def _lm_bundle(arch: str, cfg: TransformerConfig, shape: ShapeSpec, *,
               use_kernel: bool, device: torch.device) -> ArchBundle:
    from repro_torch.models.transformer import model as M

    B = shape.dims["global_batch"]
    S = shape.dims["seq_len"]

    def flops():
        if shape.kind == "prefill":
            return 2.0 * cfg.params_active * B * S
        # decode: one token per sequence + attention over the cache
        attn = 4.0 * B * S * cfg.n_heads * cfg.d_head
        return 2.0 * cfg.params_active * B + attn

    def gen_device(gen: torch.Generator):
        if gen.device.type != device.type:
            raise ValueError(f"generator on {gen.device}, bundle on {device}")

    if shape.kind == "prefill":

        def step(model, batch):
            logits, _ = M.lm_forward(model, batch["tokens"], cfg,
                                     use_kernel=use_kernel, last_only=True)
            return logits[:, 0]

        def init(gen=None):
            if device.type == "meta":
                return (M.init_lm(None, cfg),)
            gen_device(gen)
            return (M.init_lm(gen, cfg),)

        def input_specs():
            return dict(batch=dict(tokens=TensorSpec((B, S), torch.int32)))

    elif shape.kind == "decode":

        def step(model, caches, batch):
            return M.lm_decode_step(model, caches, batch["tokens"],
                                    batch["positions"], cfg)

        def init(gen=None):
            if device.type == "meta":
                return (M.init_lm(None, cfg), M.init_cache(cfg, B, S, device))
            gen_device(gen)
            return (M.init_lm(gen, cfg), M.init_cache(cfg, B, S, device))

        def input_specs():
            return dict(batch=dict(tokens=TensorSpec((B,), torch.int32),
                                   positions=TensorSpec((B,), torch.int32)))

    else:
        raise NotImplementedError(
            f"LM shape kind {shape.kind!r} (the train bundle) is not ported "
            f"({NOT_PORTED})"
        )

    return ArchBundle(
        arch=arch, cfg=cfg, shape=shape, step=step, init=init,
        input_specs=input_specs, model_flops=flops,
    )


# ---------------------------------------------------------------------------
# ProbeSim family (the paper)
# ---------------------------------------------------------------------------

REAL_GRAPH_MAX_N = 100_000  # init builds a real graph up to this n


def _probesim_bundle(arch: str, cfg: ProbeSimConfig, shape: ShapeSpec, *,
                     mesh) -> ArchBundle:
    from repro_torch.core.distributed import (
        build_sharded_graph,
        make_serve_step,
        sharded_graph_abstract,
    )
    from repro_torch.core.params import make_params
    from repro_torch.core.ring import (
        build_ring_graph,
        make_ring_serve_step,
        ring_graph_abstract,
    )
    from repro_torch.core.walks import make_generator

    d = shape.dims
    Q = d["queries"]
    Bw = d["walk_chunk"]
    params = make_params(cfg.n, c=cfg.c, eps_a=cfg.eps_a, delta=cfg.delta)
    L = params.max_len
    # the reference's 16 x 8, and a whole number of rows a block
    n_pad_mult = math.lcm(16 * 8, mesh.shards)
    m_pad_mult = 512 * 8  # divisible by all device counts x edge chunks
    ring = cfg.push_mode == "ring"
    fdt = torch.bfloat16 if cfg.frontier_dtype == "bfloat16" else torch.float32

    if ring:
        serve = make_ring_serve_step(cfg, queries=Q, walk_chunk=Bw,
                                     max_len=L, frontier_dtype=fdt)
    else:
        serve = make_serve_step(cfg, queries=Q, walk_chunk=Bw, max_len=L,
                                edge_chunks=8)

    def step(graph, batch, *, uniforms=None):
        """``batch = {"queries": [Q] int32, "seed": int}``; the walks come
        from a generator seeded with ``seed`` on the mesh's home device,
        or from ``uniforms = (cont, pick)`` (on a ``meta`` mesh, which has
        no generator, ``meta`` draws)."""
        gen = None
        if uniforms is None:
            gen = make_generator(int(batch["seed"]), mesh.home)
        return serve(graph, batch["queries"], gen, uniforms=uniforms)

    def init(gen=None):
        """The graph: a real ``powerlaw_graph(n, m, seed=0)`` up to
        ``REAL_GRAPH_MAX_N`` nodes (``gen`` is not used: the graph's seed is
        fixed, as in the reference) placed on the mesh, else its full-scale
        shapes as ``meta`` tensors over the mesh's block count."""
        shards = mesh.shards
        if cfg.n <= REAL_GRAPH_MAX_N:
            from repro_torch.graph.generators import powerlaw_graph

            src, dst, n = powerlaw_graph(cfg.n, cfg.m, seed=0)
            if ring:
                return (build_ring_graph(src, dst, n, mesh=mesh, csr=True),)
            return (build_sharded_graph(src, dst, n, mesh=mesh,
                                        pad_nodes=n_pad_mult,
                                        pad_edges=m_pad_mult),)
        if ring:
            # bucket padding: expected m/S^2 per bucket, 1.5x skew slack
            # (production rebalances hub destinations across buckets)
            e_max = -(-cfg.m * 3 // (2 * shards * shards) // 8) * 8
            return (ring_graph_abstract(cfg.n, cfg.m, shards, e_max),)
        return (sharded_graph_abstract(cfg.n, cfg.m, shards,
                                       pad_nodes=n_pad_mult,
                                       pad_edges=m_pad_mult),)

    def input_specs():
        # a seed in place of the reference's threefry key [2] uint32
        return dict(batch=dict(queries=TensorSpec((Q,), torch.int32),
                               seed=TensorSpec((), torch.int64)))

    def flops():
        # telescoped probe: (L-1) pushes x 2 flops/edge/column
        return 2.0 * cfg.m * Q * Bw * (L - 1)

    return ArchBundle(
        arch=arch, cfg=cfg, shape=shape, step=step, init=init,
        input_specs=input_specs, model_flops=flops,
        notes=f"n_r={params.n_r} walks/query; this step covers {Bw} of them",
    )


# ---------------------------------------------------------------------------


def build(arch: str, shape_name: str, *, smoke: bool = False,
          use_kernel: bool = True, device="cuda", mesh=None) -> ArchBundle:
    cfg = get_config(arch, smoke=smoke)
    shape = next(s for s in shapes_for(arch) if s.name == shape_name)
    if smoke:
        shape = _shrink_shape(cfg, shape)
    return build_with_cfg(arch, cfg, shape, use_kernel=use_kernel,
                          device=device, mesh=mesh)


def build_with_cfg(arch: str, cfg, shape: ShapeSpec, *, use_kernel: bool = True,
                   device="cuda", mesh=None) -> ArchBundle:
    """A bundle for an explicit config and shape (e.g. a cut batch).
    ``mesh`` (a ``ShardMesh``) places the ProbeSim family's row blocks; by
    default one block on ``device``."""
    if cfg.family == "lm":
        return _lm_bundle(arch, cfg, shape, use_kernel=use_kernel,
                          device=resolve_device(device))
    if cfg.family == "probesim":
        if mesh is None:
            from repro_torch.launch.mesh import ShardMesh

            mesh = ShardMesh([resolve_device(device)])
        return _probesim_bundle(arch, cfg, shape, mesh=mesh)
    raise NotImplementedError(f"family {cfg.family!r} is not ported ({NOT_PORTED})")


def _shrink_shape(cfg, shape: ShapeSpec) -> ShapeSpec:
    d = dict(shape.dims)
    if cfg.family == "lm":
        d.update(seq_len=min(d["seq_len"], 64), global_batch=min(d["global_batch"], 2))
    elif cfg.family == "probesim":
        d.update(queries=2, walk_chunk=16)
    else:
        raise NotImplementedError(f"family {cfg.family!r} is not ported ({NOT_PORTED})")
    return ShapeSpec(shape.name, shape.kind, d)


def is_applicable(arch: str, shape_name: str) -> tuple[bool, str]:
    """Cell applicability (the reference's rule: pure full-attention LMs
    skip long_500k)."""
    if family_of(arch) == "lm" and shape_name == "long_500k":
        return (
            False,
            "pure full-attention arch: long_500k skipped per assignment "
            "(decode itself is O(seq); reported as bonus cell)",
        )
    return True, ""
