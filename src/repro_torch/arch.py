"""Architecture API of the port: one bundle per (arch x shape) cell.

``build(arch, shape_name, smoke=..., device=..., mesh=...)`` returns an
``ArchBundle`` exposing, as the reference's ``repro.arch`` does:

* ``init(gen)``     -> the state tuple: ``(model, opt_state)`` for train
  (the model's leaves require grad), ``(model,)`` for prefill, ``(model,
  caches)`` for decode, drawn from a ``torch.Generator`` (on a ``meta``
  bundle ``init()`` gives the shapes alone, as ``meta`` tensors);
  ``(graph,)`` for the ProbeSim family;
* ``input_specs()`` -> dict[name, TensorSpec] of the step's batch;
* ``step``          -> train: ``step(model, opt_state, batch)`` -> ``(model,
  opt_state, metrics)``, one AdamW step written in place; serving
  (prefill: ``step(model, batch)`` ->
  next-token logits [B, V]; decode: ``step(model, caches, batch)`` ->
  ``(caches, logits [B, V])``, caches updated in place; ProbeSim:
  ``step(graph, batch)`` -> ``(topk_idx [Q, k], topk_val [Q, k])``);
* ``model_flops()`` -> MODEL_FLOPS of one step.

Every family of the reference is ported: the LM family (dense GQA, and
the MoE / MLA configs ``deepseek-v2-lite-16b`` and ``qwen2-moe-a2.7b``;
training, prefill and decode), the GNN family (training on the
``full_graph``, ``minibatch`` and ``batched_graphs`` shapes:
``step(params, opt_state, batch)`` over ``gnn_loss``, ``params`` the
reference's tree of tensors), the recsys family (``wide-deep``: train over
``widedeep_loss`` like a GNN; serve: ``step(params, batch)`` -> logits
[B]; retrieval: ``step(params, batch)`` -> ``torch.topk(scores, 100)``,
(values, indices) as ``jax.lax.top_k`` gives them) and the ProbeSim family
(the paper's own config, ``probesim``).  The reference's sharding specs
(``state_specs``, ``input_shardings``) are jax ``PartitionSpec``s and have
no counterpart: the port runs one device's program, and the dry-run
divides a step's counts evenly over the chips.  The port runs on the card
unless asked otherwise:
``device`` defaults to "cuda" and ``use_kernel`` to True (the flash kernel
on prefill; MLA's prefill needs ``use_kernel=False``: the kernel refuses
its head widths).  The train bundle needs ``use_kernel=False`` and raises
otherwise: the flash kernel has no backward (nor has the reference's), and
the reference trains through the plain attention too.  The ProbeSim
bundles run on ``mesh`` (a ``ShardMesh``), by default one block on
``device``: the port's form of the reference's ambient mesh.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import (
    GNNConfig,
    ProbeSimConfig,
    RecsysConfig,
    ShapeSpec,
    TransformerConfig,
    family_of,
    get_config,
    shapes_for,
)
from repro_torch.graph.structs import resolve_device

# the shape kinds a bundle trains on (its step takes and updates an
# optimizer state)
TRAIN_KINDS = ("train", "full_graph", "minibatch", "batched_graphs")


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


def _check_gen(gen: torch.Generator, device: torch.device) -> None:
    if gen.device.type != device.type:
        raise ValueError(f"generator on {gen.device}, bundle on {device}")


def _make_optimizer(cfg):
    """The reference's AdamW: warmup-cosine to 3e-4, bf16 moments when the
    parameters are bf16."""
    from repro_torch.training.optimizer import AdamW, warmup_cosine_schedule

    bf16 = getattr(cfg, "param_dtype", "") == "bfloat16"
    return AdamW(schedule=warmup_cosine_schedule(3e-4, 100, 10_000),
                 state_dtype=torch.bfloat16 if bf16 else torch.float32)


def _lm_bundle(arch: str, cfg: TransformerConfig, shape: ShapeSpec, *,
               use_kernel: bool, device: torch.device) -> ArchBundle:
    from repro_torch.models.transformer import model as M

    B = shape.dims["global_batch"]
    S = shape.dims["seq_len"]

    def flops():
        if shape.kind == "train":
            return 6.0 * cfg.params_active * B * S
        if shape.kind == "prefill":
            return 2.0 * cfg.params_active * B * S
        # decode: one token per sequence + attention over the cache
        attn = 4.0 * B * S * cfg.n_heads * cfg.d_head
        return 2.0 * cfg.params_active * B + attn

    if shape.kind == "train":
        if use_kernel:
            raise ValueError(
                f"{arch} {shape.name}: the train bundle runs the plain sdpa; the "
                "flash kernel has no backward (the reference's has none), so "
                "build it with use_kernel=False")
        from repro_torch.training.step import make_train_step

        opt = _make_optimizer(cfg)

        def loss_fn(model, batch):
            return M.lm_loss(model, batch, cfg, use_kernel=False)

        step = make_train_step(loss_fn, opt, microbatches=getattr(cfg, "microbatches", 1))

        def init(gen=None):
            if device.type == "meta":
                model = M.init_lm(None, cfg)
            else:
                _check_gen(gen, device)
                model = M.init_lm(gen, cfg)
            model.requires_grad_(True)  # serving's leaves stay frozen
            return (model, opt.init(model))

        def input_specs():
            return dict(batch=dict(tokens=TensorSpec((B, S), torch.int32),
                                   targets=TensorSpec((B, S), torch.int32)))

    elif shape.kind == "prefill":

        def step(model, batch):
            logits, _ = M.lm_forward(model, batch["tokens"], cfg,
                                     use_kernel=use_kernel, last_only=True)
            return logits[:, 0]

        def init(gen=None):
            if device.type == "meta":
                return (M.init_lm(None, cfg),)
            _check_gen(gen, device)
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
            _check_gen(gen, device)
            return (M.init_lm(gen, cfg), M.init_cache(cfg, B, S, device))

        def input_specs():
            return dict(batch=dict(tokens=TensorSpec((B,), torch.int32),
                                   positions=TensorSpec((B,), torch.int32)))

    else:
        raise ValueError(f"LM shape kind {shape.kind!r}")

    return ArchBundle(
        arch=arch, cfg=cfg, shape=shape, step=step, init=init,
        input_specs=input_specs, model_flops=flops,
    )


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------


def _pad_to(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def _gnn_batch_shapes(cfg: GNNConfig, shape: ShapeSpec) -> dict:
    from repro_torch.graph.sampler import block_shapes

    d = shape.dims
    if shape.kind == "full_graph":
        N, E, df = d["n_nodes"], d["n_edges"], d["d_feat"]
        G = 1
    elif shape.kind == "minibatch":
        bs = block_shapes(d["batch_nodes"], tuple(d["fanout"]))
        N, E, df = bs["table"], sum(bs["edges"]), d["d_feat"]
        G = 1
    else:  # batched_graphs (molecule)
        N = d["n_nodes"] * d["batch"]
        E = d["n_edges"] * d["batch"]
        df = d["d_feat"]
        G = d["batch"]
    # the reference's padding to 8,192 (its sharding divides every mesh
    # extent); padding rows and edges are masked by the layers
    if N > 8192:
        N = _pad_to(N, 8192)
    if E > 8192:
        E = _pad_to(E, 8192)
    return dict(N=N, E=E, df=df, G=G)


def _gnn_bundle(arch: str, cfg: GNNConfig, shape: ShapeSpec, *,
                device: torch.device) -> ArchBundle:
    from repro_torch.models.gnn.model import gnn_loss, init_gnn
    from repro_torch.training.step import make_train_step
    from repro_torch.training.tree import tree_map

    if shape.kind not in TRAIN_KINDS:
        raise ValueError(f"GNN shape kind {shape.kind!r}")
    s = _gnn_batch_shapes(cfg, shape)
    N, E, df, G = s["N"], s["E"], s["df"], s["G"]
    opt = _make_optimizer(cfg)
    is_nequip = cfg.conv == "nequip"
    batched = shape.kind == "batched_graphs"

    def loss_fn(params, batch):
        return gnn_loss(params, batch, cfg, n_graphs=G)

    step = make_train_step(loss_fn, opt)

    def init(gen=None):
        if device.type == "meta":
            params = init_gnn(None, cfg, df)
        else:
            _check_gen(gen, device)
            params = init_gnn(gen, cfg, df)
        params = tree_map(lambda p: p.requires_grad_(True), params)
        return (params, opt.init(params))

    def input_specs():
        f32, i32 = torch.float32, torch.int32
        b = dict(feats=TensorSpec((N, df), f32), src=TensorSpec((E,), i32),
                 dst=TensorSpec((E,), i32), mask=TensorSpec((E,), torch.bool))
        if is_nequip:
            b["pos"] = TensorSpec((N, 3), f32)
            b["energy"] = TensorSpec((G,), f32)
            if batched:
                b["graph_ids"] = TensorSpec((N,), i32)
        elif batched:
            b["graph_ids"] = TensorSpec((N,), i32)
            b["labels"] = TensorSpec((G,), i32)
            b["label_mask"] = TensorSpec((G,), f32)
        else:
            b["labels"] = TensorSpec((N,), i32)
            b["label_mask"] = TensorSpec((N,), f32)
        return dict(batch=b)

    def flops():
        d = cfg.d_hidden
        # messages ~ 2 E d, transforms ~ 2 N d^2 per layer (x3 for train)
        per_layer = 2.0 * E * d + 2.0 * N * d * d
        if is_nequip:
            per_layer = 16 * 2.0 * E * d * 9 + 2.0 * N * d * d * 9
        return 3.0 * cfg.n_layers * per_layer

    return ArchBundle(
        arch=arch, cfg=cfg, shape=shape, step=step, init=init,
        input_specs=input_specs, model_flops=flops,
    )


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------


def _recsys_bundle(arch: str, cfg: RecsysConfig, shape: ShapeSpec, *,
                   device: torch.device) -> ArchBundle:
    from repro_torch.models.recsys.widedeep import (
        init_widedeep,
        retrieval_scores,
        widedeep_forward,
        widedeep_loss,
    )
    from repro_torch.training.step import make_train_step
    from repro_torch.training.tree import tree_map

    d = shape.dims
    B = d.get("batch", 1)
    i32, f32 = torch.int32, torch.float32
    features = dict(sparse_ids=TensorSpec((B, cfg.n_sparse), i32),
                    dense=TensorSpec((B, cfg.n_dense), f32))

    def draw(gen):
        if device.type == "meta":
            return init_widedeep(None, cfg)
        _check_gen(gen, device)
        return init_widedeep(gen, cfg)

    if shape.kind == "train":
        opt = _make_optimizer(cfg)
        step = make_train_step(lambda p, b: widedeep_loss(p, b, cfg), opt)

        def init(gen=None):
            p = tree_map(lambda t: t.requires_grad_(True), draw(gen))
            return (p, opt.init(p))

        def input_specs():
            return dict(batch=dict(features, labels=TensorSpec((B,), i32)))

    elif shape.kind == "serve":

        def step(params, batch):
            return widedeep_forward(params, batch, cfg)

        def init(gen=None):
            return (draw(gen),)

        def input_specs():
            return dict(batch=dict(features))

    elif shape.kind == "retrieval":
        nc = d["n_candidates"]
        if nc > 8192:  # the reference's padding to 8,192
            nc = _pad_to(nc, 8192)

        def step(params, batch):
            scores = retrieval_scores(params, batch, cfg)
            return torch.topk(scores, 100)

        def init(gen=None):
            return (draw(gen),)

        def input_specs():
            return dict(batch=dict(features, cand_ids=TensorSpec((nc,), i32)))

    else:
        raise ValueError(f"recsys shape kind {shape.kind!r}")

    def flops():
        mlp_flops = 0
        d_in = cfg.n_sparse * cfg.embed_dim + cfg.n_dense
        for w in cfg.mlp:
            mlp_flops += 2 * d_in * w
            d_in = w
        mult = 3.0 if shape.kind == "train" else 1.0
        per_ex = mlp_flops + 2 * cfg.n_sparse * cfg.embed_dim
        total = mult * B * per_ex
        if shape.kind == "retrieval":
            total += 2.0 * d["n_candidates"] * cfg.embed_dim
        return total

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
    if cfg.family == "gnn":
        return _gnn_bundle(arch, cfg, shape, device=resolve_device(device))
    if cfg.family == "recsys":
        return _recsys_bundle(arch, cfg, shape, device=resolve_device(device))
    if cfg.family == "probesim":
        if mesh is None:
            from repro_torch.launch.mesh import ShardMesh

            mesh = ShardMesh([resolve_device(device)])
        return _probesim_bundle(arch, cfg, shape, mesh=mesh)
    raise ValueError(cfg.family)


def _shrink_shape(cfg, shape: ShapeSpec) -> ShapeSpec:
    d = dict(shape.dims)
    if cfg.family == "lm":
        d.update(seq_len=min(d["seq_len"], 64), global_batch=min(d["global_batch"], 2))
    elif cfg.family == "gnn":
        if shape.kind == "full_graph":
            d.update(n_nodes=128, n_edges=512, d_feat=24)
        elif shape.kind == "minibatch":
            d.update(n_nodes=256, n_edges=2048, batch_nodes=8, fanout=(3, 2), d_feat=24)
        else:
            d.update(batch=4, n_nodes=10, n_edges=20, d_feat=8)
    elif cfg.family == "recsys":
        d.update(batch=min(d.get("batch", 1), 32))
        if "n_candidates" in d:
            d["n_candidates"] = 512
    elif cfg.family == "probesim":
        d.update(queries=2, walk_chunk=16)
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
