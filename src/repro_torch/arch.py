"""Architecture API of the port: one bundle per (arch x shape) cell.

``build(arch, shape_name, smoke=..., device=...)`` returns an ``ArchBundle``
exposing, as the reference's ``repro.arch`` does:

* ``init(gen)``     -> the state tuple: ``(model,)`` for prefill,
  ``(model, caches)`` for decode, drawn from a ``torch.Generator``;
* ``input_specs()`` -> dict[name, TensorSpec] of the step's batch;
* ``step``          -> the serving step (prefill: ``step(model, batch)`` ->
  next-token logits [B, V]; decode: ``step(model, caches, batch)`` ->
  ``(caches, logits [B, V])``, caches updated in place);
* ``model_flops()`` -> MODEL_FLOPS of one step.

Only the LM family's serving shapes are ported.  Training, the other
families and the sharding specs wait (ROADMAP queue 1 item 14).  The port
runs on the card unless asked otherwise: ``device`` defaults to "cuda" and
``use_kernel`` to True (the flash kernel on prefill).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import ShapeSpec, TransformerConfig, get_config, shapes_for
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

        def init(gen):
            gen_device(gen)
            return (M.init_lm(gen, cfg),)

        def input_specs():
            return dict(batch=dict(tokens=TensorSpec((B, S), torch.int32)))

    elif shape.kind == "decode":

        def step(model, caches, batch):
            return M.lm_decode_step(model, caches, batch["tokens"],
                                    batch["positions"], cfg)

        def init(gen):
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


def build(arch: str, shape_name: str, *, smoke: bool = False,
          use_kernel: bool = True, device="cuda") -> ArchBundle:
    cfg = get_config(arch, smoke=smoke)
    shape = next(s for s in shapes_for(arch) if s.name == shape_name)
    if smoke:
        shape = _shrink_shape(cfg, shape)
    return build_with_cfg(arch, cfg, shape, use_kernel=use_kernel, device=device)


def build_with_cfg(arch: str, cfg, shape: ShapeSpec, *, use_kernel: bool = True,
                   device="cuda") -> ArchBundle:
    """A bundle for an explicit config and shape (e.g. a cut batch)."""
    if cfg.family == "lm":
        return _lm_bundle(arch, cfg, shape, use_kernel=use_kernel,
                          device=resolve_device(device))
    raise NotImplementedError(f"family {cfg.family!r} is not ported ({NOT_PORTED})")


def _shrink_shape(cfg, shape: ShapeSpec) -> ShapeSpec:
    d = dict(shape.dims)
    if cfg.family == "lm":
        d.update(seq_len=min(d["seq_len"], 64), global_batch=min(d["global_batch"], 2))
    else:
        raise NotImplementedError(f"family {cfg.family!r} is not ported ({NOT_PORTED})")
    return ShapeSpec(shape.name, shape.kind, d)
