"""LM transformer for serving: GQA attention, dense SwiGLU FFN (port of
``repro.models.transformer.model``).

The parameters live in an ``nn.Module`` (``LM``) whose leaves keep the
reference's layouts (``attn.wq [d, H, dh]``, ``wo [H, dh, d]``, ``ffn.w_gate
[d, f]``, ...), so converting the reference's pytree is a copy
(``lm_from_params``).  The reference scans over stacked per-stage params;
here each stage is a ``ModuleList`` of blocks and the layers run in a Python
loop.  Remat does not apply to inference.  MoE stages, MLA and the training
loss wait for later slices (ROADMAP queue 1 item 14); the sharding specs
(``param_specs``, ``cache_specs``) have no meaning on one device.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

import repro_torch.models.common as cm
from repro_torch.models.common import rms_norm
from repro_torch.models.transformer import attention as attn

Tensor = torch.Tensor

NOT_PORTED = "ROADMAP queue 1 item 14"


def stages_of(cfg) -> list[tuple[int, str]]:
    if cfg.moe is None:
        return [(cfg.n_layers, "dense")]
    fd = cfg.moe.first_dense_layers
    out = []
    if fd:
        out.append((fd, "dense"))
    out.append((cfg.n_layers - fd, "moe"))
    return out


def _check_supported(cfg) -> None:
    if cfg.attention != "gqa":
        raise NotImplementedError(f"{cfg.attention} attention is not ported ({NOT_PORTED})")
    for _, kind in stages_of(cfg):
        if kind == "moe":
            raise NotImplementedError(f"MoE stages are not ported ({NOT_PORTED})")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class ParamTree(nn.Module):
    """Tensors of a nested dict as frozen parameters and child trees."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            else:
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))

    def tree(self) -> dict:
        """The nested dict of tensors (the reference's pytree layout); an
        ``LM``'s stages are left out (each block has its own tree)."""
        out: dict[str, Any] = {n: p for n, p in self.named_parameters(recurse=False)}
        for n, child in self.named_children():
            if isinstance(child, ParamTree):
                out[n] = child.tree()
        return out


class LM(ParamTree):
    """``embed``, ``final_norm``, optional ``lm_head`` and one ``stage{i}``
    ``ModuleList`` of blocks per stage of ``stages_of(cfg)``."""

    def __init__(self, cfg, top: dict, stages: list[list[dict]]):
        super().__init__(top)
        self.cfg = cfg
        for si, blocks in enumerate(stages):
            self.add_module(f"stage{si}", nn.ModuleList(ParamTree(b) for b in blocks))

    def stage(self, si: int) -> nn.ModuleList:
        return getattr(self, f"stage{si}")


def _init_block(gen: torch.Generator | None, cfg, dtype) -> dict:
    d = cfg.d_model
    dev = gen.device if gen is not None else torch.device("meta")
    return dict(
        attn=attn.init_gqa(gen, cfg, dtype),
        ffn=dict(
            w_gate=cm.dense_init(gen, d, cfg.d_ff, dtype),
            w_up=cm.dense_init(gen, d, cfg.d_ff, dtype),
            w_down=cm.dense_init(gen, cfg.d_ff, d, dtype),
        ),
        norm_attn=torch.ones((d,), dtype=dtype, device=dev),
        norm_ffn=torch.ones((d,), dtype=dtype, device=dev),
    )


def init_lm(gen: torch.Generator | None, cfg) -> LM:
    """Random weights drawn from ``gen`` on its device, with the reference's
    distributions: embed N(0, 0.02^2), dense N(0, 1/d_in), norms 1.  With
    ``gen=None`` the same tree as ``meta`` tensors (shapes and dtypes only:
    a dry-run's state)."""
    _check_supported(cfg)
    dtype = cm.dtype_of(cfg.param_dtype)
    if gen is None:
        dev = torch.device("meta")
        embed = torch.empty((cfg.vocab, cfg.d_model), dtype=dtype, device=dev)
    else:
        dev = gen.device
        embed = (torch.randn((cfg.vocab, cfg.d_model), generator=gen, device=dev)
                 * 0.02).to(dtype)
    top: dict[str, Tensor] = dict(
        embed=embed,
        final_norm=torch.ones((cfg.d_model,), dtype=dtype, device=dev),
    )
    if not cfg.tie_embeddings:
        top["lm_head"] = cm.dense_init(gen, cfg.d_model, cfg.vocab, dtype)
    stages = [[_init_block(gen, cfg, dtype) for _ in range(depth)]
              for depth, _ in stages_of(cfg)]
    return LM(cfg, top, stages)


def _tensor(a, device) -> Tensor:
    """numpy (float32, int, or ml_dtypes bfloat16) -> tensor on ``device``."""
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def lm_from_params(params: dict, cfg, device="cuda") -> LM:
    """The port's ``LM`` from the reference's ``init_lm`` pytree as numpy
    arrays (``embed``, ``final_norm``, optional ``lm_head`` and per stage
    ``stage{i}`` leaves stacked ``[L, ...]``).  Every leaf is copied as it
    is: the layouts are the same."""
    from repro_torch.graph.structs import resolve_device

    _check_supported(cfg)
    dev = resolve_device(device)
    top = {k: _tensor(params[k], dev) for k in ("embed", "final_norm", "lm_head")
           if k in params}

    def layer(tree: dict, li: int) -> dict:
        return {k: layer(v, li) if isinstance(v, dict) else _tensor(np.asarray(v)[li], dev)
                for k, v in tree.items()}

    stages = [[layer(params[f"stage{si}"], li) for li in range(depth)]
              for si, (depth, _) in enumerate(stages_of(cfg))]
    model = LM(cfg, top, stages)
    want = {"embed": (cfg.vocab, cfg.d_model), "final_norm": (cfg.d_model,)}
    for name, shape in want.items():
        got = tuple(getattr(model, name).shape)
        if got != shape:
            raise ValueError(f"lm_from_params: {name} is {got}, config wants {shape}")
    return model


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _blocks(model: LM, cfg, si: int, cdt):
    for block in model.stage(si):
        blk = block.tree()
        yield cm.cast_tree(blk, cdt) if cfg.param_dtype != cfg.compute_dtype else blk


def _block_forward(blk: dict, x: Tensor, positions: Tensor, cfg,
                   use_kernel: bool) -> Tensor:
    h = rms_norm(x, blk["norm_attn"], cfg.norm_eps)
    x = x + attn.gqa_forward(blk["attn"], h, positions, cfg, use_kernel=use_kernel)
    h = rms_norm(x, blk["norm_ffn"], cfg.norm_eps)
    f = blk["ffn"]
    return x + cm.swiglu(h, f["w_gate"], f["w_up"], f["w_down"])


def _head(model: LM) -> Tensor:
    head = getattr(model, "lm_head", None)
    return model.embed.T if head is None else head


def lm_forward(
    model: LM,
    tokens: Tensor,  # int [B, S]
    cfg,
    *,
    use_kernel: bool = False,
    last_only: bool = False,
) -> tuple[Tensor, Tensor]:
    """Returns (logits [B, S, V] fp32, aux_loss); last_only -> [B, 1, V].

    The aux loss is the MoE router's; dense stages give 0."""
    _check_supported(cfg)
    cdt = cm.dtype_of(cfg.compute_dtype)
    B, S = tokens.shape
    x = model.embed[tokens.long()].to(cdt)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    for si, _ in enumerate(stages_of(cfg)):
        for blk in _blocks(model, cfg, si, cdt):
            x = _block_forward(blk, x, positions, cfg, use_kernel)
    if last_only:
        x = x[:, -1:, :]  # serving: only the next-token logits matter
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    ldt = cm.dtype_of(getattr(cfg, "logits_dtype", "float32"))
    logits = (x @ _head(model).to(cdt)).to(ldt)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# Decode (serving)
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, s_max: int, device="cuda") -> list:
    """Per stage ``dict(k=[L, B, s_max, Hkv, dh], v=...)`` of zeros in the
    compute dtype (the reference's stacked layout)."""
    from repro_torch.graph.structs import resolve_device

    _check_supported(cfg)
    dev = resolve_device(device)
    cdt = cm.dtype_of(cfg.compute_dtype)
    shape = (batch, s_max, cfg.n_kv_heads, cfg.d_head)
    return [dict(k=torch.zeros((depth,) + shape, dtype=cdt, device=dev),
                 v=torch.zeros((depth,) + shape, dtype=cdt, device=dev))
            for depth, _ in stages_of(cfg)]


def lm_decode_step(
    model: LM,
    caches: list,
    tokens: Tensor,  # int [B] current token
    position: Tensor,  # int [B] its position
    cfg,
) -> tuple[list, Tensor]:
    """One decode step; returns (caches, logits [B, V] fp32).  The caches
    are updated in place at ``position`` and returned."""
    _check_supported(cfg)
    cdt = cm.dtype_of(cfg.compute_dtype)
    x = model.embed[tokens.long()][:, None, :].to(cdt)  # [B, 1, D]
    for si, _ in enumerate(stages_of(cfg)):
        cache = caches[si]
        for li, blk in enumerate(_blocks(model, cfg, si, cdt)):
            h = rms_norm(x, blk["norm_attn"], cfg.norm_eps)
            layer_cache = dict(k=cache["k"][li], v=cache["v"][li])
            _, a = attn.gqa_decode(blk["attn"], layer_cache, h, position, cfg)
            x = x + a
            h = rms_norm(x, blk["norm_ffn"], cfg.norm_eps)
            f = blk["ffn"]
            x = x + cm.swiglu(h, f["w_gate"], f["w_up"], f["w_down"])
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = (x @ _head(model).to(cdt))[:, 0]
    return caches, logits.float()
