"""LM transformer for serving: GQA or MLA attention, dense or MoE FFN
(port of ``repro.models.transformer.model``).

Layers are grouped into homogeneous stages (DeepSeek-V2: 1 dense layer then
26 MoE layers).  The parameters live in an ``nn.Module`` (``LM``) whose
leaves keep the reference's layouts (``attn.wq [d, H, dh]``, ``wo [H, dh,
d]``, ``ffn.w_gate [d, f]``, MoE experts ``[E, d, f]``, MLA's ``w_dkv``,
...), so converting the reference's pytree is a copy (``lm_from_params``).
The reference scans over stacked per-stage params; here each stage is a
``ModuleList`` of blocks and the layers run in a Python loop.  ``lm_loss``
is the causal-LM loss of training: with ``cfg.remat`` and grad enabled each
block runs under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` of its scan body), so a block's activations are
recomputed in the backward pass.  Serving leaves are frozen; the train
bundle turns them on (``requires_grad_``).  ``lm_to_params`` (and ``stack_layers`` /
``unstack_layers`` under it) give the reference's stacked pytree back, so
parameters, optimizer moments and checkpoints cross between the packages.
The sharding specs (``param_specs``, ``cache_specs``) have no meaning on
one device.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

import repro_torch.models.common as cm
from repro_torch.models.common import rms_norm
from repro_torch.models.transformer import attention as attn
from repro_torch.models.transformer import moe as moe_mod

Tensor = torch.Tensor

def stages_of(cfg) -> list[tuple[int, str]]:
    if cfg.moe is None:
        return [(cfg.n_layers, "dense")]
    fd = cfg.moe.first_dense_layers
    out = []
    if fd:
        out.append((fd, "dense"))
    out.append((cfg.n_layers - fd, "moe"))
    return out


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


def _init_block(gen: torch.Generator | None, cfg, kind: str, dtype) -> dict:
    d = cfg.d_model
    dev = gen.device if gen is not None else torch.device("meta")
    if cfg.attention == "mla":
        a = attn.init_mla(gen, cfg, dtype)
    else:
        a = attn.init_gqa(gen, cfg, dtype)
    if kind == "moe":
        f = moe_mod.init_moe(gen, cfg, dtype)
    else:
        d_ff = cfg.moe.d_ff_dense if cfg.moe is not None and cfg.moe.d_ff_dense else cfg.d_ff
        f = dict(
            w_gate=cm.dense_init(gen, d, d_ff, dtype),
            w_up=cm.dense_init(gen, d, d_ff, dtype),
            w_down=cm.dense_init(gen, d_ff, d, dtype),
        )
    return dict(
        attn=a,
        ffn=f,
        norm_attn=torch.ones((d,), dtype=dtype, device=dev),
        norm_ffn=torch.ones((d,), dtype=dtype, device=dev),
    )


def init_lm(gen: torch.Generator | None, cfg) -> LM:
    """Random weights drawn from ``gen`` on its device, with the reference's
    distributions: embed N(0, 0.02^2), dense N(0, 1/d_in) (experts too; the
    router in fp32), norms 1.  With
    ``gen=None`` the same tree as ``meta`` tensors (shapes and dtypes only:
    a dry-run's state)."""
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
    stages = [[_init_block(gen, cfg, kind, dtype) for _ in range(depth)]
              for depth, kind in stages_of(cfg)]
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
    ``stage{i}`` leaves stacked ``[L, ...]``, MoE experts ``[L, E, d, f]``).
    Every leaf is copied as it is: the layouts are the same."""
    from repro_torch.graph.structs import resolve_device

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


def _split(name: str) -> tuple[str, int | None, list[str]]:
    """A ``named_parameters`` name -> (top key, layer or None, path below):
    "stage0.3.attn.wq" -> ("stage0", 3, ["attn", "wq"])."""
    parts = name.split(".")
    if parts[0].startswith("stage"):
        return parts[0], int(parts[1]), parts[2:]
    return parts[0], None, []


def stack_layers(named: dict) -> dict:
    """The reference's pytree layout from tensors keyed like an ``LM``'s
    ``named_parameters()`` (parameters, or optimizer moments of the same
    shapes): top leaves as they are, each stage's leaves stacked ``[L,
    ...]`` in layer order (``torch.stack``: a copy, on the tensors'
    device)."""
    tree: dict[str, Any] = {}
    layers: dict[tuple, dict[int, Tensor]] = {}
    for name, t in named.items():
        top, li, path = _split(name)
        if li is None:
            tree[top] = t
        else:
            layers.setdefault((top, *path), {})[li] = t
    for (top, *path), by_layer in layers.items():
        node = tree.setdefault(top, {})
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.stack([by_layer[i] for i in range(len(by_layer))])
    return tree


def unstack_layers(tree: dict, named: dict) -> None:
    """Copy the leaves of a reference-layout tree (tensors or numpy, bf16
    upcast to fp32 included) into the tensors keyed like ``named_parameters()``,
    in place, each cast to its tensor's dtype (the inverse of
    ``stack_layers``)."""
    with torch.no_grad():
        for name, t in named.items():
            top, li, path = _split(name)
            node = tree[top]
            for key in path:
                node = node[key]
            if li is not None:
                node = node[li]
            src = node if isinstance(node, Tensor) else _tensor(node, "cpu")
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"unstack_layers: {name} is {tuple(t.shape)}, "
                                 f"the tree's leaf {tuple(src.shape)}")
            t.copy_(src)


def to_numpy(tree):
    """A nested dict of tensors as numpy on the host; bf16 upcast to fp32
    (lossless: numpy has no bf16)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def lm_to_params(model: LM) -> dict:
    """The reference's ``init_lm`` pytree of ``model`` as numpy (the
    inverse of ``lm_from_params``; bf16 leaves upcast to fp32)."""
    return to_numpy(stack_layers({n: p.detach().cpu()
                                  for n, p in model.named_parameters()}))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _block_tree(block: ParamTree, cfg, cdt) -> dict:
    """A block's leaves, cast to the compute dtype when the params differ."""
    blk = block.tree()
    return cm.cast_tree(blk, cdt) if cfg.param_dtype != cfg.compute_dtype else blk


def _ffn(blk: dict, h: Tensor, cfg, kind: str) -> tuple[Tensor, Tensor | None]:
    """The block's FFN on ``h``: (output, the MoE aux loss or None)."""
    f = blk["ffn"]
    if kind == "moe":
        return moe_mod.moe_forward(f, h, cfg)
    return cm.swiglu(h, f["w_gate"], f["w_up"], f["w_down"]), None


def _block_forward(blk: dict, x: Tensor, positions: Tensor, cfg, kind: str,
                   use_kernel: bool) -> tuple[Tensor, Tensor | None]:
    h = rms_norm(x, blk["norm_attn"], cfg.norm_eps)
    fwd = attn.mla_forward if cfg.attention == "mla" else attn.gqa_forward
    x = x + fwd(blk["attn"], h, positions, cfg, use_kernel=use_kernel)
    h = rms_norm(x, blk["norm_ffn"], cfg.norm_eps)
    f, aux = _ffn(blk, h, cfg, kind)
    return x + f, aux


def _layer(block: ParamTree, x: Tensor, positions: Tensor, cfg, kind: str,
           use_kernel: bool, cdt) -> tuple[Tensor, Tensor | None]:
    """One block, its leaves cast to the compute dtype inside (under remat
    the cast is recomputed too, as in the reference's checkpointed body)."""
    return _block_forward(_block_tree(block, cfg, cdt), x, positions, cfg, kind,
                          use_kernel)


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

    The aux loss is the MoE routers' summed over the layers; dense stages
    add 0.  With ``cfg.remat`` and grad enabled each block is checkpointed
    (non-reentrant; no RNG state: a block draws nothing)."""
    cdt = cm.dtype_of(cfg.compute_dtype)
    B, S = tokens.shape
    x = model.embed[tokens.long()].to(cdt)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for si, (_, kind) in enumerate(stages_of(cfg)):
        for block in model.stage(si):
            args = (block, x, positions, cfg, kind, use_kernel, cdt)
            if remat:
                x, aux = checkpoint(_layer, *args, use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                x, aux = _layer(*args)
            if aux is not None:
                aux_total = aux_total + aux
    if last_only:
        x = x[:, -1:, :]  # serving: only the next-token logits matter
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    ldt = cm.dtype_of(getattr(cfg, "logits_dtype", "float32"))
    logits = (x @ _head(model).to(cdt)).to(ldt)
    return logits, aux_total


def lm_loss(model: LM, batch: dict, cfg, *, use_kernel: bool = False):
    """Causal-LM cross entropy plus the MoE aux loss: ``(loss, dict(nll=,
    aux=))``.

    batch: either {tokens [B, S+1]} (shifted here) or {tokens [B, S],
    targets [B, S]} (pre-shifted by the data pipeline).  The logsumexp runs
    in fp32 and the gold logit is gathered, as in the reference."""
    tokens = batch["tokens"]
    if "targets" in batch:
        inp, tgt = tokens, batch["targets"]
    else:
        inp, tgt = tokens[:, :-1], tokens[:, 1:]
    logits, aux = lm_forward(model, inp, cfg, use_kernel=use_kernel)
    logz = torch.logsumexp(logits.float(), dim=-1)
    gold = torch.gather(logits, -1, tgt.long()[..., None])[..., 0]
    nll = (logz - gold.float()).mean()
    return nll + aux, dict(nll=nll, aux=aux)


# ---------------------------------------------------------------------------
# Decode (serving)
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, s_max: int, device="cuda") -> list:
    """Per stage ``dict(k=[L, B, s_max, Hkv, dh], v=...)`` (GQA) or
    ``dict(c_kv=[L, B, s_max, r], k_rope=[L, B, s_max, dr])`` (MLA) of zeros
    in the compute dtype (the reference's stacked layout)."""
    from repro_torch.graph.structs import resolve_device

    dev = resolve_device(device)
    cdt = cm.dtype_of(cfg.compute_dtype)
    if cfg.attention == "mla":
        shapes = dict(c_kv=(batch, s_max, cfg.kv_lora_rank),
                      k_rope=(batch, s_max, cfg.qk_rope_head_dim))
    else:
        kv = (batch, s_max, cfg.n_kv_heads, cfg.d_head)
        shapes = dict(k=kv, v=kv)
    return [{k: torch.zeros((depth,) + shape, dtype=cdt, device=dev)
             for k, shape in shapes.items()}
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
    cdt = cm.dtype_of(cfg.compute_dtype)
    x = model.embed[tokens.long()][:, None, :].to(cdt)  # [B, 1, D]
    decode = attn.mla_decode if cfg.attention == "mla" else attn.gqa_decode
    for si, (_, kind) in enumerate(stages_of(cfg)):
        cache = caches[si]
        for li, block in enumerate(model.stage(si)):
            blk = _block_tree(block, cfg, cdt)
            h = rms_norm(x, blk["norm_attn"], cfg.norm_eps)
            layer_cache = {k: c[li] for k, c in cache.items()}  # views: written in place
            _, a = decode(blk["attn"], layer_cache, h, position, cfg)
            x = x + a
            h = rms_norm(x, blk["norm_ffn"], cfg.norm_eps)
            x = x + _ffn(blk, h, cfg, kind)[0]
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = (x @ _head(model).to(cdt))[:, 0]
    return caches, logits.float()
