"""Config dataclasses and registry of the LM and ProbeSim families (copy of
``repro.configs.base``).

Each ported architecture registers one module in this package exposing
``CONFIG`` (full scale, the published numbers) and ``SMOKE`` (reduced,
CPU-runnable).  The dataclasses are the reference's, field for field, so a
config compares equal across the two packages.  The LM configs (dense, MoE
and MLA) and ProbeSim are ported; the GNN and recsys configs wait for their
slices (ROADMAP queue 1 item 14), but ``ARCH_IDS``, every family's shapes
and ``family_of`` cover them, so a dry-run can name each cell it skips.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field, replace
from typing import Any


@dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0  # total shared width (n_shared * d_ff_expert if 0)
    capacity_factor: float = 1.25
    norm_topk_prob: bool = True
    router_aux_weight: float = 0.001
    first_dense_layers: int = 0  # leading dense layers (DeepSeek style)
    d_ff_dense: int = 0  # width of those dense layers


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    attention: str = "gqa"  # "gqa" | "mla"
    # MLA (DeepSeek-V2) geometry
    kv_lora_rank: int = 0
    q_lora_rank: int = 0  # 0 = direct q projection (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    moe: MoEConfig | None = None
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True  # reference only: the port always loops layers
    attn_probs_dtype: str = "float32"  # bf16 = flash-kernel semantics
    logits_dtype: str = "float32"  # bf16 logits + f32 logsumexp accum
    microbatches: int = 1  # gradient-accumulation splits of the global batch
    family: str = "lm"

    @property
    def params_dense(self) -> int:
        """Approximate parameter count (for MODEL_FLOPS)."""
        d, L, v = self.d_model, self.n_layers, self.vocab
        if self.attention == "mla":
            attn = d * self.kv_lora_rank + self.kv_lora_rank * self.n_heads * (
                self.qk_nope_head_dim + self.v_head_dim
            ) + d * self.qk_rope_head_dim
            if self.q_lora_rank:
                attn += d * self.q_lora_rank + self.q_lora_rank * self.n_heads * (
                    self.qk_nope_head_dim + self.qk_rope_head_dim
                )
            else:
                attn += d * self.n_heads * (
                    self.qk_nope_head_dim + self.qk_rope_head_dim
                )
            attn += self.n_heads * self.v_head_dim * d
        else:
            attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
            attn += self.n_heads * self.d_head * d
        if self.moe is None:
            ffn = 3 * d * self.d_ff
            total = L * (attn + ffn)
        else:
            m = self.moe
            shared_w = m.d_ff_shared or m.n_shared * m.d_ff_expert
            moe_ffn = 3 * d * (m.n_routed * m.d_ff_expert + shared_w) + d * m.n_routed
            dense_ffn = 3 * d * (m.d_ff_dense or self.d_ff)
            total = (
                L * attn
                + m.first_dense_layers * dense_ffn
                + (L - m.first_dense_layers) * moe_ffn
            )
        total += 2 * d * v if not self.tie_embeddings else d * v
        return int(total)

    @property
    def params_active(self) -> int:
        """Active params per token (MoE: only routed top-k count)."""
        if self.moe is None:
            return self.params_dense
        m = self.moe
        d, L = self.d_model, self.n_layers
        inactive_per_moe_layer = 3 * d * (m.n_routed - m.top_k) * m.d_ff_expert
        return int(
            self.params_dense - (L - m.first_dense_layers) * inactive_per_moe_layer
        )


@dataclass(frozen=True)
class ProbeSimConfig:
    """The paper's own serving config (``configs/probesim.py``)."""

    name: str
    n: int
    m: int
    c: float = 0.6
    eps_a: float = 0.1
    delta: float = 0.01
    k_max_ell: int = 64  # ELL cap for walk sampling
    push_mode: str = "auto"  # "auto" (all-gather push) | "ring"
    frontier_dtype: str = "float32"  # "bfloat16" halves exchange volume
    family: str = "probesim"


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    dims: dict[str, Any] = field(default_factory=dict)


LM_SHAPES = [
    ShapeSpec("train_4k", "train", dict(seq_len=4096, global_batch=256)),
    ShapeSpec("prefill_32k", "prefill", dict(seq_len=32768, global_batch=32)),
    ShapeSpec("decode_32k", "decode", dict(seq_len=32768, global_batch=128)),
    ShapeSpec("long_500k", "decode", dict(seq_len=524288, global_batch=1)),
]

GNN_SHAPES = [
    ShapeSpec(
        "full_graph_sm",
        "full_graph",
        dict(n_nodes=2708, n_edges=10556, d_feat=1433),
    ),
    ShapeSpec(
        "minibatch_lg",
        "minibatch",
        dict(
            n_nodes=232_965,
            n_edges=114_615_892,
            batch_nodes=1024,
            fanout=(15, 10),
            d_feat=602,
        ),
    ),
    ShapeSpec(
        "ogb_products",
        "full_graph",
        dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100),
    ),
    ShapeSpec(
        "molecule",
        "batched_graphs",
        dict(n_nodes=30, n_edges=64, batch=128, d_feat=16),
    ),
]

RECSYS_SHAPES = [
    ShapeSpec("train_batch", "train", dict(batch=65536)),
    ShapeSpec("serve_p99", "serve", dict(batch=512)),
    ShapeSpec("serve_bulk", "serve", dict(batch=262144)),
    ShapeSpec(
        "retrieval_cand", "retrieval", dict(batch=1, n_candidates=1_000_000)
    ),
]

PROBESIM_SHAPES = [
    ShapeSpec("serve_batch", "simrank_serve", dict(queries=8, walk_chunk=256)),
    ShapeSpec("serve_online", "simrank_serve", dict(queries=1, walk_chunk=256)),
]

ARCH_IDS = [
    "deepseek-v2-lite-16b",
    "qwen2-moe-a2.7b",
    "llama3-405b",
    "yi-34b",
    "llama3.2-1b",
    "gin-tu",
    "gcn-cora",
    "gatedgcn",
    "nequip",
    "wide-deep",
    "probesim",  # the paper's own config
]

_MODULE_OF = {
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "llama3-405b": "llama3_405b",
    "yi-34b": "yi_34b",
    "llama3.2-1b": "llama3_2_1b",
    "probesim": "probesim",
}

NOT_PORTED = (
    "gin-tu", "gcn-cora", "gatedgcn", "nequip", "wide-deep", "gat-bonus",
)

# the family of each config not ported yet (the reference's ``cfg.family``)
_FAMILY_OF_UNPORTED = {
    "gin-tu": "gnn", "gcn-cora": "gnn", "gatedgcn": "gnn", "nequip": "gnn",
    "gat-bonus": "gnn", "wide-deep": "recsys",
}

_SHAPES_OF = {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES,
              "probesim": PROBESIM_SHAPES}


def get_config(arch: str, smoke: bool = False):
    if arch not in _MODULE_OF:
        if arch in NOT_PORTED:
            raise NotImplementedError(
                f"config {arch!r} is not ported yet (ROADMAP queue 1 item 14)"
            )
        raise KeyError(arch)
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_OF[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG


def family_of(arch: str) -> str:
    """The arch's family, ported or not."""
    if arch in _FAMILY_OF_UNPORTED:
        return _FAMILY_OF_UNPORTED[arch]
    return get_config(arch).family


def shapes_for(arch: str) -> list[ShapeSpec]:
    return list(_SHAPES_OF[family_of(arch)])


def scale_down(cfg, **overrides):
    """Helper for SMOKE configs."""
    return replace(cfg, **overrides)
