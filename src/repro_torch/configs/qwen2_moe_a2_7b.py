"""Qwen1.5-MoE-A2.7B [hf Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (MHA: kv=16) moe_intermediate=1408, 60 routed top-4,
shared expert width 5632 ("4 shared" x 1408), vocab=151936 (copy of
``repro.configs.qwen2_moe_a2_7b``).
"""
from repro_torch.configs.base import MoEConfig, TransformerConfig

CONFIG = TransformerConfig(
    name="qwen2-moe-a2.7b",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=5632,
    vocab=151936,
    attention="gqa",
    moe=MoEConfig(
        n_routed=60,
        top_k=4,
        d_ff_expert=1408,
        n_shared=4,
        d_ff_shared=5632,
        norm_topk_prob=True,
    ),
    rope_theta=1_000_000.0,
)

SMOKE = TransformerConfig(
    name="qwen2-moe-a2.7b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab=512,
    moe=MoEConfig(
        n_routed=6,
        top_k=2,
        d_ff_expert=32,
        n_shared=1,
        d_ff_shared=64,
        capacity_factor=4.0,
    ),
    param_dtype="float32",
    compute_dtype="float32",
    remat=False,
)
