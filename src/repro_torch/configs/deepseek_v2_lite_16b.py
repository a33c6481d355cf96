"""DeepSeek-V2-Lite 16B [arXiv:2405.04434; hf deepseek-ai/DeepSeek-V2-Lite]
(copy of ``repro.configs.deepseek_v2_lite_16b``).

27L d_model=2048 16H vocab=102400, MLA (kv_lora=512, no q LoRA), MoE with 64
routed experts top-6 of width 1408 (full V2 has 160) and 2 shared; the first
layer is dense (first_k_dense_replace=1, width 10944).
"""
from repro_torch.configs.base import MoEConfig, TransformerConfig

CONFIG = TransformerConfig(
    name="deepseek-v2-lite-16b",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=10944,
    vocab=102400,
    attention="mla",
    kv_lora_rank=512,
    q_lora_rank=0,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    moe=MoEConfig(
        n_routed=64,
        top_k=6,
        d_ff_expert=1408,
        n_shared=2,
        d_ff_shared=2816,
        first_dense_layers=1,
        d_ff_dense=10944,
        norm_topk_prob=False,
    ),
    rope_theta=10000.0,
)

SMOKE = TransformerConfig(
    name="deepseek-v2-lite-16b-smoke",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab=512,
    attention="mla",
    kv_lora_rank=32,
    q_lora_rank=0,
    qk_nope_head_dim=16,
    qk_rope_head_dim=8,
    v_head_dim=16,
    moe=MoEConfig(
        n_routed=8,
        top_k=2,
        d_ff_expert=32,
        n_shared=2,
        d_ff_shared=64,
        first_dense_layers=1,
        d_ff_dense=128,
        norm_topk_prob=False,
        capacity_factor=4.0,
    ),
    rope_theta=10000.0,
    param_dtype="float32",
    compute_dtype="float32",
    remat=False,
)
