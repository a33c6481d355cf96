"""Yi-34B [arXiv:2403.04652; hf 01-ai/Yi-34B]: 60L d=7168 56H GQA kv=8."""
from repro_torch.configs.base import TransformerConfig

CONFIG = TransformerConfig(
    name="yi-34b",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=20480,
    vocab=64000,
    rope_theta=5_000_000.0,
)

SMOKE = TransformerConfig(
    name="yi-34b-smoke",
    n_layers=2,
    d_model=56,
    n_heads=7,
    n_kv_heads=1,
    d_head=8,
    d_ff=160,
    vocab=512,
    param_dtype="float32",
    compute_dtype="float32",
    remat=False,
)
