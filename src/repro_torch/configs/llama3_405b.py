"""Llama-3.1 405B [arXiv:2407.21783]: 126L d=16384 128H GQA kv=8 d_ff=53248."""
from repro_torch.configs.base import TransformerConfig

CONFIG = TransformerConfig(
    name="llama3-405b",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_head=128,
    d_ff=53248,
    vocab=128256,
    rope_theta=500_000.0,
)

SMOKE = TransformerConfig(
    name="llama3-405b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_head=8,
    d_ff=192,
    vocab=512,
    param_dtype="float32",
    compute_dtype="float32",
    remat=False,
)
