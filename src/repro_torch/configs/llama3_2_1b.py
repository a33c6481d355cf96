"""Llama-3.2 1B [hf meta-llama/Llama-3.2-1B]: 16L d=2048 32H GQA kv=8."""
from repro_torch.configs.base import TransformerConfig

CONFIG = TransformerConfig(
    name="llama3.2-1b",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_head=64,
    d_ff=8192,
    vocab=128256,
    rope_theta=500_000.0,
    tie_embeddings=True,
)

SMOKE = TransformerConfig(
    name="llama3.2-1b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=256,
    vocab=512,
    tie_embeddings=True,
    param_dtype="float32",
    compute_dtype="float32",
    remat=False,
)
