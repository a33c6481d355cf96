"""Wide&Deep [arXiv:1606.07792]: 40 sparse fields, dim 32, MLP 1024-512-256."""
from repro_torch.configs.base import RecsysConfig

CONFIG = RecsysConfig(
    name="wide-deep", n_sparse=40, embed_dim=32, mlp=(1024, 512, 256),
    vocab_per_field=1_000_000, n_dense=13,
)
SMOKE = RecsysConfig(
    name="wide-deep-smoke", n_sparse=6, embed_dim=8, mlp=(32, 16),
    vocab_per_field=1000, n_dense=4,
)
