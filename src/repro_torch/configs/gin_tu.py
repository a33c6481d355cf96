"""GIN on TU datasets [arXiv:1810.00826]: 5L d=64 sum-agg learnable-eps."""
from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="gin-tu", conv="gin", n_layers=5, d_hidden=64, aggregator="sum",
    eps_learnable=True, n_classes=16,
)
SMOKE = GNNConfig(
    name="gin-tu-smoke", conv="gin", n_layers=2, d_hidden=16, n_classes=4,
)
