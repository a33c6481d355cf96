"""GAT [arXiv:1710.10903] — BONUS architecture beyond the assigned ten,
exercising the SDDMM + segment-softmax kernel regime (taxonomy §GNN)."""
from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="gat-bonus", conv="gat", n_layers=2, d_hidden=64, aggregator="attn",
    n_classes=7,
)
SMOKE = GNNConfig(
    name="gat-bonus-smoke", conv="gat", n_layers=2, d_hidden=16, n_classes=4,
)
