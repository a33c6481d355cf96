"""GatedGCN [arXiv:2003.00982 benchmarking-gnns]: 16L d=70 gated agg."""
from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="gatedgcn", conv="gatedgcn", n_layers=16, d_hidden=70,
    aggregator="gated", n_classes=16,
)
SMOKE = GNNConfig(
    name="gatedgcn-smoke", conv="gatedgcn", n_layers=3, d_hidden=16, n_classes=4,
)
