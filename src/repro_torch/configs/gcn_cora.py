"""GCN on Cora [arXiv:1609.02907]: 2L d=16 sym-norm mean-agg."""
from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="gcn-cora", conv="gcn", n_layers=2, d_hidden=16, aggregator="mean",
    n_classes=7,
)
SMOKE = GNNConfig(
    name="gcn-cora-smoke", conv="gcn", n_layers=2, d_hidden=8, n_classes=4,
)
