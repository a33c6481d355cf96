"""NequIP [arXiv:2101.03164]: 5L 32ch l_max=2 8 Bessel rbf cutoff 5A."""
from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="nequip", conv="nequip", n_layers=5, d_hidden=32, l_max=2, n_rbf=8,
    cutoff=5.0, n_classes=1,
)
SMOKE = GNNConfig(
    name="nequip-smoke", conv="nequip", n_layers=2, d_hidden=8, l_max=2,
    n_rbf=4, cutoff=5.0, n_classes=1,
)
