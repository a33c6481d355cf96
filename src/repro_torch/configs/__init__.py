"""Model configurations of the port (LM and GNN families; copies of
``repro.configs``)."""
from repro_torch.configs.base import (
    GNN_SHAPES,
    LM_SHAPES,
    GNNConfig,
    MoEConfig,
    ShapeSpec,
    TransformerConfig,
    get_config,
    shapes_for,
)

__all__ = ["GNN_SHAPES", "GNNConfig", "LM_SHAPES", "MoEConfig", "ShapeSpec",
           "TransformerConfig", "get_config", "shapes_for"]
