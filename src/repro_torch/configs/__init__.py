"""Model configurations of the port (the LM, GNN, recsys and ProbeSim
families; copies of ``repro.configs``)."""
from repro_torch.configs.base import (
    GNN_SHAPES,
    LM_SHAPES,
    RECSYS_SHAPES,
    GNNConfig,
    MoEConfig,
    RecsysConfig,
    ShapeSpec,
    TransformerConfig,
    get_config,
    shapes_for,
)

__all__ = ["GNN_SHAPES", "GNNConfig", "LM_SHAPES", "MoEConfig", "RECSYS_SHAPES",
           "RecsysConfig", "ShapeSpec", "TransformerConfig", "get_config",
           "shapes_for"]
