"""Model configurations of the port (LM family; copies of ``repro.configs``)."""
from repro_torch.configs.base import (
    LM_SHAPES,
    MoEConfig,
    ShapeSpec,
    TransformerConfig,
    get_config,
    shapes_for,
)

__all__ = ["LM_SHAPES", "MoEConfig", "ShapeSpec", "TransformerConfig",
           "get_config", "shapes_for"]
