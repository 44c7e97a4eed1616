# The assigned architectures (exact published numbers), the shape grid and
# the smoke variants, as plain dataclasses.
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, shape_applicable
from repro_torch.configs.registry import (
    ARCH_NAMES,
    all_cells,
    batch_specs,
    decode_specs,
    get_config,
    get_smoke_config,
)

__all__ = [
    "SHAPES", "ModelConfig", "ShapeConfig", "shape_applicable",
    "ARCH_NAMES", "all_cells", "batch_specs", "decode_specs",
    "get_config", "get_smoke_config",
]
