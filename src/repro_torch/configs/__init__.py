"""Architecture configs of the port (qwen3-4b and xlstm-1.3b so far) and the shape suite."""
from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPE_SUITE,
    ArchConfig,
    ShapeCell,
    get_config,
    get_smoke_config,
    shape_cell,
)

__all__ = [
    "ARCH_IDS",
    "SHAPE_SUITE",
    "ArchConfig",
    "ShapeCell",
    "get_config",
    "get_smoke_config",
    "shape_cell",
]
