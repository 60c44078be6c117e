"""Architecture configs of the port (one module per arch, copies of the
reference's) and the shape suite."""
from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPE_SUITE,
    ArchConfig,
    ShapeCell,
    all_configs,
    get_config,
    get_smoke_config,
    shape_cell,
)

__all__ = [
    "ARCH_IDS",
    "SHAPE_SUITE",
    "ArchConfig",
    "ShapeCell",
    "all_configs",
    "get_config",
    "get_smoke_config",
    "shape_cell",
]
