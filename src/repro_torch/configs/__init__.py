from repro_torch.configs.base import (
    BlockSpec,
    MeshConfig,
    ModelConfig,
    SEBSConfig,
    SegmentSpec,
    ServeConfig,
    TrainConfig,
)
from repro_torch.configs.registry import ARCHS, get_config, list_archs
from repro_torch.configs.shapes import INPUT_SHAPES, input_specs, shape_applicable

__all__ = [
    "BlockSpec",
    "MeshConfig",
    "ModelConfig",
    "SEBSConfig",
    "SegmentSpec",
    "ServeConfig",
    "TrainConfig",
    "ARCHS",
    "get_config",
    "list_archs",
    "INPUT_SHAPES",
    "input_specs",
    "shape_applicable",
]
