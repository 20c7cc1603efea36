from repro_torch.sharding.partitioning import (
    DATA_AXES,
    LOGICAL_RULES,
    NamedSharding,
    batch_spec,
    is_axes_leaf,
    logical_to_mesh_spec,
    map_axes,
    mesh_data_axes,
    named_sharding,
    shard_tree,
)

__all__ = [
    "DATA_AXES",
    "LOGICAL_RULES",
    "NamedSharding",
    "batch_spec",
    "is_axes_leaf",
    "logical_to_mesh_spec",
    "map_axes",
    "mesh_data_axes",
    "named_sharding",
    "shard_tree",
]
