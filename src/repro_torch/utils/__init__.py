from repro_torch.utils.log import get_logger
from repro_torch.utils.prng import fold_in_name, key_iter
from repro_torch.utils.tree import tree_add, tree_leaves, tree_map, tree_scale, tree_size

__all__ = [
    "tree_add",
    "tree_leaves",
    "tree_map",
    "tree_scale",
    "tree_size",
    "key_iter",
    "fold_in_name",
    "get_logger",
]
