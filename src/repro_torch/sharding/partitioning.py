"""Logical-axis partitioning, the JAX package's ``sharding/partitioning.py``
over the port's meshes of worker processes.

Every parameter (and cache leaf) is annotated with a tuple of *logical*
axis names (e.g. ``("embed", "heads", "head_dim")``). A rule table maps
logical names to mesh axes. :func:`logical_to_mesh_spec` applies the rules
with a **divisibility fallback**: a dimension that the product of its mesh
axes does not divide takes the longest prefix of them that does, or is
replicated (2 KV heads over a 16-way model axis, arctic's 56 heads over 16),
and no mesh axis is used twice. One rule table serves every architecture.

A spec is a plain tuple with one entry per dimension: ``None``, a mesh axis
name, or a tuple of names (equal by value to JAX's ``PartitionSpec``).
:class:`NamedSharding` places one leaf: which slice of it each rank of the
mesh stores. Shards follow JAX's index order: the mesh's ranks are its grid
in row-major order, and along a dimension sharded over ``("pod", "data")``
a rank's shard index is ``pod_idx * data + data_idx``; so the shards,
concatenated in index order, are the leaf bit for bit.

The rules place storage, and compute follows them in one place only. The
port computes data-parallel over every rank of a mesh
(``distributed/sharded.py``): a worker gathers each layer's shards into
whole leaves where the layer runs and updates only its own slices after
the step; but an MoE layer's experts, which the rules split over ``model``,
are gathered over the rank's expert group and computed over its ``model``
group, as the JAX package's ``constrain`` of the dispatch, ``xe`` and ``h``
splits them. There is no GSPMD to split any other matmul across a
``model`` group, so ``constrain`` (a ``with_sharding_constraint`` on an
activation) and ``legacy_manual_axes`` (shard_map's manual axes on old
jax) have no counterpart here.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

# logical axis -> preferred mesh axis (or tuple of axes), in priority order:
# the JAX package's table, unchanged
LOGICAL_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "expert_batch": ("pod", "data"),
    "seq": (),
    "kv_seq": ("data",),
    "seq_sp": ("model",),
    "vocab": ("model",),
    "embed": ("data",),  # FSDP: the d_model dim of weights over `data`
    "heads": ("model",),
    "kv_heads": ("model",),
    "heads_group": ("model",),
    "head_dim": ("model",),  # where kv_heads does not divide the model axis
    "mlp": ("model",),
    "experts": ("model",),
    "ssm_inner": ("model",),
    "ssm_heads": ("model",),
    "ssm_state": (),
    "conv_width": (),
    "layers": (),  # the stacked leading layer axis: never sharded
    "group": (),
}

# mesh axes that carry data parallelism, in nesting order
DATA_AXES: Tuple[str, ...] = ("pod", "data")

Spec = Tuple[Any, ...]


def is_axes_leaf(x) -> bool:
    """Logical-axes trees use tuples of axis names as leaves."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def mesh_data_axes(mesh) -> Tuple[str, ...]:
    """The subset of DATA_AXES present on ``mesh`` (possibly empty)."""
    if mesh is None:
        return ()
    return tuple(a for a in DATA_AXES if a in mesh.axis_names)


def logical_to_mesh_spec(logical_axes: Sequence[Optional[str]], mesh, shape: Optional[Sequence[int]] = None,
                         rules: Optional[Mapping[str, Tuple[str, ...]]] = None) -> Spec:
    """Map logical axis names to a spec for ``mesh`` (anything with a
    ``shape`` mapping of axis name to size).

    If ``shape`` is given, a dimension not divisible by the product of its
    assigned mesh axes takes the longest prefix of the rule's axes that
    divides it, or is replicated. Mesh axes are never assigned twice."""
    rules = LOGICAL_RULES if rules is None else rules
    sizes = dict(mesh.shape)
    used: set = set()
    spec: list = []
    for i, ax in enumerate(logical_axes):
        cand = [] if ax is None else [a for a in rules.get(ax, ()) if a in sizes and a not in used]
        assign, prod = [], 1
        dim = None if shape is None else int(shape[i])
        for a in cand:
            if dim is not None and dim % (prod * sizes[a]) != 0:
                break
            assign.append(a)
            prod *= sizes[a]
        used.update(assign)
        spec.append(None if not assign else tuple(assign) if len(assign) > 1 else assign[0])
    return tuple(spec)


def batch_spec(mesh, extra_dims: int = 1, batch_size: Optional[int] = None) -> Spec:
    """Spec of a (batch, ...) input: batch over all data axes. With
    ``batch_size`` given, the greedy prefix of the data axes that divides it
    (batch 1 is replicated)."""
    axes = list(mesh_data_axes(mesh))
    if batch_size is not None:
        sizes = dict(mesh.shape)
        keep, prod = [], 1
        for a in axes:
            if batch_size % (prod * sizes[a]) != 0:
                break
            keep.append(a)
            prod *= sizes[a]
        axes = keep
    return (tuple(axes) if len(axes) > 1 else (axes[0] if axes else None),) + (None,) * extra_dims


def _entry_axes(entry) -> Tuple[str, ...]:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


@dataclass(frozen=True)
class NamedSharding:
    """Where a leaf of ``shape`` lives on ``mesh`` under ``spec``: each rank
    stores the slice :meth:`shard_slices` names, of :attr:`shard_shape`."""

    mesh: Any
    spec: Spec
    shape: Tuple[int, ...]

    def _counts(self):
        sizes = dict(self.mesh.shape)
        return [_prod(sizes[a] for a in _entry_axes(e)) for e in self.spec]

    @property
    def shard_shape(self) -> Tuple[int, ...]:
        return tuple(d // c for d, c in zip(self.shape, self._counts()))

    @property
    def num_shards(self) -> int:
        return _prod(self._counts())

    @property
    def replicated(self) -> bool:
        return self.num_shards == 1

    def shard_index(self, rank: int) -> Tuple[int, ...]:
        """The rank's shard index along each dimension (row-major over the
        dimension's mesh axes, in the spec's order)."""
        coords = self.mesh.coords(rank)
        sizes = dict(self.mesh.shape)
        out = []
        for e in self.spec:
            idx = 0
            for a in _entry_axes(e):
                idx = idx * sizes[a] + coords[a]
            out.append(idx)
        return tuple(out)

    def slices_of(self, index: Tuple[int, ...]) -> Tuple[slice, ...]:
        """The slices of the leaf that shard ``index`` holds."""
        return tuple(slice(i * s, (i + 1) * s) for i, s in zip(index, self.shard_shape))

    def shard_slices(self, rank: int) -> Tuple[slice, ...]:
        return self.slices_of(self.shard_index(rank))

    def holders(self) -> Dict[Tuple[int, ...], int]:
        """Each shard index -> the lowest rank that stores it, in index order."""
        return dict(self._holders)

    @functools.cached_property
    def _holders(self) -> Dict[Tuple[int, ...], int]:
        sizes = dict(self.mesh.shape)
        axes = [_entry_axes(e) for e in self.spec]
        out: Dict[Tuple[int, ...], int] = {}
        for rank in range(self.mesh.size):
            coords = self.mesh.coords(rank)
            index = []
            for entry in axes:
                idx = 0
                for a in entry:
                    idx = idx * sizes[a] + coords[a]
                index.append(idx)
            out.setdefault(tuple(index), rank)
        return dict(sorted(out.items()))


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= x
    return n


def named_sharding(mesh, logical_axes: Sequence[Optional[str]], shape: Sequence[int]) -> NamedSharding:
    return NamedSharding(mesh, logical_to_mesh_spec(logical_axes, mesh, shape), tuple(int(d) for d in shape))


def map_axes(fn: Callable, axes: Any, *trees: Any) -> Any:
    """``fn(leaf_axes, *leaves)`` over an axes tree and trees of the same
    structure (nested dicts and lists, axes tuples as leaves)."""
    if is_axes_leaf(axes):
        return fn(axes, *trees)
    if isinstance(axes, dict):
        return {k: map_axes(fn, v, *(t[k] for t in trees)) for k, v in axes.items()}
    if isinstance(axes, (list, tuple)):
        out = [map_axes(fn, v, *(t[i] for t in trees)) for i, v in enumerate(axes)]
        return type(axes)(*out) if hasattr(axes, "_fields") else type(axes)(out)
    raise TypeError(f"not an axes tree node: {axes!r}")


def shard_tree(tree_axes, tree_vals, mesh):
    """A :class:`NamedSharding` tree from a matching tree of logical-axes
    tuples (each as long as its value's rank; a non-tensor leaf, such as a
    host integer, takes ``()`` and is replicated)."""
    return map_axes(lambda axes, val: named_sharding(mesh, axes, tuple(getattr(val, "shape", ()))),
                    tree_axes, tree_vals)
