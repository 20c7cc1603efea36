"""Meshes of worker processes, the port's counterpart of the JAX package's
``launch/mesh.py``.

:class:`Mesh` is a grid of worker ranks with named axes, JAX's ``Mesh``
over processes: rank r is the grid's r-th entry in row-major order, each
rank has its device, and the sharding rules (``sharding/partitioning.py``)
decide which slice of each leaf a rank stores. :func:`make_production_mesh`
lays the visible cards out as the JAX package lays out a pod;
:func:`make_host_mesh` is the small mesh of tests and examples.

In the port a mesh of width W is the first W workers of an elastic run
(each a process with its own device), their devices, a gloo process group
over ranks ``[0, W)``, and the run's shared host slots
(``distributed/staging.py``) through which its large collectives go. Every
rank creates all the power-of-two prefix groups at start-up
(:func:`prefix_groups`), together and in the same order, because
``torch.distributed.new_group`` is a collective call. The widths are
prefixes of one worker order, so replica r keeps its device across every
stage it takes part in.

A rank's axis groups (:meth:`Mesh.group_ranks`) are the ranks that share
its every coordinate but those along some axes: its ``model`` group (the
same ``data`` index) and its expert group (every axis but ``model``: the
same ``model`` index; under tensor parallelism it gathers the rank's
slices of the split leaves). :func:`make_axis_groups` creates one process group
for each, once a run, and gives the rank its two as :class:`GroupMesh`;
the sharded step computes an MoE layer's experts over the ``model`` group
(``distributed/sharded.py``).

:func:`make_disagg_submeshes` carves two disjoint device grids for
disaggregated serving.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def visible_devices() -> List[torch.device]:
    """The visible CUDA devices (the JAX package's ``jax.devices()``); raises
    when there is none: a CPU run names its devices."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass the devices explicitly "
                           "(e.g. [torch.device('cpu')] * n) to run the workers on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """A grid of worker ranks: ``devices`` an object array of
    ``torch.device`` (one a rank; several ranks may share a card), laid out
    over ``axis_names``. The sharded step gathers a leaf over the whole mesh
    (the run's prefix groups, :func:`prefix_groups`), except an MoE layer's
    experts split over ``model``: those it gathers over the rank's expert
    group, and it exchanges their tokens over the rank's ``model`` group
    (:func:`make_axis_groups`)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.empty(np.shape(devices), object)
        grid[...] = devices
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-d device grid for axes {tuple(axis_names)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in mesh order (JAX's ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, rank: int) -> Dict[str, int]:
        return self._coords[rank]

    @functools.cached_property
    def _coords(self) -> List[Dict[str, int]]:
        grid = np.unravel_index(np.arange(self.size), self.devices.shape)
        return [dict(zip(self.axis_names, (int(g[r]) for g in grid))) for r in range(self.size)]

    def device_of(self, rank: int) -> torch.device:
        return torch.device(self.devices.flat[rank])

    @property
    def device_list(self) -> List[torch.device]:
        return [self.device_of(r) for r in range(self.size)]

    def group_ranks(self, rank: int, axes: Sequence[str]) -> Tuple[int, ...]:
        """The ranks that share every coordinate of ``rank`` but those along
        ``axes``, in the mesh's row-major order (so a rank's position in
        the tuple is its index on the sub-grid of ``axes``)."""
        mine = self.coords(rank)
        fixed = [a for a in self.axis_names if a not in axes]
        return tuple(r for r in range(self.size) if all(self.coords(r)[a] == mine[a] for a in fixed))

    def all_groups(self, axes: Sequence[str]) -> List[Tuple[int, ...]]:
        """Every group of :meth:`group_ranks` over ``axes``, by lowest rank."""
        seen: Dict[int, Tuple[int, ...]] = {}
        for r in range(self.size):
            ranks = self.group_ranks(r, axes)
            seen.setdefault(ranks[0], ranks)
        return [seen[k] for k in sorted(seen)]

    def submesh(self, rank: int, axes: Sequence[str]) -> "Mesh":
        """The sub-grid over ``axes`` (in mesh order) of ``rank``'s group."""
        names = tuple(a for a in self.axis_names if a in axes)
        grid = np.empty((len(self.group_ranks(rank, axes)),), object)
        grid[:] = [self.devices.flat[r] for r in self.group_ranks(rank, axes)]
        return Mesh(grid.reshape(tuple(self.shape[a] for a in names)), names)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.device_list]})"



def _default_devices(n: int) -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass devices=[torch.device('cpu')] * n to lay the "
                           "mesh's workers on the CPU")
    return [torch.device("cuda", 0)] * n


def make_host_mesh(data: int = 1, model: int = 1, pod: Optional[int] = None,
                   devices: Optional[Sequence] = None) -> Mesh:
    """The small mesh of tests and examples, ``("data", "model")`` or, with
    ``pod``, ``("pod", "data", "model")``. Its ranks share one device:
    ``devices`` default to ``[cuda:0] * n`` (several workers on one card, as
    the elastic trainer runs them); on the CPU pass ``[cpu] * n``."""
    shape = (data, model) if pod is None else (pod, data, model)
    axes = ("data", "model") if pod is None else ("pod", "data", "model")
    n = int(np.prod(shape))
    devices = _default_devices(n) if devices is None else [torch.device(d) for d in devices]
    if len(devices) < n:
        raise ValueError(f"a {shape} mesh needs {n} devices, got {len(devices)}")
    grid = np.empty((n,), object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(shape), axes)


def production_shape(n: int, multi_pod: bool = False) -> Tuple[int, ...]:
    """The production layout of ``n`` devices: ``model`` the largest power
    of two whose square is at most the pod's device count, ``data`` the
    rest (256 -> (16, 16)); multi-pod adds ``pod = 2`` in front, each pod
    laid out alike (512 -> (2, 16, 16))."""
    if multi_pod:
        if n < 2:
            raise ValueError(f"a multi-pod mesh needs at least 2 devices (2 pods), have {n}")
        return (2,) + production_shape(n // 2)
    if n < 1:
        raise ValueError("a mesh needs at least one device")
    model = 1
    while (2 * model) ** 2 <= n:
        model *= 2
    return (n // model, model)


def make_production_mesh(*, multi_pod: bool = False, devices: Optional[Sequence] = None) -> Mesh:
    """The visible cards laid out as the JAX package lays out a pod:
    ``("data", "model")`` by :func:`production_shape`, or ``("pod", "data",
    "model")`` with ``multi_pod``; one worker a card (on the CPU, pass
    ``devices``). The JAX package's 256 and 512 TPU chips give its (16, 16)
    and (2, 16, 16); 4 cards give (2, 2) and 1 card (1, 1)."""
    devices = visible_devices() if devices is None else [torch.device(d) for d in devices]
    shape = production_shape(len(devices), multi_pod)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    grid = np.empty((n,), object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(shape), axes)


@dataclass(frozen=True)
class DataMesh:
    """The first ``len(devices)`` workers: their devices, the gloo group over
    their ranks and the run's host exchange (None for width 1, and outside
    a worker process)."""

    devices: tuple
    group: Any = None
    exchange: Any = None

    @property
    def width(self) -> int:
        return len(self.devices)

    # a ("data",) mesh to the sharding rules
    axis_names = ("data",)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.width}

    @property
    def size(self) -> int:
        return self.width

    def coords(self, rank: int) -> Dict[str, int]:
        return {"data": rank}

    # its ranks are the run's first ``width``: a rank's position is the rank
    @property
    def ranks(self) -> range:
        return range(self.width)

    def index(self, rank: int) -> int:
        return rank


@dataclass(frozen=True)
class GroupMesh:
    """One axis group of a mesh's ranks (:meth:`Mesh.group_ranks`): their
    global ``ranks`` in the group's order, their devices, the group's gloo
    process group and the run's exchange, whose collectives over this mesh
    take positions in ``ranks`` where a :class:`DataMesh` takes ranks."""

    ranks: tuple
    devices: tuple
    group: Any = None
    exchange: Any = None

    @property
    def width(self) -> int:
        return len(self.ranks)

    def index(self, rank: int) -> int:
        return self.ranks.index(rank)


@dataclass(frozen=True)
class AxisGroups:
    """A rank's two axis groups on ``mesh``: ``model`` (its ``model``
    group) and ``experts`` (every axis but ``model``: the ranks that store
    the same experts)."""

    mesh: Any
    model: GroupMesh
    experts: GroupMesh

    @property
    def expert_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.mesh.axis_names if a != "model")


def axis_groups(mesh: Mesh, rank: int, exchange: Any = None, made: Optional[Dict[Tuple[int, ...], Any]] = None
                ) -> AxisGroups:
    """``rank``'s :class:`AxisGroups` on ``mesh``, their collectives through
    ``exchange``; ``made`` maps a group's ranks to its gloo group (none for
    the dry run's recording transport)."""
    made = {} if made is None else made

    def group(axes) -> GroupMesh:
        ranks = mesh.group_ranks(rank, axes)
        return GroupMesh(ranks, tuple(mesh.device_of(r) for r in ranks), made.get(ranks), exchange)

    return AxisGroups(mesh, group(("model",)), group(tuple(a for a in mesh.axis_names if a != "model")))


def make_axis_groups(mesh: Mesh, rank: int, exchange: Any) -> AxisGroups:
    """``rank``'s :class:`AxisGroups` on ``mesh`` inside a worker process:
    every rank of the run calls it together, and it creates a gloo group
    for each ``model`` group and each expert group of more than one rank,
    in one order, and the exchange's own where it keeps some (NCCL's
    ``add_group``)."""
    import torch.distributed as dist

    made: Dict[Tuple[int, ...], Any] = {}
    for axes in (("model",), tuple(a for a in mesh.axis_names if a != "model")):
        for ranks in mesh.all_groups(axes):
            if len(ranks) > 1:  # a group of one rank makes no collective
                made[ranks] = dist.new_group(ranks=list(ranks), backend="gloo")
                if hasattr(exchange, "add_group"):
                    exchange.add_group(ranks)
    return axis_groups(mesh, rank, exchange, made)


def prefix_widths(world_size: int) -> List[int]:
    """The widths of the run's prefix groups: each power of two ``2 <= w <=
    world_size``, and ``world_size`` itself (a sharded run's mesh)."""
    widths, w = [], 2
    while w <= world_size:
        widths.append(w)
        w *= 2
    return widths + ([world_size] if world_size > 1 and world_size not in widths else [])


def prefix_groups(world_size: int) -> Dict[int, Any]:
    """One gloo group over ranks ``[0, w)`` for each of :func:`prefix_widths`,
    created in increasing order. Every rank of the default process group
    must call it, at the same point."""
    import torch.distributed as dist

    return {w: dist.new_group(ranks=list(range(w)), backend="gloo") for w in prefix_widths(world_size)}


def make_data_mesh(width: int, devices: Optional[Sequence] = None,
                   groups: Optional[Dict[int, Any]] = None, exchange: Any = None) -> DataMesh:
    """The ("data",) mesh over the first ``width`` workers. ``groups`` are
    :func:`prefix_groups`' and ``exchange`` the run's host slots (inside a
    worker process); ``devices`` default to :func:`visible_devices`."""
    devices = visible_devices() if devices is None else list(devices)
    if not 1 <= width <= len(devices):
        raise ValueError(f"width {width} not in [1, {len(devices)}]")
    group = None
    if width > 1 and groups is not None:
        if width not in groups:
            raise ValueError(f"no process group for width {width} (widths are powers of two)")
        group = groups[width]
    return DataMesh(tuple(torch.device(d) for d in devices[:width]), group, exchange if width > 1 else None)


def make_disagg_submeshes(prefill_pods: int = 1, decode_pods: int = 1, data: int = 1, model: int = 1,
                          devices: Optional[Sequence] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Carve one ``("pod", "data", "model")`` device grid into a disjoint
    (prefill, decode) pair for disaggregated serving, the JAX package's
    ``make_disagg_submeshes``.

    The first ``(prefill_pods + decode_pods) * data * model`` devices are
    laid out as a pod-major grid and split along the pod axis: pods
    ``[0, prefill_pods)`` become the prefill grid, the rest the decode grid.
    Returns ``(prefill, decode)``, object arrays of ``torch.device`` of
    shape ``(pods, data, model)``; a worker of
    :class:`~repro_torch.serve.engine.DisaggregatedEngine` takes its grid's
    lead device (``grid.flat[0]``). ``devices`` default to the visible CUDA
    devices (:func:`visible_devices`); on the CPU pass ``[cpu] * n``, the
    counterpart of the JAX package's forced host devices.
    """
    if prefill_pods < 1 or decode_pods < 1:
        raise ValueError("prefill_pods and decode_pods must each be >= 1")
    devices = visible_devices() if devices is None else list(devices)
    need = (prefill_pods + decode_pods) * data * model
    if len(devices) < need:
        raise ValueError(
            f"need {need} devices for a ({prefill_pods}+{decode_pods})x{data}x{model} "
            f"submesh pair, have {len(devices)}"
        )
    grid = np.empty((need,), object)
    grid[:] = [torch.device(d) for d in devices[:need]]
    grid = grid.reshape(prefill_pods + decode_pods, data, model)
    return grid[:prefill_pods], grid[prefill_pods:]


def row_groups(mesh, tensor_parallel: bool = False) -> int:
    """The units rows spread over: every rank of ``mesh``, or under tensor
    parallelism its ``model`` groups (the ranks of a group share their rows
    and split each matmul), ``mesh.size // model``."""
    return mesh.size // mesh.shape.get("model", 1) if tensor_parallel else mesh.size


def row_index(mesh, rank: int, tensor_parallel: bool = False) -> int:
    """``rank``'s place among :func:`row_groups`: the rank, or under tensor
    parallelism its ``model`` group's data index (``model`` is the mesh's
    last axis, so a group's ranks are consecutive)."""
    return rank // mesh.shape.get("model", 1) if tensor_parallel else rank


def rank_rows(global_rows: int, ranks: int):
    """(rows a computing rank takes, computing ranks): the rows spread over
    every rank where they divide, else one row a rank over the first
    ``global_rows`` ranks."""
    if global_rows % ranks == 0:
        return global_rows // ranks, ranks
    if global_rows < ranks:
        return 1, global_rows
    raise ValueError(f"{global_rows} rows do not divide over {ranks} ranks")
