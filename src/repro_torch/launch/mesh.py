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

:func:`make_disagg_submeshes` carves two disjoint device grids for
disaggregated serving.
"""
from __future__ import annotations

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
    over ``axis_names``. Its collectives span all its ranks (the run's
    prefix groups, :func:`prefix_groups`): the sharded step gathers every
    shard of a leaf over the whole mesh."""

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
        return dict(zip(self.axis_names, (int(i) for i in np.unravel_index(rank, self.devices.shape))))

    def device_of(self, rank: int) -> torch.device:
        return torch.device(self.devices.flat[rank])

    @property
    def device_list(self) -> List[torch.device]:
        return [self.device_of(r) for r in range(self.size)]

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
