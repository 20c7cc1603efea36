"""Data-parallel meshes of worker processes, the port's counterpart of the
JAX package's ``make_data_mesh``.

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
disaggregated serving. ``make_production_mesh`` and ``make_host_mesh`` come
with the sharding slice.
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


def prefix_groups(world_size: int) -> Dict[int, Any]:
    """One gloo group over ranks ``[0, w)`` for each power of two
    ``2 <= w <= world_size``, created in increasing order. Every rank of the
    default process group must call it, at the same point."""
    import torch.distributed as dist

    groups = {}
    w = 2
    while w <= world_size:
        groups[w] = dist.new_group(ranks=list(range(w)), backend="gloo")
        w *= 2
    return groups


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
