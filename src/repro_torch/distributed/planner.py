"""ElasticMeshPlanner: the SEBS stage ladder mapped onto a data-parallel
width, as the JAX package's ``distributed/planner.py``.

The unit of data parallelism is the *microbatch*, not the sample: stage s
performs ``accum_steps = b_s / b_1`` microbatch-gradient computations per
optimizer update, and the planner assigns them to ``W`` replicas with
``accum_steps / W`` local accumulation steps each. The per-replica compute
shape (microbatch, seq) is therefore the same at every width, and the
cross-microbatch reduction uses a canonical fixed-shape tree
(``distributed/step.py``), so widening changes WHERE gradients are computed,
not any floating-point result.

Width rule: the largest power of two that divides the stage's
``accum_steps`` and fits the device budget. With the paper's rho = 2 ladder
stage s runs ``min(2^s, budget)`` replicas.

In the port a replica is a worker process. ``devices`` lists one
``torch.device`` per worker and may name one card several times: that is how
one H100 holds widths 2 and 4 (the JAX package's counterpart on the CPU is
``--xla_force_host_platform_device_count``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

from repro_torch.core.stages import StepPlan
from repro_torch.launch.mesh import DataMesh, make_data_mesh, visible_devices


@dataclass(frozen=True)
class MeshPlan:
    """Execution geometry of one optimizer update."""

    stage: int
    width: int        # replicas (workers) of this update
    local_accum: int  # microbatch gradients per replica per update

    @property
    def global_accum(self) -> int:
        return self.width * self.local_accum


class ElasticMeshPlanner:
    def __init__(self, device_budget: Optional[int] = None, devices: Optional[Sequence] = None):
        self.devices = visible_devices() if devices is None else list(devices)
        budget = len(self.devices) if device_budget is None else device_budget
        if budget < 1:
            raise ValueError(f"device budget must be >= 1, got {budget}")
        self.device_budget = min(budget, len(self.devices))
        #: the workers' prefix process groups (launch.mesh.prefix_groups) and the
        #: run's host slots (staging.HostExchange), set in a worker
        self.groups: Optional[Dict[int, Any]] = None
        self.exchange: Any = None
        self._meshes: Dict[int, DataMesh] = {}
        #: the most replicas a width may take, where it is not the device budget (a mesh whose
        #: ``model`` groups share their rows: its group count)
        self.width_budget: Optional[int] = None

    def width_for(self, accum_steps: int) -> int:
        """Largest power of two dividing ``accum_steps``, capped at the budget.

        Power-of-two widths that divide the count are what the canonical
        reduction tree needs for cross-width bit-identity; counts that are
        not powers of two (rho not a power of two) degrade toward width 1."""
        width, budget = 1, self.width_budget or self.device_budget
        while width * 2 <= budget and accum_steps % (width * 2) == 0:
            width *= 2
        return width

    def plan_for(self, plan: StepPlan) -> MeshPlan:
        width = self.width_for(plan.accum_steps)
        return MeshPlan(stage=plan.stage, width=width, local_accum=plan.accum_steps // width)

    def mesh_for(self, width: int) -> DataMesh:
        """The (cached) mesh of the first ``width`` workers; every width is a
        prefix of the same worker order."""
        if width not in self._meshes:
            self._meshes[width] = make_data_mesh(width, self.devices, self.groups, self.exchange)
        return self._meshes[width]
