"""Elastic data-parallel training: the width follows the SEBS batch ladder.
The port of the JAX package's ``distributed/``, over worker processes (one
a replica, each with its own device) and gloo.

SEBS's distributed claim is that geometric batch enlargement means
geometrically fewer parameter updates and therefore fewer gradient
synchronizations. This package makes the claim structural: stage s runs
``accum = rho^s`` microbatch gradients per update, and the
:class:`ElasticMeshPlanner` maps that count onto a data-parallel width:
narrow early stages (spare workers idle, local accumulation), wider later
stages up to the device budget. :class:`SyncScheduler` chooses between
``exact`` sync (one collective per update) and ``local`` SGD (parameter
averages on a stage-keyed cadence), with a :class:`CommAccountant` ledger of
collectives and bytes.

Invariants, as the JAX package states them (``tests/test_torch_distributed*.py``):

1. **Placement never changes values.** Width transitions copy the state's
   bytes (rank 0's replica to the workers that join); every leaf is bitwise
   unchanged.
2. **The reduction tree is the same at every width.** Exact-sync gradients
   are summed by a canonical pairwise tree over the GLOBAL accumulation
   index (``step.py``); workers compute subtrees and the all-gathered
   combine finishes the same tree. Losses, stage transitions and final
   params are bit-identical across every planner-legal width, and across
   width changes at stage boundaries.
3. **Checkpoints do not depend on the width.** Only the collapsed state is
   serialized (local-SGD saves snap to averaging points), so a checkpoint
   written at width W restores at any width W'.
4. **The data is keyed by sample offset.** Batch contents depend only on
   the consumed-sample offset (``data/pipeline.py``), so every width sees
   the same rows in the same microbatch order.

Rule-based storage sharding (``param_axes``; ``SEBSTrainer(mesh=...)``
through :class:`MeshTrainer`): each worker stores its shards of
:func:`state_shardings`, gathered whole inside each step
(``sharded.py``); where every worker has a card of its own the large
collectives go through NCCL (``nccl.py``), else through the host slots.
"""
from repro_torch.distributed.planner import ElasticMeshPlanner, MeshPlan
from repro_torch.distributed.reshard import (
    broadcast_state,
    build_sync_step,
    collapse_state,
    float_state_bytes,
    reshard_state,
    state_shardings,
)
from repro_torch.distributed.sharded import build_sharded_train_step
from repro_torch.distributed.step import build_elastic_train_step, build_local_train_step, span_tree_sum
from repro_torch.distributed.sync import (
    SYNC_MODES,
    CommAccountant,
    SyncScheduler,
    allgather_bytes_per_device,
    allreduce_bytes_per_device,
    sync_cost,
)
from repro_torch.distributed.trainer import ElasticTrainer, MeshTrainer, run_on_mesh

__all__ = [
    "ElasticMeshPlanner",
    "MeshPlan",
    "ElasticTrainer",
    "MeshTrainer",
    "run_on_mesh",
    "build_sharded_train_step",
    "reshard_state",
    "state_shardings",
    "SyncScheduler",
    "CommAccountant",
    "SYNC_MODES",
    "build_elastic_train_step",
    "build_local_train_step",
    "build_sync_step",
    "span_tree_sum",
    "broadcast_state",
    "collapse_state",
    "float_state_bytes",
    "allgather_bytes_per_device",
    "allreduce_bytes_per_device",
    "sync_cost",
]
