"""ElasticTrainer: SEBSTrainer with a stage-elastic data-parallel width, as
the JAX package's ``distributed/trainer.py``, over worker processes.

It subclasses :class:`repro_torch.core.trainer.SEBSTrainer` through its hook
seams and decides what the JAX trainer decides, in the same way: when the
width changes, which reshards are counted and with which bytes, the
stage-boundary average that restarts the local-SGD cadence, the GNS starved
in local mode, and saves only at consistent updates. Its constructor, hooks
and checkpoint meta keys (``accountant``, ``data_width``, ``sync_mode``) are
the JAX trainer's, so either package resumes the other's elastic checkpoint.

Guarantees (exact mode, ``tests/test_torch_distributed*.py``):

- width equivalence: losses, stage transitions, GNS and final params are
  bit-identical at every device budget, across the width changes at stage
  boundaries too;
- elastic kill-equivalence: a run killed at any update under budget W and
  resumed under budget W' reproduces the uninterrupted run bit for bit
  (checkpoints hold the collapsed state only; the data is keyed by sample
  offset, so every width sees the same rows).

Local SGD trades those bit guarantees for communication: replicas drift
between averages, so saves snap to averaging points.

**Processes.** :meth:`ElasticTrainer.run`, called in the caller's process,
spawns one worker per device of the budget (``torch.multiprocessing``'s
``spawn``; a gloo process group over a ``FileStore`` in a temporary
directory, so no network port; gloo's own connections go over the loopback
interface unless ``GLOO_SOCKET_IFNAME`` says otherwise). A budget of 1 runs
in a spawned worker too, so every budget computes in the same kind of
process. The caller's state tensors go to rank 0 as torch.multiprocessing
shares them (a CUDA tensor by an IPC handle, a CPU tensor by moving its
storage to shared memory in place); rank 0 gives the state to the workers
that join at each widening (``reshard.broadcast_state``) and writes its
final values back into the caller's tensors. The large collectives go
through shared host slots, files in the run's temporary directory that
every worker maps (``staging.py``); gloo carries barriers and control. Every
rank runs the same loop and keeps the same schedule state, pipeline offset,
GNS, accountant and ``TrainLog``: every rank draws the whole batch and takes
its chunk ``[r * local_accum, (r + 1) * local_accum)``; ranks outside the
current width hold no replica and wait; rank 0 broadcasts each update's few
metrics to every rank. That control traffic (the metrics, the integer
leaves, checkpoint meta on resume, a barrier after each save) is not a
modeled sync and the accountant does not count it. Only rank 0 writes
checkpoints. ``run`` returns rank 0's collapsed state, in the caller's
state tensors (the port's updates are in place), and its log, and
leaves this trainer holding rank 0's accountant, pipeline position, schedule
state and the steps it built (``_steps``, keyed (mode, width, local_accum)),
and each worker's statistics in :attr:`worker_stats` (peak device memory,
kernel launches, the host-staged collectives' seconds, the reshards').
:func:`run_together` (and :func:`run_all_on_mesh` for mesh runs) runs
several trainers of the same workers one after another in one spawn, each
as it runs alone: the workers start once.

**Bits.** Each worker takes the caller's ``torch.get_num_threads()``, TF32
flags, float32 matmul precision and deterministic-algorithms flag, so a
microbatch's gradient has the same bits in every worker. **No hangs.** The
process group has a timeout (``collective_timeout``, 120 s), the parent
waits with an optional ``deadline`` (seconds for the whole run), and when a
worker exits non-zero or the deadline passes the parent terminates the rest
and raises with the failing worker's traceback. A worker uses the device it
is given and raises when that is absent; there is no fallback to one
process. The parent builds the CUDA kernels before it spawns (a worker only
loads them; ``kernels/_cuda.py`` writes each library through a per-process
temporary file and a rename).

**Transport.** Where every worker has a CUDA card of its own, the large
collectives go through NCCL (``nccl.py``: all-gathers and broadcasts of
bytes, never a reduce); where workers share a card, or run on the CPU,
through the shared host slots (``staging.make_exchange`` chooses; no
fallback).

**Sharded storage.** With ``param_axes`` (exact mode), each replica of a
width-W stage stores only its shards of the state on the ("data",) mesh of
W workers (``embed`` sharded over them, FSDP; the other rules name
``model``, which this mesh lacks, so those dimensions stay whole), gathered
whole before each step and updated shard by shard (``sharded.py``); the
losses and params stay bit-identical to the unsharded run's, and the
checkpoints hold the collapsed state, byte-equal to an unsharded run's.
Local SGD keeps whole replicas, as in the JAX package.
:class:`MeshTrainer` runs ``SEBSTrainer(mesh=...)`` through the same
machinery: every rank of a fixed mesh stores its shards, and the stage's
width of them compute. On a mesh whose ``model`` axis splits an MoE
layer's experts, each worker also makes its axis groups
(``launch/mesh.make_axis_groups``) and computes its experts over its
``model`` group (``sharded.py``): that path holds the unsharded run within
a tolerance, not to its bits. With ``SEBSTrainer(...,
tensor_parallel=True)`` the ``model`` groups split the attention, MLPs,
experts, vocabulary and recurrent heads (``sharded.TensorParallel``): the stage's
width counts the groups that compute, the ranks of a group take its rows
(``launch/mesh.row_index``), and that path too holds the unsharded run
within a tolerance.
"""
from __future__ import annotations

import dataclasses
import gc
import os
import shutil
import tempfile
from datetime import timedelta
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.checkpoint import CheckpointManager, train_state_from_tree
from repro_torch.core.stages import StepPlan
from repro_torch.core.trainer import SEBSTrainer, TrainLog
from repro_torch.data.pipeline import DataPipeline
from repro_torch.distributed.planner import ElasticMeshPlanner, MeshPlan
from repro_torch.distributed.procs import (
    apply_settings,
    caller_settings,
    fail_worker,
    join_workers,
    slot_bytes,
    stop_workers,
)
from repro_torch.distributed.reshard import (
    broadcast_state,
    build_sync_step,
    collapse_state,
    float_state_bytes,
    skeleton_of,
    state_shardings,
)
from repro_torch.distributed.sharded import (
    build_sharded_train_step,
    move_state,
    tensor_leaves,
    tensor_parallel,
    tensor_shardings,
)
from repro_torch.distributed.staging import StagingTimes, make_exchange
from repro_torch.distributed.step import build_elastic_train_step, build_local_train_step
from repro_torch.distributed.sync import CommAccountant, SyncScheduler, allreduce_bytes_per_device, sync_cost
from repro_torch.launch.mesh import make_axis_groups, prefix_groups, row_groups, row_index
from repro_torch.obs.metrics import NULL_METRICS, MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.optim.base import Optimizer
from repro_torch.train.state import TrainState
from repro_torch.utils.tree import tree_leaves, tree_size

#: per-update metrics rank 0 shares with every rank, in this order
_METRIC_KEYS = ("loss", "aux", "grad_sq_small", "grad_sq_big", "grad_norm")
#: what rank 0 hands back to the caller's trainer besides the state and log
_ADOPTED = ("_width", "_stacked", "_last_sync", "_updates_done", "_last_saved")


class ElasticTrainer(SEBSTrainer):
    def __init__(
        self,
        model,
        optimizer: Optimizer,
        schedule,
        pipeline: DataPipeline,
        *,
        sync_mode: str = "exact",
        device_budget: Optional[int] = None,
        devices=None,
        microbatch: Optional[int] = None,
        grad_clip: float = 0.0,
        seed: int = 0,
        param_axes=None,
        local_interval: int = 4,
        local_growth: float = 1.0,
        tracer=None,
        metrics=None,
        collective_timeout: float = 120.0,
        deadline: Optional[float] = None,
    ):
        super().__init__(
            model, optimizer, schedule, pipeline, microbatch=microbatch, mode="accumulate",
            accum_mode="deferred", grad_clip=grad_clip, seed=seed, tracer=tracer, metrics=metrics,
        )
        self.planner = ElasticMeshPlanner(device_budget=device_budget, devices=devices)
        self.sync = SyncScheduler(mode=sync_mode, local_interval=local_interval, local_growth=local_growth)
        self.accountant = CommAccountant()
        self.param_axes = param_axes
        self._sharded = param_axes is not None and sync_mode == "exact"
        self._held: Optional[int] = None    # ranks that store the state (sharded layouts)
        self._axis = None                   # a worker's axis groups on a mesh (MeshTrainer)
        self._tp = None                     # a worker's TensorParallel on a mesh (MeshTrainer)
        self.collective_timeout = collective_timeout
        self.deadline = deadline
        self._width: Optional[int] = None   # realized width (None = not placed yet)
        self._stacked = False               # replicas drift (local mode, width > 1)
        self._mp: Optional[MeshPlan] = None
        self._last_sync = 0                 # update index of the last average
        self._updates_done = 0              # optimizer updates executed so far
        self._sync_steps: Dict[int, object] = {}
        self._grad_bytes: Optional[int] = None   # f32 gradient payload
        self._state_bytes: Optional[int] = None  # float state payload (local sync)
        # inside a worker process: its rank, and the state's shapes for a replica that joins
        self._rank: Optional[int] = None
        self._skeleton: Optional[TrainState] = None
        self._times: Dict[str, list] = {"allgather": [], "sync": [], "reshard_s": [], "broadcast": [],
                                        "sharded": [], "between_bytes": [], "update_peak_bytes": []}
        self._layouts: Dict[int, list] = {}
        self._run_peak = 0  # a sharded worker's peak bytes before its last reset of the card's peak
        self._keep = False  # the state stays with the workers (run(init_seed=...)): no collapse, no copy back
        #: per rank, after run(): device, peak memory, kernel launches, staging seconds
        self.worker_stats: List[dict] = []

    # -- into a worker process --------------------------------------------------

    def __getstate__(self) -> dict:
        d = dict(self.__dict__)
        d["tracer"] = Tracer(capacity=self.tracer.capacity) if self.tracer.enabled else None
        d["metrics"] = MetricsRegistry() if self.metrics.enabled else None
        d["_clock"] = None
        d["_steps"], d["_sync_steps"], d["worker_stats"] = {}, {}, []
        # a run's first placement is cold: rank 0 alone holds the state
        d["_width"], d["_stacked"], d["_held"], d["_layouts"], d["_axis"] = None, False, None, {}, None
        return d

    def __setstate__(self, d: dict) -> None:
        self.__dict__.update(d)
        self.tracer = self.tracer if self.tracer is not None else NULL_TRACER
        self.metrics = self.metrics if self.metrics is not None else NULL_METRICS
        self._clock = self.tracer.clock

    # -- compiled-step caches ---------------------------------------------------

    def _store_width(self, width: int) -> int:
        """How many ranks store the state when ``width`` of them compute."""
        return width

    def _axis_groups(self, rank: int, exchange):
        """A worker's axis groups (None: the elastic widths are ("data",) meshes)."""
        return None

    def _tensor_split(self):
        """A worker's ``sharded.TensorParallel`` (None: data-parallel compute)."""
        return None

    def _row(self) -> int:
        """This worker's place among the units that take rows: its rank."""
        return self._rank

    def _layout(self, n: int) -> list:
        """The shardings of the state's tensor leaves when ranks ``[0, n)``
        store it (n = 1: rank 0 holds it whole)."""
        if n not in self._layouts:
            mesh = self.planner.mesh_for(n)
            shardings = state_shardings(self._skeleton, mesh, self.param_axes if n > 1 else None)
            self._layouts[n] = tensor_shardings(shardings, self._skeleton)
        return self._layouts[n]

    def _elastic_step(self, mp: MeshPlan):
        stacked = self.sync.mode == "local" and mp.width > 1
        key = ("local" if stacked else "exact", mp.width, mp.local_accum)
        if key not in self._steps:
            mesh = self.planner.mesh_for(mp.width)
            if self._sharded:
                n_params = len(tree_leaves(self._skeleton.params))
                self._steps[key] = build_sharded_train_step(
                    self.model, self.optimizer, self._layout(self._held)[:n_params], rank=self._rank,
                    width=mp.width, local_accum=mp.local_accum, xmesh=self.planner.mesh_for(self._held),
                    grad_clip=self.grad_clip, times=self._times["sharded"], axis=self._axis, tp=self._tp)
            elif stacked:
                self._steps[key] = build_local_train_step(
                    self.model, self.optimizer, mesh, width=mp.width, local_accum=mp.local_accum,
                    grad_clip=self.grad_clip)
            else:
                self._steps[key] = build_elastic_train_step(
                    self.model, self.optimizer, mesh, width=mp.width, local_accum=mp.local_accum,
                    grad_clip=self.grad_clip, times=self._times["allgather"])
        return self._steps[key]

    def _sync_step(self, width: int):
        if width not in self._sync_steps:
            self._sync_steps[width] = build_sync_step(self.planner.mesh_for(width), self._rank,
                                                      times=self._times["sync"])
        return self._sync_steps[width]

    # -- run-loop hooks (in every worker) ---------------------------------------

    def _before_update(self, state: TrainState, plan: StepPlan) -> TrainState:
        mp = self.planner.plan_for(plan)
        if mp.width != self._width:
            state = self._transition(state, mp, plan.stage)
        self._mp = mp
        return state

    def _transition(self, state: TrainState, mp: MeshPlan, stage: int) -> TrainState:
        """Move the state to the new width. Average first if the replicas were
        drifting (local mode); then give rank 0's state to the workers that
        join. Placement never changes values."""
        t0 = self._clock()
        with self.tracer.span("train.reshard", old=self._width or 0, new=mp.width, stage=stage):
            state = self._transition_inner(state, mp, stage)
        self._times["reshard_s"].append(self._clock() - t0)
        return state

    def _move(self, state: Optional[TrainState], n_new: int, last: bool = False) -> Optional[TrainState]:
        """The sharded state from ranks ``[0, self._held)`` (rank 0 alone
        before the first placement) to ranks ``[0, n_new)``. ``last``: the
        old layout is not read again, so each leaf's memory goes as it is
        sent (as a first placement's whole state does)."""
        n_old = self._held or 1
        xw = max(n_old, n_new)
        if n_new != n_old and self._rank < xw:
            old = tensor_leaves(state) if state is not None and n_old == 1 else []
            state = move_state(state, self._skeleton, self._layout(n_old), self._layout(n_new), self._rank,
                               self.planner.mesh_for(xw), StagingTimes(), free_source=last or bool(old))
            # rank 0's whole state (its own copy of the caller's, a restore, or a width-1 stage's), which the
            # callers' frames may still name: free its memory, so that only the shards stay, and give the
            # card its blocks back (workers sharing a card would otherwise find them held by rank 0's cache)
            for t in old:
                t.untyped_storage().resize_(0)
            if old and old[0].device.type == "cuda":
                torch.cuda.empty_cache()
        self._held = n_new
        return state if self._rank < n_new else None

    def _transition_inner(self, state: TrainState, mp: MeshPlan, stage: int) -> TrainState:
        first_placement = self._width is None
        if self._sharded:
            state = self._move(state, self._store_width(mp.width))
            if not first_placement:
                self.accountant.record_reshard(stage, bytes_moved=self._state_bytes if mp.width > self._width else 0)
            self._width = mp.width
            return state
        if self._stacked:  # leaving a local-SGD stage: one final average
            if self._rank < self._width:
                state = self._sync_step(self._width)(state)
            self._stacked = False
            # the boundary average IS a sync: restart the stage-keyed cadence
            # from here, or the new stage's first window would pay a second
            # full-state all-reduce almost at once
            self._last_sync = self._updates_done
            if not first_placement:
                self.accountant.record_reshard(
                    stage, bytes_moved=allreduce_bytes_per_device(self._state_bytes, self._width))
        widened = mp.width > (self._width or 1)
        if mp.width > 1 and (first_placement or widened) and self._rank < mp.width:
            times = StagingTimes()
            state = broadcast_state(state, self.planner.mesh_for(mp.width), self._rank, self._skeleton, times)
            self._times["broadcast"].append(times)
        if self._rank >= mp.width:
            state = None  # outside the mesh: no replica
        self._stacked = self.sync.mode == "local" and mp.width > 1
        if not first_placement:
            # only WIDENING moves bytes: each joining replica receives one full
            # state copy; narrowing drops copies already in place
            self.accountant.record_reshard(stage, bytes_moved=self._state_bytes if widened else 0)
        self._width = mp.width
        return state

    def _place_batch(self, batch: dict, plan: StepPlan) -> Optional[dict]:
        mp = self._mp
        if self._row() >= mp.width:
            if not self._sharded:
                return None
            # a sharded step's rank that computes nothing runs it on meta tensors of a chunk's shapes
            return {k: torch.empty((mp.local_accum, plan.microbatch) + tuple(v.shape[1:]), dtype=v.dtype,
                                   device="meta") for k, v in batch.items()}
        lo = self._row() * mp.local_accum
        return {k: v.reshape((plan.accum_steps, plan.microbatch) + tuple(v.shape[1:]))[lo:lo + mp.local_accum]
                for k, v in batch.items()}

    def _execute(self, state: TrainState, batch: Optional[dict], plan: StepPlan):
        metrics = None
        device = self.pipeline.device
        if self._sharded and device.type == "cuda" and state is not None:
            # what the worker stores between updates; cuBLAS keeps its workspaces (64 MiB on the H100,
            # through the caching allocator) from one call to the next, and they are not state
            clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
            if clear is not None:
                clear()
            between = torch.cuda.memory_allocated(device)
            self._times["between_bytes"].append(between)
            self._run_peak = max(self._run_peak, torch.cuda.max_memory_allocated(device))
            torch.cuda.reset_peak_memory_stats(device)  # so that each update's peak is its own
        if self._rank < (self._held if self._sharded else self._mp.width):
            state, metrics = self._elastic_step(self._mp)(state, batch, plan.lr, plan.stage)
            if self._sharded and device.type == "cuda":
                self._times["update_peak_bytes"].append((plan.stage, between, torch.cuda.max_memory_allocated(device)))
            if self._stacked:
                metrics = self._replica_mean(metrics)
        return state, self._share(metrics)

    def _replica_mean(self, metrics: dict) -> dict:
        """Local mode: the replica mean of the metrics (control traffic).
        The grad-norm pair is dropped: replicas drift between averages, so
        the (b_small, b_big) estimator does not describe the replica-local
        gradients; the GNS is starved rather than fed a mismeasured batch."""
        import torch.distributed as dist

        keys = ("loss", "aux", "grad_norm")
        mine = torch.stack([metrics[k].float().reshape(()) for k in keys]).cpu()
        every = [torch.empty_like(mine) for _ in range(self._mp.width)]
        dist.all_gather(every, mine, group=self.planner.mesh_for(self._mp.width).group)
        return dict(zip(keys, torch.stack(every).mean(0)))

    def _share(self, metrics: Optional[dict]) -> dict:
        """Rank 0's metrics, as Python floats, on every rank."""
        import torch.distributed as dist

        box = [{k: float(metrics[k]) for k in _METRIC_KEYS if k in metrics} if self._rank == 0 else None]
        if dist.get_world_size() > 1:
            dist.broadcast_object_list(box, 0)
        return box[0]

    def _after_update(self, state: TrainState, update: int, plan: StepPlan) -> TrainState:
        mp = self._mp
        self._updates_done = update
        if not self._stacked:
            # exact sync: the step itself all-gathered the partial sums
            collectives, bytes_moved = sync_cost("exact", mp.width, grad_bytes=self._grad_bytes,
                                                 state_bytes=self._state_bytes)
            self.accountant.record_update(plan.stage, collectives=collectives, bytes_moved=bytes_moved)
            self._last_sync = update
            return state
        if self.sync.due(update, self._last_sync, plan.stage):
            if self._rank < mp.width:
                state = self._sync_step(mp.width)(state)
            self._last_sync = update
            self.tracer.instant("train.sync", update=update, stage=plan.stage)
            collectives, bytes_moved = sync_cost("local", mp.width, grad_bytes=self._grad_bytes,
                                                 state_bytes=self._state_bytes)
            self.accountant.record_update(plan.stage, collectives=collectives, bytes_moved=bytes_moved)
        else:
            self.accountant.record_update(plan.stage)
        return state

    def _comm_counters(self) -> tuple:
        return self.accountant.total_bytes, self.accountant.total_sync_events

    def _ready_to_save(self, update: int) -> bool:
        # local-SGD replicas are checkpoint-consistent only right after an
        # average; exact mode is consistent after every update
        return not self._stacked or self._last_sync == update

    def _save_view(self, state: TrainState) -> TrainState:
        return collapse_state(state, self._rank)

    def _collapse(self, state: Optional[TrainState], last: bool = False) -> Optional[TrainState]:
        """A sharded state whole on rank 0 (None on the other ranks)."""
        return self._move(state, 1, last)

    def _finalize(self, state: TrainState) -> TrainState:
        if self._sharded and not self._keep:
            if self.pipeline.device.type == "cuda":
                # the steps are over: what a worker's cache holds, rank 0 may need for the whole state
                # (workers that share a card)
                torch.cuda.empty_cache()
            with self.tracer.span("train.collapse", width=self._held or 1):
                return self._collapse(state, last=True)
        if self._stacked:
            if self._rank < self._width:
                state = self._sync_step(self._width)(state)
            state = collapse_state(state, self._rank)
            self._stacked = False
        return state

    def _meta_extra(self) -> dict:
        return {"accountant": self.accountant.state(), "data_width": self._width, "sync_mode": self.sync.mode}

    def _restore_extra(self, meta: dict) -> None:
        if meta.get("accountant") is not None:
            self.accountant.restore(meta["accountant"])
        # the state was restored collapsed (the only serialized layout); the
        # next _before_update places it at whatever width THIS run's planner
        # assigns: an elastic resume is a cold placement
        self._width = self._held = None
        self._stacked = False
        self._last_sync = self._updates_done = int(meta.get("update", 0))

    def _save(self, ckpt, update, state, log, gns) -> None:
        """Rank 0 writes (a sharded state gathered whole onto it for the
        save, then dropped); the other ranks wait for it at a barrier."""
        import torch.distributed as dist

        if self._sharded and self._held and self._held > 1 and self._rank < self._held:
            held = self._held
            state = self._collapse(state)
            self._held = held
        if self._rank == 0:
            super()._save(ckpt, update, state, log, gns)
        else:
            self._last_saved = update
        dist.barrier()

    def _restore(self, ckpt, state, log, gns):
        """Rank 0 reads the latest checkpoint and shares its meta; the state
        stays on rank 0 until the first placement."""
        import torch.distributed as dist

        restored = ckpt.restore_latest() if self._rank == 0 else None
        box = [None if restored is None else restored[1]]
        dist.broadcast_object_list(box, 0)
        meta = box[0]
        if meta is None:
            return state, 0
        if self._rank == 0:
            state = train_state_from_tree(restored[0], state, self.model.cfg)
        self._apply_meta(meta, log, gns)
        return state, int(meta["update"])

    # -- the run ----------------------------------------------------------------

    def run(self, state: Optional[TrainState], log_every: int = 10, *,
            checkpointer: Optional[CheckpointManager] = None, save_every: int = 0, resume: bool = False,
            stop_after_updates: Optional[int] = None, init_seed: Optional[int] = None):
        """Drive the schedule to its sample budget over the workers; returns
        (state, log) as :meth:`SEBSTrainer.run` does (see the module
        docstring for the processes). With ``init_seed`` in place of a
        ``state`` (None), rank 0 builds the initial state on its own device
        (``model.init(init_seed)`` and the optimizer's) and the state stays
        with the workers: no final collapse, nothing copied back, and the
        returned state holds meta tensors of its shapes. That is for a state
        the caller cannot hold, or should not pass through the host."""
        if self._rank is not None:  # a worker: the loop itself
            return super().run(state, log_every, checkpointer=checkpointer, save_every=save_every,
                               resume=resume, stop_after_updates=stop_after_updates)
        kw = {"log_every": log_every, "checkpointer": checkpointer, "save_every": save_every, "resume": resume,
              "stop_after_updates": stop_after_updates, "init_seed": init_seed}
        return run_together([(self, state, kw)])[0]

    def _job(self, state: Optional[TrainState], log_every: int = 10, *,
             checkpointer: Optional[CheckpointManager] = None, save_every: int = 0, resume: bool = False,
             stop_after_updates: Optional[int] = None, init_seed: Optional[int] = None):
        """What a worker needs for this run (see :meth:`run`): (the job, the
        state tensors rank 0 takes from the caller or None, the caller's
        state or its meta stand-in)."""
        if checkpointer is not None and not isinstance(checkpointer, CheckpointManager):
            raise TypeError(f"checkpointer must be a CheckpointManager, not {type(checkpointer).__name__}")
        if (state is None) == (init_seed is None):
            raise ValueError("pass either a state or an init_seed")
        self._keep = init_seed is not None
        if self._keep:
            state = self._initial_state(init_seed, "meta")
        if self._grad_bytes is None:
            self._grad_bytes = tree_size(state.params) * 4  # grads travel in f32
            self._state_bytes = float_state_bytes(state)
        self._skeleton = skeleton_of(state)
        # the tensors go to rank 0 as torch.multiprocessing shares them: a CUDA
        # tensor by an IPC handle, a CPU one by moving its storage to shared
        # memory (in place); rank 0 copies them in and its final values back
        shared = None if self._keep else _map_state(lambda t: t.detach(), state)
        job = {"trainer": self, "slot_bytes": slot_bytes(state), "log_every": log_every,
               "save_every": save_every, "resume": resume, "stop_after_updates": stop_after_updates,
               "init_seed": init_seed,
               "ckpt": None if checkpointer is None else (checkpointer.directory, checkpointer.keep_last)}
        return job, shared, state

    def _initial_state(self, seed: int, device) -> TrainState:
        params = self.model.init(seed, device=device)
        return TrainState(params, self.optimizer.init(params), 0)

    def _adopt(self, state: TrainState, results: List[dict]):
        """Rank 0's results into the caller's state and this trainer."""
        r0 = results[0]
        state.opt_state.update(r0["opt_ints"])
        state = TrainState(state.params, state.opt_state, r0["step"])
        self.accountant.restore(r0["accountant"])
        self.pipeline.restore(r0["pipeline"])
        if r0["schedule"] is not None:
            self.controller.schedule.restore(r0["schedule"])
        self.host_rng.bit_generator.state = r0["host_rng"]
        self._steps = {tuple(k): None for k in r0["steps"]}
        for name in _ADOPTED:
            setattr(self, name, r0[name])
        if self.tracer.enabled:
            for ev in r0["events"]:
                self.tracer._emit(ev)
        if self.metrics.enabled:
            self.metrics._series.update(r0["metrics"])
        self.worker_stats = [r["stats"] for r in results]
        return state, TrainLog.from_dict(r0["log"])

    def _result(self, state, log, device) -> dict:
        """What this worker hands back: its statistics, and on rank 0 the run."""
        stats = {
            "rank": self._rank, "device": str(device),
            "peak_bytes": max(self._run_peak, torch.cuda.max_memory_allocated(device)) if device.type == "cuda"
            else None,
            "launches": _launch_counts(), "steps": sorted(self._steps),
            "allgather": [dataclasses.asdict(t) for t in self._times["allgather"]],
            "sync": [dataclasses.asdict(t) for t in self._times["sync"]],
            "broadcast": [dataclasses.asdict(t) for t in self._times["broadcast"]],
            "reshard_s": list(self._times["reshard_s"]),
            "sharded": [dataclasses.asdict(t) for t in self._times["sharded"]],
            "between_bytes": list(self._times["between_bytes"]),
            "update_peak_bytes": list(self._times["update_peak_bytes"]),
            "exchange": type(self.planner.exchange).__name__ if self.planner.exchange is not None else None,
        }
        if self._rank != 0:
            return {"stats": stats}
        schedule = self.controller.schedule
        return {
            "stats": stats, "step": state.step, "log": log.as_dict(),
            "opt_ints": {k: v for k, v in state.opt_state.items() if isinstance(v, int)},
            "accountant": self.accountant.state(), "pipeline": self.pipeline.state(),
            "schedule": schedule.state() if hasattr(schedule, "state") else None,
            "host_rng": self.host_rng.bit_generator.state, "steps": list(self._steps),
            "events": list(self.tracer.events) if self.tracer.enabled else [],
            "metrics": self.metrics._series if self.metrics.enabled else {},
            **{name: getattr(self, name) for name in _ADOPTED},
        }


class MeshTrainer(ElasticTrainer):
    """What :meth:`SEBSTrainer.run` hands a run on a mesh to: one worker
    process a rank of ``base.mesh``, each storing its shards of the state by
    ``base.param_axes`` (replicated without them) for the whole run. Each
    update's microbatches are spread over ``width`` ranks, the largest power
    of two dividing the accumulation count that fits the mesh, as the
    elastic planner chooses; every rank gathers, receives the summed
    gradient and updates its shards (``sharded.py``). So the losses and
    params are bit-identical to :class:`ElasticTrainer`'s at budget 1, but
    where an MoE layer's experts split over ``model``: computed over the
    ``model`` groups, they hold that run within a tolerance (1e-6 at f32).
    With ``base.tensor_parallel`` the microbatches spread over the
    ``model`` groups (``width`` counts groups) and each group splits its
    compute (within 1e-6 of that run at f32 too).
    Checkpoints are the single-process trainer's (no elastic meta keys)."""

    def __init__(self, base: SEBSTrainer):
        if base.controller.mode != "accumulate":
            raise ValueError("a run on a mesh spreads microbatches over its workers: it needs mode='accumulate'")
        mesh = base.mesh
        super().__init__(base.model, base.optimizer, base.controller.schedule, base.pipeline,
                         microbatch=base.controller.microbatch, device_budget=mesh.size, devices=mesh.device_list,
                         grad_clip=base.grad_clip, tracer=base.tracer, metrics=base.metrics, deadline=base.deadline)
        # the caller's own controller, pipeline and host RNG: what the run moves on is the caller's
        self.controller, self.host_rng = base.controller, base.host_rng
        self.param_axes, self.storage, self._sharded = base.param_axes, mesh, True
        self.tensor_parallel = base.tensor_parallel
        if self.tensor_parallel:  # a stage's width counts the model groups that compute
            self.planner.width_budget = row_groups(mesh, True)

    def _store_width(self, width: int) -> int:
        return self.storage.size

    def _tensor_split(self):
        """With ``tensor_parallel``, the ``model`` groups split a dense
        decoder's compute (``sharded.tensor_parallel``; None on a mesh whose
        ``model`` axis has one rank)."""
        if not self.tensor_parallel:
            return None
        return tensor_parallel(self.model, self._skeleton.params, self.storage, self.param_axes)

    def _row(self) -> int:
        return row_index(self.storage, self._rank, self._tp is not None)

    def _axis_groups(self, rank: int, exchange):
        """The rank's ``model`` and expert groups on the storage mesh, made
        by every worker together: an MoE layer whose experts the rules split
        over ``model`` computes them over the ``model`` group."""
        if self.storage.shape.get("model", 1) < 2:
            return None
        return make_axis_groups(self.storage, rank, exchange)

    def _layout(self, n: int) -> list:
        if n == self.storage.size and n > 1 and n not in self._layouts:
            self._layouts[n] = tensor_shardings(state_shardings(self._skeleton, self.storage, self.param_axes),
                                                self._skeleton)
        return super()._layout(n)

    def _after_update(self, state: TrainState, update: int, plan: StepPlan) -> TrainState:
        self._updates_done = update
        return state

    def _comm_counters(self) -> tuple:
        return 0, 0

    def _meta_extra(self) -> dict:
        return {}


def run_on_mesh(base: SEBSTrainer, state: TrainState, **run_kw):
    """``base.run`` on ``base.mesh`` (see :class:`MeshTrainer`)."""
    return run_all_on_mesh([(base, state, run_kw)])[0]


def run_all_on_mesh(runs: Sequence[Tuple[SEBSTrainer, Optional[TrainState], dict]]) -> list:
    """Several :func:`run_on_mesh` runs, (base, state, run keywords) each,
    on meshes of the same devices, one after another by one spawn of the
    mesh's workers (:func:`run_together`). Returns each run's (state, log)."""
    runners = [MeshTrainer(base) for base, _, _ in runs]
    out = run_together([(runner, state, kw) for runner, (_, state, kw) in zip(runners, runs)])
    for (base, _, _), runner in zip(runs, runners):
        base._steps, base._last_saved, base.worker_stats = runner._steps, runner._last_saved, runner.worker_stats
    return out


def run_together(runs: Sequence[Tuple[ElasticTrainer, Optional[TrainState], dict]]) -> list:
    """Each of ``runs``, (trainer, state, :meth:`ElasticTrainer.run`'s
    keywords), one after another in one spawn of workers: every trainer's
    budget of the same devices. A worker runs each as it would alone (its
    own process groups and host slots, its card's peak and the kernels'
    launch counts zeroed before it, its memory freed after it) and the
    parent waits for them all (the sum of their deadlines). Returns each
    run's (state, log), and leaves each trainer as its :meth:`run` does."""
    first = runs[0][0].planner
    world, devices = first.device_budget, [torch.device(d) for d in first.devices[:first.device_budget]]
    for trainer, _, _ in runs[1:]:
        planner = trainer.planner
        if planner.device_budget != world or [torch.device(d) for d in planner.devices[:world]] != devices:
            raise ValueError(f"runs together need the same workers: {planner.device_budget} on "
                             f"{planner.devices[:planner.device_budget]}, not {world} on {devices}")
    jobs, shared, states = [], [], []
    for trainer, state, kw in runs:
        job, box, state = trainer._job(state, **kw)
        jobs.append(job)
        shared.append(box)
        states.append(state)
    if any(d.type == "cuda" for d in devices):
        if not torch.cuda.is_available():
            raise RuntimeError("the elastic trainer's devices name CUDA, and none is available")
        from repro_torch.kernels import _cuda

        _cuda.build()  # the workers load what the parent built
    deadlines = [trainer.deadline for trainer, _, _ in runs]
    workdir = tempfile.mkdtemp(prefix="elastic_")
    try:
        for i in range(len(jobs)):
            os.mkdir(os.path.join(workdir, f"run_{i}"))  # each run's host slots
        common = {"workdir": workdir, "world": world, "settings": caller_settings(),
                  "timeout": max(trainer.collective_timeout for trainer, _, _ in runs)}
        ctx = torch.multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_worker, args=(rank, common, jobs, shared if rank == 0 else []),
                             name=f"elastic-{rank}") for rank in range(world)]
        try:
            for p in procs:
                p.start()
        except BaseException:
            stop_workers([p for p in procs if p.pid is not None])
            raise
        join_workers(procs, workdir, None if None in deadlines else sum(deadlines))
        results = [[torch.load(os.path.join(workdir, f"result_{i}_{r}.pt"), weights_only=False)
                    for r in range(world)] for i in range(len(jobs))]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        if torch.cuda.is_initialized():
            torch.cuda.ipc_collect()  # the blocks rank 0 held through IPC handles
    return [trainer._adopt(state, res) for (trainer, _, _), state, res in zip(runs, states, results)]


# -- the processes ------------------------------------------------------------------


def _launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count in this process."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.fused_optim import ops as optim_ops
    from repro_torch.kernels.gla import ops as gla_ops
    from repro_torch.kernels.paged_decode import ops as paged_ops

    return {**flash_ops.LAUNCHES, **optim_ops.LAUNCHES, **gla_ops.LAUNCHES, **paged_ops.LAUNCHES}


def _map_state(fn, state: TrainState) -> TrainState:
    """``fn`` applied to every tensor of ``state``."""
    f = lambda t: fn(t) if isinstance(t, torch.Tensor) else t  # noqa: E731
    return TrainState(_map(f, state.params), _map(f, state.opt_state), state.step)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


@torch.no_grad()
def _copy_tensors(dst: TrainState, src: TrainState) -> None:
    """``src``'s tensor values into ``dst``'s tensors, in place."""
    for a, b in zip(tree_leaves([dst.params, dst.opt_state]), tree_leaves([src.params, src.opt_state]), strict=True):
        if isinstance(a, torch.Tensor):
            a.copy_(b)


def _reset_launch_counts() -> None:
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.fused_optim import ops as optim_ops
    from repro_torch.kernels.gla import ops as gla_ops
    from repro_torch.kernels.paged_decode import ops as paged_ops

    for ops in (flash_ops, optim_ops, gla_ops, paged_ops):
        ops.reset_launches()


def _worker(rank: int, common: dict, jobs: list, box: list) -> None:
    """One worker process: join the process group, then run each job in
    turn (:func:`_run_job`); the traceback of a failure goes into the run's
    directory."""
    import torch.distributed as dist

    workdir = common["workdir"]
    try:
        apply_settings(common["settings"])
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        device = torch.device(jobs[0]["trainer"].planner.devices[rank])
        if device.type == "cuda":
            if not torch.cuda.is_available() or (device.index or 0) >= torch.cuda.device_count():
                raise RuntimeError(f"worker {rank}: its device {device} is not available")
            torch.cuda.set_device(device)
        dist.init_process_group("gloo", init_method="file://" + os.path.join(workdir, "store"), rank=rank,
                                world_size=common["world"], timeout=timedelta(seconds=common["timeout"]))
        try:
            for i in range(len(jobs)):
                job, jobs[i] = jobs[i], None  # the process object holds its arguments to the end
                _run_job(i, rank, common, job, box.pop(0) if rank == 0 else None, device)
                del job
                gc.collect()
                if device.type == "cuda":
                    torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    except BaseException:
        fail_worker(workdir, rank)


def _run_job(i: int, rank: int, common: dict, job: dict, shared: Optional[TrainState], device) -> None:
    """Run ``i`` of a spawn in this worker: the loop, then its result in the
    run's directory. Rank 0 gets the caller's state (``shared``), writes
    its final values into it and drops it, so that the parent may free
    CUDA memory it shared; or, given the job's ``init_seed``, builds the
    state on its device."""
    world, workdir = common["world"], common["workdir"]
    trainer: ElasticTrainer = job["trainer"]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _reset_launch_counts()
    trainer._rank = rank
    trainer.planner.groups, trainer.planner._meshes = prefix_groups(world), {}
    if world > 1:
        trainer.planner.exchange = make_exchange(os.path.join(workdir, f"run_{i}"), rank, world, job["slot_bytes"],
                                                 trainer.planner.devices)
        trainer._axis = trainer._axis_groups(rank, trainer.planner.exchange)
        trainer._tp = trainer._tensor_split()
    trainer.pipeline.device = device
    state = None
    if rank == 0:
        state = (trainer._initial_state(job["init_seed"], device) if shared is None
                 else _map_state(lambda t: t.to(device, copy=True), shared))
    ckpt = None if job["ckpt"] is None else CheckpointManager(job["ckpt"][0], keep_last=job["ckpt"][1])
    try:
        state, log = trainer.run(state, job["log_every"], checkpointer=ckpt, save_every=job["save_every"],
                                 resume=job["resume"], stop_after_updates=job["stop_after_updates"])
    finally:
        if ckpt is not None:
            ckpt.close()
    if shared is not None:
        _copy_tensors(shared, state)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        del shared  # releases the IPC handles
    torch.save(trainer._result(state, log, device), os.path.join(workdir, f"result_{i}_{rank}.pt"))
