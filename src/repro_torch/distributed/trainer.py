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
width of them compute.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from multiprocessing import connection
from typing import Dict, List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager, train_state_from_tree
from repro_torch.core.stages import StepPlan
from repro_torch.core.trainer import SEBSTrainer, TrainLog
from repro_torch.data.pipeline import DataPipeline
from repro_torch.distributed.planner import ElasticMeshPlanner, MeshPlan
from repro_torch.distributed.reshard import (
    broadcast_state,
    build_sync_step,
    collapse_state,
    float_state_bytes,
    skeleton_of,
    state_shardings,
)
from repro_torch.distributed.sharded import build_sharded_train_step, move_state, tensor_leaves, tensor_shardings
from repro_torch.distributed.staging import StagingTimes, make_exchange
from repro_torch.distributed.step import build_elastic_train_step, build_local_train_step
from repro_torch.distributed.sync import CommAccountant, SyncScheduler, allreduce_bytes_per_device, sync_cost
from repro_torch.launch.mesh import prefix_groups
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
        d["_width"], d["_stacked"], d["_held"], d["_layouts"] = None, False, None, {}
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
                    grad_clip=self.grad_clip, times=self._times["sharded"])
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
        t0 = time.perf_counter()
        with self.tracer.span("train.reshard", old=self._width or 0, new=mp.width, stage=stage):
            state = self._transition_inner(state, mp, stage)
        self._times["reshard_s"].append(time.perf_counter() - t0)
        return state

    def _move(self, state: Optional[TrainState], n_new: int) -> Optional[TrainState]:
        """The sharded state from ranks ``[0, self._held)`` (rank 0 alone
        before the first placement) to ranks ``[0, n_new)``."""
        n_old = self._held or 1
        xw = max(n_old, n_new)
        if n_new != n_old and self._rank < xw:
            old = tensor_leaves(state) if state is not None and n_old == 1 else []
            state = move_state(state, self._skeleton, self._layout(n_old), self._layout(n_new), self._rank,
                               self.planner.mesh_for(xw), StagingTimes())
            # rank 0's whole state (its own copy of the caller's, a restore, or a width-1 stage's), which the
            # callers' frames may still name: free its memory, so that only the shards stay
            for t in old:
                t.untyped_storage().resize_(0)
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
        if self._rank >= mp.width:
            if not self._sharded:
                return None
            # a sharded step's rank that computes nothing runs it on meta tensors of a chunk's shapes
            return {k: torch.empty((mp.local_accum, plan.microbatch) + tuple(v.shape[1:]), dtype=v.dtype,
                                   device="meta") for k, v in batch.items()}
        lo = self._rank * mp.local_accum
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

    def _collapse(self, state: Optional[TrainState]) -> Optional[TrainState]:
        """A sharded state whole on rank 0 (None on the other ranks)."""
        return self._move(state, 1)

    def _finalize(self, state: TrainState) -> TrainState:
        if self._sharded:
            return self._collapse(state)
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

    def run(self, state: TrainState, log_every: int = 10, *, checkpointer: Optional[CheckpointManager] = None,
            save_every: int = 0, resume: bool = False, stop_after_updates: Optional[int] = None):
        """Drive the schedule to its sample budget over the workers; returns
        (state, log) as :meth:`SEBSTrainer.run` does (see the module
        docstring for the processes)."""
        if self._rank is not None:  # a worker: the loop itself
            return super().run(state, log_every, checkpointer=checkpointer, save_every=save_every,
                               resume=resume, stop_after_updates=stop_after_updates)
        if checkpointer is not None and not isinstance(checkpointer, CheckpointManager):
            raise TypeError(f"checkpointer must be a CheckpointManager, not {type(checkpointer).__name__}")
        world = self.planner.device_budget
        if any(torch.device(d).type == "cuda" for d in self.planner.devices[:world]):
            if not torch.cuda.is_available():
                raise RuntimeError("the elastic trainer's devices name CUDA, and none is available")
            from repro_torch.kernels import _cuda

            _cuda.build()  # the workers load what the parent built
        if self._grad_bytes is None:
            self._grad_bytes = tree_size(state.params) * 4  # grads travel in f32
            self._state_bytes = float_state_bytes(state)
        self._skeleton = skeleton_of(state)
        # the tensors go to rank 0 as torch.multiprocessing shares them: a CUDA
        # tensor by an IPC handle, a CPU one by moving its storage to shared
        # memory (in place); rank 0 copies them in and its final values back
        shared = _map_state(lambda t: t.detach(), state)
        workdir = tempfile.mkdtemp(prefix="elastic_")
        try:
            job = {"workdir": workdir, "world": world, "trainer": self, "settings": _caller_settings(),
                   "slot_bytes": _slot_bytes(state), "log_every": log_every, "save_every": save_every,
                   "resume": resume, "stop_after_updates": stop_after_updates,
                   "ckpt": None if checkpointer is None else (checkpointer.directory, checkpointer.keep_last)}
            ctx = torch.multiprocessing.get_context("spawn")
            procs = [ctx.Process(target=_worker, args=(rank, job, [shared] if rank == 0 else []),
                                 name=f"elastic-{rank}") for rank in range(world)]
            try:
                for p in procs:
                    p.start()
            except BaseException:
                _stop([p for p in procs if p.pid is not None])
                raise
            _join(procs, workdir, self.deadline)
            results = [torch.load(os.path.join(workdir, f"result_{r}.pt"), weights_only=False)
                       for r in range(world)]
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
            if torch.cuda.is_initialized():
                torch.cuda.ipc_collect()  # the blocks rank 0 held through IPC handles
        return self._adopt(state, results)

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
    params are bit-identical to :class:`ElasticTrainer`'s at budget 1.
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

    def _store_width(self, width: int) -> int:
        return self.storage.size

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
    runner = MeshTrainer(base)
    state, log = runner.run(state, **run_kw)
    base._steps, base._last_saved, base.worker_stats = runner._steps, runner._last_saved, runner.worker_stats
    return state, log


# -- the processes ------------------------------------------------------------------


def _caller_settings() -> dict:
    """The numerics settings a worker must share with its caller."""
    return {"num_threads": torch.get_num_threads(), "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_precision": torch.get_float32_matmul_precision(),
            "deterministic": torch.are_deterministic_algorithms_enabled()}


def _apply_settings(s: dict) -> None:
    torch.set_num_threads(s["num_threads"])
    torch.backends.cuda.matmul.allow_tf32 = s["matmul_tf32"]
    torch.backends.cudnn.allow_tf32 = s["cudnn_tf32"]
    torch.set_float32_matmul_precision(s["matmul_precision"])
    torch.use_deterministic_algorithms(s["deterministic"])


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


def _slot_bytes(state: TrainState) -> int:
    """Bytes of a host slot: the largest tensor of the state, or of its f32
    gradient."""
    return max(64, *(t.numel() * max(t.element_size(), 4)
                     for t in tree_leaves([state.params, state.opt_state]) if isinstance(t, torch.Tensor)))


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


def _worker(rank: int, job: dict, box: list) -> None:
    """One worker process: join the process group, run the loop, write the
    result (or the traceback) into the run's directory. Rank 0 gets the
    caller's state (in ``box``), writes its final values into it and drops
    it before it exits, so that the parent may free CUDA memory it shared."""
    import torch.distributed as dist

    workdir = job["workdir"]
    try:
        _apply_settings(job["settings"])
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        trainer: ElasticTrainer = job["trainer"]
        device = torch.device(trainer.planner.devices[rank])
        if device.type == "cuda":
            if not torch.cuda.is_available() or (device.index or 0) >= torch.cuda.device_count():
                raise RuntimeError(f"worker {rank}: its device {device} is not available")
            torch.cuda.set_device(device)
            torch.cuda.reset_peak_memory_stats(device)
        dist.init_process_group("gloo", init_method="file://" + os.path.join(workdir, "store"), rank=rank,
                                world_size=job["world"], timeout=timedelta(seconds=trainer.collective_timeout))
        try:
            trainer._rank = rank
            trainer.planner.groups, trainer.planner._meshes = prefix_groups(job["world"]), {}
            if job["world"] > 1:
                trainer.planner.exchange = make_exchange(workdir, rank, job["world"], job["slot_bytes"],
                                                         trainer.planner.devices)
            trainer.pipeline.device = device
            state = shared = None
            if rank == 0:
                shared = box.pop()  # the process object holds its arguments to the end
                state = _map_state(lambda t: t.to(device, copy=True), shared)
            ckpt = None if job["ckpt"] is None else CheckpointManager(job["ckpt"][0], keep_last=job["ckpt"][1])
            try:
                state, log = trainer.run(state, job["log_every"], checkpointer=ckpt, save_every=job["save_every"],
                                         resume=job["resume"], stop_after_updates=job["stop_after_updates"])
            finally:
                if ckpt is not None:
                    ckpt.close()
            if rank == 0:
                _copy_tensors(shared, state)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                del shared  # releases the IPC handles
            torch.save(trainer._result(state, log, device), os.path.join(workdir, f"result_{rank}.pt"))
        finally:
            dist.destroy_process_group()
    except BaseException:
        path = os.path.join(workdir, f"error_{rank}.txt")
        with open(path + ".tmp", "w") as f:
            f.write(f"{time.time():.9f}\n{traceback.format_exc()}")  # when, to find the first failure
        os.replace(path + ".tmp", path)  # whole, or not there: the parent may stop this worker at any time
        os._exit(1)


def _stop(procs) -> None:
    """Terminate ``procs`` (then kill what is left after 10 s)."""
    for p in procs:
        p.terminate()
    for p in procs:
        p.join(10)
        if p.exitcode is None:
            p.kill()
            p.join()


def _join(procs, workdir: str, deadline: Optional[float]) -> None:
    """Wait for every worker. When one exits non-zero, or ``deadline``
    seconds pass (or the wait itself is interrupted), terminate the rest;
    raise with the first failing worker's traceback."""
    t_end = None if deadline is None else time.monotonic() + deadline
    alive, failed = list(procs), False
    try:
        while alive and not failed:
            wait = 1.0 if t_end is None else max(0.0, min(1.0, t_end - time.monotonic()))
            connection.wait([p.sentinel for p in alive], wait)
            for p in list(alive):
                if p.exitcode is not None:
                    alive.remove(p)
                    failed = failed or p.exitcode != 0
            if t_end is not None and time.monotonic() >= t_end and alive:
                break
    finally:
        _stop([p for p in procs if p.exitcode is None])
    if not failed and not alive:
        return
    errors = []
    for name in os.listdir(workdir):
        if name.startswith("error_") and name.endswith(".txt"):
            with open(os.path.join(workdir, name)) as f:
                when, _, text = f.read().partition("\n")
            errors.append((float(when), name[len("error_"):-len(".txt")], text))
    errors.sort()
    if errors:
        _, first, text = errors[0]
        others = [rank for _, rank, _ in errors[1:]]
        detail = f"worker rank {first} failed:\n{text}"
        if others:
            detail += f"(ranks {', '.join(others)} failed after it)"
    else:
        codes = {p.name: p.exitcode for p in procs}
        detail = f"the workers left no traceback here (exit codes {codes}; see their standard error)"
    if not failed:
        raise TimeoutError(f"the elastic run did not finish within {deadline} s; its workers were terminated. "
                           + (detail if errors else ""))
    raise RuntimeError(f"an elastic worker failed; the others were terminated. {detail}")
