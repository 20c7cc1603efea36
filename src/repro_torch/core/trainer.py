"""SEBSTrainer: glue between schedule, stage controller, data pipeline,
optimizer and the train step, in one process.

Runs any :class:`Schedule` (SEBS, classical stagewise, adaptive, ...) over
a model of the port, in either batch-growth execution mode. Train steps
are built per distinct (microbatch, accum_steps) pair and cached: SEBS with
S stages builds S step variants in ``accumulate`` mode. It tracks
(samples_consumed, parameter_updates), so a run can be plotted against
computation and against iteration complexity (paper Fig. 3).

Fault tolerance: :meth:`SEBSTrainer.run` takes a
:class:`repro_torch.checkpoint.CheckpointManager` and snapshots the full
run state every ``save_every`` updates: params, optimizer state, step
counter, host RNG, pipeline position, stateful-schedule internals
(AdaptiveSEBS), the GradientNoiseScale EMA and the log so far. The state is
written in the JAX package's layout and ``meta.json`` carries the same keys
and encodings as its trainer's, so either package resumes from the other's
directory. The contract is kill-equivalence: a run killed after any update
and resumed from the latest checkpoint gives bit-identical losses, stage
transitions and final params to an uninterrupted run.

The run loop goes through the JAX trainer's hook seams (``_before_update``,
``_place_batch``, ``_execute``, ``_after_update``, ``_comm_counters``,
``_ready_to_save``, ``_save_view``, ``_finalize``, ``_meta_extra``,
``_restore_extra``): each does nothing here, and
:class:`repro_torch.distributed.ElasticTrainer` fills them in.

**A mesh.** With ``mesh`` (``launch/mesh.py``'s :class:`Mesh`), ``run``
spawns one worker process a rank of it (the elastic trainer's machinery,
``distributed/trainer.py``'s ``MeshTrainer``): each stores its shards of
the state by ``param_axes`` (``LanguageModel.param_axes()``; the rules of
``sharding/partitioning.py``), gathered whole inside each step, and the
microbatches are spread data-parallel over the ranks, not split by the
``model`` axis as GSPMD splits them in the JAX package: the rules place
storage only. The log and state are bit-identical to
``ElasticTrainer``'s at budget 1. With ``tensor_parallel=True`` (the dense
decoders; a ``ValueError`` names the ``ROADMAP.md`` item for the others)
the ``model`` groups split attention, the MLPs and the vocabulary as GSPMD
does, and the microbatches spread over the groups: the log holds that run
within a tolerance. ``deadline`` bounds such a run's seconds. With
``REPRO_SANITIZE=1`` the loop checks each update's loss and gradient norm
for NaN/Inf and audits the tracer at the end of the run, as the JAX
trainer does (:mod:`repro_torch.analysis.sanitize`); the elastic trainer's
ranks run the same loop, and so the same hooks.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.analysis import sanitize
from repro_torch.checkpoint import CheckpointManager, train_state_from_tree, train_state_tree
from repro_torch.core.noise_scale import GradientNoiseScale
from repro_torch.core.schedules import Schedule
from repro_torch.core.stages import StageController, StepPlan
from repro_torch.data.pipeline import DataPipeline
from repro_torch.obs.metrics import NULL_METRICS, MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.optim.base import Optimizer
from repro_torch.train.state import TrainState
from repro_torch.train.step import build_train_step


@dataclass
class TrainLog:
    steps: List[int] = field(default_factory=list)
    samples: List[int] = field(default_factory=list)
    stages: List[int] = field(default_factory=list)
    batch_sizes: List[int] = field(default_factory=list)
    losses: List[float] = field(default_factory=list)
    noise_scales: List[float] = field(default_factory=list)
    # cumulative per-device sync bytes and sync collectives at each logged
    # update (the elastic trainer's CommAccountant fills them; one process
    # logs zeros)
    comm_bytes: List[int] = field(default_factory=list)
    sync_events: List[int] = field(default_factory=list)

    def as_dict(self) -> Dict[str, list]:
        # copies, not views: checkpoint meta is serialized by the writer
        # thread while the train loop keeps appending
        return {f.name: list(getattr(self, f.name)) for f in dataclasses.fields(self)}

    @classmethod
    def from_dict(cls, d: Dict[str, list]) -> "TrainLog":
        log = cls(**{f.name: list(d.get(f.name, [])) for f in dataclasses.fields(cls)})
        # checkpoints written before the comm counters existed: pad to the
        # logged length so the per-update alignment with `steps` holds
        for name in ("comm_bytes", "sync_events"):
            lst = getattr(log, name)
            if len(lst) < len(log.steps):
                lst.extend([0] * (len(log.steps) - len(lst)))
        return log


class SEBSTrainer:
    def __init__(
        self,
        model,
        optimizer: Optimizer,
        schedule: Schedule,
        pipeline: DataPipeline,
        *,
        mesh=None,
        param_axes=None,
        microbatch: Optional[int] = None,
        mode: str = "accumulate",
        accum_mode: str = "deferred",
        grad_clip: float = 0.0,
        seed: int = 0,
        tracer: Optional[Tracer] = None,
        metrics: Optional[MetricsRegistry] = None,
        deadline: Optional[float] = None,
        tensor_parallel: bool = False,
    ):
        if param_axes is not None and mesh is None:
            raise ValueError("param_axes place the state on a mesh: pass mesh too")
        if tensor_parallel:
            if mesh is None:
                raise ValueError("tensor_parallel splits compute over a mesh's model groups: pass mesh too")
            from repro_torch.sharding.partitioning import check_tensor_parallel

            check_tensor_parallel(model.cfg)
        self.model = model
        self.mesh = mesh
        self.param_axes = param_axes
        self.tensor_parallel = tensor_parallel
        self.deadline = deadline
        self.optimizer = optimizer
        self.controller = StageController(schedule, microbatch=microbatch, mode=mode)
        self.pipeline = pipeline
        self.accum_mode = accum_mode
        self.grad_clip = grad_clip
        # observability: no-op singletons unless attached; the trainer's
        # clock reads go through the tracer's injected seam
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else NULL_METRICS
        self._clock = self.tracer.clock
        # host-side RNG for any non-data stochastic decision; data batches
        # are keyed by sample offset, not by this generator, but its state
        # is checkpointed so that consumers stay kill-equivalent too
        self.host_rng = np.random.default_rng(seed)
        self._steps: Dict[tuple, Callable] = {}
        self._last_saved: Optional[int] = None  # update index of the last checkpoint

    def _step_fn(self, plan: StepPlan) -> Callable:
        key = (plan.microbatch, plan.accum_steps)
        if key not in self._steps:
            self._steps[key] = build_train_step(
                self.model, self.optimizer, accum_steps=plan.accum_steps,
                mode=self.accum_mode, grad_clip=self.grad_clip,
            )
        return self._steps[key]

    def _shape_batch(self, batch: dict, plan: StepPlan) -> dict:
        if plan.accum_steps == 1:
            return batch
        return {
            k: v.reshape((plan.accum_steps, plan.microbatch) + tuple(v.shape[1:]))
            for k, v in batch.items()
        }

    # -- checkpointing ------------------------------------------------------

    def _save(self, ckpt: CheckpointManager, update: int, state: TrainState,
              log: TrainLog, gns: GradientNoiseScale) -> None:
        """Snapshot the full run state after optimizer update ``update``, in
        the JAX package's layout and with its trainer's meta keys. The
        ``train.save`` span covers the copy to the host; the disk write runs
        on in the checkpointer's writer thread."""
        t0 = self._clock()
        meta = {
            "update": update,
            "pipeline": self.pipeline.state(),
            "gns": gns.state(),
            "host_rng": self.host_rng.bit_generator.state,
            "log": log.as_dict(),
        }
        if hasattr(self.controller.schedule, "state"):
            meta["schedule"] = self.controller.schedule.state()
        meta.update(self._meta_extra())
        ckpt.save(update, train_state_tree(self._save_view(state), self.model.cfg), meta=meta)
        self._last_saved = update
        self.tracer.complete("train.save", t0, self._clock(), update=update)

    def _restore(self, ckpt: CheckpointManager, state: TrainState,
                 log: TrainLog, gns: GradientNoiseScale) -> Tuple[TrainState, int]:
        """Restore the latest checkpoint, if any, onto the device of
        ``state``'s parameters. Returns (state, update)."""
        restored = ckpt.restore_latest()
        if restored is None:
            return state, 0
        tree, meta = restored
        state = train_state_from_tree(tree, state, self.model.cfg)
        self._apply_meta(meta, log, gns)
        return state, int(meta["update"])

    def _apply_meta(self, meta: dict, log: TrainLog, gns: GradientNoiseScale) -> None:
        """Restore everything of a checkpoint but the train state from its meta."""
        self.pipeline.restore(meta["pipeline"])
        gns.restore(meta["gns"])
        self.host_rng.bit_generator.state = meta["host_rng"]
        if meta.get("schedule") is not None and hasattr(self.controller.schedule, "restore"):
            self.controller.schedule.restore(meta["schedule"])
        saved_log = TrainLog.from_dict(meta["log"])
        for f in dataclasses.fields(TrainLog):
            getattr(log, f.name)[:] = getattr(saved_log, f.name)
        self._restore_extra(meta)

    # -- subclass hooks (repro_torch.distributed.ElasticTrainer) ------------
    #
    # The run loop goes through these seams so that the elastic data-parallel
    # trainer can change where the state lives (which workers hold a replica)
    # and when replicas synchronize, without a second copy of the schedule,
    # checkpoint and GNS plumbing. Each is an identity or a no-op here.

    def _before_update(self, state: TrainState, plan: StepPlan) -> TrainState:
        """Called before each update's batch is drawn (width transitions)."""
        return state

    def _place_batch(self, batch: dict, plan: StepPlan) -> dict:
        """Shape (and placement) of the raw pipeline batch."""
        return self._shape_batch(batch, plan)

    def _execute(self, state: TrainState, batch: dict, plan: StepPlan):
        """Run one optimizer update; returns (state, metrics)."""
        return self._step_fn(plan)(state, batch, plan.lr, plan.stage)

    def _after_update(self, state: TrainState, update: int, plan: StepPlan) -> TrainState:
        """Called after each update (local-SGD averaging, comm accounting)."""
        return state

    def _comm_counters(self) -> Tuple[int, int]:
        """(cumulative bytes per device, cumulative sync events) for the log."""
        return 0, 0

    def _ready_to_save(self, update: int) -> bool:
        """Whether the run state is checkpoint-consistent at this update
        (local-SGD replicas are only consistent right after an average)."""
        return True

    def _save_view(self, state: TrainState) -> TrainState:
        """The state to serialize (the collapsed one)."""
        return state

    def _finalize(self, state: TrainState) -> TrainState:
        """Called once when the loop exits, before the farewell save."""
        return state

    def _meta_extra(self) -> dict:
        return {}

    def _restore_extra(self, meta: dict) -> None:
        pass

    # -- the training loop --------------------------------------------------

    def run(
        self,
        state: TrainState,
        log_every: int = 10,
        *,
        checkpointer: Optional[CheckpointManager] = None,
        save_every: int = 0,
        resume: bool = False,
        stop_after_updates: Optional[int] = None,
    ) -> Tuple[TrainState, TrainLog]:
        """Drive the schedule to its sample budget; returns (state, log).

        ``checkpointer`` + ``save_every`` snapshot the full run state every
        ``save_every`` optimizer updates (plus once at exit). ``resume``
        restores from the checkpointer's latest checkpoint when one exists
        (a fresh directory falls through to a cold start).
        ``stop_after_updates`` exits the loop after that many updates: a
        simulated preemption, with no farewell save.
        """
        if checkpointer is not None and not isinstance(checkpointer, CheckpointManager):
            raise TypeError(f"checkpointer must be a CheckpointManager, not {type(checkpointer).__name__}")
        if self.mesh is not None:
            from repro_torch.distributed.trainer import run_on_mesh

            return run_on_mesh(self, state, log_every=log_every, checkpointer=checkpointer, save_every=save_every,
                               resume=resume, stop_after_updates=stop_after_updates)
        log = TrainLog()
        gns = GradientNoiseScale()
        update = 0
        save_pending = False
        if resume and checkpointer is not None:
            t0 = self._clock()
            state, update = self._restore(checkpointer, state, log, gns)
            self.tracer.complete("train.restore", t0, self._clock(), update=update)
        interrupted = False
        for plan in self.controller.plans(start_samples=self.pipeline.samples_consumed):
            if stop_after_updates is not None and update >= stop_after_updates:
                # checked BEFORE the update so a resume whose restored
                # counter already meets the limit runs no extra update;
                # exit WITHOUT a farewell save: resume must replay from the
                # last periodic checkpoint, exactly as after a real kill
                interrupted = True
                break
            t0 = self._clock()
            state = self._before_update(state, plan)
            batch = self._place_batch(self.pipeline.next_batch(plan.batch_size), plan)
            state, metrics = self._execute(state, batch, plan)
            update += 1
            state = self._after_update(state, update, plan)
            loss = float(metrics["loss"])  # waits for the update to finish
            t1 = self._clock()
            self.tracer.complete("train.update", t0, t1, update=update, stage=plan.stage,
                                 batch=plan.batch_size, loss=loss)
            self.metrics.histogram("train.update_s", labels={"stage": plan.stage}).observe(t1 - t0)
            self.metrics.counter("train.updates").inc()
            self.metrics.counter("train.samples").inc(plan.batch_size)
            if sanitize.enabled():
                sanitize.check_finite_update(dict(metrics, loss=loss), update=update, stage=plan.stage)
            # adaptive schedules consume the measured loss; the GNS estimator
            # consumes the per-microbatch grad norms of accumulate mode
            if hasattr(self.controller.schedule, "observe"):
                self.controller.schedule.observe(plan.samples_after, loss)
            if "grad_sq_big" in metrics and plan.accum_steps > 1:
                gns.update(float(metrics["grad_sq_small"]), float(metrics["grad_sq_big"]),
                           b_small=plan.microbatch, b_big=plan.batch_size)
            if update % log_every == 0 or plan.samples_after >= self.controller.schedule.total_samples:
                log.steps.append(update)
                log.samples.append(plan.samples_after)
                log.stages.append(plan.stage)
                log.batch_sizes.append(plan.batch_size)
                log.losses.append(loss)
                log.noise_scales.append(gns.b_noise)
                comm_bytes, sync_events = self._comm_counters()
                log.comm_bytes.append(comm_bytes)
                log.sync_events.append(sync_events)
                # the registry reads the same numbers as the log
                self.metrics.gauge("train.comm_bytes").set(comm_bytes)
                self.metrics.gauge("train.sync_events").set(sync_events)
                self.metrics.gauge("train.gns").set(gns.b_noise)
                if self.tracer.enabled:
                    self.tracer.counter("train.comm", bytes=comm_bytes, syncs=sync_events)
                    if not np.isnan(gns.b_noise):  # NaN is invalid trace JSON
                        self.tracer.counter("train.gns", b_noise=gns.b_noise)
            if checkpointer is not None and save_every:
                # saves SNAP to the next checkpoint-consistent update rather
                # than being dropped: local-SGD replicas are consistent only
                # right after an average, whose cadence need not align with
                # save_every
                save_pending = save_pending or update % save_every == 0
                if save_pending and self._ready_to_save(update):
                    self._save(checkpointer, update, state, log, gns)
                    save_pending = False
        state = self._finalize(state)
        if sanitize.enabled():
            sanitize.audit_tracer(self.tracer, where="(train run end)")
        if checkpointer is not None:
            # farewell save unless this exact update is already on disk
            if not interrupted and update and update != self._last_saved:
                self._save(checkpointer, update, state, log, gns)
            checkpointer.wait()
        return state, log
