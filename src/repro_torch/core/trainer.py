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

Not yet ported: the elastic data-parallel hooks (the multi-worker slice)
and the sanitizer hooks (the analysis slice).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

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
    # update (the JAX package's elastic trainer fills them; one process
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
        microbatch: Optional[int] = None,
        mode: str = "accumulate",
        accum_mode: str = "deferred",
        grad_clip: float = 0.0,
        seed: int = 0,
        tracer: Optional[Tracer] = None,
        metrics: Optional[MetricsRegistry] = None,
    ):
        self.model = model
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
        ckpt.save(update, train_state_tree(state, self.model.cfg), meta=meta)
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
        self.pipeline.restore(meta["pipeline"])
        gns.restore(meta["gns"])
        self.host_rng.bit_generator.state = meta["host_rng"]
        if meta.get("schedule") is not None and hasattr(self.controller.schedule, "restore"):
            self.controller.schedule.restore(meta["schedule"])
        saved_log = TrainLog.from_dict(meta["log"])
        for f in dataclasses.fields(TrainLog):
            getattr(log, f.name)[:] = getattr(saved_log, f.name)
        return state, int(meta["update"])

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
        log = TrainLog()
        gns = GradientNoiseScale()
        update = 0
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
            batch = self._shape_batch(self.pipeline.next_batch(plan.batch_size), plan)
            state, metrics = self._step_fn(plan)(state, batch, plan.lr, plan.stage)
            update += 1
            loss = float(metrics["loss"])  # waits for the update to finish
            t1 = self._clock()
            self.tracer.complete("train.update", t0, t1, update=update, stage=plan.stage,
                                 batch=plan.batch_size, loss=loss)
            self.metrics.histogram("train.update_s", labels={"stage": plan.stage}).observe(t1 - t0)
            self.metrics.counter("train.updates").inc()
            self.metrics.counter("train.samples").inc(plan.batch_size)
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
                log.comm_bytes.append(0)
                log.sync_events.append(0)
                self.metrics.gauge("train.gns").set(gns.b_noise)
                if self.tracer.enabled and not np.isnan(gns.b_noise):  # NaN is invalid trace JSON
                    self.tracer.counter("train.gns", b_noise=gns.b_noise)
            if checkpointer is not None and save_every and update % save_every == 0:
                self._save(checkpointer, update, state, log, gns)
        if checkpointer is not None:
            # farewell save unless this exact update is already on disk
            if not interrupted and update and update != self._last_saved:
                self._save(checkpointer, update, state, log, gns)
            checkpointer.wait()
        return state, log
