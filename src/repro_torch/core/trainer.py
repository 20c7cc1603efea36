"""SEBSTrainer: glue between schedule, stage controller, data pipeline,
optimizer and the train step, in one process.

Runs any :class:`Schedule` (SEBS, classical stagewise, adaptive, ...) over
a model of the port, in either batch-growth execution mode. Train steps
are built per distinct (microbatch, accum_steps) pair and cached: SEBS with
S stages builds S step variants in ``accumulate`` mode. It tracks
(samples_consumed, parameter_updates), so a run can be plotted against
computation and against iteration complexity (paper Fig. 3).

Not yet ported: checkpoint/resume (the checkpoint slice; passing a
checkpointer raises), the elastic data-parallel hooks (the multi-worker
slice) and the sanitizer hooks (the analysis slice).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

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
        return {f.name: list(getattr(self, f.name)) for f in dataclasses.fields(self)}


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
        self._steps: Dict[tuple, Callable] = {}

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

    def run(self, state: TrainState, log_every: int = 10, *,
            checkpointer=None) -> Tuple[TrainState, TrainLog]:
        """Drive the schedule to its sample budget; returns (state, log)."""
        if checkpointer is not None:
            raise NotImplementedError("checkpoint and resume come with the checkpoint slice")
        log = TrainLog()
        gns = GradientNoiseScale()
        update = 0
        for plan in self.controller.plans(start_samples=self.pipeline.samples_consumed):
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
        return state, log
