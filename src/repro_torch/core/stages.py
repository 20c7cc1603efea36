"""StageController — the runtime half of SEBS.

Maps the pipeline's consumed-sample count onto the current
:class:`StageInfo` and derives the *execution plan* for the train step:

- ``reshape`` mode: the global batch itself grows (one compiled step per
  distinct batch size — stage boundaries trigger a re-jit);
- ``accumulate`` mode (default): the global microbatch is fixed at ``b₁``
  and batch growth becomes more accumulation steps per optimizer update
  (``accum = bₛ/b₁``), with ONE gradient all-reduce per update (deferred
  psum). Communication per sample thus falls by exactly ρˢ in stage s —
  the paper's iteration-complexity saving made structural.

The controller is pure Python (host side); the only values crossing into
the jitted step are (stage_idx, lr) scalars and the microbatch array.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, Optional

from repro_torch.core.schedules import Schedule, StageInfo


@dataclass(frozen=True)
class StepPlan:
    stage: int
    lr: float
    batch_size: int       # optimizer-update batch (grows with stage)
    microbatch: int       # fixed per-compile batch
    accum_steps: int      # batch_size // microbatch (accumulate mode)
    samples_after: int    # consumed-sample count once this update is applied


class StageController:
    def __init__(self, schedule: Schedule, microbatch: Optional[int] = None,
                 mode: str = "accumulate"):
        assert mode in ("accumulate", "reshape")
        self.schedule = schedule
        self.mode = mode
        first = schedule.info(0)
        self.microbatch = microbatch or first.batch_size
        if mode == "accumulate" and first.batch_size % self.microbatch:
            raise ValueError(
                f"b1={first.batch_size} not divisible by microbatch={self.microbatch}"
            )

    def plan(self, samples_consumed: int) -> StepPlan:
        info: StageInfo = self.schedule.info(samples_consumed)
        if self.mode == "accumulate":
            # ceil, not round: the planned batch must never undershoot the
            # schedule's bₛ (e.g. b = 1.4·micro rounded down to 1 microbatch
            # would silently shrink the stage batch)
            accum = max(1, math.ceil(info.batch_size / self.microbatch))
            bs = accum * self.microbatch
        else:
            accum = 1
            bs = info.batch_size
        return StepPlan(
            stage=info.stage,
            lr=info.lr,
            batch_size=bs,
            microbatch=self.microbatch if self.mode == "accumulate" else bs,
            accum_steps=accum,
            samples_after=samples_consumed + bs,
        )

    def plans(self, start_samples: int = 0) -> Iterator[StepPlan]:
        """Iterate update plans until the schedule's budget is exhausted.

        ``start_samples`` resumes the plan stream mid-run (checkpoint
        restore): because :meth:`plan` is a pure function of the
        consumed-sample count (plus, for stateful schedules, their restored
        internal state), ``plans(k)`` is exactly the tail of ``plans(0)``
        after the update that ends at ``k`` samples — the kill-equivalence
        property the resume path relies on.
        """
        samples = start_samples
        while samples < self.schedule.total_samples:
            p = self.plan(samples)
            yield p
            samples = p.samples_after

    def total_updates(self) -> int:
        return sum(1 for _ in self.plans())

    def total_samples(self) -> int:
        last = 0
        for p in self.plans():
            last = p.samples_after
        return last

    def distinct_shapes(self) -> set:
        """(microbatch, accum) pairs → number of distinct compilations."""
        return {(p.microbatch, p.accum_steps) for p in self.plans()}

    def stage_ladder(self) -> list[StepPlan]:
        """First StepPlan of each stage, in stage order — the (batch,
        accum) ladder a mesh planner widens along. One pass over the plan
        stream, filtered to stage entries."""
        out: list[StepPlan] = []
        for p in self.plans():
            if not out or p.stage != out[-1].stage:
                out.append(p)
        return out
