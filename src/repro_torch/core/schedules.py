"""Batch-size / learning-rate schedules.

The paper's central object is the *joint* (batch size, learning rate)
schedule as a function of consumed computation (samples). All methods the
paper discusses are instances of one interface:

- :class:`SEBS` (the contribution, Alg. 1): constant η, batch ``bₛ = b₁ρˢ``,
  stage budgets ``Cₛ = C₁ρˢ`` samples;
- :class:`ClassicalStagewise` (He et al. baseline): constant batch,
  ``ηₛ = η₁/ρˢ`` — the paper's equivalence theorem (strategy (a) vs (b))
  says these two match in training error at the same computation
  complexity, but SEBS divides the number of parameter updates by ~ρˢ;
- :class:`DBSGD` (Yu & Jin 2019): batch ×``scale`` (1.02) every epoch,
  within stages;
- :class:`SmithBatch` (Smith et al. 2018): large initial batch, batch ×ρ at
  one boundary, then LR decay — the "don't decay the LR" baseline;
- :class:`WarmupConstant` (Goyal et al. 2017-style linear warmup) for the
  LARS baseline.

``info(samples)`` must be pure and cheap: the training loop calls it every
step, and the stage index it returns is fed into the jitted train step as a
dynamic scalar (one compiled step serves all stages in `accumulate` mode).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Protocol, Sequence, Tuple


@dataclass(frozen=True)
class StageInfo:
    stage: int
    batch_size: int
    lr: float
    samples_begin: int
    samples_end: int  # exclusive; == total budget for the last stage


class Schedule(Protocol):
    def info(self, samples: int) -> StageInfo: ...

    @property
    def total_samples(self) -> int: ...


def _geometric_boundaries(c1: int, rho: float, stages: int) -> List[int]:
    bounds, acc = [], 0
    for s in range(stages):
        acc += int(round(c1 * rho**s))
        bounds.append(acc)
    return bounds


@dataclass(frozen=True)
class SEBS:
    """Stagewise Enlargement of Batch Size (Alg. 1)."""

    b1: int
    C1: int
    rho: float
    num_stages: int
    eta: float

    def __post_init__(self):
        assert self.rho > 1, "paper requires rho > 1"

    @property
    def boundaries(self) -> List[int]:
        return _geometric_boundaries(self.C1, self.rho, self.num_stages)

    @property
    def total_samples(self) -> int:
        return self.boundaries[-1]

    def info(self, samples: int) -> StageInfo:
        begin = 0
        for s, end in enumerate(self.boundaries):
            if samples < end or s == self.num_stages - 1:
                return StageInfo(
                    stage=s,
                    batch_size=int(round(self.b1 * self.rho**s)),
                    lr=self.eta,
                    samples_begin=begin,
                    samples_end=end,
                )
            begin = end
        raise AssertionError

    def updates_per_stage(self) -> List[int]:
        """Mₛ = Cₛ/bₛ — constant across stages for SEBS (paper §3.3)."""
        out = []
        begin = 0
        for s, end in enumerate(self.boundaries):
            b = int(round(self.b1 * self.rho**s))
            out.append(math.ceil((end - begin) / b))
            begin = end
        return out


@dataclass(frozen=True)
class ClassicalStagewise:
    """Constant batch; LR divided by rho at each stage boundary."""

    b: int
    C1: int
    rho: float
    num_stages: int
    eta1: float

    @property
    def boundaries(self) -> List[int]:
        return _geometric_boundaries(self.C1, self.rho, self.num_stages)

    @property
    def total_samples(self) -> int:
        return self.boundaries[-1]

    def info(self, samples: int) -> StageInfo:
        begin = 0
        for s, end in enumerate(self.boundaries):
            if samples < end or s == self.num_stages - 1:
                return StageInfo(s, self.b, self.eta1 / self.rho**s, begin, end)
            begin = end
        raise AssertionError

    def updates_per_stage(self) -> List[int]:
        out, begin = [], 0
        for end in self.boundaries:
            out.append(math.ceil((end - begin) / self.b))
            begin = end
        return out


@dataclass(frozen=True)
class EpochStagewise:
    """He-et-al-style schedule keyed to epoch boundaries (e.g. 80/120):
    either decrease LR by rho (classical) or enlarge batch by rho (SEBS) at
    each boundary — exactly the paper's CIFAR-10 experiment setup."""

    b1: int
    eta1: float
    rho: float
    epoch_size: int
    boundaries_epochs: Tuple[int, ...]
    total_epochs: int
    mode: str = "sebs"  # "sebs" | "classical"

    @property
    def total_samples(self) -> int:
        return self.total_epochs * self.epoch_size

    def info(self, samples: int) -> StageInfo:
        epoch = samples / self.epoch_size
        stage = sum(1 for e in self.boundaries_epochs if epoch >= e)
        bounds = [0] + [e * self.epoch_size for e in self.boundaries_epochs] + [self.total_samples]
        if self.mode == "sebs":
            b = int(round(self.b1 * self.rho**stage))
            lr = self.eta1
        else:
            b = self.b1
            lr = self.eta1 / self.rho**stage
        return StageInfo(stage, b, lr, bounds[stage], bounds[stage + 1])


@dataclass(frozen=True)
class DBSGD:
    """Yu & Jin (2019): batch grows by `scale` every epoch (ratio must stay
    small for their convergence guarantee — the paper shows this hurts)."""

    b1: int
    eta: float
    epoch_size: int
    total_epochs: int
    scale: float = 1.02

    @property
    def total_samples(self) -> int:
        return self.total_epochs * self.epoch_size

    def info(self, samples: int) -> StageInfo:
        epoch = int(samples // self.epoch_size)
        b = max(1, int(round(self.b1 * self.scale**epoch)))
        return StageInfo(epoch, b, self.eta, epoch * self.epoch_size, (epoch + 1) * self.epoch_size)


@dataclass(frozen=True)
class SmithBatch:
    """Smith et al. 2018 for ResNet50 as run in the paper's Table 1:
    batch ×rho at `grow_epoch`, LR /rho at each of `decay_epochs`."""

    b1: int
    eta1: float
    rho: float
    epoch_size: int
    grow_epoch: int
    decay_epochs: Tuple[int, ...]
    total_epochs: int

    @property
    def total_samples(self) -> int:
        return self.total_epochs * self.epoch_size

    def info(self, samples: int) -> StageInfo:
        epoch = samples / self.epoch_size
        b = self.b1 * (self.rho if epoch >= self.grow_epoch else 1)
        decays = sum(1 for e in self.decay_epochs if epoch >= e)
        stage = (1 if epoch >= self.grow_epoch else 0) + decays
        # real stage window (every (grow|decay) event opens a stage), not
        # the whole-run [0, total) placeholder this used to return: stage
        # equals the number of events at or before `epoch`, so the window
        # is bounded by the events adjacent to that count. A grow and a
        # decay on the same epoch advance the stage by 2; the duplicated
        # event keeps the bounds list aligned (the skipped stage is empty).
        # clamp: an event scheduled at/past total_epochs never fires inside
        # the budget, but must not push a window past total_samples
        events = sorted(min(e, self.total_epochs) for e in (self.grow_epoch, *self.decay_epochs))
        bounds = [0] + [e * self.epoch_size for e in events] + [self.total_samples]
        return StageInfo(stage, int(b), self.eta1 / self.rho**decays,
                         bounds[stage], bounds[stage + 1])


@dataclass(frozen=True)
class WarmupConstant:
    """Goyal-style linear warmup to a constant LR at a constant batch."""

    b: int
    eta: float
    warmup_samples: int
    total: int

    @property
    def total_samples(self) -> int:
        return self.total

    def info(self, samples: int) -> StageInfo:
        frac = min(1.0, (samples + 1) / max(1, self.warmup_samples))
        return StageInfo(0, self.b, self.eta * frac, 0, self.total)
