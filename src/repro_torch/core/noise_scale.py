"""Beyond-paper extension: adaptive batch sizing.

Two estimators that close the loop the paper leaves open (SEBS fixes the
stage ratio ρ a priori; the theory says the *right* batch is a function of
run-time quantities):

1. :class:`GradientNoiseScale` — McCandlish et al. 2018 (cited by the
   paper as motivation), computed FOR FREE from the gradient-accumulation
   microbatches the SEBS `accumulate` mode already produces:

       tr(Σ) ≈ (E‖g_small‖² − ‖g_big‖²) / (1/b_small − 1/b_big)
       ‖G‖²  ≈ (b_big‖g_big‖² − b_small·E‖g_small‖²) / (b_big − b_small)
       B_noise = tr(Σ) / ‖G‖²

   The critical batch size ≈ B_noise: below it, scaling batch is ~free.

2. :class:`AdaptiveSEBS` — the paper's Eq. 8 (`bₛ ∝ 1/εₛ`) operationalized
   with the *measured* training loss instead of the a-priori geometric ε
   schedule: when the smoothed loss has decayed by factor ρ_obs since the
   stage anchor, the controller opens the next stage with
   `b ← b × clip(ρ_obs, 1, ρ_max)`. Falls back to the geometric schedule's
   stage budget accounting, so computation complexity bookkeeping is
   unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.core.schedules import StageInfo


def microbatch_grad_sq_norms(grads_sum_sq, grad_big_sq, b_small: int, b_big: int):
    """Pure function combining the two squared norms into (trΣ, |G|², B_noise).

    ``grads_sum_sq``: E over microbatches of ‖g_micro‖² (each over b_small
    samples); ``grad_big_sq``: ‖mean grad‖² (over b_big samples). Computed
    in f32, as the JAX package computes it (numpy scalars here)."""
    small, big = np.float32(grads_sum_sq), np.float32(grad_big_sq)
    tr_sigma = (small - big) / np.float32(1.0 / b_small - 1.0 / b_big)
    g_sq = (np.float32(b_big) * big - np.float32(b_small) * small) / np.float32(b_big - b_small)
    b_noise = tr_sigma / np.maximum(g_sq, np.float32(1e-20))
    return tr_sigma, g_sq, b_noise


@dataclass
class GradientNoiseScale:
    """Host-side EMA of the noise-scale estimate fed from step metrics."""

    ema: float = 0.9
    _tr_sigma: Optional[float] = None
    _g_sq: Optional[float] = None

    def update(self, sum_sq_small: float, sq_big: float, b_small: int, b_big: int) -> float:
        tr_s, g_s, _ = microbatch_grad_sq_norms(sum_sq_small, sq_big, b_small, b_big)
        tr_s, g_s = float(tr_s), float(g_s)
        if self._tr_sigma is None:
            self._tr_sigma, self._g_sq = tr_s, g_s
        else:
            self._tr_sigma = self.ema * self._tr_sigma + (1 - self.ema) * tr_s
            self._g_sq = self.ema * self._g_sq + (1 - self.ema) * g_s
        return self.b_noise

    @property
    def b_noise(self) -> float:
        if self._tr_sigma is None or self._g_sq is None or self._g_sq <= 0:
            return float("nan")
        return self._tr_sigma / self._g_sq

    # -- checkpointing (kill-equivalent resume) -----------------------------

    def state(self) -> dict:
        """JSON-able snapshot of the EMA accumulators."""
        return {"tr_sigma": self._tr_sigma, "g_sq": self._g_sq}

    def restore(self, state: dict) -> None:
        self._tr_sigma = state["tr_sigma"]
        self._g_sq = state["g_sq"]


@dataclass
class AdaptiveSEBS:
    """Loss-keyed SEBS: stage transitions when the smoothed loss has
    contracted, batch multiplied by the OBSERVED contraction (Eq. 8 with
    measured ε). Implements the ``Schedule`` protocol *statefully* — the
    trainer feeds losses via :meth:`observe`.
    """

    b1: int
    eta: float
    total: int                   # total computation budget (samples)
    rho_max: float = 8.0         # cap per-stage growth
    min_stage_samples: int = 0   # don't transition before this many samples
    loss_floor: float = 0.0      # F* estimate (0 for CE-style losses)
    smooth: float = 0.8

    _batch: int = field(default=None, init=False)  # type: ignore[assignment]
    _stage: int = field(default=0, init=False)
    _stage_begin: int = field(default=0, init=False)
    _anchor_loss: Optional[float] = field(default=None, init=False)
    _ema_loss: Optional[float] = field(default=None, init=False)
    history: List[dict] = field(default_factory=list, init=False)

    def __post_init__(self):
        self._batch = self.b1
        if not self.min_stage_samples:
            self.min_stage_samples = max(self.total // 20, self.b1 * 4)

    @property
    def total_samples(self) -> int:
        return self.total

    def observe(self, samples: int, loss: float) -> None:
        """Feed a training loss; may open a new stage (batch growth)."""
        self._ema_loss = (
            loss if self._ema_loss is None
            else self.smooth * self._ema_loss + (1 - self.smooth) * loss
        )
        if self._anchor_loss is None:
            self._anchor_loss = self._ema_loss
            return
        if samples - self._stage_begin < self.min_stage_samples:
            return
        eps_anchor = max(self._anchor_loss - self.loss_floor, 1e-12)
        eps_now = max(self._ema_loss - self.loss_floor, 1e-12)
        rho_obs = eps_anchor / eps_now
        if rho_obs >= 1.5:  # meaningful contraction → next stage (Eq. 8)
            growth = float(min(rho_obs, self.rho_max))
            self._batch = max(self._batch + 1, int(round(self._batch * growth)))
            self._stage += 1
            self._stage_begin = samples
            self._anchor_loss = self._ema_loss
            self.history.append(
                {"samples": samples, "stage": self._stage, "batch": self._batch,
                 "rho_obs": rho_obs, "loss": self._ema_loss}
            )

    def info(self, samples: int) -> StageInfo:
        return StageInfo(
            stage=self._stage,
            batch_size=self._batch,
            lr=self.eta,
            samples_begin=self._stage_begin,
            samples_end=self.total,
        )

    # -- checkpointing (kill-equivalent resume) -----------------------------

    def state(self) -> dict:
        """JSON-able snapshot of everything :meth:`observe` mutates."""
        return {
            "batch": self._batch,
            "stage": self._stage,
            "stage_begin": self._stage_begin,
            "anchor_loss": self._anchor_loss,
            "ema_loss": self._ema_loss,
            "history": list(self.history),
        }

    def restore(self, state: dict) -> None:
        self._batch = int(state["batch"])
        self._stage = int(state["stage"])
        self._stage_begin = int(state["stage_begin"])
        self._anchor_loss = state["anchor_loss"]
        self._ema_loss = state["ema_loss"]
        self.history = list(state["history"])
