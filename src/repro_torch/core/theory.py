"""Calculators for the paper's theory — used by tests (to verify the math),
by the Fig. 2 reproduction (optimal batch size vs initialization gap), and
by the stage controller's "auto" mode (set bₛ from Theorem 4 / Eq. 8).

Notation: C computation complexity (samples), M = C/b updates, gap =
‖w₁ − w*‖, σ² gradient variance bound, α weak quasi-convexity, L smoothness,
μ the PL constant, ρ > 1 the stage ratio.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


def psi_bound(eta: float, b: float, C: float, gap: float, sigma: float, alpha: float) -> float:
    """ψ(η, b) = b·gap²/(αCη) + ησ²/(αb)   — the RHS of Lemma 1 with M=C/b."""
    return b * gap**2 / (alpha * C * eta) + eta * sigma**2 / (alpha * b)


def psi_min(C: float, gap: float, sigma: float, alpha: float) -> float:
    """Global minimum of ψ over (η, b): 2·gap·σ/(α√C)."""
    return 2.0 * gap * sigma / (alpha * math.sqrt(C))


def optimal_ratio(C: float, gap: float, sigma: float) -> float:
    """Eq. (5): the minimizing pairs satisfy η*/b* = gap/(σ√C)."""
    return gap / (sigma * math.sqrt(C))


def optimal_batch(C: float, gap: float, sigma: float, alpha: float, L: float) -> float:
    """Largest b on the optimal ray subject to η ≤ α/(2L) (Lemma 1):
    b* = (α/(2L)) / (gap/(σ√C)) = ασ√C / (2L·gap)  → b* ∝ 1/gap."""
    return (alpha / (2.0 * L)) / optimal_ratio(C, gap, sigma)


@dataclass(frozen=True)
class SEBSTheory:
    """Theorem 4 quantities."""

    sigma: float
    alpha: float
    mu: float
    L: float
    rho: float

    @property
    def theta(self) -> float:
        return 32.0 * self.sigma**2 * self.rho**2 / (self.alpha**2 * self.mu)

    @property
    def kappa(self) -> float:
        return self.L / self.mu

    def gamma_max_inv(self) -> float:
        """Theorem 4 requires 1/γ ≤ αμ/(4ρ)."""
        return self.alpha * self.mu / (4.0 * self.rho)

    def stage_batch(self, eps_s: float) -> float:
        """Eq. (8) with η = α/(2L): bₛ = ασ√(μθ)/(2√2·L·εₛ) ∝ 1/εₛ."""
        return self.alpha * self.sigma * math.sqrt(self.mu * self.theta) / (
            2.0 * math.sqrt(2.0) * self.L * eps_s
        )

    def stage_compute(self, eps_s: float) -> float:
        """Cₛ = θ/εₛ."""
        return self.theta / eps_s

    def stage_lr(self, b_s: float, eps_s: float) -> float:
        """Eq. (7): ηₛ = √2·bₛ·εₛ/(σ√(μθ)), must be ≤ α/(2L)."""
        return math.sqrt(2.0) * b_s * eps_s / (self.sigma * math.sqrt(self.mu * self.theta))

    def num_stages(self, eps1: float, eps: float) -> int:
        return max(1, math.ceil(math.log(eps1 / eps, self.rho)))

    def computation_complexity(self, eps: float) -> float:
        """Σ Cₛ = O(σ²/(α²με)) — same as classical stagewise SGD."""
        return self.theta / eps * self.rho / (self.rho - 1.0)

    def iteration_complexity(self, eps1: float, eps: float) -> float:
        """Σ Mₛ = O(L/(α²μ)·log(1/ε)) — per stage Mₛ = Cₛ/bₛ is constant."""
        m_s = self.stage_compute(1.0) / self.stage_batch(1.0)  # eps cancels
        return m_s * self.num_stages(eps1, eps)

    def classical_iteration_complexity(self, eps: float, G: float) -> float:
        """Classical stagewise SGD with constant batch b₁=1: O(G²/(α²με))."""
        return G**2 / (self.alpha**2 * self.mu * eps)
