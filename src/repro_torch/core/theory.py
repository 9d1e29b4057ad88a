"""Exact bias/variance recursions for SGD / normalized SGD on noisy
linear regression — the paper's theoretical engine (Section 5, Appendices
A & B), implemented verbatim in the eigenbasis of H.

State per step (d-vectors, diagonal of the rotated iterate covariance):
    m_{t+1} = (1-ηλ)² ⊙ m_t + (η²/B)(λ² ⊙ m_t + λ ⟨λ, m_t⟩) + (η²σ²/B) λ
    e_{t+1} = (1-ηλ) ⊙ e_t                       (mean of δ_t = w_t − w*)
Excess risk  = ½⟨λ, m⟩.

Normalized SGD (Appendix B): η_eff = η / √(E‖g‖²) with the exact
denominator
    E‖g‖² = (σ²TrH + 2⟨λ², m⟩ + TrH·⟨λ, m⟩)/B + (1−1/B)⟨λ², e²⟩
or the Assumption-2 approximation  E‖g‖² = σ²TrH/B.

These recursions are *exact* expectations — no sampling noise — so the
Theorem 1 / Corollary 1 equivalences can be verified to numerical
precision, and Lemma 4 divergence reproduced, in milliseconds.

This package's copy of ``repro.core.theory``: the same numpy float64
arithmetic in the same order, so every result equals the reference's
bit for bit.  They are host recursions of O(d) a step, not device work.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class TheoryPhase:
    eta: float          # learning rate during the phase
    batch: float        # batch size during the phase
    steps: int          # number of SGD steps in the phase

    @property
    def samples(self) -> float:
        return self.batch * self.steps


def power_law_spectrum(d: int = 100, a: float = 1.0,
                       trace: float = 1.0) -> np.ndarray:
    lam = np.arange(1, d + 1, dtype=np.float64) ** (-a)
    return lam * (trace / lam.sum())


def stability_eta(lams: np.ndarray) -> float:
    """Theorem 1's step-size condition η ≤ 0.01/Tr(H)."""
    return 0.01 / float(np.sum(lams))


# --------------------------------------------------------------------- #
# core recursion
# --------------------------------------------------------------------- #

def _step(m, e, lam, eta, B, sigma2):
    contract = (1.0 - eta * lam) ** 2
    quad = (eta * eta / B) * (lam * lam * m + lam * np.dot(lam, m))
    m = contract * m + quad + (eta * eta * sigma2 / B) * lam
    e = (1.0 - eta * lam) * e
    return m, e


def effective_grad_norm_sq(m, e, lam, B, sigma2):
    trH = float(np.sum(lam))
    var = (sigma2 * trH + 2.0 * np.dot(lam * lam, m)
           + trH * np.dot(lam, m)) / B
    mean = (1.0 - 1.0 / B) * np.dot(lam * lam, e * e)
    return var + mean


def run_schedule(lam: np.ndarray, sigma2: float,
                 phases: Sequence[TheoryPhase], *,
                 m0: Optional[np.ndarray] = None,
                 e0: Optional[np.ndarray] = None,
                 normalized: bool = False,
                 assume_variance_dominated: bool = False,
                 record_every: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Run the exact recursion.  Returns (risk_at_phase_ends,
    trajectory (tokens, risk) if record_every else empty, final m)."""
    d = lam.shape[0]
    m = np.full(d, 1.0 / d) if m0 is None else m0.astype(np.float64).copy()
    e = np.sqrt(m) if e0 is None else e0.astype(np.float64).copy()
    trH = float(np.sum(lam))
    risks = []
    traj = []
    samples_seen = 0.0
    for ph in phases:
        for t in range(ph.steps):
            eta = ph.eta
            if normalized:
                if assume_variance_dominated:
                    denom = math.sqrt(sigma2 * trH / ph.batch)
                else:
                    denom = math.sqrt(max(effective_grad_norm_sq(
                        m, e, lam, ph.batch, sigma2), 1e-300))
                eta = ph.eta / denom
            m, e = _step(m, e, lam, eta, ph.batch, sigma2)
            samples_seen += ph.batch
            if record_every and (t % record_every == 0):
                traj.append((samples_seen, 0.5 * float(np.dot(lam, m))))
            if not np.isfinite(m).all() or m.max() > 1e12:
                # diverged — record inf and stop
                risks.append(np.inf)
                return (np.asarray(risks),
                        np.asarray(traj) if traj else np.zeros((0, 2)), m)
        risks.append(0.5 * float(np.dot(lam, m)))
    return (np.asarray(risks),
            np.asarray(traj) if traj else np.zeros((0, 2)), m)


def excess_risk(lam, m) -> float:
    return 0.5 * float(np.dot(lam, m))


# --------------------------------------------------------------------- #
# schedule constructors for the theorem setups
# --------------------------------------------------------------------- #

def phase_schedule(eta0: float, b0: float, alpha: float, beta: float,
                   samples_per_phase: Sequence[float]) -> List[TheoryPhase]:
    """(η_k, B_k) = (η α^{-k}, B β^k), phase k processes
    samples_per_phase[k] samples (Theorem 1 setup)."""
    out = []
    for k, P_k in enumerate(samples_per_phase):
        B_k = b0 * beta ** k
        steps = max(int(round(P_k / B_k)), 1)
        out.append(TheoryPhase(eta=eta0 * alpha ** (-k), batch=B_k,
                               steps=steps))
    return out


def warm_start(lam: np.ndarray, sigma2: float, eta0: float, b0: float,
               steps: int, normalized: bool = False) -> np.ndarray:
    """Run a constant-(η,B) burn-in so Assumption 1 (risk ≲ σ²) holds at
    the first cut, mirroring 'well tuned scheduler starts cutting when
    bias is resolved'."""
    _, _, m = run_schedule(lam, sigma2,
                           [TheoryPhase(eta0, b0, steps)],
                           normalized=normalized,
                           assume_variance_dominated=False)
    return m


def theorem1_risk_ratio(lam, sigma2, *, eta0, b0, alpha1, beta1, alpha2,
                        beta2, samples_per_phase, m_start=None) -> float:
    """Risk ratio of the two Theorem-1 processes at the final phase end.
    With α₁β₁ = α₂β₂ the ratio must stay O(1) in phases."""
    ph1 = phase_schedule(eta0, b0, alpha1, beta1, samples_per_phase)
    ph2 = phase_schedule(eta0, b0, alpha2, beta2, samples_per_phase)
    r1, _, _ = run_schedule(lam, sigma2, ph1, m0=m_start)
    r2, _, _ = run_schedule(lam, sigma2, ph2, m0=m_start)
    return float(r1[-1] / r2[-1])


def corollary1_risk_ratio(lam, sigma2, *, eta0, b0, alpha1, beta1, alpha2,
                          beta2, samples_per_phase, m_start=None,
                          variance_dominated=True) -> float:
    """Same for normalized SGD; equivalence requires α√β matched."""
    ph1 = phase_schedule(eta0, b0, alpha1, beta1, samples_per_phase)
    ph2 = phase_schedule(eta0, b0, alpha2, beta2, samples_per_phase)
    kw = dict(normalized=True,
              assume_variance_dominated=variance_dominated)
    r1, _, _ = run_schedule(lam, sigma2, ph1, m0=m_start, **kw)
    r2, _, _ = run_schedule(lam, sigma2, ph2, m0=m_start, **kw)
    return float(r1[-1] / r2[-1])
