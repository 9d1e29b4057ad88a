"""Critical-batch-size estimation from the gradient noise scale
(McCandlish et al., 2018 — the quantity the paper uses to set B₀ = B*).

    B_noise = tr(Σ) / ‖G‖²

estimated from two batch sizes (the unbiased two-point estimator):
given gradient estimates g_small (batch b) and g_big (batch B ≥ 2b),

    ‖G‖²_est  = (B·‖g_big‖² − b·‖g_small‖²) / (B − b)
    tr(Σ)_est = (‖g_small‖² − ‖g_big‖²) / (1/b − 1/B)

Also exposes the *exact* noise scale on the paper's noisy-linear-
regression model (Appendix B gives E‖g‖² in closed form), used to test
the estimator and to reproduce the observation that the noise scale —
and hence the CBS — GROWS during training (McCandlish; paper §2),
which is exactly why a batch ramp is the right shape of schedule.

This package's copy of ``repro.core.cbs``.  The estimator and the
monitor take gradients as tensors, or as dicts, lists or tuples of
them, on any device; each leaf's squared norm is taken in float64 and
summed on the host, in the reference's leaf order (dict keys sorted).
The linear-regression functions stay in numpy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import theory as T


def _leaves(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)
    else:
        yield torch.as_tensor(tree)


def _sq_norm(tree) -> float:
    total = 0.0
    for x in _leaves(tree):
        v = x.detach().reshape(-1).to(torch.float64)
        total += float(torch.dot(v, v))
    return total


def noise_scale_two_point(g_small, g_big, b: int, B: int
                          ) -> Tuple[float, float, float]:
    """Returns (B_noise, |G|² estimate, tr(Σ) estimate)."""
    assert B > b
    ns2 = _sq_norm(g_small)
    nB2 = _sq_norm(g_big)
    g2 = (B * nB2 - b * ns2) / (B - b)
    tr = (ns2 - nB2) / (1.0 / b - 1.0 / B)
    g2 = max(g2, 1e-30)
    return tr / g2, g2, tr


@dataclass
class NoiseScaleMonitor:
    """Online CBS monitor for the trainer: feed per-step (g_micro,
    g_full) pairs from gradient accumulation (micro batch b, full batch
    B) and read an EMA'd noise scale — the point where B ≈ B_noise is
    the CBS and the natural place for the first Seesaw cut."""
    micro_batch: int
    full_batch: int
    ema: float = 0.9
    value: Optional[float] = None

    def update(self, g_micro, g_full) -> float:
        bn, _, _ = noise_scale_two_point(g_micro, g_full,
                                         self.micro_batch,
                                         self.full_batch)
        bn = max(bn, 0.0)
        self.value = bn if self.value is None else \
            self.ema * self.value + (1 - self.ema) * bn
        return self.value


# --------------------------------------------------------------------- #
# exact noise scale on the linear-regression model
# --------------------------------------------------------------------- #

def exact_noise_scale(lam: np.ndarray, sigma2: float, m: np.ndarray,
                      e: Optional[np.ndarray] = None) -> float:
    """tr(Σ)/‖G‖² on x~N(0,H), y=⟨w*,x⟩+ε.  Per Appendix B:
    per-sample gradient second moment (B=1 variance term)
        tr(Σ) = σ²TrH + 2⟨λ², m⟩ + TrH·⟨λ, m⟩ − ⟨λ², e²⟩·0 …
    and the mean-gradient norm ‖G‖² = ⟨λ², e²⟩ for iterate mean e (bias)
    — for the post-burn-in regime (e→0) we use ‖G‖² = ⟨λ², m⟩ (typical
    per-coordinate signal) as the deterministic-gradient proxy."""
    e = np.zeros_like(lam) if e is None else e
    trH = float(np.sum(lam))
    tr_sigma = sigma2 * trH + 2 * float(np.dot(lam * lam, m)) \
        + trH * float(np.dot(lam, m))
    g2 = max(float(np.dot(lam * lam, e * e)),
             float(np.dot(lam * lam, m)), 1e-30)
    return tr_sigma / g2


def noise_scale_trajectory(lam: np.ndarray, sigma2: float, eta: float,
                           batch: int, steps: int, every: int = 10
                           ) -> np.ndarray:
    """Run constant-(η,B) SGD on the exact recursions and record the
    noise scale every ``every`` steps — reproduces 'the noise scale
    increases during training' (paper §2 / McCandlish)."""
    d = lam.shape[0]
    m = np.full(d, 1.0 / d)
    e = np.sqrt(m)
    out = []
    for t in range(steps):
        m, e = T._step(m, e, lam, eta, batch, sigma2)
        if t % every == 0:
            out.append(exact_noise_scale(lam, sigma2, m, e))
    return np.asarray(out)
