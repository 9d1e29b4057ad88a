"""Figure 2 / Table 2: the equivalence line α√β = 2 — points with
α ≥ √β match the (2,1) baseline; the aggressive end (α<√β) destabilizes
(Lemma 4).  Exact NSGD recursions (``benchmarks/bench_figure2.py`` on
the port's ``core.theory``)."""
from __future__ import annotations

import math
import time

import numpy as np

from repro_torch.core import theory as T
from repro_torch.core.seesaw import divergence_risk

# Table 2 of the paper: alpha in {2, 2^(3/4), 2^(1/2), 2^(1/4), 1},
# beta chosen so alpha*sqrt(beta) = 2
POINTS = [(2.0, 1.0), (2 ** 0.75, 2 ** 0.5), (2 ** 0.5, 2.0),
          (2 ** 0.25, 2 ** 1.5), (1.0, 4.0)]


def run():
    rows = []
    lam = T.power_law_spectrum(100, a=1.0)
    eta = T.stability_eta(lam)
    sigma2, B = 1.0, 8
    m0 = T.warm_start(lam, sigma2, eta, B, 2000)
    # a larger base LR exposes the instability of the infeasible points
    eta_n = 30 * eta * math.sqrt(sigma2 * np.sum(lam) / B)
    samples = [B * 1024] * 10
    base = None
    for alpha, beta in POINTS:
        t0 = time.perf_counter()
        ph = T.phase_schedule(eta_n, B, alpha, beta, samples)
        r, _, _ = T.run_schedule(lam, sigma2, ph, m0=m0, normalized=True,
                                 assume_variance_dominated=True)
        us = (time.perf_counter() - t0) * 1e6
        final = r[-1]
        if base is None:
            base = final
        ratio = final / base if np.isfinite(final) else float("inf")
        feasible = not divergence_risk(alpha, beta)
        tagged = "feasible" if feasible else "INFEASIBLE(Lemma4)"
        rows.append((f"figure2/a{alpha:.3f}_b{beta:.3f}", us,
                     f"ratio={ratio:.3f} {tagged}"))
    return rows
