"""Table 1: final losses, cosine vs Seesaw, across batch sizes — the
exact NSGD recursions sweep B ∈ {8,16,32,64} (CBS-relative)
(``benchmarks/bench_table1.py`` on the port's ``core.theory``)."""
from __future__ import annotations

import math
import time

import numpy as np

from repro_torch.core import theory as T


def run():
    rows = []
    lam = T.power_law_spectrum(100, a=1.0)
    eta = T.stability_eta(lam)
    sigma2 = 1.0
    for B in (8, 16, 32, 64):
        t0 = time.perf_counter()
        m0 = T.warm_start(lam, sigma2, eta, B, 2000)
        eta_n = eta * math.sqrt(sigma2 * np.sum(lam) / B)
        samples = [B * 512] * 5
        ph_step = T.phase_schedule(eta_n, B, 2.0, 1.0, samples)
        ph_see = T.phase_schedule(eta_n, B, math.sqrt(2.0), 2.0, samples)
        r1, _, _ = T.run_schedule(lam, sigma2, ph_step, m0=m0,
                                  normalized=True,
                                  assume_variance_dominated=True)
        r2, _, _ = T.run_schedule(lam, sigma2, ph_see, m0=m0,
                                  normalized=True,
                                  assume_variance_dominated=True)
        us = (time.perf_counter() - t0) * 1e6
        rows.append((f"table1/B{B}_risk_cosine", us, f"{r1[-1]:.3e}"))
        rows.append((f"table1/B{B}_risk_seesaw", us, f"{r2[-1]:.3e}"))
        rows.append((f"table1/B{B}_ratio", us,
                     f"{float(r2[-1]/r1[-1]):.4f}"))
    return rows
