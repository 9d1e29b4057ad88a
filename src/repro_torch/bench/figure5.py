"""Figure 5: scheduler comparison at CBS — fixed-LR batch doubling
(blue), fixed-LR quadrupling (orange), α=2 step decay (green), Seesaw
(red).  Exact NSGD recursions; the naive ramps underperform
(``benchmarks/bench_figure5.py`` on the port's ``core.theory``)."""
from __future__ import annotations

import math
import time

import numpy as np

from repro_torch.core import theory as T

SCHEDULES = [
    ("naive_double", 1.0, 2.0),
    ("naive_quadruple", 1.0, 4.0),     # infeasible per Lemma 4
    ("step_decay", 2.0, 1.0),
    ("seesaw", math.sqrt(2.0), 2.0),
]


def run():
    rows = []
    lam = T.power_law_spectrum(100, a=1.0)
    eta = T.stability_eta(lam)
    sigma2, B = 1.0, 8
    m0 = T.warm_start(lam, sigma2, eta, B, 2000)
    # a well-tuned (near-edge-of-stability) base LR, as at CBS in the
    # paper: the naive ramps' non-decaying effective LR then leaves a
    # higher noise floor (blue/orange in Fig. 5), and the β=4 ramp
    # destabilizes outright (Lemma 4)
    eta_n = 40 * eta * math.sqrt(sigma2 * np.sum(lam) / B)
    samples = [B * 1024] * 8
    results = {}
    for name, a, b in SCHEDULES:
        t0 = time.perf_counter()
        ph = T.phase_schedule(eta_n, B, a, b, samples)
        r, _, _ = T.run_schedule(lam, sigma2, ph, m0=m0, normalized=True,
                                 assume_variance_dominated=False)
        us = (time.perf_counter() - t0) * 1e6
        results[name] = float(r[-1])
        rows.append((f"figure5/{name}_final_risk", us, f"{r[-1]:.3e}"))
    ok = (results["seesaw"] <= results["naive_double"] * 1.05 and
          results["step_decay"] <= results["naive_double"] * 1.05)
    rows.append(("figure5/naive_underperforms", 0.0, str(ok)))
    return rows
