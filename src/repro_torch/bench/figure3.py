"""Figure 3 / §4.2: past the critical batch size Assumption 2 fails —
neither Seesaw nor the SGD-rule ramp matches LR decay.  The NSGD
recursion runs with the EXACT E‖g‖² denominator (mean + variance), so the
mean term's batch-independence emerges naturally as B grows
(``benchmarks/bench_figure3.py`` on the port's ``core.theory``)."""
from __future__ import annotations

import math
import time

import numpy as np

from repro_torch.core import theory as T


def run():
    rows = []
    lam = T.power_law_spectrum(100, a=1.0)
    eta = T.stability_eta(lam)
    sigma2 = 0.05          # small noise ⇒ variance stops dominating early
    for B in (8, 256, 2048):
        t0 = time.perf_counter()
        m0 = T.warm_start(lam, sigma2, eta, 8, 1000)
        eta_n = 20 * eta * math.sqrt(np.sum(lam) * sigma2 / B)
        samples = [B * 256] * 6
        kw = dict(normalized=True, assume_variance_dominated=False)
        # LR decay baseline (α=2, β=1)
        r_dec, _, _ = T.run_schedule(
            lam, sigma2, T.phase_schedule(eta_n, B, 2.0, 1.0, samples),
            m0=m0, **kw)
        # Seesaw ramp (√2, ×2)
        r_see, _, _ = T.run_schedule(
            lam, sigma2,
            T.phase_schedule(eta_n, B, math.sqrt(2.0), 2.0, samples),
            m0=m0, **kw)
        us = (time.perf_counter() - t0) * 1e6
        gap_see = float(r_see[-1] / r_dec[-1])
        rows.append((f"figure3/B{B}_seesaw_over_decay", us,
                     f"{gap_see:.3f}"))

    # §4.2 NGD toy: L(x)=½hx² — without LR decay NGD converges to a
    # stable cycle of amplitude ηh; any batch ramp leaves it unchanged,
    # only LR decay escapes it.
    t0 = time.perf_counter()
    h_q, eta_q, x = 1.0, 0.1, 1.03
    for _ in range(200):
        x = x - eta_q * h_q * np.sign(x)
    cycle_amp = abs(x)
    x2, e2 = 1.03, eta_q
    for t in range(200):
        if t % 25 == 24:
            e2 /= 2.0
        x2 = x2 - e2 * h_q * np.sign(x2)
    us = (time.perf_counter() - t0) * 1e6
    rows.append(("figure3/ngd_cycle_no_decay", us, f"{cycle_amp:.4f}"))
    rows.append(("figure3/ngd_with_lr_decay", us, f"{abs(x2):.6f}"))
    rows.append(("figure3/ngd_decay_required", us,
                 str(abs(x2) < cycle_amp / 10)))
    return rows
