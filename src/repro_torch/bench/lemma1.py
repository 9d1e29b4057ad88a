"""Lemma 1: the 2/π serial-step limit — theoretical value, discrete-plan
convergence, and the measured reduction of real SeesawPlans
(``benchmarks/bench_lemma1.py`` on the port's planner)."""
from __future__ import annotations

import math
import time

from repro_torch.core.seesaw import (build_plan, continuous_step_fraction,
                                     measured_speedup, theoretical_speedup)


def run():
    rows = []
    t0 = time.perf_counter()
    rows.append(("lemma1/theoretical_speedup", 0.1,
                 f"{theoretical_speedup():.4f}"))
    for n_cuts, alpha in [(4, 2.0), (12, 1.5), (30, 1.1), (60, 1.05)]:
        frac = continuous_step_fraction(n_cuts, alpha)
        rows.append((f"lemma1/discrete_n{n_cuts}_a{alpha}", 1.0,
                     f"reduction={1-frac:.4f}"))
    see = build_plan(kind="seesaw", base_lr=1.0, total_tokens=2 ** 30,
                     warmup_frac=0.1, b0=256, alpha=1.1, n_cuts=40)
    ref = build_plan(kind="cosine", base_lr=1.0, total_tokens=2 ** 30,
                     warmup_frac=0.1, b0=256, alpha=1.1, n_cuts=40)
    us = (time.perf_counter() - t0) * 1e6
    sp = measured_speedup(see, ref, 1024)
    rows.append(("lemma1/plan_measured_speedup", us, f"{sp:.4f}"))
    rows.append(("lemma1/limit_2_over_pi", 0.1, f"{2/math.pi:.4f}"))
    return rows
