"""Figure 1: Seesaw matches cosine in loss-vs-tokens while cutting
serial steps — a reduced-scale LM trained through the port's
``Trainer`` (the same code path as the 150M preset) + the exact theory
sim at paper-like depth (``benchmarks/bench_figure1.py``; the same
model, plan and data).  On the card the LM trains through the hand-
written kernels at head_dim 32."""
from __future__ import annotations

import math
import time
import numpy as np

from repro_torch.configs import (ModelConfig, OptimizerConfig, RunConfig,
                                 ScheduleConfig)
from repro_torch.core import theory as T
from repro_torch.data import MarkovLM, PhaseDataLoader
from repro_torch.train.trainer import Trainer

MODEL = ModelConfig(name="fig1-lm", arch_type="dense", n_layers=2,
                    d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
                    d_ff=256, vocab_size=512, max_seq_len=64,
                    rope_theta=1e4)


def config(kind: str, steps: int = 150,
           dtype: str = "bfloat16") -> RunConfig:
    """The run of ``kind`` over the plan of ``steps`` cosine steps."""
    return RunConfig(model=MODEL,
                     schedule=ScheduleConfig(kind=kind, base_lr=3e-3,
                                             alpha=2.0, n_cuts=4),
                     optimizer=OptimizerConfig(kind="adamw"),
                     seq_len=64, global_batch_size=8,
                     total_tokens=64 * 8 * steps, remat=False, dtype=dtype)


def _train(kind: str, steps: int = 150, *, device: str = "cuda",
           dtype: str = "bfloat16"):
    """One run of ``kind`` over the plan of ``steps`` cosine steps."""
    tr = Trainer(config(kind, steps, dtype), device=device)
    return tr.run(PhaseDataLoader(MarkovLM(512, seed=0), tr.plan, 64,
                                  device=device))


def run(device: str = "cuda", steps: int = 150,
        dtype: str = "bfloat16"):
    rows = []
    t0 = time.perf_counter()
    h_cos = _train("cosine", steps, device=device, dtype=dtype)
    h_see = _train("seesaw", steps, device=device, dtype=dtype)
    wall = (time.perf_counter() - t0) * 1e6 / (len(h_cos) + len(h_see))
    lc = float(np.mean([h["loss"] for h in h_cos[-5:]]))
    ls = float(np.mean([h["loss"] for h in h_see[-5:]]))
    red = 1 - len(h_see) / len(h_cos)
    rows.append(("figure1/lm_cosine_final_loss", wall, f"{lc:.4f}"))
    rows.append(("figure1/lm_seesaw_final_loss", wall, f"{ls:.4f}"))
    rows.append(("figure1/lm_loss_gap", wall, f"{abs(lc-ls):.4f}"))
    rows.append(("figure1/lm_step_reduction", wall, f"{red:.3f}"))

    # theory sim at paper-like cut depth (α=1.1 ⇒ many cuts)
    lam = T.power_law_spectrum(100, a=1.0)
    eta = T.stability_eta(lam)
    m0 = T.warm_start(lam, 1.0, eta, 8, 2000)
    t0 = time.perf_counter()
    eta_n = eta * math.sqrt(np.sum(lam) / 8)
    # cosine-approximating step decay (α=2 cuts) vs Seesaw (√2, ×2)
    ph_step = T.phase_schedule(eta_n, 8, 2.0, 1.0, [8192] * 5)
    ph_see = T.phase_schedule(eta_n, 8, math.sqrt(2.0), 2.0, [8192] * 5)
    r1, _, _ = T.run_schedule(lam, 1.0, ph_step, m0=m0, normalized=True,
                              assume_variance_dominated=True)
    r2, _, _ = T.run_schedule(lam, 1.0, ph_see, m0=m0, normalized=True,
                              assume_variance_dominated=True)
    us = (time.perf_counter() - t0) * 1e6
    steps_ref = sum(p.steps for p in ph_step)
    steps_see = sum(p.steps for p in ph_see)
    rows.append(("figure1/theory_risk_ratio", us,
                 f"{float(r2[-1]/r1[-1]):.4f}"))
    rows.append(("figure1/theory_step_reduction", us,
                 f"{1 - steps_see/steps_ref:.3f}"))
    return rows
