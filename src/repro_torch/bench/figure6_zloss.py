"""Appendix E (Figures 6–7): z-loss ablation — final loss is unchanged
with z-loss on/off under cosine, and the z² statistic is tracked under
Seesaw (the paper observed end-of-training z-loss instabilities with
Seesaw at 600M; the statistic is surfaced so the effect is measurable).
Trained through the port's ``Trainer`` (``benchmarks/
bench_figure6_zloss.py``; the same model, plan and data)."""
from __future__ import annotations

import time
import numpy as np

from repro_torch.configs import (ModelConfig, OptimizerConfig, RunConfig,
                                 ScheduleConfig)
from repro_torch.data import MarkovLM, PhaseDataLoader
from repro_torch.train.trainer import Trainer

MODEL = ModelConfig(name="fig6-lm", arch_type="dense", n_layers=2,
                    d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
                    d_ff=256, vocab_size=512, max_seq_len=64,
                    rope_theta=1e4)


def _train(kind: str, z: float, steps: int = 100, *,
           device: str = "cuda", dtype: str = "bfloat16"):
    cfg = RunConfig(model=MODEL,
                    schedule=ScheduleConfig(kind=kind, base_lr=3e-3,
                                            alpha=2.0, n_cuts=3),
                    optimizer=OptimizerConfig(kind="adamw"),
                    seq_len=64, global_batch_size=8, z_loss=z,
                    total_tokens=64 * 8 * steps, remat=False, dtype=dtype)
    tr = Trainer(cfg, device=device)
    return tr.run(PhaseDataLoader(MarkovLM(512, seed=0), tr.plan, 64,
                                  device=device))


def run(device: str = "cuda", steps: int = 100,
        dtype: str = "bfloat16"):
    rows = []
    t0 = time.perf_counter()
    h_off = _train("cosine", 0.0, steps, device=device, dtype=dtype)
    h_on = _train("cosine", 1e-4, steps, device=device, dtype=dtype)
    h_see = _train("seesaw", 1e-4, steps, device=device, dtype=dtype)
    us = ((time.perf_counter() - t0) * 1e6
          / (len(h_off) + len(h_on) + len(h_see)))
    lo = float(np.mean([h["ce_loss"] for h in h_off[-5:]]))
    ln = float(np.mean([h["ce_loss"] for h in h_on[-5:]]))
    rows.append(("figure6/zloss_off_ce", us, f"{lo:.4f}"))
    rows.append(("figure6/zloss_on_ce", us, f"{ln:.4f}"))
    rows.append(("figure6/zloss_neutral", us, str(abs(lo - ln) < 0.12)))
    z_end = float(np.mean([h["z_sq"] for h in h_see[-5:]]))
    z_mid = float(np.mean([h["z_sq"]
                           for h in h_see[len(h_see)//2 - 2:
                                          len(h_see)//2 + 3]]))
    rows.append(("figure7/seesaw_z_sq_mid", us, f"{z_mid:.3f}"))
    rows.append(("figure7/seesaw_z_sq_end", us, f"{z_end:.3f}"))
    return rows
