"""Appendix C (Figure 4 / Table 3): Seesaw still matches cosine when
AdamW weight decay is enabled — reduced-scale LM, λ=1e-4 (the paper's
optimal from its sweep), trained through the port's ``Trainer``
(``benchmarks/bench_figure4_wd.py``; the same model, plan and data)."""
from __future__ import annotations

import time
import numpy as np

from repro_torch.configs import (ModelConfig, OptimizerConfig, RunConfig,
                                 ScheduleConfig)
from repro_torch.data import MarkovLM, PhaseDataLoader
from repro_torch.train.trainer import Trainer

MODEL = ModelConfig(name="fig4-lm", arch_type="dense", n_layers=2,
                    d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
                    d_ff=256, vocab_size=512, max_seq_len=64,
                    rope_theta=1e4)


def _train(kind: str, wd: float, steps: int = 120, *,
           device: str = "cuda", dtype: str = "bfloat16"):
    cfg = RunConfig(model=MODEL,
                    schedule=ScheduleConfig(kind=kind, base_lr=3e-3,
                                            alpha=2.0, n_cuts=4),
                    optimizer=OptimizerConfig(kind="adamw",
                                              weight_decay=wd),
                    seq_len=64, global_batch_size=8,
                    total_tokens=64 * 8 * steps, remat=False, dtype=dtype)
    tr = Trainer(cfg, device=device)
    return tr.run(PhaseDataLoader(MarkovLM(512, seed=0), tr.plan, 64,
                                  device=device))


def run(device: str = "cuda", steps: int = 120,
        dtype: str = "bfloat16"):
    rows = []
    t0 = time.perf_counter()
    wd = 1e-4
    h_cos = _train("cosine", wd, steps, device=device, dtype=dtype)
    h_see = _train("seesaw", wd, steps, device=device, dtype=dtype)
    us = (time.perf_counter() - t0) * 1e6 / (len(h_cos) + len(h_see))
    lc = float(np.mean([h["loss"] for h in h_cos[-5:]]))
    ls = float(np.mean([h["loss"] for h in h_see[-5:]]))
    rows.append(("figure4/wd1e-4_cosine_loss", us, f"{lc:.4f}"))
    rows.append(("figure4/wd1e-4_seesaw_loss", us, f"{ls:.4f}"))
    rows.append(("figure4/wd1e-4_gap", us, f"{abs(lc-ls):.4f}"))
    rows.append(("figure4/wd_robust", us, str(abs(lc - ls) < 0.12)))
    return rows
