"""Beyond-paper extension demo: budget-free Seesaw.

The paper derives cut points from a reference cosine over a KNOWN total
token budget.  The adaptive controller instead fires each (√α LR cut,
×α batch ramp) when the smoothed loss plateaus — no budget needed —
while staying on the Corollary-1 equivalence line.  This demo trains
the same tiny LM three ways and compares; ``run_adaptive`` is the
ordinary Trainer with ``kind="adaptive-seesaw"``.

    python -m repro_torch.examples.adaptive_seesaw [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs import (ModelConfig, OptimizerConfig, RunConfig,
                                 ScheduleConfig)
from repro_torch.data import MarkovLM, PhaseDataLoader
from repro_torch.train.trainer import Trainer

MODEL = ModelConfig(name="adaptive-demo", arch_type="dense", n_layers=2,
                    d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
                    d_ff=256, vocab_size=512, max_seq_len=64,
                    rope_theta=1e4)
SEQ, B0, STEPS = 64, 8, 150


def run_scheduled(kind, device="cuda"):
    cfg = RunConfig(model=MODEL,
                    schedule=ScheduleConfig(kind=kind, base_lr=3e-3,
                                            alpha=2.0, n_cuts=4),
                    optimizer=OptimizerConfig(kind="adamw"),
                    seq_len=SEQ, global_batch_size=B0,
                    total_tokens=SEQ * B0 * STEPS, remat=False)
    tr = Trainer(cfg, device=device)
    return tr.run(PhaseDataLoader(MarkovLM(512, seed=0), tr.plan, SEQ,
                                  device=device))


def run_adaptive(device="cuda"):
    """Same trainer substrate, cuts chosen online from the loss EMA."""
    cfg = RunConfig(model=MODEL,
                    schedule=ScheduleConfig(kind="adaptive-seesaw",
                                            base_lr=3e-3, alpha=2.0,
                                            n_cuts=4, ema_decay=0.9,
                                            plateau_window=8,
                                            plateau_threshold=8e-3),
                    optimizer=OptimizerConfig(kind="adamw"),
                    seq_len=SEQ, global_batch_size=B0,
                    total_tokens=SEQ * B0 * STEPS, remat=False)
    tr = Trainer(cfg, device=device)
    hist = tr.run(PhaseDataLoader(MarkovLM(512, seed=0), tr.plan, SEQ,
                                  device=device))
    return hist, tr.controller


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    h_cos = run_scheduled("cosine", args.device)
    h_see = run_scheduled("seesaw", args.device)
    h_ada, ctl = run_adaptive(args.device)

    def f(h):
        return np.mean([x["loss"] for x in h[-5:]])

    print(f"cosine            : {len(h_cos):4d} steps  loss {f(h_cos):.4f}")
    print(f"seesaw (scheduled): {len(h_see):4d} steps  loss {f(h_see):.4f}")
    print(f"seesaw (adaptive) : {len(h_ada):4d} steps  loss {f(h_ada):.4f}"
          f"  cuts at steps {ctl.cut_steps} "
          f"(final batch {int(B0 * ctl.batch_multiplier)})")
    print("\nadaptive needs no token budget: cuts fire on loss plateaus,"
          "\nstaying on the Corollary-1 line (alpha_s*sqrt(beta) = alpha).")
    return h_cos, h_see, h_ada, ctl


if __name__ == "__main__":
    main()
