"""60-second tour: train a tiny LM with Seesaw vs cosine and see the
paper's effect — same loss trajectory in tokens, ~25% fewer serial steps
at this cut depth (→36% at the paper's α=1.1 depth, Lemma 1).

    python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs import (ModelConfig, OptimizerConfig, RunConfig,
                                 ScheduleConfig)
from repro_torch.data import MarkovLM, PhaseDataLoader
from repro_torch.train.trainer import Trainer

MODEL = ModelConfig(name="quickstart", arch_type="dense", n_layers=2,
                    d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
                    d_ff=256, vocab_size=512, max_seq_len=64,
                    rope_theta=1e4)


def train(kind: str, device: str = "cuda", steps: int = 150):
    cfg = RunConfig(
        model=MODEL,
        schedule=ScheduleConfig(kind=kind, base_lr=3e-3, alpha=2.0,
                                n_cuts=4),
        optimizer=OptimizerConfig(kind="adamw", beta1=0.9, beta2=0.95),
        seq_len=64, global_batch_size=8, total_tokens=64 * 8 * steps,
        remat=False)
    tr = Trainer(cfg, device=device)
    print(f"\n=== {kind}: {len(tr.plan.phases)} phases, "
          f"batches {tr.plan.batch_sizes()} ===")
    loader = PhaseDataLoader(MarkovLM(512, seed=0), tr.plan, cfg.seq_len,
                             device=device)
    hist = tr.run(loader, log_cb=lambda r: print(
        f"  step {r['step']:4d}  B={r['batch_size']:3d} "
        f"lr={r['lr']:.2e}  loss={r['loss']:.4f}"))
    return hist


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=150)
    args = ap.parse_args(argv)
    h_cos = train("cosine", args.device, args.steps)
    h_see = train("seesaw", args.device, args.steps)
    lc = np.mean([h["loss"] for h in h_cos[-5:]])
    ls = np.mean([h["loss"] for h in h_see[-5:]])
    print(f"\ncosine : {len(h_cos)} steps, final loss {lc:.4f}")
    print(f"seesaw : {len(h_see)} steps, final loss {ls:.4f}")
    print(f"serial-step reduction: {1 - len(h_see)/len(h_cos):.1%} "
          f"(Lemma 1 limit: 36.3%)")
    return h_cos, h_see


if __name__ == "__main__":
    main()
