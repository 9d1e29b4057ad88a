"""End-to-end driver: trains an OLMo-style model with the paper's §4
protocol — AdamW(0.9, 0.95), 10% warmup, seq 1024, Seesaw vs cosine at
the critical batch size — through the port's trainer (one CUDA graph
per (batch size, micro-batches), batch ramp, token-indexed LR).

Default: a ~4M-param reduction for a few hundred steps.  ``--model 150m
--steps N`` runs the paper's 150M preset (``paper_run``) at B0 =
``CBS["seesaw-150m"]`` = 256 sequences for a horizon of N cosine steps;
``--steps 0`` the full Chinchilla budget.  On one card a B0 = 256 step
accumulates ``--max-device-batch`` sequences at a time.

    python -m repro_torch.examples.seesaw_vs_cosine_lm [--model 150m]
        [--steps N] [--n-cuts K] [--device cpu]
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.configs import OptimizerConfig, RunConfig, ScheduleConfig
from repro_torch.configs.seesaw_paper import CBS, SEESAW_150M, paper_run
from repro_torch.data import MarkovLM, PhaseDataLoader
from repro_torch.train.trainer import Trainer


def run_config(model: str, kind: str, steps: int, alpha: float,
               n_cuts=None) -> RunConfig:
    """The run of ``kind``: the 150M preset through ``paper_run`` (a
    horizon of ``steps`` cosine steps at its CBS, 0 = Chinchilla), or the
    reduced model.  ``n_cuts`` overrides the schedule's depth."""
    if model == "150m":
        cfg = paper_run(SEESAW_150M, kind=kind, alpha=alpha)
        if steps:
            b0 = CBS["seesaw-150m"]
            cfg = dataclasses.replace(cfg, global_batch_size=b0,
                                      total_tokens=steps * b0 * cfg.seq_len)
    else:
        b0 = 16
        cfg = RunConfig(
            model=SEESAW_150M.reduced(),
            schedule=ScheduleConfig(kind=kind, base_lr=3e-3,
                                    warmup_frac=0.10, alpha=alpha,
                                    n_cuts=4),
            optimizer=OptimizerConfig(kind="adamw", beta1=0.9, beta2=0.95,
                                      eps=1e-8, weight_decay=0.0),
            seq_len=128, global_batch_size=b0,
            total_tokens=(steps or 300) * b0 * 128, remat=False)
    if n_cuts is not None:
        cfg = dataclasses.replace(
            cfg, schedule=dataclasses.replace(cfg.schedule, n_cuts=n_cuts))
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="reduced",
                    choices=["reduced", "150m"])
    ap.add_argument("--steps", type=int, default=300,
                    help="0 = full Chinchilla token budget")
    ap.add_argument("--alpha", type=float, default=2.0,
                    help="paper's Table 1 uses 1.1; 2.0 is the default")
    ap.add_argument("--n-cuts", type=int, default=None,
                    help="the schedule's depth (default: the config's)")
    ap.add_argument("--max-device-batch", type=int, default=32,
                    help="sequences a micro-batch (the 150M preset)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    results = {}
    for kind in ("cosine", "seesaw"):
        cfg = run_config(args.model, kind, args.steps, args.alpha,
                         args.n_cuts)
        tr = Trainer(cfg, device=args.device,
                     max_device_batch=(args.max_device_batch
                                       if args.model == "150m" else None))
        n_steps = tr.plan.total_steps(cfg.seq_len)
        print(f"\n{kind}: N={cfg.model.param_count()/1e6:.1f}M  "
              f"B0={cfg.global_batch_size}  {len(tr.plan.phases)} phases "
              f"→ {n_steps} serial steps, batches "
              f"{tr.plan.batch_sizes()}, "
              f"{tr.plan.total_tokens_scheduled(cfg.seq_len):.0f} tokens "
              f"scheduled of {cfg.resolved_total_tokens()}")
        src = MarkovLM(vocab_size=min(cfg.model.vocab_size, 2048), seed=0)
        loader = PhaseDataLoader(src, tr.plan, cfg.seq_len,
                                 device=args.device)
        hist = tr.run(loader, log_cb=lambda r: print(
            f"  step {r['step']:5d} B={r['batch_size']:4d} "
            f"lr={r['lr']:.2e} loss={r['loss']:.4f}"))
        results[kind] = hist

    h_c, h_s = results["cosine"], results["seesaw"]
    lc = np.mean([h["loss"] for h in h_c[-5:]])
    ls = np.mean([h["loss"] for h in h_s[-5:]])
    print("\n================= Figure-1 summary =================")
    print(f"cosine : {len(h_c):5d} steps  final loss {lc:.4f}  "
          f"tokens {h_c[-1]['tokens']:.3g}")
    print(f"seesaw : {len(h_s):5d} steps  final loss {ls:.4f}  "
          f"tokens {h_s[-1]['tokens']:.3g}")
    print(f"loss gap {abs(lc-ls):.4f} | serial-step reduction "
          f"{1 - len(h_s)/len(h_c):.1%} (Lemma-1 limit 36.3%)")
    return results


if __name__ == "__main__":
    main()
