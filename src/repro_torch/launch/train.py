"""Training launcher (``repro.launch.train`` in PyTorch, single process).

    PYTHONPATH=src python -m repro_torch.launch.train --arch seesaw-150m \\
        --schedule seesaw [--reduced] [--batch-size 32] [--seq-len 1024] \\
        [--steps N | --total-tokens T] [--fuse-steps 4] \\
        [--max-device-batch 8] [--device cuda|cpu]

Builds the run config, the ``Trainer`` and a ``PhaseDataLoader`` over
``MarkovLM(min(vocab, 2048), seed)``, prints the plan line, one line per
``log_every`` (10) steps and a final line.  ``--device`` (default
``cuda``) picks where it runs: the hand-written kernels on the card,
their plain versions on the CPU; asking for the card without one
raises.  Multi-process launch, checkpoints and resume come with later
slices, and so does the ``adaptive-seesaw`` schedule.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import (OptimizerConfig, RunConfig, ScheduleConfig,
                                 get_config)
from repro_torch.data import MarkovLM, PhaseDataLoader
from repro_torch.train.trainer import Trainer

SCHEDULES = ("seesaw", "cosine", "step", "constant", "seesaw-general",
             "naive-ramp")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="seesaw-150m")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale variant of the arch")
    ap.add_argument("--schedule", default="seesaw", choices=SCHEDULES)
    ap.add_argument("--alpha", type=float, default=2.0)
    ap.add_argument("--beta", type=float, default=None)
    ap.add_argument("--max-cuts", type=int, default=8,
                    help="step-decay approximation depth")
    ap.add_argument("--max-batch-size", type=int, default=None,
                    help="hardware cap on the batch ramp")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--total-tokens", type=int, default=None)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--z-loss", type=float, default=0.0)
    ap.add_argument("--fuse-steps", type=int, default=1,
                    help="optimizer steps per engine call")
    ap.add_argument("--max-device-batch", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    model = get_config(args.arch)
    if args.reduced:
        model = model.reduced()
    seq_len = args.seq_len or min(model.max_seq_len, 1024)
    b0 = args.batch_size or 32
    total = args.total_tokens or (
        args.steps * b0 * seq_len if args.steps else 20 * model.param_count())
    cfg = RunConfig(
        model=model,
        schedule=ScheduleConfig(kind=args.schedule, base_lr=args.lr,
                                alpha=args.alpha,
                                beta=args.beta or args.alpha,
                                n_cuts=args.max_cuts,
                                max_batch_size=args.max_batch_size),
        optimizer=OptimizerConfig(kind=args.optimizer),
        seq_len=seq_len, global_batch_size=b0, total_tokens=total,
        z_loss=args.z_loss, seed=args.seed)

    trainer = Trainer(cfg, device=args.device, fuse_steps=args.fuse_steps,
                      max_device_batch=args.max_device_batch)
    print(f"arch={model.name} N={model.param_count()/1e6:.0f}M "
          f"schedule={args.schedule} phases={len(trainer.plan.phases)} "
          f"steps={trainer.plan.total_steps(seq_len)} "
          f"batches={trainer.plan.batch_sizes()} "
          f"fuse_steps={trainer.fuse_steps}")
    src = MarkovLM(vocab_size=min(model.vocab_size, 2048), seed=args.seed)
    loader = PhaseDataLoader(src, trainer.plan, seq_len, device=args.device)

    def log(rec):
        print(f"step {rec['step']:5d} phase {rec['phase']} "
              f"B={rec['batch_size']:4d} lr={rec['lr']:.2e} "
              f"loss={rec['loss']:.4f} ({rec['wall']:.1f}s)")

    hist = trainer.run(loader, max_steps=args.steps, log_cb=log)
    if hist:
        print(f"done: {len(hist)} steps, final loss {hist[-1]['loss']:.4f}")
    else:
        print("done: nothing to run")
    return hist


if __name__ == "__main__":
    main()
