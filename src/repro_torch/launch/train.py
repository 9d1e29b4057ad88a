"""Training launcher (``repro.launch.train`` in PyTorch, single process).

    PYTHONPATH=src python -m repro_torch.launch.train --arch seesaw-150m \\
        --schedule seesaw [--reduced] [--batch-size 32] [--seq-len 1024] \\
        [--steps N | --total-tokens T] [--fuse-steps 4] \\
        [--max-device-batch 8] [--device cuda|cpu] \\
        [--checkpoint ck [--save-every N] [--sync-save] [--resume] \\
         [--verify-restore] [--grace S]]

Builds the run config, the ``Trainer`` and a ``PhaseDataLoader`` over
``MarkovLM(min(vocab, 2048), seed)``, prints the plan line, one line per
``log_every`` (10) steps and a final line.  ``--device`` (default
``cuda``) picks where it runs: the hand-written kernels on the card,
their plain versions on the CPU; asking for the card without one
raises.

``--checkpoint`` names a checkpoint directory in the reference's format
(``repro_torch.train.checkpoint``), written at the end of the run;
``--save-every N`` adds saves at chunk boundaries, async unless
``--sync-save``.  ``--resume`` restores it (``--verify-restore`` checks
every block's crc32 first) and continues the run on its exact step
boundary; give the same schedule flags and ``--total-tokens`` (a
``--steps`` without ``--total-tokens`` defines the token budget, so it
must stay the same too).  SIGTERM/SIGINT stop the run at the next chunk
boundary and the final save runs if ``--grace`` seconds have not passed
since the signal.  ``--schedule adaptive-seesaw`` cuts on loss plateaus
(``--ema-decay``, ``--plateau-window``, ``--plateau-threshold``,
``--plateau-min-steps``; ``--max-cuts`` is the most cuts).  Multi-process
launch is not ported.  The frontend archs (``internvl2-76b``,
``seamless-m4t-medium``) are refused: their batches need the stub
frontend's embeddings, which the loader does not make (the reference's
neither).
"""
from __future__ import annotations

import argparse
import signal
import time

from repro_torch.configs import (OptimizerConfig, RunConfig, ScheduleConfig,
                                 get_config)
from repro_torch.data import MarkovLM, PhaseDataLoader
from repro_torch.models import registry as R
from repro_torch.train.trainer import Trainer

SCHEDULES = ("seesaw", "cosine", "step", "constant", "seesaw-general",
             "naive-ramp", "adaptive-seesaw")


class PreemptionGuard:
    """SIGTERM/SIGINT as a stop request: ``install()`` replaces the
    handlers, the trainer polls :meth:`should_stop` at each chunk
    boundary, so the run stops on an exact boundary and a final save
    resumes bit for bit.  :meth:`grace_remaining` counts the save's
    budget down from the first signal."""

    def __init__(self, grace: float = 60.0):
        self.grace = float(grace)
        self._signaled_at: float | None = None
        self._prev: dict = {}

    def install(self, signals=(signal.SIGTERM, signal.SIGINT)):
        for s in signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def uninstall(self):
        for s, h in self._prev.items():
            signal.signal(s, h)
        self._prev.clear()

    def _handler(self, signum, frame):
        if self._signaled_at is None:
            self._signaled_at = time.monotonic()

    def requested(self) -> bool:
        return self._signaled_at is not None

    def grace_remaining(self) -> float:
        if self._signaled_at is None:
            return self.grace
        return max(self.grace - (time.monotonic() - self._signaled_at),
                   0.0)

    def should_stop(self) -> bool:
        """The chunk loop's stop poll (one process: the local flag)."""
        return self.requested()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="seesaw-150m")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale variant of the arch")
    ap.add_argument("--schedule", default="seesaw", choices=SCHEDULES)
    ap.add_argument("--alpha", type=float, default=2.0)
    ap.add_argument("--beta", type=float, default=None)
    ap.add_argument("--ema-decay", type=float, default=0.98,
                    help="adaptive: loss-EMA decay per step")
    ap.add_argument("--plateau-window", type=int, default=50,
                    help="adaptive: steps per plateau test")
    ap.add_argument("--plateau-threshold", type=float, default=2e-3,
                    help="adaptive: relative improvement below which a "
                         "window counts as a plateau")
    ap.add_argument("--plateau-min-steps", type=int, default=None,
                    help="adaptive: minimum steps between cuts (default: "
                         "one plateau window)")
    ap.add_argument("--max-cuts", type=int, default=8,
                    help="adaptive: most cuts the controller may fire; "
                         "prescheduled: step-decay approximation depth")
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
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint directory (the reference's format)")
    ap.add_argument("--resume", action="store_true",
                    help="restore --checkpoint and continue the run")
    ap.add_argument("--save-every", type=int, default=None,
                    help="save every N steps (at chunk boundaries), "
                         "async unless --sync-save")
    ap.add_argument("--sync-save", action="store_true",
                    help="block the step loop during periodic saves")
    ap.add_argument("--verify-restore", action="store_true",
                    help="check every block's crc32 before resuming")
    ap.add_argument("--grace", type=float, default=60.0,
                    help="seconds allowed for the final save after "
                         "SIGTERM/SIGINT")
    args = ap.parse_args(argv)
    if args.resume and not args.checkpoint:
        ap.error("--resume needs --checkpoint")

    model = get_config(args.arch)
    if args.reduced:
        model = model.reduced()
    if R.has_frontend(model):
        ap.error(f"arch {args.arch} (arch_type={model.arch_type}) takes a "
                 f"stub frontend's embeddings, which the token loader does "
                 f"not make; train it through train.engine's grad step on "
                 f"batches with src_emb (enc-dec) or prefix_emb (VLM)")
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
                                max_batch_size=args.max_batch_size,
                                ema_decay=args.ema_decay,
                                plateau_window=args.plateau_window,
                                plateau_threshold=args.plateau_threshold,
                                plateau_min_steps=args.plateau_min_steps),
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
    if args.resume:
        meta = trainer.restore_checkpoint(args.checkpoint,
                                          verify=args.verify_restore)
        print(f"resumed step {trainer.state.step} "
              f"(phase {meta.get('phase')}, B={meta.get('batch_size')}, "
              f"tokens {trainer.state.tokens_seen})")
    src = MarkovLM(vocab_size=min(model.vocab_size, 2048), seed=args.seed)
    loader = PhaseDataLoader(src, trainer.plan, seq_len, device=args.device)
    if args.resume:
        loader.resume(trainer.state.tokens_seen)

    def log(rec):
        print(f"step {rec['step']:5d} phase {rec['phase']} "
              f"B={rec['batch_size']:4d} lr={rec['lr']:.2e} "
              f"loss={rec['loss']:.4f} ({rec['wall']:.1f}s)", flush=True)

    guard = PreemptionGuard(grace=args.grace).install()
    try:
        hist = trainer.run(loader, max_steps=args.steps, log_cb=log,
                           checkpoint_path=args.checkpoint,
                           save_every=args.save_every,
                           async_save=not args.sync_save,
                           stop_fn=guard.should_stop)
    finally:
        guard.uninstall()
    if guard.requested():
        print(f"preemption signal: stopped at step {trainer.state.step} "
              f"(chunk boundary)")
    if hist:
        print(f"done: {len(hist)} steps, final loss {hist[-1]['loss']:.4f}")
    else:
        print("done: nothing to run")
    if trainer.controller is not None:
        print(f"adaptive cuts at steps {trainer.controller.cut_steps}")
    if args.checkpoint:
        if guard.requested() and guard.grace_remaining() <= 0:
            print("grace deadline exceeded — skipping the final save "
                  "(the last periodic checkpoint is the resume point)")
        else:
            trainer.save_checkpoint(args.checkpoint)
            print(f"checkpoint → {args.checkpoint}")
    trainer.close()
    return hist


if __name__ == "__main__":
    main()
