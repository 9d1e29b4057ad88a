"""Training launcher (``repro.launch.train`` in PyTorch).

    PYTHONPATH=src python -m repro_torch.launch.train --arch seesaw-150m \\
        --schedule seesaw [--reduced] [--batch-size 32] [--seq-len 1024] \\
        [--steps N | --total-tokens T] [--fuse-steps 4] \\
        [--max-device-batch 8] [--device cuda|cpu] [--dtype float32] \\
        [--checkpoint ck [--save-every N] [--sync-save] [--resume] \\
         [--verify-restore] [--grace S]] \\
        [--per-host] [--coordinator HOST:PORT --num-processes N \\
         --process-id I] [--mesh DxM | PxDxM]

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
``--plateau-min-steps``; ``--max-cuts`` is the most cuts).  The frontend archs (``internvl2-76b``,
``seamless-m4t-medium``) are refused: their batches need the stub
frontend's embeddings, which the loader does not make (the reference's
neither).

Multi-process data parallelism: run the same command once a process
with ``--coordinator`` (rank 0's ``host:port``), ``--num-processes`` and
a distinct ``--process-id``, or under ``torchrun``, whose
``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` stand for them
(the flags win)::

    torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --device cpu --reduced --batch-size 4 --steps 20

:func:`maybe_init_distributed` joins the ``torch.distributed`` group
(retrying with backoff, ``--connect-attempts``/``--connect-backoff``;
a failure after the retries raises, nothing falls back to one process).
The backend follows the devices: ``gloo`` on the CPU and when ranks
share a card, ``nccl`` when each has one of its own; rank r runs on
``cuda:(LOCAL_RANK mod device count)`` (``LOCAL_RANK`` from torchrun,
else the process id).  Every rank holds the model and trains on its own
rows of each global batch; per-host feeding (``--per-host``) is forced
on, each process sampling rows ``[r·B/N, (r+1)·B/N)``, and the ramp is
checked up front to divide across the processes (from the resume point
on a resume, which may have another process count: a checkpoint
restores on any number).  The stop poll is collective: a signal to one
rank stops every rank at the same chunk boundary, and they save.

``--mesh DxM`` (or ``PxDxM``) shards the dense family over a data ×
model mesh of the processes (one process a slot; the reference's
``--mesh``): FSDP over the data axes, tensor-parallel over model
(``repro_torch.parallel``).  Each rank feeds its data slot's rows
(``process_index`` = the slot, ``process_count`` = P·D; the ranks of a
slot load the same rows), ``--max-device-batch`` counts rows a data
slot, and a checkpoint holds each distinct block once.  The steps run
eagerly (a gloo collective is host work no CUDA graph holds).  Another
family, a head count or dim the mesh does not divide, or a mesh whose
size is not the process count raises ``ValueError`` before any
collective.  Without ``--mesh`` the ranks replicate the model, as above::

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --device cpu --reduced --mesh 2x2 --batch-size 4 --steps 20
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
import time

import torch
import torch.distributed as dist

from repro_torch import parallel
from repro_torch.configs import (OptimizerConfig, RunConfig, ScheduleConfig,
                                 get_config)
from repro_torch.data import MarkovLM, PhaseDataLoader
from repro_torch.launch import mesh
from repro_torch.models import registry as R
from repro_torch.train.trainer import Trainer

SCHEDULES = ("seesaw", "cosine", "step", "constant", "seesaw-general",
             "naive-ramp", "adaptive-seesaw")


class PreemptionGuard:
    """SIGTERM/SIGINT as a stop request: ``install()`` replaces the
    handlers, the trainer polls :meth:`should_stop` at each chunk
    boundary, so the run stops on an exact boundary and a final save
    resumes bit for bit.  In a multi-process run the poll is collective
    (the ranks all-reduce their flags, max): one rank's signal stops
    every rank at the same boundary, since a rank leaving the loop alone
    would strand its peers in the next step's all-reduce.
    :meth:`grace_remaining` counts the save's budget down from the first
    signal."""

    def __init__(self, grace: float = 60.0):
        self.grace = float(grace)
        self._signaled_at: float | None = None
        self._prev: dict = {}
        self.stopped = False            # the (collective) poll said stop

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
        """This process received a signal (local, no collective)."""
        return self._signaled_at is not None

    def grace_remaining(self) -> float:
        if self._signaled_at is None:
            return self.grace
        return max(self.grace - (time.monotonic() - self._signaled_at),
                   0.0)

    def should_stop(self) -> bool:
        """The chunk loop's stop poll: every process returns the same
        answer at the same boundary."""
        self.stopped = _any_rank(self.requested())
        return self.stopped

    def save_allowed(self) -> bool:
        """Whether the final save runs: while every rank is inside its
        grace period (collective, so the ranks save together or not)."""
        return not _any_rank(self.requested()
                             and self.grace_remaining() <= 0)


def say(msg: str) -> None:
    """``msg`` as one line on stdout in one write, flushed: the ranks of
    a run often share one terminal or pipe (torchrun's), and a line
    printed as two writes (the text, then the newline) can be cut by
    another rank's."""
    sys.stdout.write(msg + "\n")
    sys.stdout.flush()


def _any_rank(flag: bool) -> bool:
    """``flag`` of any rank (an all-reduce, max; the local flag in one
    process)."""
    if mesh.world_size() <= 1:
        return bool(flag)
    dev = (torch.device("cpu") if dist.get_backend() == "gloo"
           else torch.device("cuda", torch.cuda.current_device()))
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def init_distributed_with_retry(init_fn, *, attempts: int = 4,
                                backoff: float = 1.0,
                                sleep=time.sleep, log=print):
    """Run ``init_fn`` (a zero-argument ``init_process_group`` closure)
    with exponential backoff: a restarted job whose coordinator is still
    coming back up retries instead of failing the relaunch.  Delays are
    ``backoff * 2**i``; the last failure propagates."""
    for i in range(max(int(attempts), 1)):
        try:
            return init_fn()
        except Exception as e:                 # noqa: BLE001
            if i + 1 >= attempts:
                raise
            delay = backoff * (2 ** i)
            log(f"torch.distributed.init_process_group failed "
                f"(attempt {i + 1}/{attempts}): {e}; retrying in "
                f"{delay:.1f}s")
            sleep(delay)


def backend_for(device: str, local_world: int) -> str:
    """``gloo`` on the CPU and when the local ranks share cards (gloo
    copies a card's tensors through the host); ``nccl`` when each local
    rank has a card of its own."""
    if device == "cpu" or local_world > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def maybe_init_distributed(coordinator=None, num_processes=None,
                           process_id=None, *, connect_attempts: int = 1,
                           connect_backoff: float = 1.0,
                           device: str = "cuda") -> bool:
    """Join the ``torch.distributed`` group from the flags or torchrun's
    environment (``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``; the flags win); returns True when a multi-process group was
    initialized.  A single-process run (no coordinator, and
    ``num_processes`` absent or 1) initializes nothing.  Otherwise all
    three are needed; the backend is :func:`backend_for`'s, printed."""
    env = os.environ
    if not coordinator and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if not coordinator and not num_processes:
        return False
    if num_processes is not None and num_processes <= 1 \
            and not coordinator:
        return False
    if not (coordinator and num_processes and process_id is not None):
        raise ValueError(
            "multi-process launch needs all three of coordinator "
            "address, num_processes and process_id (flags or "
            "MASTER_ADDR/MASTER_PORT, WORLD_SIZE and RANK); got "
            f"coordinator={coordinator!r}, "
            f"num_processes={num_processes!r}, "
            f"process_id={process_id!r}")
    local_world = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    backend = backend_for(device, local_world)
    say(f"torch.distributed: process {process_id}/{num_processes}, "
        f"backend {backend}")
    init_distributed_with_retry(
        lambda: dist.init_process_group(
            backend, init_method=f"tcp://{coordinator}",
            world_size=int(num_processes), rank=int(process_id)),
        attempts=connect_attempts, backoff=connect_backoff)
    return True


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
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"),
                    help="compute dtype (weights and optimizer state stay "
                         "float32)")
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
    ap.add_argument("--connect-attempts", type=int, default=4,
                    help="init_process_group attempts (a slow "
                         "coordinator restart)")
    ap.add_argument("--connect-backoff", type=float, default=1.0,
                    help="initial retry delay, doubled per attempt")
    ap.add_argument("--per-host", action="store_true",
                    help="each process feeds only its rank's shard of "
                         "the global batch (forced on in multi-process "
                         "runs)")
    ap.add_argument("--coordinator", default=None,
                    help="rank 0's host:port (or MASTER_ADDR and "
                         "MASTER_PORT)")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="process count of the multi-process run (or "
                         "WORLD_SIZE)")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this process's rank (or RANK)")
    ap.add_argument("--mesh", default=None,
                    help="DxM (data x model) or PxDxM: shard the model "
                         "over the processes (dense family)")
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
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "launch.train: --device cuda but no CUDA device is present; "
            "pass --device cpu to train with the plain versions")
    if args.mesh:             # refused before the group and any collective
        parallel.check_model(model, mesh.Mesh(mesh.parse_mesh(args.mesh)))
    distributed = maybe_init_distributed(
        args.coordinator, args.num_processes, args.process_id,
        connect_attempts=args.connect_attempts,
        connect_backoff=args.connect_backoff, device=args.device)
    try:
        return _run(args, model, distributed)
    finally:
        if distributed:
            dist.destroy_process_group()


def _run(args, model, distributed: bool):
    device = args.device
    if distributed:
        rank, world = dist.get_rank(), dist.get_world_size()
        if device == "cuda":
            local = int(os.environ.get("LOCAL_RANK", rank))
            device = f"cuda:{local % torch.cuda.device_count()}"
            torch.cuda.set_device(device)
        say(f"process {rank}/{world} on {device}")
        if not args.per_host:
            # one process cannot feed (or even hold) every rank's rows
            args.per_host = True
            say("per-host data feeding forced on (multi-process)")
    grid = mesh.make_launch_mesh(args.mesh, distributed=distributed)
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
        z_loss=args.z_loss, seed=args.seed, dtype=args.dtype)

    trainer = Trainer(cfg, device=device, fuse_steps=args.fuse_steps,
                      max_device_batch=args.max_device_batch, mesh=grid)
    say(f"arch={model.name} N={model.param_count()/1e6:.0f}M "
        f"schedule={args.schedule} phases={len(trainer.plan.phases)} "
        f"steps={trainer.plan.total_steps(seq_len)} "
        f"batches={trainer.plan.batch_sizes()} "
        f"fuse_steps={trainer.fuse_steps}")
    if args.resume:
        # restored before the ramp is checked: an elastic resume feeds
        # the ramp from the restored position on
        meta = trainer.restore_checkpoint(args.checkpoint,
                                          verify=args.verify_restore)
        say(f"resumed step {trainer.state.step} "
            f"(phase {meta.get('phase')}, B={meta.get('batch_size')}, "
            f"tokens {trainer.state.tokens_seen}, saved from "
            f"{meta.get('save_process_count', '?')} processes)")
    src = MarkovLM(vocab_size=min(model.vocab_size, 2048), seed=args.seed)
    slot = {}
    if grid is not None:       # the rank's data slot feeds it
        slot = dict(process_index=grid.fsdp_index(mesh.rank()),
                    process_count=grid.n_fsdp)
        say(f"mesh {grid.shape}: process {mesh.rank()} at "
            f"{grid.coords(mesh.rank())}, data slot "
            f"{slot['process_index']}/{grid.n_fsdp}, local batch shards "
            f"{[b // grid.n_fsdp for b in trainer.plan.batch_sizes()]}")
    loader = PhaseDataLoader(src, trainer.plan, seq_len, device=device,
                             per_host=args.per_host,
                             validate=not args.resume, **slot)
    if args.resume:
        loader.resume(trainer.state.tokens_seen)
    if args.per_host and grid is None:
        mesh.assert_per_host_row_blocks()
        n = mesh.world_size()
        say(f"per-host feeding: process {mesh.rank()}/{n}, local batch "
            f"shards {[b // n for b in trainer.plan.batch_sizes()]}")

    def log(rec):
        say(f"step {rec['step']:5d} phase {rec['phase']} "
            f"B={rec['batch_size']:4d} lr={rec['lr']:.2e} "
            f"loss={rec['loss']:.4f} ({rec['wall']:.1f}s)")

    guard = PreemptionGuard(grace=args.grace).install()
    try:
        hist = trainer.run(loader, max_steps=args.steps, log_cb=log,
                           checkpoint_path=args.checkpoint,
                           save_every=args.save_every,
                           async_save=not args.sync_save,
                           stop_fn=guard.should_stop)
    finally:
        guard.uninstall()
    if guard.stopped or guard.requested():
        say(f"preemption signal: stopped at step {trainer.state.step} "
            f"(chunk boundary)")
    if hist:
        say(f"done: {len(hist)} steps, final loss {hist[-1]['loss']:.4f}")
    else:
        say("done: nothing to run")
    if trainer.controller is not None:
        say(f"adaptive cuts at steps {trainer.controller.cut_steps}")
    tp = parallel.tp_of(trainer.state.model)
    if tp is not None and hist:
        for kind, c in tp.comms.summary().items():
            say(f"{kind}: {c['calls'] / len(hist):.0f} calls, "
                f"{c['ms'] / len(hist):.3f} ms, {c['MB'] / len(hist):.1f} "
                f"MB a step ({dist.get_backend()})")
    red = trainer.engine.reduce
    if red is not None and red.calls:
        say(f"all-reduce: {red.calls} steps, {red.ms() / red.calls:.3f} "
            f"ms a step ({red.flat.numel() * 4 / 1e6:.1f} MB, "
            f"{dist.get_backend()})")
    if args.checkpoint:
        if not guard.save_allowed():
            say("grace deadline exceeded — skipping the final save "
                "(the last periodic checkpoint is the resume point)")
        else:
            trainer.save_checkpoint(args.checkpoint)
            say(f"checkpoint → {args.checkpoint}")
    trainer.close()
    return hist


if __name__ == "__main__":
    main()
