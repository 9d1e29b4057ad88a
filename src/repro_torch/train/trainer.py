"""The Seesaw training runtime (``repro.train.trainer`` in PyTorch,
single process), driving the phase execution engine.

The trainer walks the plan's phases through the loader's merged,
tail-padded chunk stream (``PhaseDataLoader.iter_chunks``): up to
``fuse_steps`` optimizer steps per engine call, the per-step LR from the
plan's token and step index, and gradient accumulation when a phase's
batch exceeds ``max_device_batch``.  The model and the optimizer state
cross phase boundaries untouched; ``tokens_seen`` is an exact Python
int.  Metrics stay on the device until a ``log_every`` boundary, where
one transfer reads them.

Checkpointing and the preemption hook (``stop_fn``) come with the
checkpointing slice, the adaptive controller with the adaptive slice;
asking for them raises ``NotImplementedError``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core.seesaw import build_plan
from repro_torch.models import registry as R
from repro_torch.optim import optimizers as O
from repro_torch.train import engine as E

CHECKPOINT_SLICE = "the checkpointing slice"


@dataclass
class TrainState:
    model: Any                          # parameters, float32, updated in place
    opt_state: Dict[str, Any]
    step: int = 0
    # exact integer token count: the host is the source of truth
    tokens_seen: int = 0


class Trainer:
    def __init__(self, cfg: RunConfig, *, device="cuda", seed: int = 0,
                 fuse_steps: Optional[int] = None,
                 max_device_batch: Optional[int] = None):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Trainer: device='cuda' but no CUDA device is present; "
                "pass device='cpu' to train with the plain versions")
        self.cfg = cfg
        self.fuse_steps = max(int(fuse_steps or 1), 1)
        sch = cfg.schedule
        self.plan = build_plan(
            kind=sch.kind, base_lr=sch.base_lr,
            total_tokens=cfg.resolved_total_tokens(),
            warmup_frac=sch.warmup_frac, b0=cfg.global_batch_size,
            alpha=sch.alpha,
            beta=(sch.beta if sch.kind in ("seesaw-general", "naive-ramp")
                  else None),
            n_cuts=sch.n_cuts, max_batch_size=sch.max_batch_size)
        self.optimizer = O.from_config(cfg.optimizer)
        self.engine = E.PhaseEngine(cfg, self.optimizer, self.plan,
                                    max_device_batch=max_device_batch)
        model = R.init_model(cfg.model, seed=cfg.seed + seed,
                             dtype=torch.float32, device=device,
                             trainable=True)
        opt_state = self.optimizer.init(dict(model.named_parameters()))
        self.state = TrainState(model, opt_state)
        self.history: List[Dict[str, float]] = []

    def save_checkpoint(self, path: str, **kw):
        raise NotImplementedError(
            f"checkpointing comes with {CHECKPOINT_SLICE}")

    def restore_checkpoint(self, path: str, **kw):
        raise NotImplementedError(
            f"checkpointing comes with {CHECKPOINT_SLICE}")

    # -- run loop ------------------------------------------------------- #
    def _chunks(self, loader, max_steps):
        """(head phase, stacked batches, n) with n ≤ fuse_steps real
        steps; a ``max_steps`` budget only lowers n."""
        st = self.state
        for phase, stacked, n in loader.iter_chunks(self.fuse_steps):
            if max_steps is not None:
                r = max_steps - st.step
                if r <= 0:
                    return
                n = min(n, r)
            yield phase, stacked, n

    def _flush(self, pending, log_cb):
        """One device→host transfer per chunk, deferred to log
        boundaries.  A chunk can span a phase boundary of one batch
        size, so each step's phase comes from its token count; rows past
        a chunk's n real steps are never read."""
        le = max(self.cfg.log_every, 1)
        for base_step, base_tok, phase, wall, metrics, n in pending:
            host = {k: v.cpu() for k, v in metrics.items()}
            tok_per_step = phase.batch_size * self.cfg.seq_len
            for i in range(n):
                tok_start = base_tok + i * tok_per_step
                ph = self.plan.realized_phase_at(tok_start,
                                                 self.cfg.seq_len)
                rec = {"step": base_step + i + 1,
                       "tokens": base_tok + (i + 1) * tok_per_step,
                       "lr": float(host["lr"][i]),
                       "batch_size": phase.batch_size,
                       "phase": ph.index,
                       "loss": float(host["loss"][i]),
                       "wall": wall}
                for name, v in host.items():
                    if name not in ("loss", "lr"):
                        rec[name] = float(v[i])
                self.history.append(rec)
                if log_cb and rec["step"] % le == 0:
                    log_cb(rec)
        pending.clear()

    def run(self, loader, max_steps: Optional[int] = None,
            log_cb: Optional[Callable] = None, *,
            checkpoint_path: Optional[str] = None,
            save_every: Optional[int] = None,
            stop_fn: Optional[Callable[[], bool]] = None
            ) -> List[Dict[str, float]]:
        """Run the chunk loop over ``loader`` (a ``PhaseDataLoader`` of
        this trainer's plan) up to ``max_steps``; ``log_cb(record)``
        sees every ``log_every``-th step.  Returns the history, one
        record per step."""
        if checkpoint_path or save_every:
            raise NotImplementedError(
                f"periodic checkpoints come with {CHECKPOINT_SLICE}")
        if stop_fn is not None:
            raise NotImplementedError(
                f"the preemption hook (stop_fn) comes with "
                f"{CHECKPOINT_SLICE}")
        st = self.state
        t0 = time.time()
        le = max(self.cfg.log_every, 1)
        pending: List[Tuple] = []
        for phase, stacked, n in self._chunks(loader, max_steps):
            st.model, st.opt_state, metrics = self.engine.run_chunk(
                st.model, st.opt_state, st.tokens_seen, stacked,
                n_valid=n, step=st.step)
            base_step, base_tok = st.step, st.tokens_seen
            st.step += n
            st.tokens_seen += n * phase.batch_size * self.cfg.seq_len
            pending.append((base_step, base_tok, phase, time.time() - t0,
                            metrics, n))
            if st.step // le > base_step // le:
                self._flush(pending, log_cb)
        self._flush(pending, log_cb)
        return self.history
