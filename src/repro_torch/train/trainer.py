"""The Seesaw training runtime (``repro.train.trainer`` in PyTorch),
driving the phase execution engine.

The trainer walks the plan's phases through the loader's merged,
tail-padded chunk stream (``PhaseDataLoader.iter_chunks``): up to
``fuse_steps`` optimizer steps per engine call, the per-step LR from the
plan's token and step index, and gradient accumulation when a phase's
batch exceeds ``max_device_batch``.  The model and the optimizer state
cross phase boundaries untouched; ``tokens_seen`` is an exact Python
int.  Metrics stay on the device until a ``log_every`` boundary, where
one transfer reads them.

Checkpoints are the reference's format (``train.checkpoint``): periodic
saves at chunk boundaries, async by default (a snapshot on the device,
streamed by a writer thread), and ``stop_fn``, the preemption hook,
polled at each boundary.  A restore copies into the live parameters and
optimizer state in place, so a trainer keeps replaying the CUDA graphs
it captured.  An ``adaptive-seesaw`` run feeds the engine's loss EMA to
the plateau controller at each chunk boundary; a cut extends the plan,
checks that the processes can feed its new stage, re-chunks the loader
there, starts capturing the new batch size's graph in the background
(``PhaseEngine.prewarm_async``) and restarts the chunk stream; the
controller's state rides in every checkpoint.

In a multi-process run every rank runs this loop over its per-host
loader: the engine averages grads and metrics over the ranks, so every
rank logs the global batch's loss, feeds the controller the same EMA
and cuts at the same boundary; saves and the stop poll are collective.
On a data × model mesh (``Trainer(cfg, mesh=...)``) the model and its
AdamW state are cut to the rank's shards (``parallel.shard``, after
drawing the whole model from the seed, so every mesh starts from one
process's weights), the loader feeds the rank's data slot, and a
checkpoint holds each distinct block of a leaf once.
"""
from __future__ import annotations

import copy
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import parallel
from repro_torch.configs.base import RunConfig
from repro_torch.core.adaptive import AdaptiveSeesaw
from repro_torch.core.seesaw import build_plan
from repro_torch.data.pipeline import validate_per_host_plan
from repro_torch.models import registry as R
from repro_torch.optim import optimizers as O
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import engine as E
from repro_torch.weights import opt_tree, param_tree


@dataclass
class TrainState:
    model: Any                          # parameters, float32, updated in place
    opt_state: Dict[str, Any]
    step: int = 0
    # exact integer token count: the host is the source of truth
    tokens_seen: int = 0
    # adaptive-seesaw only: the loss EMA after the last chunk (None =
    # unseeded), carried into the next chunk and through checkpoints
    loss_ema: Optional[float] = None


class Trainer:
    def __init__(self, cfg: RunConfig, *, device="cuda", seed: int = 0,
                 fuse_steps: Optional[int] = None,
                 max_device_batch: Optional[int] = None, mesh=None):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Trainer: device='cuda' but no CUDA device is present; "
                "pass device='cpu' to train with the plain versions")
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:       # refused here, before any collective
            parallel.check(cfg.model, mesh)
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
        # the adaptive plan grows at runtime; the one-phase seed stays so
        # a resume can rebuild the extended plan from the saved cut tokens
        self._base_plan = self.plan
        self.controller: Optional[AdaptiveSeesaw] = None
        self.cut_tokens: List[int] = []
        if sch.kind == "adaptive-seesaw":
            mn = sch.plateau_min_steps
            self.controller = AdaptiveSeesaw(
                alpha=sch.alpha, window=int(sch.plateau_window),
                rel_threshold=float(sch.plateau_threshold),
                max_cuts=int(sch.n_cuts),
                min_steps_between=int(mn if mn is not None
                                      else sch.plateau_window))
        self.optimizer = O.from_config(cfg.optimizer)
        self.engine = E.PhaseEngine(cfg, self.optimizer, self.plan,
                                    max_device_batch=max_device_batch,
                                    mesh=mesh)
        model = R.init_model(cfg.model, seed=cfg.seed + seed,
                             dtype=torch.float32, device=device,
                             trainable=True)
        if mesh is not None:
            parallel.shard(model, cfg.model, mesh)
        opt_state = self.optimizer.init(dict(model.named_parameters()))
        self.state = TrainState(model, opt_state)
        self.history: List[Dict[str, float]] = []
        self._ckpt_manager: Optional[CKPT.CheckpointManager] = None

    @property
    def _step_cache(self):
        """The engine's step cache: one entry per ``(batch_size,
        micro)``, on the card one captured graph each (the reference's
        one executable per key)."""
        return self.engine._cache

    # -- checkpointing -------------------------------------------------- #
    def _trees(self):
        """The live state in the reference's layout (no copy)."""
        st = self.state
        return param_tree(st.model), opt_tree(st.model, st.opt_state)

    @property
    def checkpoint_manager(self) -> CKPT.CheckpointManager:
        """The async checkpoint writer, made at first use."""
        if self._ckpt_manager is None:
            self._ckpt_manager = self.engine.make_checkpoint_manager()
        return self._ckpt_manager

    def save_checkpoint(self, path: str,
                        chunk_bytes: int = CKPT.DEFAULT_CHUNK_BYTES,
                        block: bool = True):
        """Write a checkpoint directory, streamed in ``chunk_bytes``
        slices.  ``block=False`` snapshots the state on its device and
        returns while the :attr:`checkpoint_manager`'s writer streams
        it."""
        extra = self._adaptive_extra()
        params, opt_state = self._trees()
        st = self.state
        if not block:
            self.checkpoint_manager.request_save(
                path, params, opt_state, st.step, st.tokens_seen, extra)
            return
        if self._ckpt_manager is not None:
            # an async save of an older snapshot lands first: generations
            # are sequential per directory
            self._ckpt_manager.finalize()
        CKPT.save_phase_checkpoint(path, params, opt_state, st.step,
                                   st.tokens_seen, plan=self.plan,
                                   seq_len=self.cfg.seq_len, extra=extra,
                                   chunk_bytes=chunk_bytes)

    def _adaptive_extra(self) -> Optional[Dict[str, Any]]:
        """What lets a resume replay an adaptive run bit for bit: the
        controller's state, every cut's token boundary (to rebuild the
        extended plan) and the carried loss EMA."""
        if self.controller is None:
            return None
        return {"adaptive": {
            "controller": self.controller.state_dict(),
            "cut_tokens": list(self.cut_tokens),
            "loss_ema": self.state.loss_ema}}

    def restore_checkpoint(self, path: str,
                           verify: bool = False) -> Dict[str, Any]:
        """Restore a checkpoint directory or a legacy ``.npz`` into the
        live state, in place.  ``verify=True`` checks every block's crc32
        first.  An adaptive trainer first reads the metadata alone: the
        saved cut tokens rebuild the extended plan (replaying
        :meth:`SeesawPlan.extend_at` from the one-phase plan) and the
        controller's state is loaded, so the phase check runs against the
        plan the run had at the save and later cuts fire at the same
        steps.  Everything is checked before anything changes: a refused
        checkpoint leaves the trainer as it was."""
        if self._ckpt_manager is not None:
            self._ckpt_manager.finalize()
        plan, ad = self.plan, None
        if self.controller is not None:
            ad = CKPT.read_meta(path).get("adaptive")
            if ad is None:
                raise ValueError(
                    f"checkpoint {path!r} carries no adaptive "
                    f"controller state — it was saved by a "
                    f"prescheduled run and cannot resume an "
                    f"adaptive-seesaw trainer")
            plan = self._base_plan
            for ct in ad["cut_tokens"]:
                plan = plan.extend_at(
                    int(ct), seq_len=self.cfg.seq_len,
                    max_batch_size=self.cfg.schedule.max_batch_size)
            # a malformed state fails here, on a copy
            copy.deepcopy(self.controller).load_state_dict(ad["controller"])
        # the plan, controller and EMA change only once every check (the
        # phase, each leaf) has passed and the arrays are in
        params, opt_state = self._trees()
        _, _, meta = CKPT.restore_phase_checkpoint(
            path, params, opt_state, plan=plan,
            seq_len=self.cfg.seq_len, verify=verify)
        if ad is not None:
            self._set_plan(plan)
            self.controller.load_state_dict(ad["controller"])
            self.cut_tokens = [int(ct) for ct in ad["cut_tokens"]]
            ema = ad.get("loss_ema")
            self.state.loss_ema = None if ema is None else float(ema)
        self.state.step = int(meta["step"])
        self.state.tokens_seen = CKPT.exact_tokens(meta["tokens_seen"])
        return meta

    def _set_plan(self, plan) -> None:
        self.plan = plan
        self.engine.update_plan(plan)
        if self._ckpt_manager is not None:
            self._ckpt_manager.plan = plan

    def close(self):
        """Join the async checkpoint writer and surface its error, if
        any; idempotent."""
        if self._ckpt_manager is not None:
            self._ckpt_manager.finalize()

    # -- run loop ------------------------------------------------------- #
    def _chunks(self, loader, max_steps):
        """(head phase, stacked batches, n) with n ≤ fuse_steps real
        steps; a ``max_steps`` budget only lowers n.  Closing this
        generator closes the loader's stream (and stops its thread)."""
        st = self.state
        stream = loader.iter_chunks(self.fuse_steps)
        try:
            for phase, stacked, n in stream:
                if max_steps is not None:
                    r = max_steps - st.step
                    if r <= 0:
                        return
                    n = min(n, r)
                yield phase, stacked, n
        finally:
            stream.close()

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
            async_save: bool = True,
            stop_fn: Optional[Callable[[], bool]] = None
            ) -> List[Dict[str, float]]:
        """Run the chunk loop over ``loader`` (a ``PhaseDataLoader`` of
        this trainer's plan) up to ``max_steps``; ``log_cb(record)`` sees
        every ``log_every``-th step.  Returns the history, one record per
        step.

        ``checkpoint_path`` + ``save_every`` save at each chunk boundary
        that crosses a ``save_every``-step boundary, async unless
        ``async_save=False``; a writer error surfaces at the next
        boundary.  ``stop_fn`` is polled at each boundary: True ends the
        loop there, so a final save resumes bit for bit.  The order at a
        boundary is the reference's: the writer's check, the step, the
        adaptive cut decision, the metric flush, the save, ``stop_fn``
        — a checkpoint holds the plan and controller after the
        decision."""
        st = self.state
        t0 = time.time()
        le = max(self.cfg.log_every, 1)
        se = max(save_every, 1) if save_every else None
        pending: List[Tuple] = []
        stop = False
        rechunk = True
        while rechunk and not stop:
            rechunk = False
            # closed here, not when dropped: a cut's superseded stream
            # stops its sampling thread before the next stream starts
            chunks = self._chunks(loader, max_steps)
            try:
                for phase, stacked, n in chunks:
                    if self._ckpt_manager is not None:
                        self._ckpt_manager.check()
                    out = self.engine.run_chunk(
                        st.model, st.opt_state, st.tokens_seen, stacked,
                        n_valid=n, step=st.step, loss_ema=st.loss_ema)
                    if self.controller is not None:
                        st.model, st.opt_state, metrics, ema = out
                        st.loss_ema = float(ema)
                    else:
                        st.model, st.opt_state, metrics = out
                    base_step, base_tok = st.step, st.tokens_seen
                    st.step += n
                    st.tokens_seen += n * phase.batch_size * self.cfg.seq_len
                    pending.append((base_step, base_tok, phase,
                                    time.time() - t0, metrics, n))
                    if (self.controller is not None
                            and self.controller.observe_smoothed(
                                st.loss_ema, n)):
                        self._fire_cut(loader, stacked)
                        rechunk = True
                    if st.step // le > base_step // le:
                        self._flush(pending, log_cb)
                    if (se and checkpoint_path
                            and st.step // se > base_step // se):
                        self.save_checkpoint(checkpoint_path,
                                             block=not async_save)
                    if stop_fn is not None and stop_fn():
                        stop = True
                    if rechunk or stop:
                        break
            finally:
                chunks.close()
        # a background capture outlives no run: its key may never come
        self.engine.join_prewarm()
        self._flush(pending, log_cb)
        return self.history

    def _fire_cut(self, loader, stacked) -> None:
        """One adaptive cut at this chunk boundary: extend the plan with
        a (÷√α LR, ×α batch) phase from ``tokens_seen``, check that this
        run's processes can feed the new stage (at the cut, not mid-ramp),
        swap the plan into the engine, the checkpoint writer and the
        loader, and start capturing the new batch size's step in the
        background; the run loop then closes the superseded stream."""
        st = self.state
        old_b = self.plan.phases[-1].batch_size
        new_plan = self.plan.extend_at(
            st.tokens_seen, seq_len=self.cfg.seq_len,
            max_batch_size=self.cfg.schedule.max_batch_size)
        new_b = new_plan.phases[-1].batch_size
        validate_per_host_plan(new_plan, getattr(loader, "_pcount", 1) or 1,
                               self.engine.n_data_devices(),
                               start_phase=len(new_plan.phases) - 1)
        self._set_plan(new_plan)
        self.cut_tokens.append(int(st.tokens_seen))
        if not hasattr(loader, "rechunk"):
            raise ValueError(
                "adaptive-seesaw fired a cut but the loader cannot "
                "re-chunk mid-stream — use PhaseDataLoader (or any "
                "loader with rechunk(plan, tokens_seen))")
        loader.rechunk(new_plan, st.tokens_seen)
        if new_b != old_b:
            self.engine.prewarm_async(new_b, self.fuse_steps, stacked)
