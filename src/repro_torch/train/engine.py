"""The phase execution engine (``repro.train.engine`` in PyTorch, single
process) — the one train-step stack under ``Trainer`` and
``launch.train``.

1. ``make_grad_step`` — one optimizer step ``(model, opt_state, batch,
   lr) → (model, opt_state, metrics)``: micro-batch accumulation that
   averages the grads and means the metrics, then the optimizer.
2. ``plan_lr_fn`` — the plan's token-indexed LR, with the realized
   (step-quantized) cut boundaries summed as exact integers and the
   exact int32 step compare.
3. ``chunk_lrs`` — the LR of each step of a K-step chunk, on the host,
   with the reference's exact int step offset and ``step0 < 0``
   sentinel.
4. ``PhaseEngine`` — the accumulation count per batch size, the step
   cache and ``run_chunk``: up to K steps a call, with the reference's
   ``n_valid`` mask; metrics come back stacked ``(K,)`` on the device,
   read by the caller at its log boundaries.

The step cache is the reference's compile cache (one executable per
``(batch_size, micro, K)``): one entry per ``(batch_size, micro)`` in
``PhaseEngine._cache``, K being a loop on the host.  On the card an
entry holds a CUDA graph of one optimizer step, ``make_grad_step``'s
body, captured over static buffers: the batch, the LR as a 0-d device
tensor, the metrics, and the parameters and optimizer state, which the
step updates in place.  ``run_chunk`` replays it once per real step:
batch i is copied into the static batch on the device, the LR staged
from pinned memory (no sync), the graph replayed and its metric row
copied into the chunk's stacked outputs; rows past ``n_valid`` stay
zero, so a short chunk captures nothing new.  The engine's first step
runs eagerly: it builds the kernels and makes cuBLAS's handles and the
kernels' counters before any capture.  Every later key is captured
directly and then replayed, with no eager step of its own (at 2.7B an
eager step would not fit beside the graphs' pool).  The graphs of one
engine share one memory pool, captured in ramp order and never replayed
concurrently.  A failed capture raises.  On the CPU an entry holds the
eager step, which ``run_chunk`` calls: the same bookkeeping and the
same numbers.

The LR is evaluated on the host in float32 torch arithmetic (the
reference's); the CPU step reads it as a 0-d CPU tensor.

An ``adaptive-seesaw`` plan grows at runtime.  Its LR is
``plan_lr_fn`` of the current plan, rebuilt at each cut
(``update_plan``): a cut changes values the host computes and nothing
on the card, so no graph is captured again, and a cut that only cuts
the LR (a ramp clamped by ``max_batch_size``) keeps its batch size's
graph.  (The reference passes the phase table as runtime arguments,
padded to a fixed width, only because its step is compiled.)
``run_chunk`` then also carries the loss EMA the plateau controller
reads, one float32 scalar a chunk (``make_fused_step(ema_decay=...)`` in
the reference).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import graphs as G
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import schedules as S
from repro_torch.core.seesaw import SeesawPlan
from repro_torch.models import registry as R
from repro_torch.optim import optimizers as O

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


# --------------------------------------------------------------------- #
# 1. the single grad step
# --------------------------------------------------------------------- #

def make_grad_step(cfg: ModelConfig, optimizer: O.Optimizer, *,
                   micro_batches: int = 1, z_loss: float = 0.0,
                   dtype=torch.bfloat16, remat: bool = True) -> Callable:
    """The one training step builder: ``step(model, opt_state, batch,
    lr) → (model, opt_state, metrics)``.  With ``micro_batches`` > 1 the
    batch splits along its first dim; the grads are summed and divided
    by the count, the metrics averaged.  ``metrics["grad_norm"]`` is the
    global norm of the averaged grads before clipping."""

    def step(model, opt_state, batch, lr):
        params = dict(model.named_parameters())
        names = list(params)
        if micro_batches > 1:
            b = next(iter(batch.values())).shape[0] // micro_batches
            gacc, rows = None, []
            for i in range(micro_batches):
                mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
                loss, aux = R.loss_fn(model, cfg, mb, z_loss=z_loss,
                                      dtype=dtype, remat=remat)
                g = torch.autograd.grad(loss, [params[n] for n in names])
                if gacc is None:
                    gacc = list(g)
                else:                   # in place: one set of grads held
                    for a, gi in zip(gacc, g):
                        a.add_(gi)
                # freed before the next backward, which would otherwise
                # hold a third set of grads from the third micro-batch on
                g = gi = None
                rows.append(dict(aux, loss=loss))
            grads = [a.div_(micro_batches) for a in gacc]
            metrics = {k: torch.stack([r[k].detach() for r in rows]).mean()
                       for k in rows[0]}
        else:
            loss, metrics = R.loss_fn(model, cfg, batch, z_loss=z_loss,
                                      dtype=dtype, remat=remat)
            grads = torch.autograd.grad(loss, [params[n] for n in names])
        metrics = {k: v.detach().float() for k, v in metrics.items()}
        metrics["grad_norm"] = O.global_norm(grads)
        _, opt_state = optimizer.update(dict(zip(names, grads)), opt_state,
                                        params, lr)
        return model, opt_state, metrics

    return step


# --------------------------------------------------------------------- #
# 2. token-indexed LR
# --------------------------------------------------------------------- #

def plan_lr_fn(plan: SeesawPlan,
               seq_len: Optional[int] = None) -> Callable:
    """The plan's LR curve ``lr(tokens_seen, step=None)``: the
    continuous quarter-cosine for cosine plans, else
    :func:`schedules.piecewise_lr` over the phase table.  With
    ``seq_len`` the cut thresholds are the *realized* phase starts of
    ``steps_per_phase`` (where the loader switches batch size), summed
    in exact integers, and the cumulative step boundaries go with them,
    so a step that knows its global index selects its phase by an exact
    int32 compare."""
    if plan.kind == "cosine":
        return S.quarter_cosine_lr(plan.base_lr, plan.total_tokens,
                                   plan.warmup_tokens)
    if seq_len:
        ends, step_ends, tok, n_cum = [], [], 0, 0
        for p, n in zip(plan.phases, plan.steps_per_phase(seq_len)):
            tok += n * p.batch_size * seq_len
            n_cum += n
            ends.append(tok)
            step_ends.append(n_cum)
    else:
        ends = [p.end_tokens for p in plan.phases]
        step_ends = None
    return S.piecewise_lr(plan.base_lr, plan.warmup_tokens, ends,
                          [p.lr_scale for p in plan.phases],
                          phase_end_steps=step_ends)


# --------------------------------------------------------------------- #
# 3. the LRs of a K-step chunk
# --------------------------------------------------------------------- #

def chunk_lrs(lr_fn: Callable, tokens_seen, step0: int, n: int,
              tokens_per_step: int) -> torch.Tensor:
    """The (n,) float32 LRs of a chunk's first n steps, on the host.
    Step i's token count is the once-rounded float32 ``tokens_seen``
    plus ``i * tokens_per_step`` computed in int32; its global step index
    is ``step0 + i``, or the sentinel -1 for every step when ``step0 <
    0``."""
    tps = torch.tensor(int(tokens_per_step), dtype=torch.int32)
    tok0 = torch.tensor(float(tokens_seen), dtype=torch.float32)
    lrs = [lr_fn(tok0 + (torch.tensor(i, dtype=torch.int32) * tps).float(),
                 -1 if step0 < 0 else step0 + i) for i in range(n)]
    return torch.stack(lrs) if lrs else torch.zeros(0)


# --------------------------------------------------------------------- #
# 4. the engine
# --------------------------------------------------------------------- #

class _Step:
    """One cache entry: the grad step of a ``(batch_size, micro)`` key
    and, on the card once captured, its graph, the static batch it reads
    and the (model, optimizer state) it updates."""

    def __init__(self, grad: Callable):
        self.grad = grad
        self.graph: Optional[G.Graph] = None
        self.batch: Optional[Dict[str, torch.Tensor]] = None
        self.state: Optional[Tuple] = None


def ema_update(ema: torch.Tensor, losses: torch.Tensor, n: int,
               decay: float) -> torch.Tensor:
    """The reference's loss-EMA carry over a chunk's first ``n`` steps:
    ``ema ← d·ema + (1−d)·loss`` per step in float32, ``1−d`` computed in
    float32, seeded by the first loss when ``ema < 0`` (unseeded); padded
    steps leave it alone.  Runs where ``losses`` lie, without a sync."""
    d = torch.tensor(decay, dtype=torch.float32, device=losses.device)
    one_minus = torch.tensor(1.0, dtype=torch.float32,
                             device=losses.device) - d
    for i in range(n):
        loss = losses[i]
        ema = torch.where(ema < 0, loss, d * ema + one_minus * loss)
    return ema


class PhaseEngine:
    """Dispatcher for one run: the accumulation count per batch size, the
    step cache and the K-step chunk call.  An ``adaptive-seesaw`` plan
    adds the live plan (``update_plan``) and the loss EMA
    (``run_chunk(loss_ema=)``)."""

    def __init__(self, cfg: RunConfig, optimizer: O.Optimizer,
                 plan: SeesawPlan, *, max_device_batch: Optional[int] = None):
        self.cfg = cfg
        self.model = cfg.model
        self.optimizer = optimizer
        self.plan = plan
        self.max_device_batch = max_device_batch
        self.adaptive = plan.kind == "adaptive-seesaw"
        if self.adaptive:
            self.ema_decay = float(cfg.schedule.ema_decay or 0.98)
        self.lr_fn = plan_lr_fn(plan, cfg.seq_len)
        self.dtype = DTYPES[cfg.dtype]
        self._cache: Dict[Tuple[int, int], _Step] = {}
        self.captures = 0                 # graphs captured
        self.capture_s = 0.0              # seconds spent capturing them
        self.lr: Optional[torch.Tensor] = None   # the graphs' LR (card)
        self._warm = False                # the first (eager) step has run
        self._pool = None
        self._stage: Optional[G.PinnedStage] = None

    def micro_batches(self, batch_size: int) -> int:
        """Accumulation count for a global batch: the least count whose
        micro-batch holds at most ``max_device_batch`` rows and divides
        the batch (one device)."""
        if not self.max_device_batch:
            return 1
        micro = max(-(-batch_size // self.max_device_batch), 1)
        while batch_size % micro:
            micro += 1
        return micro

    def update_plan(self, plan: SeesawPlan) -> None:
        """Swap in an extended plan after an adaptive cut.  Only for the
        adaptive kind: a prescheduled plan's LR is fixed for the run."""
        if not self.adaptive:
            raise ValueError(
                "update_plan is only valid for adaptive-seesaw engines; "
                "a prescheduled plan is fixed for the run")
        self.plan = plan
        self.lr_fn = plan_lr_fn(plan, self.cfg.seq_len)

    def host_lr(self, tokens: float, step: Optional[int] = None) -> float:
        """The schedule's LR at a host-known position."""
        return float(self.lr_fn(float(tokens), step))

    def make_checkpoint_manager(self, **kw):
        """A :class:`checkpoint.CheckpointManager` bound to this engine's
        plan and seq_len, so its saves carry the phase metadata of the
        trainer's sync path; ``kw`` passes through (``chunk_bytes``)."""
        from repro_torch.train.checkpoint import CheckpointManager
        return CheckpointManager(plan=self.plan, seq_len=self.cfg.seq_len,
                                 **kw)

    def step_for(self, batch_size: int) -> _Step:
        """The cache entry of a global batch size (made on first use)."""
        micro = self.micro_batches(batch_size)
        key = (batch_size, micro)
        ent = self._cache.get(key)
        if ent is None:
            ent = self._cache[key] = _Step(make_grad_step(
                self.model, self.optimizer, micro_batches=micro,
                z_loss=self.cfg.z_loss, dtype=self.dtype,
                remat=self.cfg.remat))
        return ent

    def run_chunk(self, model, opt_state, tokens_seen, stacked_batch,
                  n_valid: Optional[int] = None,
                  step: Optional[int] = None, loss_ema=None):
        """One call: up to K optimizer steps.  Returns (model, opt_state,
        stacked metrics) without a sync; rows past ``n_valid`` (default
        all K) are zeros.  ``tokens_seen`` is the host's exact token
        count; ``step`` the global index of the chunk's first step
        (None: select LR cuts by tokens).  Metrics come back stacked
        (K,): the LR on the host, the rest on the batch's device.  An
        adaptive engine returns a fourth element, the loss EMA after the
        chunk (a float32 0-d tensor on the batch's device), carried from
        ``loss_ema`` (None: unseeded, the first loss seeds it)."""
        first = next(iter(stacked_batch.values()))
        k, batch_size = first.shape[0], first.shape[1]
        n = k if n_valid is None else min(int(n_valid), k)
        if k * batch_size * self.cfg.seq_len >= 2 ** 31:
            raise ValueError(
                f"chunk of {k}x{batch_size}x{self.cfg.seq_len} tokens "
                f"overflows the int32 token offset — lower fuse_steps")
        ent = self.step_for(batch_size)
        lrs = chunk_lrs(self.lr_fn, tokens_seen,
                        -1 if step is None else int(step), n,
                        batch_size * self.cfg.seq_len)
        if first.device.type == "cuda":
            metrics = self._run_card(ent, model, opt_state, stacked_batch,
                                     lrs, k)
        else:
            rows = []
            for i in range(n):
                model, opt_state, m = ent.grad(
                    model, opt_state,
                    {name: v[i] for name, v in stacked_batch.items()},
                    lrs[i])
                rows.append(m)
            metrics = {}
            for name in (rows[0] if rows else ()):
                col = torch.stack([r[name] for r in rows])
                metrics[name] = torch.cat([col, col.new_zeros(k - n)])
        if n:
            metrics["lr"] = torch.cat([lrs, lrs.new_zeros(k - n)])
        if not self.adaptive:
            return model, opt_state, metrics
        ema = torch.tensor(-1.0 if loss_ema is None else float(loss_ema),
                           dtype=torch.float32, device=first.device)
        if n:
            ema = ema_update(ema, metrics["loss"], n, self.ema_decay)
        return model, opt_state, metrics, ema

    # -- the card: eager first step, then captured graphs --------------- #
    def _run_card(self, ent: _Step, model, opt_state, stacked, lrs,
                  k: int) -> Dict[str, torch.Tensor]:
        device = next(iter(stacked.values())).device
        if self.lr is None:
            self.lr = torch.zeros((), dtype=torch.float32, device=device)
            self._stage = G.PinnedStage(torch.float32)
            self._pool = torch.cuda.graph_pool_handle()
        host_lrs = self._stage.put(lrs)
        out: Dict[str, torch.Tensor] = {}
        for i in range(len(lrs)):
            self.lr.copy_(host_lrs[i], non_blocking=True)
            batch = {name: v[i] for name, v in stacked.items()}
            if not self._warm:
                _, _, m = ent.grad(model, opt_state, batch, self.lr)
                self._warm = True
                # the eager step's cached blocks go back before the
                # graphs' pool takes its own
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            else:
                if ent.graph is None:
                    self._capture(ent, model, opt_state, batch)
                elif ent.state[0] is not model or ent.state[1] is not \
                        opt_state:
                    raise ValueError(
                        "run_chunk: this batch size's graph was captured "
                        "over another model or optimizer state")
                for name, buf in ent.batch.items():
                    buf.copy_(batch[name])
                m = ent.graph.replay()
            if not out:
                rows = torch.zeros(len(m), k, dtype=torch.float32,
                                   device=device)
                out = dict(zip(m, rows.unbind()))
            for name, v in m.items():
                out[name][i].copy_(v)
        self._stage.done()
        return out

    def _capture(self, ent: _Step, model, opt_state, batch) -> None:
        """Capture ``ent``'s step over a static copy of ``batch``, the
        engine's LR and the given model and state."""
        ent.batch = {name: v.clone() for name, v in batch.items()}
        ent.state = (model, opt_state)
        ent.graph = G.Graph(
            lambda: ent.grad(model, opt_state, ent.batch, self.lr)[2],
            self._pool)
        self.captures += 1
        self.capture_s += ent.graph.capture_s
