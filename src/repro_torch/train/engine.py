"""The phase execution engine (``repro.train.engine`` in PyTorch, single
process) — the one train-step stack under ``Trainer`` and
``launch.train``.

1. ``make_grad_step`` — one optimizer step ``(model, opt_state, batch,
   lr) → (model, opt_state, metrics)``: micro-batch accumulation that
   averages the grads and means the metrics, then the optimizer.
2. ``plan_lr_fn`` — the plan's token-indexed LR, with the realized
   (step-quantized) cut boundaries summed as exact integers and the
   exact int32 step compare.
3. ``make_fused_step`` — up to K steps per call with the reference's
   exact int step offset, ``step0 < 0`` sentinel and ``n_valid`` mask;
   metrics come back stacked ``(K,)`` on the device, read by the caller
   at its log boundaries.
4. ``PhaseEngine`` — the accumulation count per batch size and
   ``run_chunk``.

PyTorch runs eagerly, so there is no compile cache: the reference's
per-(batch size, micro, K) executables are a plain loop here.  The LR is
evaluated on the host in float32 torch arithmetic (the reference's) and
handed to the update as a 0-d CPU tensor, which the card reads without a
sync.  The model's parameters and the optimizer state are updated in
place.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

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
# 3. K-step dispatch
# --------------------------------------------------------------------- #

def make_fused_step(grad_step: Callable, lr_fn: Callable,
                    tokens_per_step: int) -> Callable:
    """Wrap a grad step into ``fused(model, opt_state, tokens_seen,
    step0, n_valid, batches) → (model, opt_state, metrics)``, where
    ``batches`` has a leading K dim.  Step i's token count is the
    once-rounded float32 ``tokens_seen`` plus ``i * tokens_per_step``
    computed in int32; its global step index is ``step0 + i``, or the
    sentinel -1 for every step when ``step0 < 0``.  Steps ``i >=
    n_valid`` run nothing and give zero metric rows.  Metrics come back
    stacked (K,): the LR on the host, the rest on the device."""
    tps = torch.tensor(int(tokens_per_step), dtype=torch.int32)

    def fused(model, opt_state, tokens_seen, step0, n_valid, batches):
        k = next(iter(batches.values())).shape[0]
        tok0 = torch.tensor(float(tokens_seen), dtype=torch.float32)
        rows = []
        for i in range(min(int(n_valid), k)):
            tok = tok0 + (torch.tensor(i, dtype=torch.int32) * tps).float()
            lr = lr_fn(tok, -1 if step0 < 0 else step0 + i)
            model, opt_state, m = grad_step(
                model, opt_state, {n: v[i] for n, v in batches.items()}, lr)
            rows.append(dict(m, lr=lr))
        metrics: Dict[str, torch.Tensor] = {}
        for name in (rows[0] if rows else ()):
            col = torch.stack([r[name] for r in rows])
            metrics[name] = torch.cat([col, col.new_zeros(k - len(rows))])
        return model, opt_state, metrics

    return fused


# --------------------------------------------------------------------- #
# 4. the engine
# --------------------------------------------------------------------- #

class PhaseEngine:
    """Dispatcher for one run: the accumulation count per batch size and
    the K-step chunk call.  The adaptive kind (live plan, loss EMA,
    runtime LR tables) comes with the adaptive slice."""

    def __init__(self, cfg: RunConfig, optimizer: O.Optimizer,
                 plan: SeesawPlan, *, max_device_batch: Optional[int] = None):
        self.cfg = cfg
        self.model = cfg.model
        self.optimizer = optimizer
        self.plan = plan
        self.max_device_batch = max_device_batch
        self.lr_fn = plan_lr_fn(plan, cfg.seq_len)
        self.dtype = DTYPES[cfg.dtype]

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

    def run_chunk(self, model, opt_state, tokens_seen, stacked_batch,
                  n_valid: Optional[int] = None,
                  step: Optional[int] = None):
        """One call: up to K optimizer steps.  Returns (model, opt_state,
        stacked metrics) without a sync; rows past ``n_valid`` (default
        all K) are zeros.  ``tokens_seen`` is the host's exact token
        count; ``step`` the global index of the chunk's first step
        (None: select LR cuts by tokens)."""
        first = next(iter(stacked_batch.values()))
        k, batch_size = first.shape[0], first.shape[1]
        if n_valid is None:
            n_valid = k
        if k * batch_size * self.cfg.seq_len >= 2 ** 31:
            raise ValueError(
                f"chunk of {k}x{batch_size}x{self.cfg.seq_len} tokens "
                f"overflows the int32 token offset — lower fuse_steps")
        grad = make_grad_step(self.model, self.optimizer,
                              micro_batches=self.micro_batches(batch_size),
                              z_loss=self.cfg.z_loss, dtype=self.dtype,
                              remat=self.cfg.remat)
        fused = make_fused_step(grad, self.lr_fn,
                                batch_size * self.cfg.seq_len)
        return fused(model, opt_state, tokens_seen,
                     -1 if step is None else int(step), n_valid,
                     stacked_batch)
