"""Learning-rate schedules (``repro.core.schedules`` in PyTorch).

All schedule math is in *tokens*, so it is batch-size independent —
what makes the Seesaw ramp a drop-in.  Each curve is a function
``lr(tok, step=None)`` that returns a float32 0-d tensor, computed in
float32 torch arithmetic with every constant rounded to float32 first,
as the reference's jnp arithmetic does.  The engine evaluates the curve
on the host once per step (``train.engine.chunk_lrs``): on the CPU the
update reads the 0-d tensor itself; on the card the engine stages it
into the 0-d device tensor its captured graphs read, without a sync.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _warm(base_lr: float, warmup_tokens: float, tok: torch.Tensor):
    return _f32(base_lr) * tok / _f32(max(warmup_tokens, 1.0))


def quarter_cosine_lr(base_lr: float, total_tokens: float,
                      warmup_tokens: float) -> Callable:
    """The paper's Lemma-1 form: η(t) = η₀ cos(π t / 2T) after a linear
    warmup (decays to 0).  Continuous — ``step`` is accepted and
    ignored."""

    def lr(tok, step=None):
        tok = _f32(tok)
        prog = torch.clamp((tok - _f32(warmup_tokens))
                           / _f32(max(total_tokens - warmup_tokens, 1.0)),
                           0.0, 1.0)
        cos = _f32(base_lr) * torch.cos(_f32(0.5 * math.pi) * prog)
        return torch.where(tok < _f32(warmup_tokens),
                           _warm(base_lr, warmup_tokens, tok), cos)

    return lr


def cosine_cut_points(total_tokens: float, warmup_tokens: float,
                      alpha: float, n_cuts: int,
                      quarter: bool = True) -> List[float]:
    """Token counts where the cosine schedule's LR first falls below
    η₀/α^k, k = 1..n_cuts — the ``S`` array fed to Seesaw (Algorithm 1).
    ``quarter=True`` uses η₀cos(πt/2T) (paper Lemma 1), else the
    half-cosine."""
    span = total_tokens - warmup_tokens
    cuts = []
    for k in range(1, n_cuts + 1):
        target = alpha ** (-k)
        if quarter:
            p = 2.0 / math.pi * math.acos(target)
        else:
            p = math.acos(2 * target - 1) / math.pi
        tok = warmup_tokens + p * span
        if tok < total_tokens:
            cuts.append(tok)
    return cuts


def piecewise_lr(base_lr: float, warmup_tokens: float,
                 phase_ends: Sequence[float],
                 phase_scales: Sequence[float],
                 phase_end_steps: Optional[Sequence[int]] = None
                 ) -> Callable:
    """Piecewise-constant LR over a phase table: ``phase_ends[k]`` is the
    end-token count of phase k, whose LR is ``base_lr *
    phase_scales[k]``.

    The cut comes in the reference's two exactness tiers.  The float32
    token compare is exact only below 2^24 tokens.  With
    ``phase_end_steps`` (the realized cumulative step count per phase)
    and a global ``step`` index, the cut is selected by an exact int32
    compare instead, and ``tok`` only drives the continuous warmup.  A
    negative ``step`` (the engine's "unknown" sentinel) falls back to
    the token compare."""
    ends = torch.from_numpy(np.asarray(phase_ends, np.float32))
    scales = torch.from_numpy(np.asarray(phase_scales, np.float32))
    step_ends = (None if phase_end_steps is None else
                 torch.from_numpy(np.asarray(phase_end_steps, np.int32)))

    def lr(tok, step=None):
        tok = _f32(tok)
        k = (tok >= ends[:-1]).sum()             # ≤ n-1 by construction
        if step is not None and step_ends is not None:
            step = torch.as_tensor(step, dtype=torch.int32)
            k = torch.where(step >= 0, (step >= step_ends[:-1]).sum(), k)
        return torch.where(tok < _f32(warmup_tokens),
                           _warm(base_lr, warmup_tokens, tok),
                           _f32(base_lr) * scales[k])

    return lr


def constant_lr(base_lr: float, warmup_tokens: float = 0.0) -> Callable:
    def lr(tok, step=None):
        tok = _f32(tok)
        return torch.where(tok < _f32(warmup_tokens),
                           _warm(base_lr, warmup_tokens, tok),
                           _f32(base_lr))

    return lr
