"""Seesaw (Algorithm 1) as a runtime object (``repro.core.seesaw`` in
PyTorch — plain Python, no tensors).

A :class:`SeesawPlan` is the compiled form of a token-indexed LR×batch
schedule: an ordered list of :class:`Phase` (token budget, LR
multiplier, batch size).  Guarantees enforced here (paper §3):

- token conservation: Σ phase tokens == total tokens, ramp or no ramp;
- the Lemma-4 feasibility constraint α ≥ √β (raises on violation);
- the equivalence invariant: a Seesaw plan and its step-decay reference
  have the same α√β product (Corollary 1).

The adaptive kind starts as one phase and grows at runtime: each cut of
``repro_torch.core.adaptive.AdaptiveSeesaw`` appends a phase through
:meth:`SeesawPlan.extend_at`.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

from repro_torch.core import schedules as S


@dataclass(frozen=True)
class Phase:
    index: int
    start_tokens: float
    end_tokens: float
    lr_scale: float              # multiplier on base_lr during this phase
    batch_size: int              # global batch (sequences)

    @property
    def tokens(self) -> float:
        return self.end_tokens - self.start_tokens


@dataclass(frozen=True)
class SeesawPlan:
    base_lr: float
    warmup_tokens: float
    total_tokens: float
    phases: List[Phase]
    alpha: float                 # LR cut factor per phase boundary
    beta: float                  # batch multiplier per phase boundary
    kind: str = "seesaw"

    def steps_per_phase(self, seq_len: int) -> List[int]:
        """Whole steps per phase, with a token carry across phases so
        the total token budget is conserved exactly (±1 step) whatever
        the ramp — the equal-FLOPs comparison depends on it.  This is
        the authoritative allocation: the loader, the LR cuts and the
        phase of every step follow it."""
        out = []
        carry = 0.0
        for i, p in enumerate(self.phases):
            tok_per_step = p.batch_size * seq_len
            avail = p.tokens + carry
            if i == len(self.phases) - 1:
                steps = int(math.floor(avail / tok_per_step + 0.5))
            else:
                steps = int(avail // tok_per_step)
            out.append(steps)
            carry = avail - steps * tok_per_step
        return out

    def total_steps(self, seq_len: int) -> int:
        return sum(self.steps_per_phase(seq_len))

    def batch_sizes(self) -> List[int]:
        return [p.batch_size for p in self.phases]

    def merged_segments(self, seq_len: int):
        """Adjacent same-batch-size phases merged into contiguous
        segments ``[(batch_size, [(phase, n_steps), ...]), ...]``; phases
        with no realized step are dropped.  A fused chunk may span a
        phase boundary inside a segment: the LR is token/step-indexed,
        and the batch shape does not change."""
        segs: List = []
        for phase, n in zip(self.phases, self.steps_per_phase(seq_len)):
            if n <= 0:
                continue
            if segs and segs[-1][0] == phase.batch_size:
                segs[-1][1].append((phase, n))
            else:
                segs.append((phase.batch_size, [(phase, n)]))
        return segs

    def phase_at_tokens(self, tok: float) -> Phase:
        """Phase of an ideal (unquantized) token count."""
        for p in self.phases:
            if tok < p.end_tokens:
                return p
        return self.phases[-1]

    def realized_phase_at(self, tok: float, seq_len: int) -> Phase:
        """Phase of the step that *starts* at ``tok``, under the
        step-quantized boundaries of :meth:`steps_per_phase`."""
        tok = float(tok)
        for p, n in zip(self.phases, self.steps_per_phase(seq_len)):
            span = n * p.batch_size * seq_len
            if tok < span - 0.5:
                return p
            tok -= span
        return self.phases[-1]

    def validate(self) -> "SeesawPlan":
        assert self.phases, "empty plan"
        tol = 1e-6 * self.total_tokens
        assert abs(self.phases[-1].end_tokens - self.total_tokens) <= tol
        for p in self.phases:
            if p.end_tokens - p.start_tokens <= 0:
                raise ValueError(
                    f"phase {p.index} has non-positive token span "
                    f"[{p.start_tokens}, {p.end_tokens}) — the cut "
                    f"points are out of order or past total_tokens")
        for a, b in zip(self.phases, self.phases[1:]):
            assert abs(a.end_tokens - b.start_tokens) <= tol
            assert b.batch_size >= a.batch_size, "batch must not shrink"
        # Lemma 4 — except 'naive-ramp', the paper's deliberately
        # divergent Figure-5 baseline (batch ×β with no LR cut)
        if (self.kind != "naive-ramp" and self.beta > 1.0
                and self.alpha < math.sqrt(self.beta) - 1e-9):
            raise ValueError(
                f"divergent ramp (Lemma 4): alpha={self.alpha} < "
                f"sqrt(beta)={math.sqrt(self.beta)}")
        return self

    # -- live extension (adaptive Seesaw) ------------------------------- #
    def extend_at(self, cut_tokens: int, *, seq_len: int,
                  max_batch_size: Optional[int] = None) -> "SeesawPlan":
        """A new plan with the last phase cut at ``cut_tokens`` and a
        (LR ÷ α, batch × β) phase appended up to ``total_tokens``: one
        adaptive cut.  ``cut_tokens`` must lie on a realized step boundary
        strictly inside the last phase (the trainer cuts at chunk
        boundaries), so the re-chunked loader, the LR and a resume agree
        on one integer boundary.  ``max_batch_size`` clamps the new batch
        (the LR keeps cutting).  The new plan is validated."""
        last = self.phases[-1]
        cut = int(cut_tokens)
        realized_start = 0
        for p, n in zip(self.phases[:-1],
                        self.steps_per_phase(seq_len)[:-1]):
            realized_start += n * p.batch_size * seq_len
        tok_per_step = last.batch_size * seq_len
        if not realized_start < cut < self.total_tokens:
            raise ValueError(
                f"cut at {cut} tokens is outside the open last phase "
                f"({realized_start}, {self.total_tokens:.0f})")
        if (cut - realized_start) % tok_per_step:
            raise ValueError(
                f"cut at {cut} tokens is not on a step boundary of "
                f"phase {last.index} (B={last.batch_size}, "
                f"seq_len={seq_len}: {tok_per_step} tokens/step)")
        new_b = int(round(last.batch_size * self.beta))
        if max_batch_size:
            new_b = min(new_b, max_batch_size)
        phases = list(self.phases[:-1])
        phases.append(dataclasses.replace(last, end_tokens=float(cut)))
        phases.append(Phase(last.index + 1, float(cut), self.total_tokens,
                            last.lr_scale / self.alpha, new_b))
        return dataclasses.replace(self, phases=phases).validate()


def build_plan(*, kind: str, base_lr: float, total_tokens: float,
               warmup_frac: float, b0: int, alpha: float = 2.0,
               beta: Optional[float] = None, n_cuts: int = 8,
               max_batch_size: Optional[int] = None,
               cut_tokens: Optional[Sequence[float]] = None,
               quarter_cosine: bool = True) -> SeesawPlan:
    """The phase plan of one of the paper's schedulers:

    - ``cosine``: one phase at B0; the LR is the continuous curve.
    - ``step``: the α-step-decay approximation of cosine (β=1).
    - ``seesaw``: Algorithm 1, cut √α and batch ×α at each cut.
    - ``seesaw-general``: any (α, β), validated against Lemma 4.
    - ``constant``: constant LR and batch (Figure 5 baseline).
    - ``naive-ramp``: constant LR, batch ×β per cut (Figure 5).
    - ``adaptive-seesaw``: one (LR 1.0, B0) phase; each cut of the
      plateau controller appends a (÷√α LR, ×α batch) phase through
      :meth:`SeesawPlan.extend_at` (``total_tokens`` is the run's
      horizon).

    An explicit ``cut_tokens`` list must be strictly increasing and lie
    strictly inside (warmup, total_tokens).
    """
    warmup = warmup_frac * total_tokens
    if cut_tokens is None:
        cut_tokens = S.cosine_cut_points(total_tokens, warmup, alpha,
                                         n_cuts, quarter=quarter_cosine)
    elif kind not in ("cosine", "adaptive-seesaw"):
        explicit = [float(c) for c in cut_tokens]
        for a, b in zip(explicit, explicit[1:]):
            if b <= a:
                raise ValueError(
                    f"cut_tokens must be strictly increasing: "
                    f"{b} follows {a}")
        bad = [c for c in explicit if not warmup < c < total_tokens]
        if bad:
            raise ValueError(
                f"cut_tokens {bad} outside the open interval "
                f"(warmup={warmup:.0f}, total_tokens="
                f"{total_tokens:.0f})")
    cuts = [c for c in cut_tokens if warmup < c < total_tokens]

    if kind == "cosine":
        phases = [Phase(0, 0.0, total_tokens, 1.0, b0)]
        return SeesawPlan(base_lr, warmup, total_tokens, phases,
                          alpha=1.0, beta=1.0, kind=kind).validate()

    if kind == "adaptive-seesaw":
        # the per-cut factors extend_at applies (α_s=√α, β=α), on the
        # Seesaw line α_s√β = α (Corollary 1)
        phases = [Phase(0, 0.0, total_tokens, 1.0, b0)]
        return SeesawPlan(base_lr, warmup, total_tokens, phases,
                          alpha=math.sqrt(alpha), beta=alpha,
                          kind=kind).validate()

    if kind == "constant":
        lr_cut, b_mult = 1.0, 1.0
    elif kind == "step":
        lr_cut, b_mult = alpha, 1.0
    elif kind == "seesaw":
        lr_cut, b_mult = math.sqrt(alpha), alpha
    elif kind == "seesaw-general":
        assert beta is not None
        lr_cut, b_mult = alpha, beta
    elif kind == "naive-ramp":
        assert beta is not None
        lr_cut, b_mult = 1.0, beta
    else:
        raise ValueError(kind)

    bounds = [0.0] + list(cuts) + [total_tokens]
    phases = []
    b = float(b0)
    for i in range(len(bounds) - 1):
        bs = int(round(b))
        if max_batch_size:
            bs = min(bs, max_batch_size)
        phases.append(Phase(i, bounds[i], bounds[i + 1],
                            lr_cut ** (-i), bs))
        b *= b_mult
    return SeesawPlan(base_lr, warmup, total_tokens, phases,
                      alpha=lr_cut, beta=b_mult, kind=kind).validate()


def measured_speedup(plan_seesaw: SeesawPlan, plan_ref: SeesawPlan,
                     seq_len: int) -> float:
    s, r = plan_seesaw.total_steps(seq_len), plan_ref.total_steps(seq_len)
    return 1.0 - s / r


def continuous_step_fraction(n_cuts: int, alpha: float = 2.0) -> float:
    """Discrete-plan approximation of ∫cos: with cut points where a
    quarter-cosine crosses α^{-k}, Seesaw's batch grows ×α per phase, so
    the fraction of baseline steps is Σ w_k α^{-k}, w_k the token
    fraction of phase k."""
    cuts = S.cosine_cut_points(1.0, 0.0, alpha, n_cuts, quarter=True)
    bounds = [0.0] + cuts + [1.0]
    frac = 0.0
    for k in range(len(bounds) - 1):
        frac += (bounds[k + 1] - bounds[k]) * alpha ** (-k)
    return frac
