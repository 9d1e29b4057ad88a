"""Adaptive Seesaw (``repro.core.adaptive`` in PyTorch — plain Python):
cuts triggered by a loss plateau instead of by a reference cosine.

The controller fires a (√α LR cut, ×α batch) whenever the smoothed loss
stops improving, so the schedule needs no token budget in advance.  Two
ways to feed it share one plateau test:

- ``observe(loss)`` — one raw loss per step; the window mean is taken
  here.
- ``observe_smoothed(ema, n_steps)`` — the engine's path: one loss EMA
  per chunk (carried by ``PhaseEngine.run_chunk``), the step count
  advanced by the chunk's real steps, the test run when a window
  boundary has been crossed.  Decisions land on chunk boundaries, where
  the trainer can extend the plan and re-chunk the loader.

A cut needs fresh evidence: the controller arms on a window that
improved by at least ``rel_threshold`` and fires on the first later
window that did not; firing disarms it and clears the previous window,
so a flat stream gives one cut per plateau.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class AdaptiveSeesaw:
    """Plateau-triggered Seesaw controller: feed ``observe`` once a step
    or ``observe_smoothed`` once a chunk; read ``lr_scale`` and
    ``batch_multiplier``."""
    alpha: float = 2.0                 # reference decay per cut
    window: int = 50                   # steps per plateau test
    rel_threshold: float = 2e-3        # relative improvement floor
    max_cuts: int = 12
    min_steps_between: int = 50
    # state -------------------------------------------------------------
    n_cuts: int = 0
    steps: int = 0
    last_cut_step: int = 0
    _window_losses: List[float] = field(default_factory=list)
    _prev_window_mean: Optional[float] = None
    _window_start: int = 0             # step the current window opened
    _armed: bool = True                # saw improvement since last cut
    cut_steps: List[int] = field(default_factory=list)

    @property
    def lr_scale(self) -> float:
        return math.sqrt(self.alpha) ** (-self.n_cuts)

    @property
    def batch_multiplier(self) -> float:
        return self.alpha ** self.n_cuts

    # -- the one plateau test ------------------------------------------- #
    def _test_window(self, mean: float) -> bool:
        """Compare this window's smoothed loss with the previous one's;
        fire if armed and the improvement stalled.  A cut clears the
        previous window (the next comparison is between two post-cut
        windows) and disarms until a window improves again."""
        fired = False
        if self._prev_window_mean is not None:
            improvement = self._prev_window_mean - mean
            scale = max(abs(self._prev_window_mean), 1e-12)
            improving = improvement >= self.rel_threshold * scale
            if improving:
                self._armed = True
            elif (self._armed
                    and self.n_cuts < self.max_cuts
                    and self.steps - self.last_cut_step
                    >= self.min_steps_between):
                self.n_cuts += 1
                self.last_cut_step = self.steps
                self.cut_steps.append(self.steps)
                self._armed = False
                fired = True
        self._window_start = self.steps
        self._prev_window_mean = None if fired else mean
        return fired

    # -- per-step host path --------------------------------------------- #
    def observe(self, loss: float) -> bool:
        """True if a cut fires at this step."""
        self.steps += 1
        self._window_losses.append(float(loss))
        if len(self._window_losses) < self.window:
            return False
        mean = sum(self._window_losses) / len(self._window_losses)
        self._window_losses.clear()
        return self._test_window(mean)

    # -- per-chunk engine path ------------------------------------------ #
    def observe_smoothed(self, ema: float, n_steps: int) -> bool:
        """The loss EMA after ``n_steps`` more real steps; tests once per
        crossed window boundary (a chunk longer than a window still tests
        once: the EMA already sums up the span).  True if a cut fires."""
        self.steps += int(n_steps)
        if self.steps - self._window_start < self.window:
            return False
        return self._test_window(float(ema))

    # -- checkpointing --------------------------------------------------- #
    def state_dict(self) -> Dict:
        """JSON-able state for the checkpoint's metadata: enough to replay
        the run bit for bit from a resume between two cuts."""
        return {"n_cuts": self.n_cuts, "steps": self.steps,
                "last_cut_step": self.last_cut_step,
                "window_losses": list(self._window_losses),
                "prev_window_mean": self._prev_window_mean,
                "window_start": self._window_start,
                "armed": self._armed,
                "cut_steps": list(self.cut_steps)}

    def load_state_dict(self, state: Dict) -> "AdaptiveSeesaw":
        self.n_cuts = int(state["n_cuts"])
        self.steps = int(state["steps"])
        self.last_cut_step = int(state["last_cut_step"])
        self._window_losses = [float(x)
                               for x in state.get("window_losses", [])]
        pw = state.get("prev_window_mean")
        self._prev_window_mean = None if pw is None else float(pw)
        self._window_start = int(state.get("window_start", 0))
        self._armed = bool(state.get("armed", True))
        self.cut_steps = [int(s) for s in state["cut_steps"]]
        return self
