"""Deterministic synthetic data (``repro.data.synthetic``'s ``MarkovLM``
and ``LinearRegressionSampler``, copied verbatim in numpy so that the two
packages' streams are identical seed for seed).

MarkovLM — a sparse bigram language with Zipf-weighted transitions: a
model must learn the transition table, so the loss falls smoothly toward
the chain's conditional entropy.  Sequence ``i`` of the stream depends
only on (seed, i), so two schedulers see identical data at equal token
counts (the paper's equal-FLOPs comparisons need this).

LinearRegressionSampler — the Section-5 distribution
x~N(0,H), y = ⟨w*,x⟩ + N(0,σ²), sampled in the eigenbasis; the batch of
step t depends only on (seed, t).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


class MarkovLM:
    def __init__(self, vocab_size: int = 2048, branching: int = 16,
                 seed: int = 0, zipf_a: float = 1.2):
        self.vocab_size = vocab_size
        self.branching = branching
        self.seed = seed
        rng = np.random.default_rng(seed)
        self.table = np.stack([
            rng.choice(vocab_size, size=branching, replace=False)
            for _ in range(vocab_size)
        ])                                           # (V, K)
        w = (np.arange(1, branching + 1, dtype=np.float64)) ** (-zipf_a)
        rows = []
        for _ in range(vocab_size):
            rows.append(rng.permutation(w))
        probs = np.stack(rows)
        probs /= probs.sum(axis=1, keepdims=True)
        self.probs = probs
        self.cdf = np.cumsum(probs, axis=1)          # (V, K)

    def conditional_entropy(self) -> float:
        """H(next|cur) under the uniform state distribution ≈ loss floor."""
        p = self.probs
        return float(-(p * np.log(p)).sum(axis=1).mean())

    @staticmethod
    def _mix(x: np.ndarray) -> np.ndarray:
        """splitmix64 finalizer — counter-based, vectorized."""
        x = (x + np.uint64(0x9E3779B97F4A7C15))
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))

    def _uniform(self, idx: np.ndarray, t: np.ndarray) -> np.ndarray:
        """U(0,1) keyed by (seed, absolute sequence index, position)."""
        with np.errstate(over="ignore"):
            key = (np.uint64(self.seed) * np.uint64(0xD1342543DE82EF95)
                   ^ self._mix(idx.astype(np.uint64))[:, None]
                   ^ self._mix(t.astype(np.uint64)
                               + np.uint64(0x5851F42D4C957F2D))[None, :])
            h = self._mix(key)
        return (h >> np.uint64(11)).astype(np.float64) * 2.0 ** -53

    def sample(self, start: int, batch: int, seq_len: int
               ) -> Dict[str, np.ndarray]:
        """Sequences [start, start+batch) of the absolute stream.
        Tokens (batch, seq_len+1) split into inputs/labels."""
        idx = np.arange(start, start + batch, dtype=np.uint64)
        u = self._uniform(idx, np.arange(seq_len, dtype=np.uint64))
        state = (self._mix(idx ^ np.uint64(self.seed * 7919 + 13))
                 % np.uint64(self.vocab_size)).astype(np.int64)
        toks = np.empty((batch, seq_len + 1), np.int32)
        toks[:, 0] = state
        for t in range(seq_len):
            j = (self.cdf[state] < u[:, t:t + 1]).sum(axis=1)
            state = self.table[state, np.minimum(j, self.branching - 1)]
            toks[:, t + 1] = state
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class LinearRegressionSampler:
    def __init__(self, lam: np.ndarray, sigma2: float = 1.0,
                 seed: int = 0, w_star: Optional[np.ndarray] = None):
        self.lam = np.asarray(lam, np.float64)
        self.sigma = float(np.sqrt(sigma2))
        self.seed = seed
        d = self.lam.shape[0]
        self.w_star = (np.zeros(d) if w_star is None
                       else np.asarray(w_star, np.float64))

    def sample(self, step: int, batch: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        x = rng.normal(size=(batch, self.lam.shape[0])) \
            * np.sqrt(self.lam)[None, :]
        y = x @ self.w_star + self.sigma * rng.normal(size=batch)
        return x.astype(np.float32), y.astype(np.float32)

    def risk(self, w: np.ndarray) -> float:
        """Population risk ½E(⟨w,x⟩−y)² (excess + σ²/2)."""
        d = w - self.w_star
        return 0.5 * float(np.sum(self.lam * d * d) + self.sigma ** 2)
