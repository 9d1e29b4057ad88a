"""Blocking batched serving over the contiguous caches
(``repro.train.serve`` in PyTorch): a prefill, then a greedy or
temperature decode loop against ``registry.decode_step``.

- **Two prefill paths.**  A config that can serve from pages
  (``registry.supports_paged``: full attention) takes the bucketed
  path: prompts right-padded to a ladder of bucket lengths go through
  the ragged prefill, whose K/V are padded out to a full cache of
  ``max_len`` positions, so the prefills are keyed by (batch, bucket)
  and not by prompt length.  Every other family takes the exact-length
  path (``registry.prefill``): a sliding window builds its ring of
  min(window, max_len) slots, the ssm family its recurrent state, the
  RG-LRU hybrid a list of per-layer caches (recurrent states and
  rings), the enc-dec its full self-attention cache and each layer's
  cross-attention K/V.
- **Prefix embeddings.**  ``generate(prefix_emb=...)`` takes the stub
  frontend's output, as the reference's ``Server`` does: the VLM's
  patches go ahead of the prompt on the bucketed path (the bucket plus
  the prefix must fit ``max_len``; ``lengths`` count the prefix), the
  enc-dec's source frames go to its encoder (the exact-length path;
  it needs them).
- **The oracle.**  The continuous-batching ``serving.ServingEngine`` is
  held to this ``Server``: same weights, same prompts, same greedy
  tokens.  For new code ``generate`` is deprecated in the engine's
  favour (it blocks the batch on its slowest request), but it remains
  the path for families the engine cannot serve (a ring's rows share
  one position array).
- **Two faults of the reference it rejects.**  ``generate`` raises
  ``ValueError`` before the prefill when a full cache would be written
  at a position >= ``max_len`` (the reference's decode drops that
  write while its length mask still admits the slot, so it returns
  wrong tokens without an error); a ring or a recurrent state has no
  such limit (the enc-dec's self-attention cache is full too).  It
  raises when ``n_new < 1`` (the reference returns one
  token a row for 0).
- **The compile cache.**  On the card the decode step replays one
  captured CUDA graph (``graphs.Graph``) per (batch, cache layout),
  after the entry's first step ran eagerly, as the engine's first
  decode does: the graph reads a static token and cache, which each
  prefill's cache is copied into and which the step updates in place.
  Sampling runs outside the graph.  Prefills run eagerly; their
  (batch, bucket) keys are the reference's count of prefill
  executables.  On the CPU every call is eager.
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import graphs as G
from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry as R
from repro_torch.serving import DenseKVCache, pow2_buckets


@torch.inference_mode()
def _bucketed_prefill(model, cfg: ModelConfig, tokens, lengths, prefix_emb,
                      *, cache_len_cap: int):
    """Ragged prefill and the full cache around it: the raw per-layer K/V
    padded out to ``cache_len_cap`` rows.  Rows past ``lengths`` hold
    padding junk that the decode attention never reads."""
    logits, k, v = R.prefill_ragged(model, cfg, tokens, lengths,
                                    prefix_emb=prefix_emb)
    pad = (0, 0, 0, 0, 0, cache_len_cap - k.shape[2])
    return logits, DenseKVCache(data={"k": F.pad(k, pad),
                                      "v": F.pad(v, pad)},
                                lengths=lengths)


@torch.inference_mode()
def _decode(model, cfg: ModelConfig, cache: DenseKVCache, token):
    """One decode step on the static ``cache`` and ``token``: the new
    state and lengths land in ``cache``'s own tensors (the dense K/V and
    the hybrid's caches are written in place already; the ssm state is
    copied back).  Returns the logits (B, 1, V)."""
    logits, new = R.decode_step(model, cfg, cache, token)
    for (_, t), (_, old) in zip(_leaves(new.data), _leaves(cache.data)):
        if t is not old:
            old.copy_(t)
    cache.lengths.copy_(new.lengths)
    return logits


class _Entry:
    """One decode entry: the static cache and token its step reads and
    writes, and on the card, once captured, its graph."""

    def __init__(self, key: Tuple, cache: DenseKVCache,
                 token: torch.Tensor):
        self.key = key
        self.cache = cache
        self.token = token
        self.graph: Optional[G.Graph] = None


def _leaves(data):
    """(name, tensor) of a cache's data in a fixed order: a dict of
    layer-stacked tensors, or the hybrid's list of per-layer dicts
    (named ``layer/leaf``)."""
    if isinstance(data, dict):
        return sorted(data.items())
    return [(f"{i}/{n}", t) for i, d in enumerate(data)
            for n, t in sorted(d.items())]


def _layout(cache: DenseKVCache) -> Tuple:
    return tuple((n, tuple(t.shape), t.dtype)
                 for n, t in _leaves(cache.data))


class Server:
    """Blocking generation for a batch of equal-length prompts.  The
    model's weights must be in ``dtype``, the dtype the caches hold."""

    def __init__(self, cfg: ModelConfig, model, *, max_len: int = 4096,
                 dtype=torch.bfloat16, buckets=None):
        if model.dtype != dtype:
            raise ValueError(f"model holds {model.dtype} weights; build it "
                             f"with dtype={dtype} to serve in {dtype}")
        self.cfg = cfg
        self.model = model
        self.max_len = max_len
        self.dtype = dtype
        self.device = model.device
        self.bucketed = R.supports_paged(cfg)
        # a full self-attention cache, which a decode must not run past
        self.full_cache = self.bucketed or \
            cfg.arch_type in R.ENCDEC_FAMILIES
        self.buckets = tuple(sorted(buckets)) if buckets else \
            pow2_buckets(max_len)
        self._prefill_keys: set = set()            # (batch, bucket)
        self._decode_fns: Dict[Tuple, _Entry] = {}  # (batch, layout)
        self._warm: set = set()         # entries whose first step has run
        self.captures = 0
        self.capture_s = 0.0
        if self.device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()

    @property
    def n_prefill_executables(self) -> int:
        """Distinct prefills on the bucketed path: bounded by #batch
        sizes × #buckets, not by distinct prompt lengths."""
        return len(self._prefill_keys)

    def _bucket_for(self, s: int) -> int:
        for b in self.buckets:
            if s <= b:
                return b
        raise ValueError(f"prompt length {s} exceeds largest bucket "
                         f"{self.buckets[-1]}")

    def _prefix(self, prefix_emb) -> Optional[torch.Tensor]:
        """The stub frontend's embeddings on the model's device, in the
        serving dtype."""
        if prefix_emb is None:
            return None
        if not R.has_frontend(self.cfg):
            raise ValueError(f"arch_type {self.cfg.arch_type!r} has no "
                             f"frontend to take a prefix_emb")
        if not isinstance(prefix_emb, torch.Tensor):
            prefix_emb = torch.from_numpy(np.asarray(prefix_emb,
                                                     np.float32))
        return prefix_emb.to(device=self.device, dtype=self.dtype)

    def prefill(self, tokens: torch.Tensor, prefix_emb=None):
        """tokens (B, S) int64 on the model's device, ``prefix_emb`` (B, P,
        d) or None -> (logits (B, 1, V) float32 at each row's last token,
        the ``DenseKVCache``)."""
        B, S = tokens.shape
        prefix_emb = self._prefix(prefix_emb)
        if not self.bucketed:
            with torch.inference_mode():
                return R.prefill(self.model, self.cfg, tokens,
                                 cache_len_cap=self.max_len,
                                 prefix_emb=prefix_emb)
        n_prefix = 0 if prefix_emb is None else prefix_emb.shape[1]
        bucket = self._bucket_for(S)
        if n_prefix + bucket > self.max_len:
            raise ValueError(f"prompt bucket {bucket} (+{n_prefix} prefix) "
                             f"exceeds max_len {self.max_len}")
        self._prefill_keys.add((B, bucket))
        lengths = torch.full((B,), n_prefix + S, dtype=torch.int32,
                             device=self.device)
        return _bucketed_prefill(self.model, self.cfg,
                                 F.pad(tokens, (0, bucket - S)), lengths,
                                 prefix_emb, cache_len_cap=self.max_len)

    def generate(self, tokens, n_new: int, *, prefix_emb=None,
                 temperature: float = 0.0, seed: int = 0) -> np.ndarray:
        """tokens: (B, S) prompt; ``prefix_emb`` (B, P, d) the stub
        frontend's output (the VLM's patches, the enc-dec's source
        frames).  Returns (B, n_new) int32 generated ids.

        ``temperature > 0`` samples from softmax(logits / temperature)
        with a ``torch.Generator`` seeded by ``seed`` on the model's
        device: repeatable, but not the reference's draws (JAX's PRNG
        bits cannot be matched).

        .. deprecated:: blocking whole-batch generation; prefer
           ``serving.ServingEngine`` (submit/step/drain), which serves
           ragged prompts and budgets without padding the batch or
           blocking on its slowest member."""
        warnings.warn(
            "Server.generate blocks the whole batch on its slowest "
            "request; prefer serving.ServingEngine.submit()/drain() "
            "(Server remains the dense parity oracle and the path for "
            "families without a paged/state serving mode)",
            DeprecationWarning, stacklevel=2)
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64)
        B, S = tokens.shape
        if n_new < 1:
            raise ValueError(f"n_new must be >= 1, got {n_new}")
        # the VLM's prefix takes cache rows ahead of the prompt; the
        # enc-dec's source frames have a cache of their own
        if prefix_emb is not None and self.bucketed:
            S += np.shape(prefix_emb)[1]
        # the last sampled token is never written back: the cache takes
        # positions 0..S + n_new - 2
        if self.full_cache and S + n_new - 1 > self.max_len:
            raise ValueError(
                f"prompt {S} + n_new {n_new} writes position "
                f"{S + n_new - 2} of a full cache of max_len "
                f"{self.max_len}")
        gen = None
        if temperature > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        logits, cache = self.prefill(tokens.to(self.device), prefix_emb)
        with torch.inference_mode():
            ent = self._entry(cache)
            tok = _sample(logits, temperature, gen)
            out = [tok]
            for _ in range(n_new - 1):
                ent.token.copy_(tok)
                tok = _sample(self._step(ent), temperature, gen)
                out.append(tok)
            return torch.cat(out, dim=1).cpu().numpy().astype(np.int32)

    def _entry(self, cache: DenseKVCache) -> _Entry:
        """The decode entry of ``cache``'s batch and layout, its static
        cache set to ``cache`` (adopted by a new entry, copied into an
        old one, whose graph reads its tensors where they are)."""
        B = cache.lengths.shape[0]
        key = (B, _layout(cache))
        ent = self._decode_fns.get(key)
        if ent is None:
            token = torch.zeros(B, 1, dtype=torch.int64, device=self.device)
            ent = self._decode_fns[key] = _Entry(key, cache, token)
            return ent
        for (_, t), (_, new) in zip(_leaves(ent.cache.data),
                                    _leaves(cache.data)):
            t.copy_(new)
        ent.cache.lengths.copy_(cache.lengths)
        return ent

    def _step(self, ent: _Entry) -> torch.Tensor:
        """One decode step of ``ent``: eager on the CPU and for the
        entry's first step on the card (it builds the kernels, cuBLAS's
        handles and the decode kernel's buffers for this batch), a replay
        of the entry's graph after that."""
        if self.device.type != "cuda" or ent.key not in self._warm:
            self._warm.add(ent.key)
            return _decode(self.model, self.cfg, ent.cache, ent.token)
        if ent.graph is None:
            model, cfg, cache, token = self.model, self.cfg, ent.cache, \
                ent.token
            ent.graph = G.Graph(lambda: _decode(model, cfg, cache, token),
                                self._pool)
            self.captures += 1
            self.capture_s += ent.graph.capture_s
        return ent.graph.replay()


def _sample(logits, temperature: float, gen) -> torch.Tensor:
    """(B, 1) int64 next tokens from the last position's logits."""
    last = logits[:, -1]
    if temperature <= 0.0:
        return last.argmax(dim=-1, keepdim=True)
    probs = torch.softmax(last / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)
