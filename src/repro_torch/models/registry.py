"""Family dispatch for training and serving (``repro.models.registry``
in PyTorch).

``supports_paged`` and ``serving_mode`` are the reference's rules,
decided from the config alone.  The port trains the dense and MoE
families (full attention; both are ``models.transformer``) and the ssm
family (Mamba-2), and serves them: the transformer families from the
paged KV pool or, with a sliding window, through the ``Server``'s
contiguous ring cache; Mamba-2 from the recurrent state pool.  The
contiguous caches of ``prefill``, ``decode_step`` and ``cache_struct``
(``serving.cache.DenseKVCache``) serve every ported family.
Every other family raises ``NotImplementedError`` naming the slice
that brings it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba2, transformer

_TRANSFORMER_FAMILIES = ("dense", "moe", "vlm")
_FAMILIES = {"dense": transformer, "moe": transformer, "ssm": mamba2}

_LATER = {
    "vlm": "the other-families slice (VLM prefix)",
    "hybrid": "the other-families slice (RG-LRU hybrid)",
    "encdec": "the other-families slice (enc-dec)",
    "audio": "the other-families slice (enc-dec audio)",
}


def family(cfg: ModelConfig):
    fam = _FAMILIES.get(cfg.arch_type)
    if fam is not None:
        return fam
    raise NotImplementedError(
        f"arch_type {cfg.arch_type!r} is not ported yet; it comes with "
        f"{_LATER.get(cfg.arch_type, 'a later slice')}")


def init_model(cfg: ModelConfig, *, seed: int = 0, dtype=torch.bfloat16,
               device="cuda", trainable: bool = False):
    """The model at the reference's init rules, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``.  (The
    reference draws from ``jax.random``, so the numbers differ; to hold
    the two packages against each other, load the reference's weights
    with ``weights.from_jax_params``.)  ``trainable`` turns on the
    parameters' gradients; train with ``dtype=torch.float32`` (master
    weights) and pick the compute dtype in ``loss_fn``."""
    fam = family(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = fam.Model(cfg, dtype=dtype, device=device)
    return model.init_weights(gen).requires_grad_(trainable)


def loss_fn(model, cfg: ModelConfig, batch, *, z_loss: float = 0.0,
            dtype=torch.bfloat16, remat: bool = True):
    """The family's training loss: (loss, metrics)."""
    return family(cfg).loss_fn(model, cfg, batch, z_loss=z_loss,
                               dtype=dtype, remat=remat)


def supports_paged(cfg: ModelConfig) -> bool:
    """True when the family can serve from the paged KV pool: the
    transformer families with full attention."""
    return (cfg.arch_type in _TRANSFORMER_FAMILIES
            and cfg.sliding_window is None)


def serving_mode(cfg: ModelConfig):
    """``"paged"``, ``"state"`` (recurrent families) or ``None``
    (``train.serve.Server`` only: a ring cache's rows share one position
    array, so they cannot step at their own depths)."""
    if supports_paged(cfg):
        return "paged"
    if cfg.arch_type == "ssm":
        return "state"
    return None


def prefill(model, cfg: ModelConfig, tokens, *,
            cache_len_cap: Optional[int] = None):
    """Run the prompt, tokens (B, S), at its exact length and build the
    decode cache.  Returns (logits (B, 1, V) float32, a
    ``serving.cache.DenseKVCache`` whose ``lengths`` are all S).  The
    dense family needs ``cache_len_cap``: its full cache holds that many
    positions, its ring min(window, cap) slots; the ssm family's state
    is O(1) in the length and takes none."""
    from repro_torch.serving import cache as sc   # serving imports this
    fam = family(cfg)
    if cfg.arch_type == "ssm":
        logits, data = fam.prefill(model, cfg, tokens)
    elif cache_len_cap is None:
        raise ValueError(f"the {cfg.arch_type} family's prefill needs "
                         f"cache_len_cap")
    else:
        logits, data = fam.prefill(model, cfg, tokens,
                                   cache_len_cap=cache_len_cap)
    B, S = tokens.shape
    lengths = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    return logits, sc.DenseKVCache(data=data, lengths=lengths)


def prefill_ragged(model, cfg: ModelConfig, tokens, lengths):
    """Bucketed prefill (full-attention transformer families only).
    Returns (logits at each request's last real token, per-layer k, v
    (L, B, S, Hkv, hd)) for the page pool to scatter."""
    if not supports_paged(cfg):
        why = (" (Mamba-2 prefills each prompt at its own length into "
               "the state pool: padding would run the recurrence over "
               "it)" if cfg.arch_type == "ssm" else "")
        raise NotImplementedError(
            f"ragged prefill needs full attention; {cfg.arch_type} with "
            f"window={cfg.sliding_window} keeps the exact-length path{why}")
    return family(cfg).prefill_ragged(model, cfg, tokens, lengths)


def decode_step(model, cfg: ModelConfig, cache, token):
    """One decode step against a typed cache, dispatched on its type: a
    ``PagedKVCache`` (the serving pools, updated in place: attention
    pages or recurrent state rows) or a ``DenseKVCache`` from
    ``prefill`` or ``cache_struct``.  A dense cache steps at per-request
    depths (``lengths``) when the config can serve from pages, and at
    one depth (``lengths[0]``) otherwise: a ring's rows share one
    ``pos``, and the recurrent step needs no position.  The dense
    family's K/V are written in place; the ssm family's state is left
    as it was.  Returns (logits (B, 1, V), the cache with lengths
    advanced by one)."""
    from repro_torch.serving import cache as sc   # serving imports this
    fam = family(cfg)
    if isinstance(cache, sc.PagedKVCache):
        return sc.paged_decode(model, cfg, cache, token)
    if not isinstance(cache, sc.DenseKVCache):
        raise TypeError(
            f"decode_step takes a DenseKVCache or a PagedKVCache, got "
            f"{type(cache).__name__}; build one with registry.prefill or "
            f"a serving.cache.PagePool")
    if cfg.arch_type == "ssm":
        logits, data = fam.decode_step(model, cfg, cache.data, token)
    else:
        cl = cache.lengths if supports_paged(cfg) else cache.lengths[0]
        logits, data = fam.decode_step(model, cfg, cache.data, cl, token)
    return logits, sc.DenseKVCache(data=data, lengths=cache.lengths + 1)


def cache_struct(cfg: ModelConfig, batch: int, max_len: int = 0, *,
                 dtype=torch.bfloat16, device="cuda"):
    """Zeroed contiguous decode cache for ``batch`` rows, leaves (L,
    batch, ...): the dense family's full KV cache of ``max_len``
    positions or its ring of min(window, max_len) slots (with ``pos``),
    or the ssm family's recurrent state (O(1) in ``max_len``), from
    which the state pool builds its buffer with the page id on axis 1."""
    fam = family(cfg)
    if cfg.arch_type == "ssm":
        return fam.state_struct(cfg, batch, dtype=dtype, device=device)
    if max_len < 1:
        raise ValueError(f"the {cfg.arch_type} family's cache needs "
                         f"max_len >= 1, got {max_len}")
    return fam.cache_struct(cfg, batch, max_len, dtype=dtype, device=device)
