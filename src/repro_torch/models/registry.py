"""Family dispatch for training and serving (``repro.models.registry``
in PyTorch).

``supports_paged`` and ``serving_mode`` are the reference's rules,
decided from the config alone.  The port trains and serves the dense
family (from the paged KV pool) and the ssm family (Mamba-2, from the
recurrent state pool); every other family, and the dense family's
contiguous cache (the ``Server`` oracle), raises ``NotImplementedError``
naming the slice that brings it.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba2, transformer

_TRANSFORMER_FAMILIES = ("dense", "moe", "vlm")
_FAMILIES = {"dense": transformer, "ssm": mamba2}
SERVER_SLICE = "the dense Server oracle slice"

_LATER = {
    "moe": "the other-families slice (MoE)",
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
    """``"paged"``, ``"state"`` (recurrent families) or ``None`` (the
    dense oracle only)."""
    if supports_paged(cfg):
        return "paged"
    if cfg.arch_type == "ssm":
        return "state"
    return None


def prefill(model, cfg: ModelConfig, tokens):
    """Run the prompt, tokens (B, S), at its exact length and build the
    decode cache.  Returns (logits (B, 1, V) float32, a
    ``serving.cache.DenseKVCache`` whose ``lengths`` are all S).  The
    ssm family only: the dense family's contiguous cache comes with
    the dense ``Server`` oracle."""
    from repro_torch.serving import cache as sc   # serving imports this
    if cfg.arch_type != "ssm":
        family(cfg)             # raises for a family not ported yet
        raise NotImplementedError(
            f"the {cfg.arch_type} family's contiguous cache comes with "
            f"{SERVER_SLICE}; serve it from the page pool")
    logits, data = family(cfg).prefill(model, cfg, tokens)
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
    pages or recurrent state rows) or a ``DenseKVCache`` (the ssm
    family's contiguous state from ``prefill``; all rows at one depth,
    ``lengths[0]``, which the recurrent step does not need).  Returns
    (logits (B, 1, V), the cache with lengths advanced by one)."""
    from repro_torch.serving import cache as sc   # serving imports this
    if isinstance(cache, sc.PagedKVCache):
        family(cfg)             # raises for a family not ported yet
        return sc.paged_decode(model, cfg, cache, token)
    if not isinstance(cache, sc.DenseKVCache):
        raise TypeError(
            f"decode_step takes a DenseKVCache or a PagedKVCache, got "
            f"{type(cache).__name__}; build one with registry.prefill or "
            f"a serving.cache.PagePool")
    if cfg.arch_type != "ssm":
        family(cfg)
        raise NotImplementedError(
            f"the {cfg.arch_type} family's contiguous cache comes with "
            f"{SERVER_SLICE}")
    logits, data = family(cfg).decode_step(model, cfg, cache.data, token)
    return logits, sc.DenseKVCache(data=data, lengths=cache.lengths + 1)


def cache_struct(cfg: ModelConfig, batch: int, max_len: int = 0, *,
                 dtype=torch.bfloat16, device="cuda"):
    """Zeroed contiguous decode cache for ``batch`` rows: the ssm
    family's recurrent state (O(1) in ``max_len``), leaves (L, batch,
    ...).  The state pool builds its buffer from it, with the page id on
    axis 1."""
    if cfg.arch_type != "ssm":
        family(cfg)
        raise NotImplementedError(
            f"the {cfg.arch_type} family's contiguous cache comes with "
            f"{SERVER_SLICE}")
    return family(cfg).state_struct(cfg, batch, dtype=dtype, device=device)
