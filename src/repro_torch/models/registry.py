"""Family dispatch for training and serving (``repro.models.registry``
in PyTorch).

``supports_paged`` and ``serving_mode`` are the reference's rules,
decided from the config alone.  The port trains and serves the dense
family and trains the ssm family (Mamba-2); serving it, and every other
family, raises ``NotImplementedError`` naming the slice that brings it.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba2, transformer

_TRANSFORMER_FAMILIES = ("dense", "moe", "vlm")
_FAMILIES = {"dense": transformer, "ssm": mamba2}
STATE_SERVING_SLICE = "the Mamba-2 state-serving slice"

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


def prefill_ragged(model, cfg: ModelConfig, tokens, lengths):
    """Bucketed prefill (full-attention transformer families only).
    Returns (logits at each request's last real token, per-layer k, v
    (L, B, S, Hkv, hd)) for the page pool to scatter."""
    if cfg.arch_type == "ssm":
        raise NotImplementedError(
            f"Mamba-2 prefill fills a recurrent state, not pages; it "
            f"comes with {STATE_SERVING_SLICE}")
    if not supports_paged(cfg):
        raise NotImplementedError(
            f"ragged prefill needs full attention; {cfg.arch_type} with "
            f"window={cfg.sliding_window} keeps the exact-length path")
    return family(cfg).prefill_ragged(model, cfg, tokens, lengths)


def decode_step(model, cfg: ModelConfig, cache, token):
    """One decode step against the paged KV cache.  Returns (logits
    (B, 1, V), the cache with lengths advanced by one); the pool is
    updated in place."""
    from repro_torch.serving import cache as sc   # serving imports this
    if not isinstance(cache, sc.PagedKVCache):
        raise TypeError(
            f"decode_step takes a PagedKVCache, got "
            f"{type(cache).__name__}; the dense cache comes with the "
            f"dense Server oracle in a later slice")
    family(cfg)                 # raises for a family not ported yet
    return sc.paged_decode(model, cfg, cache, token)
