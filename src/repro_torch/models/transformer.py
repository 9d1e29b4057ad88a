"""Dense decoder-only transformer (``repro.models.transformer`` in
PyTorch): the training forward and loss, the ragged bucketed prefill and
the logits.

The reference stacks its layers along a leading L dim and scans them;
here each layer is a module of a ``ModuleList`` and the loop is Python.
MoE layers and the multimodal prefix come with the other families.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import Attention, attn_forward
from repro_torch.models.layers import (MLP, cross_entropy_chunked,
                                       lm_head_matrix, mlp, param, rmsnorm,
                                       trunc_normal_)


class Layer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        # zero-initialised norm scales, used as (1 + scale), in float32
        self.norm1 = param((cfg.d_model,), dtype=torch.float32, device=device)
        self.norm2 = param((cfg.d_model,), dtype=torch.float32, device=device)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, dtype=dtype, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype=dtype,
                       device=device)


class Transformer(nn.Module):
    """The dense decoder's weights.  ``dtype`` is the dtype the matrices
    and the embedding are held in: the compute dtype for serving,
    float32 (master weights) for training.  Norm scales are float32.
    Parameters start uninitialised and frozen; call ``init_weights`` or
    load them with ``weights.from_jax_params``, and ``requires_grad_``
    to train."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        if cfg.arch_type != "dense":
            raise NotImplementedError(
                f"Transformer ports the dense family; {cfg.arch_type!r} "
                f"comes with the other-families slice")
        self.cfg = cfg
        d, V = cfg.d_model, cfg.padded_vocab
        self.tok = param((V, d), dtype=dtype, device=device)
        self.lm_head = (None if cfg.tie_embeddings
                        else param((d, V), dtype=dtype, device=device))
        self.final_norm = param((d,), dtype=torch.float32, device=device)
        self.layers = nn.ModuleList(
            Layer(cfg, dtype=dtype, device=device)
            for _ in range(cfg.n_layers))

    @property
    def dtype(self) -> torch.dtype:
        return self.tok.dtype

    @property
    def device(self) -> torch.device:
        return self.tok.device

    def init_weights(self, generator: torch.Generator) -> "Transformer":
        """The reference's init rules, drawn from ``generator`` (which
        must live on the model's device)."""
        L = self.cfg.n_layers
        trunc_normal_(self.tok, 0.02, generator)
        if self.lm_head is not None:
            trunc_normal_(self.lm_head, 0.02, generator)
        self.final_norm.data.zero_()
        for layer in self.layers:
            layer.norm1.data.zero_()
            layer.norm2.data.zero_()
            layer.attn.init_weights(generator, L)
            layer.mlp.init_weights(generator, L)
        return self


# --------------------------------------------------------------------- #
# training forward and loss
# --------------------------------------------------------------------- #

def _layer(layer: Layer, x, cfg: ModelConfig):
    h = rmsnorm(x, layer.norm1, cfg.norm_eps)
    a, _ = attn_forward(layer.attn, h, n_heads=cfg.n_heads,
                        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                        rope_theta=cfg.rope_theta)
    x = x + a
    h = rmsnorm(x, layer.norm2, cfg.norm_eps)
    # sub-layer remat, as the reference's: the backward recomputes the
    # MLP apart from attention, so the peak holds one of their interiors
    f = checkpoint(mlp, layer.mlp, h, cfg.act, use_reentrant=False)
    return x + f


def forward_hidden(model: Transformer, cfg: ModelConfig, tokens, *,
                   dtype=torch.bfloat16, remat: bool = True):
    """tokens: (B, S) int -> final hidden states (B, S, d) in ``dtype``.
    The embedding is cast to ``dtype`` before the gather, as the
    reference does; ``F.embedding``'s backward sums each row's grads in
    a fixed order (an indexing backward would add them with atomics on
    the card).  ``remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``); it changes memory, not the numbers."""
    if cfg.sliding_window is not None:
        raise NotImplementedError(
            "sliding-window attention comes with a later slice")
    x = F.embedding(tokens, model.tok.to(dtype))
    for layer in model.layers:
        if remat:
            x = checkpoint(_layer, layer, x, cfg, use_reentrant=False)
        else:
            x = _layer(layer, x, cfg)
    return rmsnorm(x, model.final_norm, cfg.norm_eps)


def loss_fn(model: Transformer, cfg: ModelConfig, batch, *,
            z_loss: float = 0.0, dtype=torch.bfloat16, remat: bool = True):
    """batch: ``tokens`` and ``labels`` (B, S) int64, optional ``mask``
    (B, S) float32.  Returns (loss, metrics) as the reference: the loss
    and ``ce_loss`` (both with the z-loss term) and ``z_sq``, float32
    scalars."""
    h = forward_hidden(model, cfg, batch["tokens"], dtype=dtype,
                       remat=remat)
    labels = batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    loss, z_sq = cross_entropy_chunked(h, lm_head_matrix(model), labels,
                                       mask, cfg.vocab_size, z_loss=z_loss)
    return loss, {"ce_loss": loss, "z_sq": z_sq, "loss": loss}


# --------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------- #

def logits_from_hidden(model: Transformer, h):
    """h: (..., d) -> float32 logits over the padded vocab."""
    return (h @ lm_head_matrix(model)).float()


def prefill_ragged(model: Transformer, cfg: ModelConfig, tokens, lengths):
    """Bucketed prefill: tokens (B, S_bucket) right-padded to a shared
    bucket length, lengths (B,) true lengths.  Causality keeps every real
    position independent of the padding.

    Returns (logits (B, 1, V) float32 at each request's last real token,
    k, v (L, B, S, Hkv, hd)); rows at positions >= lengths[b] hold
    padding junk that the page pool masks by the causal reach."""
    if cfg.sliding_window is not None:
        raise NotImplementedError(
            "ragged bucketed prefill supports full attention only; "
            "sliding-window archs come with a later slice")
    x = model.tok[tokens]
    B, S, _ = x.shape
    ks, vs = [], []
    for layer in model.layers:
        h = rmsnorm(x, layer.norm1, cfg.norm_eps)
        a, (k, v) = attn_forward(
            layer.attn, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta)
        x = x + a
        h = rmsnorm(x, layer.norm2, cfg.norm_eps)
        x = x + mlp(layer.mlp, h, cfg.act)
        ks.append(k)
        vs.append(v)
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    idx = (lengths.long() - 1).clamp(0, S - 1)
    h_last = x[torch.arange(B, device=x.device), idx][:, None]   # (B, 1, d)
    return logits_from_hidden(model, h_last), torch.stack(ks), \
        torch.stack(vs)
