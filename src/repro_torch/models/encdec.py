"""Encoder-decoder transformer for seamless-m4t-medium
(``repro.models.encdec`` in PyTorch; arXiv:2308.11596).

The speech frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, frames, d_model), the batch's
``src_emb`` in training and the ``prefix_emb`` of serving.

- **Encoder**: bidirectional self-attention layers with RoPE, then the
  MLP, each behind an RMSNorm; ``enc_norm`` at the end.  The attention
  runs ``chunked_attention(causal=False)`` on both devices, as the
  reference's XLA path does (no flash kernel is bidirectional).
- **Decoder**: per layer ``norm1`` → causal self-attention (the flash
  kernels on the card), ``norm3`` → cross-attention over the encoder's
  output (no RoPE), ``norm2`` → MLP — ``norm3`` before ``norm2``, the
  reference's order.
- **Serving**: ``prefill`` computes each layer's cross-attention K/V
  (``ek``/``ev``) once, from the encoder's output, and stores them in
  the ragged decode kernel's (B, Hkv, Se, hd) layout, so that
  ``decode_step`` attends to them with no transpose: every row's
  length is the Se frames (the kernel admits keys ``0..lengths[b]``,
  so it is passed Se − 1).  ``decode_step`` writes the self-attention
  cache in place, so a captured CUDA graph replays it, and never writes
  ``ek``/``ev``.

The reference scans stacked layers; here each stack is a ``ModuleList``
and the loop is Python.  ``remat`` recomputes each layer in the
backward, as the reference's ``jax.checkpoint`` of its scan body.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import backend as KB
from repro_torch.models import attention as A
from repro_torch.models.attention import Attention, attn_forward
from repro_torch.models.layers import (MLP, P, cross_entropy_chunked,
                                       embed_specs, fsdp_axis, lm_head_matrix,
                                       mlp, mlp_specs, param, recompute,
                                       rmsnorm, trunc_normal_)
from repro_torch.models.transformer import logits_from_hidden


def _attention(cfg: ModelConfig, dtype, device) -> Attention:
    return Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                     dtype=dtype, device=device)


def _norm(cfg: ModelConfig, device) -> nn.Parameter:
    return param((cfg.d_model,), dtype=torch.float32, device=device)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.norm1 = _norm(cfg, device)
        self.norm2 = _norm(cfg, device)
        self.attn = _attention(cfg, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype=dtype,
                       device=device)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.norm1 = _norm(cfg, device)
        self.norm2 = _norm(cfg, device)
        self.norm3 = _norm(cfg, device)
        self.self_attn = _attention(cfg, dtype, device)
        self.cross_attn = _attention(cfg, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype=dtype,
                       device=device)


class EncDec(nn.Module):
    """The enc-dec's weights (``arch_type`` "encdec" or "audio").
    ``dtype`` is the dtype of the matrices and the embedding: the
    compute dtype to serve, float32 (master weights) to train.  Norm
    scales are float32.  Parameters start uninitialised and frozen, as
    ``transformer.Transformer``'s."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        if cfg.arch_type not in ("encdec", "audio"):
            raise ValueError(f"EncDec takes arch_type 'encdec' or 'audio', "
                             f"not {cfg.arch_type!r}")
        self.cfg = cfg
        d, V = cfg.d_model, cfg.padded_vocab
        self.tok = param((V, d), dtype=dtype, device=device)
        self.lm_head = (None if cfg.tie_embeddings
                        else param((d, V), dtype=dtype, device=device))
        self.enc_norm = _norm(cfg, device)
        self.final_norm = _norm(cfg, device)
        self.encoder = nn.ModuleList(
            EncoderLayer(cfg, dtype=dtype, device=device)
            for _ in range(cfg.n_encoder_layers))
        self.decoder = nn.ModuleList(
            DecoderLayer(cfg, dtype=dtype, device=device)
            for _ in range(cfg.n_layers))

    @property
    def dtype(self) -> torch.dtype:
        return self.tok.dtype

    @property
    def device(self) -> torch.device:
        return self.tok.device

    def init_weights(self, generator: torch.Generator) -> "EncDec":
        """The reference's init rules: the encoder's output projections
        scaled by its depth, the decoder's by its own."""
        Le, Ld = self.cfg.n_encoder_layers, self.cfg.n_layers
        trunc_normal_(self.tok, 0.02, generator)
        if self.lm_head is not None:
            trunc_normal_(self.lm_head, 0.02, generator)
        for n in (self.enc_norm, self.final_norm):
            n.data.zero_()
        for layer in self.encoder:
            layer.norm1.data.zero_()
            layer.norm2.data.zero_()
            layer.attn.init_weights(generator, Le)
            layer.mlp.init_weights(generator, Le)
        for layer in self.decoder:
            for n in (layer.norm1, layer.norm2, layer.norm3):
                n.data.zero_()
            layer.self_attn.init_weights(generator, Ld)
            layer.cross_attn.init_weights(generator, Ld)
            layer.mlp.init_weights(generator, Ld)
        return self


Model = EncDec


def param_specs(cfg: ModelConfig, multi_pod: bool = False):
    f = fsdp_axis(multi_pod)
    enc = {"attn": A.attention_specs(f, lead=(None,)),
           "mlp": mlp_specs(cfg.act, f, lead=(None,)),
           "norm1": P(None, None), "norm2": P(None, None)}
    dec = {"self_attn": A.attention_specs(f, lead=(None,)),
           "cross_attn": A.attention_specs(f, lead=(None,)),
           "mlp": mlp_specs(cfg.act, f, lead=(None,)),
           "norm1": P(None, None), "norm2": P(None, None),
           "norm3": P(None, None)}
    return {"embed": embed_specs(cfg.tie_embeddings, f),
            "encoder": enc, "decoder": dec,
            "enc_norm": P(None), "final_norm": P(None)}


# --------------------------------------------------------------------- #
# the encoder and the cross-attention
# --------------------------------------------------------------------- #

def _self_attn(p: Attention, h, cfg: ModelConfig, causal: bool):
    return attn_forward(p, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                        causal=causal)


def _enc_layer(layer: EncoderLayer, x, cfg: ModelConfig):
    h = rmsnorm(x, layer.norm1, cfg.norm_eps)
    x = x + _self_attn(layer.attn, h, cfg, causal=False)[0]
    h = rmsnorm(x, layer.norm2, cfg.norm_eps)
    return x + mlp(layer.mlp, h, cfg.act)


def encode(model: EncDec, cfg: ModelConfig, src_emb, *, remat: bool = True):
    """src_emb (B, Se, d) in the compute dtype -> the encoder's output
    (B, Se, d) after ``enc_norm``."""
    x = src_emb
    for layer in model.encoder:
        x = (recompute(_enc_layer, layer, x, cfg) if remat
             else _enc_layer(layer, x, cfg))
    return rmsnorm(x, model.enc_norm, cfg.norm_eps)


def _enc_kv(p: Attention, enc_out, cfg: ModelConfig):
    """The cross-attention's K and V of the encoder's output, each (B, Se,
    Hkv, hd), no RoPE."""
    B, Se, _ = enc_out.shape
    k = (enc_out @ p.w_k.to(enc_out.dtype)).reshape(B, Se, cfg.n_kv_heads,
                                                   cfg.head_dim)
    v = (enc_out @ p.w_v.to(enc_out.dtype)).reshape(B, Se, cfg.n_kv_heads,
                                                   cfg.head_dim)
    return k, v


def _cross_attend(p: Attention, h, ek, ev, cfg: ModelConfig):
    """h (B, Sq, d) attends to every key of ek/ev (B, Se, Hkv, hd)."""
    B, Sq, _ = h.shape
    q = (h @ p.w_q.to(h.dtype)).reshape(B, Sq, cfg.n_heads, cfg.head_dim)
    o = A.chunked_attention(q, ek.to(h.dtype), ev.to(h.dtype), causal=False)
    return o.reshape(B, Sq, cfg.n_heads * cfg.head_dim) @ p.w_o.to(h.dtype)


def _dec_layer(layer: DecoderLayer, x, enc_out, cfg: ModelConfig):
    """One decoder layer over x (B, S, d).  Returns (x, (k, v) of the
    self-attention, (ek, ev) of the cross-attention)."""
    h = rmsnorm(x, layer.norm1, cfg.norm_eps)
    a, kv = _self_attn(layer.self_attn, h, cfg, causal=True)
    x = x + a
    h = rmsnorm(x, layer.norm3, cfg.norm_eps)
    ek, ev = _enc_kv(layer.cross_attn, enc_out, cfg)
    x = x + _cross_attend(layer.cross_attn, h, ek, ev, cfg)
    h = rmsnorm(x, layer.norm2, cfg.norm_eps)
    return x + mlp(layer.mlp, h, cfg.act), kv, (ek, ev)


def _dec_layer_x(layer, x, enc_out, cfg):
    return _dec_layer(layer, x, enc_out, cfg)[0]


def decode_trunk(model: EncDec, cfg: ModelConfig, tokens, enc_out, *,
                 dtype=torch.bfloat16, remat: bool = True):
    """tokens (B, S) -> the decoder's final hidden states (B, S, d) after
    ``final_norm``.  The embedding is cast to ``dtype`` before the
    gather, as the reference does."""
    x = F.embedding(tokens, model.tok.to(dtype))
    for layer in model.decoder:
        x = (recompute(_dec_layer_x, layer, x, enc_out, cfg) if remat
             else _dec_layer_x(layer, x, enc_out, cfg))
    return rmsnorm(x, model.final_norm, cfg.norm_eps)


# --------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------- #

def forward_hidden(model: EncDec, cfg: ModelConfig, tokens, *, prefix_emb,
                   dtype=torch.bfloat16, remat: bool = True):
    """The decoder's final hidden states over ``tokens`` given the source
    frames ``prefix_emb`` (B, Se, d).  Returns (h, {})."""
    if prefix_emb is None:
        raise ValueError("the enc-dec needs the source embeddings "
                         "(prefix_emb)")
    enc_out = encode(model, cfg, prefix_emb.to(dtype), remat=remat)
    return decode_trunk(model, cfg, tokens, enc_out, dtype=dtype,
                        remat=remat), {}


def loss_fn(model: EncDec, cfg: ModelConfig, batch, *, z_loss: float = 0.0,
            dtype=torch.bfloat16, remat: bool = True):
    """batch: ``src_emb`` (B, Se, d) frames, ``tokens`` and ``labels`` (B,
    S) int64, optional ``mask`` (B, S) float32.  Returns (loss, metrics)
    as the reference: ``loss``, ``ce_loss`` and ``z_sq``."""
    h, _ = forward_hidden(model, cfg, batch["tokens"],
                          prefix_emb=batch["src_emb"], dtype=dtype,
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

def cache_struct(cfg: ModelConfig, batch: int, max_len: int, *,
                 dtype=torch.bfloat16, device="cuda"):
    """Zeroed decode cache, leaves stacked along a leading L: the
    self-attention's full cache {"k", "v"} (L, batch, max_len, Hkv, hd)
    and the cross-attention's {"ek", "ev"} (L, batch, Hkv, Se, hd), Se =
    ``cfg.frontend_tokens``, in the decode kernel's layout."""
    L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    Se = cfg.frontend_tokens

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {"k": z(L, batch, max_len, Hkv, hd),
            "v": z(L, batch, max_len, Hkv, hd),
            "ek": z(L, batch, Hkv, Se, hd), "ev": z(L, batch, Hkv, Se, hd)}


def prefill(model: EncDec, cfg: ModelConfig, tokens, *, prefix_emb,
            cache_len_cap: int):
    """Encode the source frames ``prefix_emb`` (B, Se, d) and run the
    prompt, tokens (B, S), at its exact length.  Returns (logits (B, 1,
    V) float32 at the last position, the cache of ``cache_struct``: the
    prompt's K/V in the first S rows of ``k``/``v``, each layer's
    cross-attention K/V in ``ek``/``ev``)."""
    if prefix_emb is None:
        raise ValueError("the enc-dec's prefill needs the source "
                         "embeddings (prefix_emb)")
    B, S = tokens.shape
    if S > cache_len_cap:
        raise ValueError(f"prompt of {S} tokens exceeds cache_len_cap "
                         f"{cache_len_cap}")
    enc_out = encode(model, cfg, prefix_emb.to(model.dtype), remat=False)
    x = model.tok[tokens]
    data = cache_struct(cfg, B, cache_len_cap, dtype=model.dtype,
                        device=x.device)
    if enc_out.shape[1] != data["ek"].shape[3]:
        raise ValueError(f"{enc_out.shape[1]} source frames; the config "
                         f"takes {cfg.frontend_tokens}")
    for i, layer in enumerate(model.decoder):
        x, (k, v), (ek, ev) = _dec_layer(layer, x, enc_out, cfg)
        data["k"][i, :, :S] = k
        data["v"][i, :, :S] = v
        data["ek"][i] = ek.transpose(1, 2)
        data["ev"][i] = ev.transpose(1, 2)
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    return logits_from_hidden(model, x[:, -1:]), data


def _cross_decode(p: Attention, h, ek, ev, cfg: ModelConfig):
    """One token's cross-attention: h (B, 1, d) against ek/ev (B, Hkv,
    Se, hd) through the ragged decode (every key of every row valid)."""
    B = h.shape[0]
    q = (h @ p.w_q).reshape(B, 1, cfg.n_heads, cfg.head_dim)
    last = torch.full((B,), ek.shape[2] - 1, dtype=torch.int32,
                      device=h.device)
    o = KB.paged_decode_attention(q, ek.transpose(1, 2), ev.transpose(1, 2),
                                  last)
    return o.reshape(B, 1, cfg.n_heads * cfg.head_dim) @ p.w_o


def decode_step(model: EncDec, cfg: ModelConfig, data, cache_len, token):
    """One decode step.  token: (B, 1) int; data: the cache from
    ``prefill`` or ``cache_struct``, its ``k``/``v`` written in place at
    ``cache_len`` (an int or 0-d tensor: every row at one depth).
    Returns (logits (B, 1, V) float32, data)."""
    x = model.tok[token]
    for i, layer in enumerate(model.decoder):
        h = rmsnorm(x, layer.norm1, cfg.norm_eps)
        a, _ = A.decode_attn(
            layer.self_attn, h, {"k": data["k"][i], "v": data["v"][i]},
            cache_len, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta)
        x = x + a
        h = rmsnorm(x, layer.norm3, cfg.norm_eps)
        x = x + _cross_decode(layer.cross_attn, h, data["ek"][i],
                              data["ev"][i], cfg)
        h = rmsnorm(x, layer.norm2, cfg.norm_eps)
        x = x + mlp(layer.mlp, h, cfg.act)
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    return logits_from_hidden(model, x), data
