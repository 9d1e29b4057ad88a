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
- **Sharded serving** (a model cut to a mesh): the encoder and the
  decoder tensor-parallel as in training; the self-attention's cache and
  ``ek``/``ev`` in the rank's boxes of the reference's
  ``input_shardings`` (``ek``/``ev`` cut on head_dim, or on the frames
  with ``cache_seq_shard``), attended over in place
  (``attention.decode_attn_tp``, ``attention.cross_decode_tp``).

- **The sequence-parallel residual** (a model cut to a mesh, the
  reference's default): the encoder's residual is cut over frames and
  gathered whole before ``enc_norm`` (``encdec.py:115``), so ``enc_out``,
  whole on every model rank, feeds every decoder layer's cross K/V; the
  decoder's residual is cut over tokens and gathered whole before
  ``final_norm`` (``encdec.py:146``).  Each attention and MLP enters on
  the gathered rows and leaves by a reduce-scatter, the cross-attention's
  q as the self-attention's.  ``enc_norm`` and ``final_norm`` see every
  row, so only the layers' norms are partial over ``model``.

The reference scans stacked layers; here each stack is a ``ModuleList``
and the loop is Python.  ``remat`` recomputes each layer in the
backward, as the reference's ``jax.checkpoint`` of its scan body.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import backend as KB
from repro_torch.models import attention as A
from repro_torch.models.attention import Attention, attn_forward
from repro_torch.models.layers import (MLP, P, embed, embed_specs,
                                       fsdp_axis, lm_loss, mlp, mlp_specs,
                                       param, recompute, rmsnorm,
                                       trunc_normal_)
from repro_torch.models.transformer import kv_cut, logits_from_hidden
from repro_torch.parallel import seq_of, tp_of, uneven_heads, weight


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

def _self_attn(p: Attention, h, cfg: ModelConfig, causal: bool, tp=None,
               seq: bool = False):
    return attn_forward(p, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                        causal=causal, tp=tp, seq=seq)


def _enc_layer(layer: EncoderLayer, x, cfg: ModelConfig, tp=None,
               seq: bool = False):
    h = rmsnorm(x, layer.norm1, cfg.norm_eps)
    x = x + _self_attn(layer.attn, h, cfg, causal=False, tp=tp, seq=seq)[0]
    h = rmsnorm(x, layer.norm2, cfg.norm_eps)
    return x + mlp(layer.mlp, h, cfg.act, tp, seq)


def encode(model: EncDec, cfg: ModelConfig, src_emb, *, remat: bool = True,
           seq_shard: bool = True):
    """src_emb (B, Se, d) in the compute dtype -> the encoder's output
    (B, Se, d) after ``enc_norm``.  On a mesh with ``seq_shard`` and
    ``parallel.seq_cut`` of Se the residual is the rank's Se/M frames
    (cut from ``src_emb``, whole on every model rank), gathered whole
    before ``enc_norm``: every consumer of ``enc_out`` passes ``to_model``,
    so that gather's backward only keeps the rank's frames."""
    tp = tp_of(model)
    seq = seq_of(tp, src_emb.shape[1], seq_shard)
    x = src_emb
    if seq:
        n = x.shape[1] // tp.n_model
        x = x[:, tp.model_slice(n)].contiguous()
        tp.note_partial(*(n_ for layer in model.encoder
                          for n_ in (layer.norm1, layer.norm2)))
    for layer in model.encoder:
        x = (recompute(_enc_layer, layer, x, cfg, tp, seq) if remat
             else _enc_layer(layer, x, cfg, tp, seq))
    if seq:
        x = tp.seq_gather(x, whole_grad=True)
    return rmsnorm(x, model.enc_norm, cfg.norm_eps)


def _enc_kv(p: Attention, enc_out, cfg: ModelConfig, tp=None):
    """The cross-attention's K and V of the encoder's output, each (B, Se,
    Hkv, hd), no RoPE.  On a mesh the encoder output, whole on every
    model rank, passes ``to_model`` before the column-parallel K/V, which
    are the KV heads of the rank's query heads."""
    if tp is not None:
        enc_out = tp.to_model(enc_out)
    return A.project_kv(p, enc_out, n_heads=cfg.n_heads,
                        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                        tp=tp)


def _cross_attend(p: Attention, h, ek, ev, cfg: ModelConfig, tp=None,
                  seq: bool = False):
    """h (B, Sq, d) attends to every key of ek/ev (B, Se, Hkv, hd); on a
    mesh with the rank's query heads, ``w_o`` row-parallel; with ``seq``
    h is the rank's rows of the cut residual, gathered on entry, the
    output reduce-scattered back."""
    if tp is not None:
        h = tp.enter(h, seq)
    B, Sq, _ = h.shape
    q = h @ weight(p.w_q, h.dtype, tp)
    ek, ev = ek.to(h.dtype), ev.to(h.dtype)
    uneven = uneven_heads(cfg.n_heads, tp)
    kw = dict(n_heads=cfg.n_heads, head_dim=cfg.head_dim)
    if uneven:
        q, ek, ev = A.rank_heads(tp, q, ek, ev, n_kv_heads=cfg.n_kv_heads,
                                 **kw)
    else:
        q = q.reshape(B, Sq, -1, cfg.head_dim)
    o = A.chunked_attention(q, ek, ev, causal=False).reshape(B, Sq, -1)
    if uneven:
        o = A.rank_cols(tp, o, **kw)
    o = o @ weight(p.w_o, h.dtype, tp)
    return o if tp is None else tp.leave(o, seq)


def _dec_layer(layer: DecoderLayer, x, enc_out, cfg: ModelConfig, tp=None,
               seq: bool = False):
    """One decoder layer over x (B, S, d) (the rank's rows with ``seq``).
    Returns (x, (k, v) of the self-attention, (ek, ev) of the
    cross-attention), K/V over the whole S."""
    h = rmsnorm(x, layer.norm1, cfg.norm_eps)
    a, kv = _self_attn(layer.self_attn, h, cfg, causal=True, tp=tp, seq=seq)
    x = x + a
    h = rmsnorm(x, layer.norm3, cfg.norm_eps)
    ek, ev = _enc_kv(layer.cross_attn, enc_out, cfg, tp)
    x = x + _cross_attend(layer.cross_attn, h, ek, ev, cfg, tp, seq)
    h = rmsnorm(x, layer.norm2, cfg.norm_eps)
    return x + mlp(layer.mlp, h, cfg.act, tp, seq), kv, (ek, ev)


def _dec_layer_x(layer, x, enc_out, cfg, tp=None, seq=False):
    return _dec_layer(layer, x, enc_out, cfg, tp, seq)[0]


def _dec_cut(model: EncDec, tokens, seq_shard: bool) -> bool:
    """Whether the decoder over ``tokens`` cuts its residual, recording
    its layers' norms as partial where it does."""
    tp = tp_of(model)
    seq = seq_of(tp, tokens.shape[1], seq_shard)
    if seq:
        tp.note_partial(*(n for layer in model.decoder
                          for n in (layer.norm1, layer.norm2, layer.norm3)))
    return seq


def decode_trunk(model: EncDec, cfg: ModelConfig, tokens, enc_out, *,
                 dtype=torch.bfloat16, remat: bool = True,
                 seq_shard: bool = True):
    """tokens (B, S) -> the decoder's final hidden states (B, S, d) after
    ``final_norm``.  The embedding is cast to ``dtype`` before the
    gather, as the reference does (vocab-parallel on a mesh).  With
    ``seq_shard`` and ``parallel.seq_cut`` of S the residual is cut over
    tokens and gathered whole before ``final_norm`` (whose grads are then
    whole, the head's ``to_model`` summing them: the gather's backward
    only keeps the rank's rows)."""
    tp = tp_of(model)
    seq = _dec_cut(model, tokens, seq_shard)
    x = embed(model, tokens, dtype, tp, seq)
    for layer in model.decoder:
        x = (recompute(_dec_layer_x, layer, x, enc_out, cfg, tp, seq)
             if remat else _dec_layer_x(layer, x, enc_out, cfg, tp, seq))
    if seq:
        x = tp.seq_gather(x, whole_grad=True)
    return rmsnorm(x, model.final_norm, cfg.norm_eps)


# --------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------- #

def forward_hidden(model: EncDec, cfg: ModelConfig, tokens, *, prefix_emb,
                   dtype=torch.bfloat16, remat: bool = True,
                   seq_shard: bool = True):
    """The decoder's final hidden states over ``tokens`` given the source
    frames ``prefix_emb`` (B, Se, d).  Returns (h, {}).  On a mesh
    (``parallel.shard``) both stacks run tensor-parallel, the frames
    this data slot's rows, each residual cut by ``seq_shard``."""
    if prefix_emb is None:
        raise ValueError("the enc-dec needs the source embeddings "
                         "(prefix_emb)")
    enc_out = encode(model, cfg, prefix_emb.to(dtype), remat=remat,
                     seq_shard=seq_shard)
    return decode_trunk(model, cfg, tokens, enc_out, dtype=dtype,
                        remat=remat, seq_shard=seq_shard), {}


def loss_fn(model: EncDec, cfg: ModelConfig, batch, *, z_loss: float = 0.0,
            dtype=torch.bfloat16, remat: bool = True,
            seq_shard: bool = True):
    """batch: ``src_emb`` (B, Se, d) frames, ``tokens`` and ``labels`` (B,
    S) int64, optional ``mask`` (B, S) float32.  Returns (loss, metrics)
    as the reference: ``loss``, ``ce_loss`` and ``z_sq``.  ``seq_shard``
    as in ``forward_hidden``; ``registry.loss_fn`` passes none, as the
    reference's ``loss_fn`` (``encdec.py:150``) swallows it in ``**_``,
    so training through the registry always cuts."""
    h, _ = forward_hidden(model, cfg, batch["tokens"],
                          prefix_emb=batch["src_emb"], dtype=dtype,
                          remat=remat, seq_shard=seq_shard)
    loss, z_sq = lm_loss(model, cfg, h, batch, z_loss, tp_of(model))
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


# the cache's cross-attention K/V leaves
CROSS_KV = ("ek", "ev")


def _cross_cut(layout):
    """(dim, start, stop) of the cross K/V's cut over 'model' in the
    reference's (B, Se, Hkv, hd) order of a layer (1: the frames, 3:
    head_dim), the order of every other family's K/V."""
    cut = layout.layer_cut("ek")
    if cut is None:
        raise NotImplementedError(
            f"a cross-attention cache cut {layout.specs['ek']}: the port "
            f"serves the head_dim cut and the frame cut")
    return {2: 1, 3: 3}[cut[0]], cut[1], cut[2]


def _prefill_tp(model: EncDec, cfg: ModelConfig, tokens, enc_out, layout,
                seq_shard: bool = True):
    """``prefill`` on a mesh: the rank's rows, the encoder's output
    ``enc_out`` (the encoder run tensor-parallel, as in training); each
    decoder layer tensor-parallel, its self-attention's K/V placed in
    the full cache and cut to its box, its cross-attention's K/V cut to
    theirs (``attention.kv_to_box`` in the reference's (B, Se, Hkv, hd)
    order, then transposed to the port's).  With ``seq_shard`` the
    decoder's residual is cut along the sequence wherever
    ``parallel.seq_cut`` holds, as the reference's prefill cuts it
    (``encdec.py:203``); the last position's hidden then comes from the
    last model rank
    (``TensorParallel.last_row``).  Returns (the rank's vocab columns of
    the last position's logits (B, 1, V/M) float32, the rank's cache
    blocks)."""
    tp = model.tp
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads)
    dim, e_dim = kv_cut(layout)[0], _cross_cut(layout)[0]
    seq = _dec_cut(model, tokens, seq_shard)
    x = embed(model, tokens, model.dtype, tp, seq)
    layers = []
    for layer in model.decoder:
        x, kv, ekv = _dec_layer(layer, x, enc_out, cfg, tp, seq)
        c = A.cache_to_box(tp, *kv, slots=layout.shapes["k"][2], ring=False,
                           dim=dim, **kw)
        for n, t in zip(CROSS_KV, ekv):
            c[n] = A.kv_to_box(tp, t, dim=e_dim, **kw).transpose(
                1, 2).contiguous()
        layers.append(c)
    data = {n: torch.stack([c[n] for c in layers]) for n in layers[0]}
    x = rmsnorm(tp.last_row(x, seq), model.final_norm, cfg.norm_eps)
    return (x @ tp.head(model, x.dtype)).float(), data


def prefill(model: EncDec, cfg: ModelConfig, tokens, *, prefix_emb,
            cache_len_cap: int, layout=None, seq_shard: bool = True):
    """Encode the source frames ``prefix_emb`` (B, Se, d) and run the
    prompt, tokens (B, S), at its exact length.  Returns (logits (B, 1,
    V) float32 at the last position, the cache of ``cache_struct``: the
    prompt's K/V in the first S rows of ``k``/``v``, each layer's
    cross-attention K/V in ``ek``/``ev``).  On a mesh (``layout``, the
    cache's ``parallel.CacheLayout``) see ``_prefill_tp``: with
    ``seq_shard`` the encoder's and the decoder's residuals are cut
    wherever ``parallel.seq_cut`` holds.  ``registry.prefill`` passes no
    ``seq_shard`` here, as the reference's ``prefill`` takes none
    (``encdec.py:194``), so serving through the registry always cuts."""
    if prefix_emb is None:
        raise ValueError("the enc-dec's prefill needs the source "
                         "embeddings (prefix_emb)")
    B, S = tokens.shape
    if S > cache_len_cap:
        raise ValueError(f"prompt of {S} tokens exceeds cache_len_cap "
                         f"{cache_len_cap}")
    if prefix_emb.shape[1] != cfg.frontend_tokens:
        raise ValueError(f"{prefix_emb.shape[1]} source frames; the config "
                         f"takes {cfg.frontend_tokens}")
    enc_out = encode(model, cfg, prefix_emb.to(model.dtype), remat=False,
                     seq_shard=seq_shard)
    if layout is not None:
        return _prefill_tp(model, cfg, tokens, enc_out, layout, seq_shard)
    x = model.tok[tokens]
    data = cache_struct(cfg, B, cache_len_cap, dtype=model.dtype,
                        device=x.device)
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


def _decode_tp(model: EncDec, cfg: ModelConfig, data, cache_len, token,
               layout):
    """``decode_step`` on a mesh: the rank's rows; the self-attention over
    its blocks of ``k``/``v``, written in place (``attention.
    decode_attn_tp``), the cross-attention over its blocks of
    ``ek``/``ev`` (``attention.cross_decode_tp``); the rank's vocab
    columns of the logits."""
    tp = model.tp
    cut, e_cut = kv_cut(layout), _cross_cut(layout)
    kw = dict(n_heads=cfg.n_heads, head_dim=cfg.head_dim, tp=tp)
    x = embed(model, token, model.dtype, tp)
    for i, layer in enumerate(model.decoder):
        h = rmsnorm(x, layer.norm1, cfg.norm_eps)
        a, _ = A.decode_attn_tp(
            layer.self_attn, h, {"k": data["k"][i], "v": data["v"][i]},
            cache_len, n_kv_heads=cfg.n_kv_heads, rope_theta=cfg.rope_theta,
            window=None, cut=cut, seq_len=layout.shapes["k"][2], **kw)
        x = x + a
        h = rmsnorm(x, layer.norm3, cfg.norm_eps)
        x = x + A.cross_decode_tp(layer.cross_attn, h, data["ek"][i],
                                  data["ev"][i], cut=e_cut,
                                  frames=cfg.frontend_tokens, **kw)
        h = rmsnorm(x, layer.norm2, cfg.norm_eps)
        x = x + mlp(layer.mlp, h, cfg.act, tp)
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    return (x @ tp.head(model, x.dtype)).float(), data


def decode_step(model: EncDec, cfg: ModelConfig, data, cache_len, token,
                layout=None):
    """One decode step.  token: (B, 1) int; data: the cache from
    ``prefill`` or ``cache_struct``, its ``k``/``v`` written in place at
    ``cache_len`` (an int or 0-d tensor: every row at one depth).
    Returns (logits (B, 1, V) float32, data).  On a mesh (``layout``)
    the rows, the cache blocks and the logits are the rank's
    (``_decode_tp``)."""
    if layout is not None:
        return _decode_tp(model, cfg, data, cache_len, token, layout)
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
