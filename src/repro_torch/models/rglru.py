"""RecurrentGemma / Griffin hybrid (arXiv:2402.19427) in PyTorch
(``repro.models.rglru``): RG-LRU recurrent blocks and local
sliding-window attention in a 2:1 pattern, each followed by an MLP; the
training forward and loss, the exact-length prefill and the one-token
decode step.

- **The RG-LRU.**  h_t = a_t·h_{t−1} + sqrt(1 − a_t²)·(i_t ⊙ y_t),
  a_t = exp(−c·softplus(λ)·r_t).  The gates run in float32 in PyTorch (autograd
  differentiates them) around ``kernels.backend.rglru_scan``, the linear
  recurrence: the scan kernel and its reverse-sweep backward on the card,
  the reference's chunked scan on the CPU.  Decode is the O(1) step
  ``rglru_step``.
- **The attention layers** run ``attention.attn_forward`` with the
  config's window, so they go through ``chunked_attention`` on both
  devices, as the reference's do; they decode from a ring of
  min(window, max_len) slots through the ragged decode kernel.
- **Layers.**  The reference scans its (recurrent, recurrent, attention)
  groups with their weights stacked along a leading dim and unrolls the
  remainder (38 = 12·3 + 2); here every layer is a module of one
  ``ModuleList`` in network order (the reference's ``_iter_layers``), and
  ``weights`` maps layer i to ``groups/slot{i mod 3}`` at group i // 3, or
  to ``rem{r}``.
- **The decode cache** is a list of per-layer dicts: a recurrent layer's
  {"conv": its last conv1d_width − 1 inputs, "h": the float32 state}, an
  attention layer's ring {"k", "v", "pos"}.  ``decode_step`` writes every
  one in place, so a captured CUDA graph replays it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import HybridConfig, ModelConfig, _pattern
from repro_torch.kernels import backend as KB
from repro_torch.models import attention as A
from repro_torch.models.attention import Attention, attn_forward
from repro_torch.models.layers import (MLP, P, act_fn, cross_entropy_chunked,
                                       embed_specs, fsdp_axis, lm_head_matrix,
                                       mlp, mlp_specs, out_std, param,
                                       recompute, rmsnorm, trunc_normal_)
from repro_torch.models.mamba2 import causal_conv1d
from repro_torch.models.transformer import logits_from_hidden

LRU_C = 8.0


def _hybrid(cfg: ModelConfig):
    """(the hybrid config, the LRU width)."""
    h = cfg.hybrid or HybridConfig()
    return h, h.lru_width or cfg.d_model


def kinds(cfg: ModelConfig):
    """Each layer's kind, ``"recurrent"`` or ``"attention"``, in network
    order."""
    return _pattern(cfg, cfg.n_layers)


def groups(cfg: ModelConfig):
    """(pattern, full groups, remainder kinds): the reference's layout,
    n_full scanned groups of the pattern then the rest unrolled."""
    pat = (cfg.hybrid or HybridConfig()).pattern
    n_full = cfg.n_layers // len(pat)
    return pat, n_full, list(kinds(cfg))[n_full * len(pat):]


# --------------------------------------------------------------------- #
# the RG-LRU core
# --------------------------------------------------------------------- #

def _gates(r, lam):
    """a_t = exp(−c·softplus(λ)·r_t) in float32."""
    return torch.exp(-LRU_C * F.softplus(lam.float()) * r.float())


def _input(a, i, y):
    """sqrt(max(1 − a², 1e-12))·(i ⊙ y) in float32."""
    return torch.sqrt(torch.clamp_min(1.0 - a.square(), 1e-12)) \
        * (i.float() * y.float())


def rglru_scan(y, r, i, lam, h0=None):
    """y, r, i: (B, S, W); lam: (W,).  h_t = a_t·h_{t−1} + sqrt(1 −
    a_t²)·(i_t ⊙ y_t) from h0 (B, W) float32, or zeros.  The gates in
    float32, the recurrence through ``kernels.backend.rglru_scan``.
    Returns (hs (B, S, W) in y's dtype, h_last (B, W) float32)."""
    a = _gates(r, lam)
    hs, h_last = KB.rglru_scan(a, _input(a, i, y), h0)
    return hs.to(y.dtype), h_last


def rglru_step(h, y, r, i, lam):
    """One step.  h: (B, W) float32; y, r, i: (B, W).  Returns (h' in
    y's dtype, h' float32)."""
    a = _gates(r, lam)
    h = a * h.float() + _input(a, i, y)
    return h.to(y.dtype), h


# --------------------------------------------------------------------- #
# modules and init
# --------------------------------------------------------------------- #

class Recurrent(nn.Module):
    """The recurrent block's weights in the reference's layout: the input
    projections ``w_gate``, ``w_x`` (d, W), the depthwise causal conv
    ``conv_w`` (K, W) and ``conv_b`` (W,), the gates' ``w_r``, ``w_i``
    (W, W), the output projection ``w_out`` (W, d), in the model's
    dtype; the recurrence parameter ``lam`` (W,) in float32."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        h, w = _hybrid(cfg)
        d = cfg.d_model
        self.w_gate = param((d, w), dtype=dtype, device=device)
        self.w_x = param((d, w), dtype=dtype, device=device)
        self.conv_w = param((h.conv1d_width, w), dtype=dtype, device=device)
        self.conv_b = param((w,), dtype=dtype, device=device)
        self.w_r = param((w, w), dtype=dtype, device=device)
        self.w_i = param((w, w), dtype=dtype, device=device)
        self.lam = param((w,), dtype=torch.float32, device=device)
        self.w_out = param((w, d), dtype=dtype, device=device)

    def init_weights(self, generator: torch.Generator, n_layers: int):
        """The reference's rules: dense std 0.02, ``w_out`` the
        depth-scaled out std, ``conv_w`` std 0.2, zero ``conv_b``, and
        ``lam`` the inverse softplus of linspace(0.1, 0.5, W)."""
        for w in (self.w_gate, self.w_x, self.w_r, self.w_i):
            trunc_normal_(w, 0.02, generator)
        trunc_normal_(self.conv_w, 0.2, generator)
        self.conv_b.data.zero_()
        W = self.lam.shape[0]
        self.lam.data.copy_(torch.log(torch.expm1(torch.linspace(
            0.1, 0.5, W, dtype=torch.float32, device=self.lam.device))))
        trunc_normal_(self.w_out, out_std(n_layers), generator)


class Layer(nn.Module):
    """One layer: ``norm1`` (float32), ``temporal`` (``Recurrent`` or
    ``attention.Attention``), ``norm2`` (float32) and a GeLU ``mlp``."""

    def __init__(self, kind: str, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.kind = kind
        self.norm1 = param((cfg.d_model,), dtype=torch.float32, device=device)
        self.norm2 = param((cfg.d_model,), dtype=torch.float32, device=device)
        self.temporal = (
            Recurrent(cfg, dtype=dtype, device=device) if kind == "recurrent"
            else Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim, dtype=dtype, device=device))
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype=dtype,
                       device=device)


class Hybrid(nn.Module):
    """The hybrid LM's weights: the embedding (tied as the head unless the
    config unties it), one ``Layer`` per layer in network order, the
    final norm.  ``dtype`` is the dtype of the matrices, the conv and the
    embedding (float32 master weights for training); the norm scales and
    ``lam`` are float32.  Parameters start uninitialised and frozen; call
    ``init_weights`` or load them with ``weights.from_jax_params``, and
    ``requires_grad_`` to train."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        if cfg.arch_type != "hybrid":
            raise ValueError(f"Hybrid is the hybrid family, got "
                             f"{cfg.arch_type!r}")
        self.cfg = cfg
        d, V = cfg.d_model, cfg.padded_vocab
        self.tok = param((V, d), dtype=dtype, device=device)
        self.lm_head = (None if cfg.tie_embeddings
                        else param((d, V), dtype=dtype, device=device))
        self.final_norm = param((d,), dtype=torch.float32, device=device)
        self.layers = nn.ModuleList(
            Layer(kind, cfg, dtype=dtype, device=device)
            for kind in kinds(cfg))

    @property
    def dtype(self) -> torch.dtype:
        return self.tok.dtype

    @property
    def device(self) -> torch.device:
        return self.tok.device

    def init_weights(self, generator: torch.Generator) -> "Hybrid":
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
            layer.temporal.init_weights(generator, L)
            layer.mlp.init_weights(generator, L)
        return self


Model = Hybrid


def recurrent_specs(fsdp, lead: tuple = ()):
    return {"w_gate": P(*lead, fsdp, "model"),
            "w_x": P(*lead, fsdp, "model"),
            "conv_w": P(*lead, None, "model"),
            "conv_b": P(*lead, "model"),
            "w_r": P(*lead, fsdp, "model"),
            "w_i": P(*lead, fsdp, "model"),
            "lam": P(*lead, "model"),
            "w_out": P(*lead, "model", fsdp)}


def _layer_specs(kind: str, cfg: ModelConfig, fsdp, lead: tuple = ()):
    t = (recurrent_specs(fsdp, lead) if kind == "recurrent"
         else A.attention_specs(fsdp, lead))
    return {"temporal": t,
            "mlp": mlp_specs(cfg.act, fsdp, lead),
            "norm1": P(*lead, None), "norm2": P(*lead, None)}


def param_specs(cfg: ModelConfig, multi_pod: bool = False):
    """The reference's spec tree: the full groups' slots stacked (a
    leading group dim), the remainder's layers unstacked."""
    f = fsdp_axis(multi_pod)
    pat, n_full, rem = groups(cfg)
    p = {"embed": embed_specs(cfg.tie_embeddings, f),
         "final_norm": P(None)}
    if n_full:
        p["groups"] = {f"slot{j}": _layer_specs(pat[j], cfg, f, lead=(None,))
                       for j in range(len(pat))}
    for r, kind in enumerate(rem):
        p[f"rem{r}"] = _layer_specs(kind, cfg, f)
    return p


# --------------------------------------------------------------------- #
# the recurrent block
# --------------------------------------------------------------------- #

def recurrent_forward(m: Recurrent, x, cfg: ModelConfig, *,
                      with_state: bool = False):
    """x: (B, S, d) -> (B, S, d).  With ``with_state`` also the state a
    decode step continues from: {"conv": the last conv1d_width − 1 conv
    inputs (B, K − 1, W), "h": the final state (B, W) float32}.

    The reference keeps ``y[:, -(K-1):]`` as the conv state, fewer rows
    than that for a prompt shorter than K − 1 (its first decode step
    then fails at S = 1 and 2, ROADMAP Queue 3).  Here the missing rows
    are zeros, the padding the causal conv reads there."""
    h_cfg, _ = _hybrid(cfg)
    gelu = act_fn("gelu")
    gate = gelu(x @ m.w_gate.to(x.dtype))
    y_in = x @ m.w_x.to(x.dtype)
    y = causal_conv1d(y_in, m.conv_w, m.conv_b)
    r = torch.sigmoid(y @ m.w_r.to(x.dtype))
    i = torch.sigmoid(y @ m.w_i.to(x.dtype))
    hs, h_last = rglru_scan(y, r, i, m.lam)
    out = (gate * hs) @ m.w_out.to(x.dtype)
    if not with_state:
        return out
    K = h_cfg.conv1d_width
    tail = F.pad(y_in, (0, 0, K - 1, 0))[:, -(K - 1):]
    return out, {"conv": tail, "h": h_last}


def recurrent_decode(m: Recurrent, x, state, cfg: ModelConfig):
    """One token through the block.  x: (B, 1, d); state: {"conv": (B,
    K − 1, W) in x's dtype, "h": (B, W) float32}, both written in place.
    The conv sums its K products in x's dtype in the order i = 0..K−1, as
    ``causal_conv1d`` does.  Returns out (B, 1, d)."""
    gelu = act_fn("gelu")
    xt = x[:, 0]
    gate = gelu(xt @ m.w_gate.to(x.dtype))
    buf = torch.cat([state["conv"], (xt @ m.w_x.to(x.dtype))[:, None]],
                    dim=1)
    w = m.conv_w.to(x.dtype)
    y = buf[:, 0] * w[0]
    for k in range(1, w.shape[0]):
        y = y + buf[:, k] * w[k]
    y = y + m.conv_b.to(x.dtype)
    r = torch.sigmoid(y @ m.w_r.to(x.dtype))
    i = torch.sigmoid(y @ m.w_i.to(x.dtype))
    h, h32 = rglru_step(state["h"], y, r, i, m.lam)
    state["conv"].copy_(buf[:, 1:])
    state["h"].copy_(h32)
    return ((gate * h) @ m.w_out.to(x.dtype))[:, None]


# --------------------------------------------------------------------- #
# layers and the loss
# --------------------------------------------------------------------- #

def _attention(layer: Layer, h, cfg: ModelConfig):
    h_cfg, _ = _hybrid(cfg)
    return attn_forward(layer.temporal, h, n_heads=cfg.n_heads,
                        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                        rope_theta=cfg.rope_theta,
                        window=h_cfg.local_window)


def _layer(layer: Layer, x, cfg: ModelConfig):
    h = rmsnorm(x, layer.norm1, cfg.norm_eps)
    if layer.kind == "recurrent":
        t = recurrent_forward(layer.temporal, h, cfg)
    else:
        t, _ = _attention(layer, h, cfg)
    x = x + t
    return x + mlp(layer.mlp, rmsnorm(x, layer.norm2, cfg.norm_eps),
                   cfg.act)


def forward_hidden(model: Hybrid, cfg: ModelConfig, tokens, *,
                   dtype=torch.bfloat16, remat: bool = True):
    """tokens: (B, S) int -> final hidden states (B, S, d) in ``dtype``.
    The embedding is cast to ``dtype`` before the gather, as the
    reference does.  ``remat`` recomputes each layer in the backward
    (the reference's nested per-layer ``jax.checkpoint``); it changes
    memory, not the numbers."""
    x = F.embedding(tokens, model.tok.to(dtype))
    for layer in model.layers:
        x = recompute(_layer, layer, x, cfg) if remat else \
            _layer(layer, x, cfg)
    return rmsnorm(x, model.final_norm, cfg.norm_eps)


def loss_fn(model: Hybrid, cfg: ModelConfig, batch, *, z_loss: float = 0.0,
            dtype=torch.bfloat16, remat: bool = True):
    """batch: ``tokens`` and ``labels`` (B, S) int64, optional ``mask``
    (B, S) float32.  Returns (loss, metrics) as the reference: the loss
    and ``ce_loss`` (both with the z-loss term) and ``z_sq``."""
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
# serving: per-layer heterogeneous caches
# --------------------------------------------------------------------- #

def cache_struct(cfg: ModelConfig, batch: int, max_len: int, *,
                 dtype=torch.bfloat16, device="cuda"):
    """Zeroed decode cache (the reference's ``_cache_struct``): a list in
    network order, {"conv": (batch, K − 1, W) in ``dtype``, "h": (batch,
    W) float32} for a recurrent layer and a ring of min(window, max_len)
    slots for an attention layer."""
    h_cfg, w = _hybrid(cfg)
    caches = []
    for kind in kinds(cfg):
        if kind == "recurrent":
            caches.append({
                "conv": torch.zeros(batch, h_cfg.conv1d_width - 1, w,
                                    dtype=dtype, device=device),
                "h": torch.zeros(batch, w, dtype=torch.float32,
                                 device=device)})
        else:
            caches.append(A.init_ring_cache(
                batch, min(h_cfg.local_window, max_len), cfg.n_kv_heads,
                cfg.head_dim, dtype=dtype, device=device))
    return caches


def prefill(model: Hybrid, cfg: ModelConfig, tokens, *, cache_len_cap: int):
    """Run the prompt, tokens (B, S), at its exact length in the model's
    dtype.  Returns (logits (B, 1, V) float32 at the last position, the
    cache: ``cache_struct``'s list, each ring of min(window,
    cache_len_cap) slots built by ``attention.ring_from_prefill``)."""
    h_cfg, _ = _hybrid(cfg)
    S = tokens.shape[1]
    W = min(h_cfg.local_window, cache_len_cap)
    x = model.tok[tokens]
    caches = []
    for layer in model.layers:
        h = rmsnorm(x, layer.norm1, cfg.norm_eps)
        if layer.kind == "recurrent":
            t, st = recurrent_forward(layer.temporal, h, cfg,
                                      with_state=True)
            caches.append(st)
        else:
            t, (k, v) = _attention(layer, h, cfg)
            caches.append(A.ring_from_prefill(k, v, S, W))
        x = x + t
        x = x + mlp(layer.mlp, rmsnorm(x, layer.norm2, cfg.norm_eps),
                    cfg.act)
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    return logits_from_hidden(model, x[:, -1:]), caches


def decode_step(model: Hybrid, cfg: ModelConfig, cache, cache_len, token):
    """One decode step for every row at one depth.  token: (B, 1) int;
    cache: the list from ``prefill`` or ``cache_struct``, written in
    place; cache_len: the new token's position (an int or a 0-d tensor;
    the rings' rows share one ``pos``).  Returns (logits (B, 1, V)
    float32, cache)."""
    h_cfg, _ = _hybrid(cfg)
    x = model.tok[token]
    for layer, cl in zip(model.layers, cache):
        h = rmsnorm(x, layer.norm1, cfg.norm_eps)
        if layer.kind == "recurrent":
            t = recurrent_decode(layer.temporal, h, cl, cfg)
        else:
            t, _ = A.decode_attn(
                layer.temporal, h, cl, cache_len, n_heads=cfg.n_heads,
                n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                rope_theta=cfg.rope_theta, window=h_cfg.local_window)
        x = x + t
        x = x + mlp(layer.mlp, rmsnorm(x, layer.norm2, cfg.norm_eps),
                    cfg.act)
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    return logits_from_hidden(model, x), cache

