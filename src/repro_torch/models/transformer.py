"""Dense, MoE and VLM decoder-only transformer
(``repro.models.transformer`` in PyTorch): the training forward and
loss, and serving: the exact-length ``prefill`` into a contiguous cache
(full, or a ring for a sliding window), the ragged bucketed prefill, the
one-token ``decode_step`` and the logits.

The reference stacks its layers along a leading L dim and scans them;
here each layer is a module of a ``ModuleList`` and the loop is Python.
An MoE layer (``arch_type == "moe"``) holds ``models.moe.MoE`` where a
dense one holds its MLP; its aux losses are averaged over the layers in
float32 and added to the training loss, as the reference's scan does.
The VLM (``arch_type == "vlm"``) is the dense decoder behind a
multimodal prefix: ``prefix_emb`` (B, P, d), the stub frontend's
projected patches, goes ahead of the token embeddings in the training
forward (whose loss is taken on the text only) and in both prefills
(whose lengths count the prefix).  The decode steps see text only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models.attention import Attention, attn_forward
from repro_torch.parallel import tp_of
from repro_torch.models.layers import (MLP, P, cross_entropy_chunked,
                                       embed_specs, fsdp_axis, lm_head_matrix,
                                       mlp, mlp_specs, param, recompute,
                                       rmsnorm, trunc_normal_)


class Layer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        # zero-initialised norm scales, used as (1 + scale), in float32
        self.norm1 = param((cfg.d_model,), dtype=torch.float32, device=device)
        self.norm2 = param((cfg.d_model,), dtype=torch.float32, device=device)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, dtype=dtype, device=device)
        if cfg.arch_type == "moe":
            self.moe = M.MoE(cfg, dtype=dtype, device=device)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype=dtype,
                           device=device)


class Transformer(nn.Module):
    """The dense, MoE or VLM decoder's weights.  ``dtype`` is the dtype the matrices
    and the embedding are held in: the compute dtype for serving,
    float32 (master weights) for training.  Norm scales are float32.
    Parameters start uninitialised and frozen; call ``init_weights`` or
    load them with ``weights.from_jax_params``, and ``requires_grad_``
    to train."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        if cfg.arch_type not in ("dense", "moe", "vlm"):
            raise ValueError(
                f"Transformer takes the dense, MoE and VLM families, not "
                f"{cfg.arch_type!r}")
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
            (layer.moe if self.cfg.arch_type == "moe"
             else layer.mlp).init_weights(generator, L)
        return self


Model = Transformer


def param_specs(cfg: ModelConfig, multi_pod: bool = False):
    """The reference's spec tree over its leaf paths (``lead`` is its
    stacked layer dim, which the port's ``ModuleList`` does not have)."""
    f = fsdp_axis(multi_pod)
    layers = {"attn": A.attention_specs(f, lead=(None,)),
              "norm1": P(None, None),
              "norm2": P(None, None)}
    if cfg.arch_type == "moe":
        layers["moe"] = M.moe_specs(f, lead=(None,))
    else:
        layers["mlp"] = mlp_specs(cfg.act, f, lead=(None,))
    return {"embed": embed_specs(cfg.tie_embeddings, f),
            "layers": layers,
            "final_norm": P(None)}


# --------------------------------------------------------------------- #
# training forward and loss
# --------------------------------------------------------------------- #

def ffn(layer: Layer, h, cfg: ModelConfig):
    """The layer's feed-forward block over h (B, S, d): (out, aux), aux
    the MoE's losses ({} for a dense MLP)."""
    if cfg.arch_type == "moe":
        return M.moe_forward(layer.moe, h, cfg)
    return mlp(layer.mlp, h, cfg.act), {}


def _layer(layer: Layer, x, cfg: ModelConfig, tp=None):
    h = rmsnorm(x, layer.norm1, cfg.norm_eps)
    a, _ = attn_forward(layer.attn, h, n_heads=cfg.n_heads,
                        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                        rope_theta=cfg.rope_theta, window=cfg.sliding_window,
                        tp=tp)
    x = x + a
    h = rmsnorm(x, layer.norm2, cfg.norm_eps)
    if cfg.arch_type == "moe":
        f, aux = M.moe_forward(layer.moe, h, cfg)
    else:
        # sub-layer remat, as the reference's: the backward recomputes
        # the MLP apart from attention, so the peak holds one of their
        # interiors (the reference remats no MoE apart)
        f, aux = recompute(mlp, layer.mlp, h, cfg.act, tp), {}
    return x + f, aux


def _embed(model: Transformer, tokens, prefix_emb, dtype, tp=None):
    """The token embeddings in ``dtype`` (the embedding cast before the
    gather, as the reference's), behind ``prefix_emb`` when given.  On a
    mesh the embedding is vocab-parallel: this rank looks up the ids of
    its rows, zeros for the rest, summed over the model group."""
    if tp is None:
        x = F.embedding(tokens, model.tok.to(dtype))
    else:
        W = tp.weight(model.tok, dtype)
        local = tokens - tp.vocab_start(W.shape[0])
        inside = (local >= 0) & (local < W.shape[0])
        x = F.embedding(local.clamp(0, W.shape[0] - 1), W)
        x = tp.from_model(torch.where(inside[..., None], x, 0.0))
    if prefix_emb is None:
        return x
    return torch.cat([prefix_emb.to(dtype), x], dim=1)


def forward_hidden(model: Transformer, cfg: ModelConfig, tokens, *,
                   prefix_emb=None, dtype=torch.bfloat16,
                   remat: bool = True):
    """tokens: (B, S) int, prefix_emb: None or (B, P, d) -> (final hidden
    states (B, P + S, d) in ``dtype``, aux), aux each MoE loss averaged
    over the layers in float32 ({} for the dense family).  The embedding is cast to
    ``dtype`` before the gather, as the reference does;
    ``F.embedding``'s backward sums each row's grads in a fixed order
    (an indexing backward would add them with atomics on the card).
    ``remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``); it changes memory, not the numbers.
    A sliding-window config trains through ``chunked_attention``'s
    autograd, as the reference trains it through XLA.  A model cut to a
    mesh (``parallel.shard``) runs its layers sharded, each weight
    gathered inside the layer's recompute region."""
    M.check_tokens(cfg, tokens.numel())
    tp = tp_of(model)
    x = _embed(model, tokens, prefix_emb, dtype, tp)
    auxs = []
    for layer in model.layers:
        if remat:
            x, aux = recompute(_layer, layer, x, cfg, tp)
        else:
            x, aux = _layer(layer, x, cfg, tp)
        auxs.append(aux)
    aux = {k: torch.stack([a[k].float() for a in auxs]).mean()
           for k in auxs[0]} if auxs else {}
    return rmsnorm(x, model.final_norm, cfg.norm_eps), aux


def loss_fn(model: Transformer, cfg: ModelConfig, batch, *,
            z_loss: float = 0.0, dtype=torch.bfloat16, remat: bool = True):
    """batch: ``tokens`` and ``labels`` (B, S) int64, optional ``mask``
    (B, S) float32 and ``prefix_emb`` (B, P, d) (the VLM's patches; the
    loss is taken on the text only).  Returns (loss, metrics) as the reference: the loss
    and ``ce_loss`` (both with the z-loss term) and ``z_sq``, float32
    scalars; the MoE family adds ``moe_aux_total`` to the loss (not to
    ``ce_loss``) and reports ``lb_loss``, ``rz_loss`` and
    ``frac_dropped``."""
    prefix = batch.get("prefix_emb")
    h, aux = forward_hidden(model, cfg, batch["tokens"], prefix_emb=prefix,
                            dtype=dtype, remat=remat)
    if prefix is not None:
        h = h[:, prefix.shape[1]:]
    labels = batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    tp = tp_of(model)
    W = lm_head_matrix(model) if tp is None else tp.head(model, h.dtype)
    loss, z_sq = cross_entropy_chunked(h, W, labels, mask, cfg.vocab_size,
                                       z_loss=z_loss, tp=tp)
    metrics = {"ce_loss": loss, "z_sq": z_sq}
    if cfg.arch_type == "moe":
        loss = loss + M.moe_aux_total(aux, cfg)
        metrics.update(aux)
    metrics["loss"] = loss
    return loss, metrics


# --------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------- #

def logits_from_hidden(model: Transformer, h):
    """h: (..., d) -> float32 logits over the padded vocab."""
    return (h @ lm_head_matrix(model)).float()


def cache_struct(cfg: ModelConfig, batch: int, max_len: int, *,
                 dtype=torch.bfloat16, device="cuda"):
    """Zeroed contiguous decode cache (the reference's ``_cache_struct``),
    leaves stacked along a leading L dim: a full cache {"k", "v"} (L,
    batch, max_len, Hkv, hd), or for a sliding window a ring of W =
    min(window, max_len) slots, {"k", "v"} (L, batch, W, Hkv, hd) and
    "pos" (L, W) int32, -1 while empty."""
    if cfg.sliding_window is not None:
        one = A.init_ring_cache(batch, min(cfg.sliding_window, max_len),
                                cfg.n_kv_heads, cfg.head_dim, dtype=dtype,
                                device=device)
    else:
        one = A.init_cache(batch, max_len, cfg.n_kv_heads, cfg.head_dim,
                           dtype=dtype, device=device)
    return {n: t.expand(cfg.n_layers, *t.shape).contiguous()
            for n, t in one.items()}


def _prefill_trunk(model: Transformer, cfg: ModelConfig, tokens,
                   window, prefix_emb=None):
    """Every layer over the prompt, behind ``prefix_emb`` when given:
    (final hidden (B, S, d) after the final norm, the layers' K/V lists,
    each (B, S, Hkv, hd)), S counting the prefix."""
    M.check_tokens(cfg, tokens.numel())
    x = model.tok[tokens]
    if prefix_emb is not None:
        x = torch.cat([prefix_emb.to(x.dtype), x], dim=1)
    ks, vs = [], []
    for layer in model.layers:
        h = rmsnorm(x, layer.norm1, cfg.norm_eps)
        a, (k, v) = attn_forward(
            layer.attn, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta, window=window)
        x = x + a
        h = rmsnorm(x, layer.norm2, cfg.norm_eps)
        x = x + ffn(layer, h, cfg)[0]
        ks.append(k)
        vs.append(v)
    return rmsnorm(x, model.final_norm, cfg.norm_eps), ks, vs


def prefill(model: Transformer, cfg: ModelConfig, tokens, *,
            cache_len_cap: int, prefix_emb=None):
    """Run the prompt, tokens (B, S) behind ``prefix_emb`` (B, P, d) when
    given, at its exact length and build the decode cache (S counts the
    prefix from here on).  Returns (logits (B, 1, V) float32 at the last
    position, the cache): a full cache of ``cache_len_cap`` rows whose
    first S hold the prompt's K/V (the rest zeros), or for a sliding
    window a ring of min(window, cache_len_cap) slots
    (``attention.ring_from_prefill``)."""
    B, S = tokens.shape
    if prefix_emb is not None:
        S += prefix_emb.shape[1]
    window = cfg.sliding_window
    if window is None and S > cache_len_cap:
        raise ValueError(f"prompt of {S} tokens exceeds cache_len_cap "
                         f"{cache_len_cap}")
    x, ks, vs = _prefill_trunk(model, cfg, tokens, window, prefix_emb)
    if window is not None:
        W = min(window, cache_len_cap)
        rings = [A.ring_from_prefill(k, v, S, W) for k, v in zip(ks, vs)]
        data = {n: torch.stack([r[n] for r in rings]) for n in rings[0]}
    else:
        data = cache_struct(cfg, B, cache_len_cap, dtype=ks[0].dtype,
                            device=x.device)
        data["k"][:, :, :S] = torch.stack(ks)
        data["v"][:, :, :S] = torch.stack(vs)
    return logits_from_hidden(model, x[:, -1:]), data


def prefill_ragged(model: Transformer, cfg: ModelConfig, tokens, lengths, *,
                   prefix_emb=None):
    """Bucketed prefill: tokens (B, S_bucket) right-padded to a shared
    bucket length behind ``prefix_emb`` (B, P, d) when given, lengths
    (B,) true lengths, the prefix included (as the reference's).
    Causality keeps every real position independent of the padding.

    Returns (logits (B, 1, V) float32 at each request's last real token,
    k, v (L, B, S, Hkv, hd)); rows at positions >= lengths[b] hold
    padding junk that the cache masks: the decode attention reads no key
    past a request's length (the page pool, the Server's full cache)."""
    if cfg.sliding_window is not None:
        raise NotImplementedError(
            "ragged bucketed prefill supports full attention only; "
            "sliding-window (ring-cache) archs keep the exact-length "
            "prefill path")
    x, ks, vs = _prefill_trunk(model, cfg, tokens, None, prefix_emb)
    B, S = x.shape[:2]
    idx = (lengths.long() - 1).clamp(0, S - 1)
    h_last = x[torch.arange(B, device=x.device), idx][:, None]   # (B, 1, d)
    return logits_from_hidden(model, h_last), torch.stack(ks), \
        torch.stack(vs)


def decode_step(model: Transformer, cfg: ModelConfig, data, cache_len,
                token):
    """One decode step.  token: (B, 1) int; data: the layer-stacked cache
    from ``prefill`` or ``cache_struct``, written in place (so a captured
    CUDA graph can replay the step); cache_len: the new token's position,
    a 0-d tensor (or int) for all rows, or (B,) per request (full cache
    only).  Returns (logits (B, 1, V) float32, data)."""
    x = model.tok[token]
    for i, layer in enumerate(model.layers):
        h = rmsnorm(x, layer.norm1, cfg.norm_eps)
        a, _ = A.decode_attn(
            layer.attn, h, {n: t[i] for n, t in data.items()}, cache_len,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
            window=cfg.sliding_window)
        x = x + a
        h = rmsnorm(x, layer.norm2, cfg.norm_eps)
        x = x + ffn(layer, h, cfg)[0]
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    return logits_from_hidden(model, x), data
