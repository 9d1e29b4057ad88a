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

On a data × model mesh the training forward and the prefill run the
reference's sequence-parallel residual by default (``seq_shard=True``,
``parallel.seq_cut``): the residual between blocks is the rank's S/M
rows, each block gathers them on entry and reduce-scatters its output,
the final norm runs on the cut rows and the hiddens are gathered whole
before the head.  ``remat_policy="dots"`` keeps the products' outputs
under remat (``layers.recompute``).

A model cut to a data × model mesh (``parallel.shard`` or
``registry.init_model(mesh=)``) serves sharded: ``prefill`` and
``decode_step`` take the rank's rows, run the training path's
tensor-parallel layers (vocab-parallel embedding, column- and
row-parallel products, expert-parallel MoE) without remat, return the
rank's vocab columns of the logits, and keep the cache in the rank's
boxes of the reference's ``input_shardings`` (``parallel.CacheLayout``):
the prompt's K/V are re-cut to them once per prefill, and decode attends
over them in place (``attention.decode_attn_tp``).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models.attention import Attention, attn_forward
from repro_torch.parallel import seq_of, tp_of
from repro_torch.models.layers import (MLP, P, embed, embed_specs,
                                       fsdp_axis, lm_head_matrix, lm_loss,
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

def ffn(layer: Layer, h, cfg: ModelConfig, tp=None, n_slots=None,
        seq: bool = False):
    """The layer's feed-forward block over h (B, S, d): (out, aux), aux
    the MoE's losses ({} for a dense MLP); on a mesh (``tp``) tensor- or
    expert-parallel, the batch cut into ``n_slots`` data slots, h the
    rank's rows of the cut residual with ``seq``."""
    if cfg.arch_type == "moe":
        return M.moe_forward(layer.moe, h, cfg, tp=tp, n_slots=n_slots,
                             seq=seq)
    return mlp(layer.mlp, h, cfg.act, tp, seq), {}


def _layer(layer: Layer, x, cfg: ModelConfig, tp=None, seq: bool = False):
    h = rmsnorm(x, layer.norm1, cfg.norm_eps)
    a, _ = attn_forward(layer.attn, h, n_heads=cfg.n_heads,
                        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                        rope_theta=cfg.rope_theta, window=cfg.sliding_window,
                        tp=tp, seq=seq)
    x = x + a
    h = rmsnorm(x, layer.norm2, cfg.norm_eps)
    if cfg.arch_type == "moe":
        f, aux = M.moe_forward(layer.moe, h, cfg, tp=tp, seq=seq)
    else:
        # sub-layer remat, as the reference's: the backward recomputes
        # the MLP apart from attention, so the peak holds one of their
        # interiors (the reference remats no MoE apart)
        f, aux = recompute(mlp, layer.mlp, h, cfg.act, tp, seq), {}
    return x + f, aux


def _embed(model: Transformer, tokens, prefix_emb, dtype, tp=None,
           seq: bool = False):
    """The token embeddings in ``dtype`` (``layers.embed``: vocab-parallel
    on a mesh), behind ``prefix_emb`` when given (its rows this data
    slot's, whole on every model rank); with ``seq`` the rank's rows of
    the cut residual, the prefix counted in S."""
    if seq:
        return embed(model, tokens, dtype, tp, seq=True, prefix=prefix_emb)
    x = embed(model, tokens, dtype, tp)
    if prefix_emb is None:
        return x
    return torch.cat([prefix_emb.to(dtype), x], dim=1)


def _seq(model: Transformer, tokens, prefix_emb, seq_shard: bool) -> bool:
    """Whether the forward over ``tokens`` behind ``prefix_emb`` cuts the
    residual (``parallel.seq_of``: S counts the prefix)."""
    S = tokens.shape[1] + (0 if prefix_emb is None else prefix_emb.shape[1])
    return seq_of(tp_of(model), S, seq_shard)


def forward_hidden(model: Transformer, cfg: ModelConfig, tokens, *,
                   prefix_emb=None, dtype=torch.bfloat16,
                   remat: bool = True, seq_shard: bool = True,
                   remat_policy: str = ""):
    """tokens: (B, S) int, prefix_emb: None or (B, P, d) -> (final hidden
    states (B, P + S, d) in ``dtype``, aux), aux each MoE loss averaged
    over the layers in float32 ({} for the dense family).  The embedding is cast to
    ``dtype`` before the gather, as the reference does;
    ``F.embedding``'s backward sums each row's grads in a fixed order
    (an indexing backward would add them with atomics on the card).
    ``remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``); it changes memory, not the numbers;
    ``remat_policy="dots"`` keeps the products' outputs
    (``layers.recompute``).
    A sliding-window config trains through ``chunked_attention``'s
    autograd, as the reference trains it through XLA.  A model cut to a
    mesh (``parallel.shard``) runs its layers sharded, each weight
    gathered inside the layer's recompute region; with ``seq_shard``
    (the reference's default) and ``parallel.seq_cut`` of P + S the
    residual is cut along the sequence (the module's docstring): the
    norms run on the rank's rows (their scales recorded as partial,
    ``TensorParallel.note_partial``, the final norm's too, as the
    reference norms the cut residual, ``transformer.py:142``) and the
    final hiddens are gathered whole."""
    tp = tp_of(model)
    M.check_tokens(cfg, tokens.numel(), n_slots=1 if tp is None
                   else tp.n_fsdp)
    seq = _seq(model, tokens, prefix_emb, seq_shard)
    x = _embed(model, tokens, prefix_emb, dtype, tp, seq)
    if seq:
        tp.note_partial(model.final_norm, *(n for layer in model.layers
                                            for n in (layer.norm1,
                                                      layer.norm2)))
    auxs = []
    for layer in model.layers:
        if remat:
            x, aux = recompute(_layer, layer, x, cfg, tp, seq,
                               policy=remat_policy)
        else:
            x, aux = _layer(layer, x, cfg, tp, seq)
        auxs.append(aux)
    aux = {k: torch.stack([a[k].float() for a in auxs]).mean()
           for k in auxs[0]} if auxs else {}
    h = rmsnorm(x, model.final_norm, cfg.norm_eps)
    return (tp.seq_gather(h) if seq else h), aux


def loss_fn(model: Transformer, cfg: ModelConfig, batch, *,
            z_loss: float = 0.0, dtype=torch.bfloat16, remat: bool = True,
            seq_shard: bool = True, remat_policy: str = ""):
    """batch: ``tokens`` and ``labels`` (B, S) int64, optional ``mask``
    (B, S) float32 and ``prefix_emb`` (B, P, d) (the VLM's patches; the
    loss is taken on the text only).  Returns (loss, metrics) as the reference: the loss
    and ``ce_loss`` (both with the z-loss term) and ``z_sq``, float32
    scalars; the MoE family adds ``moe_aux_total`` to the loss (not to
    ``ce_loss``) and reports ``lb_loss``, ``rz_loss`` and
    ``frac_dropped``.  ``seq_shard`` and ``remat_policy`` as in
    ``forward_hidden``: the transformer family honours both, as the
    reference's (``transformer.py:148``)."""
    prefix = batch.get("prefix_emb")
    h, aux = forward_hidden(model, cfg, batch["tokens"], prefix_emb=prefix,
                            dtype=dtype, remat=remat, seq_shard=seq_shard,
                            remat_policy=remat_policy)
    if prefix is not None:
        h = h[:, prefix.shape[1]:]
    loss, z_sq = lm_loss(model, cfg, h, batch, z_loss, tp_of(model),
                         gathered=_seq(model, batch["tokens"], prefix,
                                       seq_shard))
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


def kv_cut(layout):
    """(dim, start, stop) of a layer's K/V cut over 'model' (its (B, S,
    Hkv, hd) dims) from the cache's layout."""
    cut = layout.layer_cut("k")
    if cut is None or cut[0] not in (1, 3):
        raise NotImplementedError(
            f"a decode cache cut {layout.specs['k']}: the port serves the "
            f"head_dim cut and the sequence cut")
    return cut


def _slots(cfg: ModelConfig, layout, tokens) -> int:
    """The data slots the batch is cut into (1 where it is replicated);
    an MoE's tokens must split into whole routing groups over them."""
    n = layout.batch // tokens.shape[0]
    M.check_tokens(cfg, tokens.numel(), n_slots=n)
    return n


def _prefill_tp(model: Transformer, cfg: ModelConfig, tokens, *,
                prefix_emb, layout, seq_shard: bool = True):
    """``prefill`` on a mesh: the rank's rows (and their prefix), the
    layers tensor-parallel; each layer's K/V (of the KV heads the rank's
    query heads attend to, after RoPE) placed in the full cache or the
    ring and re-cut to the cache's box (``attention.kv_to_box``).  With
    ``seq_shard`` and ``parallel.seq_cut`` of the prompt (the prefix
    counted) the residual is cut along the sequence, as the reference's
    prefill cuts it (``transformer.py:210``): each layer's K/V come from
    the gathered rows, so they are the whole prompt's, and the last
    position's hidden is brought from the last model rank
    (``TensorParallel.last_row``).  Returns (the rank's vocab columns of
    the last position's logits (B, 1, V/M) float32, the rank's cache
    blocks)."""
    tp = model.tp
    n_slots = _slots(cfg, layout, tokens)
    dim = kv_cut(layout)[0]
    seq = _seq(model, tokens, prefix_emb, seq_shard)
    x = _embed(model, tokens, prefix_emb, model.dtype, tp, seq)
    window = cfg.sliding_window
    cap = layout.shapes["k"][2]
    layers = []
    for layer in model.layers:
        h = rmsnorm(x, layer.norm1, cfg.norm_eps)
        a, kv = attn_forward(
            layer.attn, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta, window=window,
            tp=tp, seq=seq)
        x = x + a
        h = rmsnorm(x, layer.norm2, cfg.norm_eps)
        x = x + ffn(layer, h, cfg, tp, n_slots, seq)[0]
        layers.append(A.cache_to_box(
            tp, *kv, slots=cap, ring=window is not None, dim=dim,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads))
    data = {n: torch.stack([c[n] for c in layers]) for n in layers[0]}
    x = rmsnorm(tp.last_row(x, seq), model.final_norm, cfg.norm_eps)
    return (x @ tp.head(model, x.dtype)).float(), data


def prefill(model: Transformer, cfg: ModelConfig, tokens, *,
            cache_len_cap: int, prefix_emb=None, layout=None,
            seq_shard: bool = True):
    """Run the prompt, tokens (B, S) behind ``prefix_emb`` (B, P, d) when
    given, at its exact length and build the decode cache (S counts the
    prefix from here on).  Returns (logits (B, 1, V) float32 at the last
    position, the cache): a full cache of ``cache_len_cap`` rows whose
    first S hold the prompt's K/V (the rest zeros), or for a sliding
    window a ring of min(window, cache_len_cap) slots
    (``attention.ring_from_prefill``).  On a mesh (``layout``, the
    cache's ``parallel.CacheLayout``) see ``_prefill_tp``; ``seq_shard``
    changes nothing on one process."""
    B, S = tokens.shape
    if prefix_emb is not None:
        S += prefix_emb.shape[1]
    window = cfg.sliding_window
    if window is None and S > cache_len_cap:
        raise ValueError(f"prompt of {S} tokens exceeds cache_len_cap "
                         f"{cache_len_cap}")
    if layout is not None:
        return _prefill_tp(model, cfg, tokens, prefix_emb=prefix_emb,
                           layout=layout, seq_shard=seq_shard)
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


def _decode_tp(model: Transformer, cfg: ModelConfig, data, cache_len,
               token, layout):
    """``decode_step`` on a mesh: the rank's rows, its cache blocks
    written in place, the rank's vocab columns of the logits."""
    tp = model.tp
    n_slots = _slots(cfg, layout, token)
    cut = kv_cut(layout)
    x = embed(model, token, model.dtype, tp)
    for i, layer in enumerate(model.layers):
        h = rmsnorm(x, layer.norm1, cfg.norm_eps)
        a, _ = A.decode_attn_tp(
            layer.attn, h, {n: t[i] for n, t in data.items()}, cache_len,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
            window=cfg.sliding_window, tp=tp, cut=cut,
            seq_len=layout.shapes["k"][2])
        x = x + a
        h = rmsnorm(x, layer.norm2, cfg.norm_eps)
        x = x + ffn(layer, h, cfg, tp, n_slots)[0]
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    return (x @ tp.head(model, x.dtype)).float(), data


def decode_step(model: Transformer, cfg: ModelConfig, data, cache_len,
                token, layout=None):
    """One decode step.  token: (B, 1) int; data: the layer-stacked cache
    from ``prefill`` or ``cache_struct``, written in place (so a captured
    CUDA graph can replay the step); cache_len: the new token's position,
    a 0-d tensor (or int) for all rows, or (B,) per request (full cache
    only).  Returns (logits (B, 1, V) float32, data).  On a mesh
    (``layout``) the rows, the cache and the logits are the rank's (see
    ``_decode_tp``)."""
    if layout is not None:
        return _decode_tp(model, cfg, data, cache_len, token, layout)
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
