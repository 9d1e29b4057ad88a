"""Family dispatch for training and serving (``repro.models.registry``
in PyTorch).

``supports_paged`` and ``serving_mode`` are the reference's rules,
decided from the config alone.  The port trains and serves every family
of the reference: the dense, MoE and VLM families (all
``models.transformer``) from the paged KV pool or, with a sliding
window, through the ``Server``'s contiguous ring cache; the ssm family
(Mamba-2) from the recurrent state pool; the RG-LRU hybrid
(``models.rglru``) through the ``Server``, a list of per-layer caches
(recurrent states and rings); the enc-dec (``models.encdec``, arch
types "encdec" and "audio") through the ``Server``, its cache holding
the cross-attention's K/V beside the self-attention's.  The contiguous
caches of ``prefill``, ``decode_step`` and ``cache_struct``
(``serving.cache.DenseKVCache``) serve every family.

The frontend families (vlm, audio, encdec) take a stub frontend's
embeddings: the VLM's ``prefix_emb`` ahead of its text, the enc-dec's
source frames (``src_emb`` in training, ``prefix_emb`` in serving).
``text_len`` and ``concrete_inputs`` are the reference's helpers for
their inputs.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.base import InputShape
from repro_torch.models import encdec, mamba2, rglru, transformer
from repro_torch.models.layers import P, fsdp_axis

_TRANSFORMER_FAMILIES = ("dense", "moe", "vlm")
ENCDEC_FAMILIES = ("encdec", "audio")
_FAMILIES = {"dense": transformer, "moe": transformer, "vlm": transformer,
             "ssm": mamba2, "hybrid": rglru, "encdec": encdec,
             "audio": encdec}


def family(cfg: ModelConfig):
    fam = _FAMILIES.get(cfg.arch_type)
    if fam is None:
        raise ValueError(f"unknown arch_type {cfg.arch_type!r}; known: "
                         f"{sorted(_FAMILIES)}")
    return fam


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


def param_specs(cfg: ModelConfig, multi_pod: bool = False,
                serve_resident: bool = False):
    """The family's spec tree (the reference's leaf paths, a
    :class:`layers.P` a leaf).  ``serve_resident=True`` drops the FSDP
    axes ('data'/'pod') from every weight: weights replicate over data
    and stay split over 'model' only (no per-step weight gather in
    decode)."""
    specs = family(cfg).param_specs(cfg, multi_pod)
    if not serve_resident:
        return specs

    def strip(spec):
        cleaned = []
        for ax in spec:
            if ax in ("data", "pod"):
                cleaned.append(None)
            elif isinstance(ax, tuple):
                kept = tuple(a for a in ax if a not in ("data", "pod"))
                cleaned.append(kept[0] if len(kept) == 1 else
                               (kept or None))
            else:
                cleaned.append(ax)
        return P(*cleaned)

    def walk(tree):
        if isinstance(tree, P):
            return strip(tree)
        return {k: walk(v) for k, v in tree.items()}

    return walk(specs)


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
    """``"paged"``, ``"state"`` (Mamba-2) or ``None``
    (``train.serve.Server`` only: a ring cache's rows share one position
    array, so they cannot step at their own depths, which holds for the
    hybrid's attention layers too; the enc-dec needs each request's
    source frames)."""
    if supports_paged(cfg):
        return "paged"
    if cfg.arch_type == "ssm":
        return "state"
    return None


def prefill(model, cfg: ModelConfig, tokens, *,
            cache_len_cap: Optional[int] = None, prefix_emb=None):
    """Run the prompt, tokens (B, S), at its exact length and build the
    decode cache.  Returns (logits (B, 1, V) float32, a
    ``serving.cache.DenseKVCache`` whose ``lengths`` are all S, the
    VLM's prefix counted).  The dense family needs ``cache_len_cap``:
    its full cache holds that many positions, its ring min(window, cap)
    slots, and so do the hybrid's attention layers and the enc-dec's
    self-attention; the ssm family's state is O(1) in the length and
    takes none.  ``prefix_emb`` (B, P, d) is the VLM's patches or the
    enc-dec's source frames (which it needs)."""
    from repro_torch.serving import cache as sc   # serving imports this
    fam = family(cfg)
    kw = {}
    if prefix_emb is not None:
        if not has_frontend(cfg):
            raise ValueError(f"arch_type {cfg.arch_type!r} takes no "
                             f"prefix_emb")
        kw["prefix_emb"] = prefix_emb
    elif cfg.arch_type in ENCDEC_FAMILIES:
        raise ValueError("the enc-dec's prefill needs the source "
                         "embeddings (prefix_emb)")
    if cfg.arch_type == "ssm":
        logits, data = fam.prefill(model, cfg, tokens)
    elif cache_len_cap is None:
        raise ValueError(f"the {cfg.arch_type} family's prefill needs "
                         f"cache_len_cap")
    else:
        logits, data = fam.prefill(model, cfg, tokens,
                                   cache_len_cap=cache_len_cap, **kw)
    B, S = tokens.shape
    if prefix_emb is not None and cfg.arch_type == "vlm":
        S += prefix_emb.shape[1]
    lengths = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    return logits, sc.DenseKVCache(data=data, lengths=lengths)


def prefill_ragged(model, cfg: ModelConfig, tokens, lengths, *,
                   prefix_emb=None):
    """Bucketed prefill (full-attention transformer families only), the
    VLM's ``prefix_emb`` ahead of the tokens (``lengths`` count it).
    Returns (logits at each request's last real token, per-layer k, v
    (L, B, S, Hkv, hd)) for the page pool to scatter."""
    if not supports_paged(cfg):
        why = (" (Mamba-2 prefills each prompt at its own length into "
               "the state pool: padding would run the recurrence over "
               "it)" if cfg.arch_type == "ssm" else "")
        raise NotImplementedError(
            f"ragged prefill needs full attention; {cfg.arch_type} with "
            f"window={cfg.sliding_window} keeps the exact-length path{why}")
    return family(cfg).prefill_ragged(model, cfg, tokens, lengths,
                                      prefix_emb=prefix_emb)


def decode_step(model, cfg: ModelConfig, cache, token):
    """One decode step against a typed cache, dispatched on its type: a
    ``PagedKVCache`` (the serving pools, updated in place: attention
    pages or recurrent state rows) or a ``DenseKVCache`` from
    ``prefill`` or ``cache_struct``.  A dense cache steps at per-request
    depths (``lengths``) when the config can serve from pages, and at
    one depth (``lengths[0]``) otherwise: a ring's rows share one
    ``pos``, the recurrent step needs no position, and the enc-dec
    steps at one depth as the reference's does.  The dense
    family's K/V and the hybrid's caches are written in place; the ssm
    family's state is left as it was.  Returns (logits (B, 1, V), the
    cache with lengths advanced by one)."""
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
    the ssm family's recurrent state (O(1) in ``max_len``), from which
    the state pool builds its buffer with the page id on axis 1, the
    hybrid's list of per-layer caches, or the enc-dec's full cache with
    its cross-attention K/V."""
    fam = family(cfg)
    if cfg.arch_type == "ssm":
        return fam.state_struct(cfg, batch, dtype=dtype, device=device)
    if max_len < 1:
        raise ValueError(f"the {cfg.arch_type} family's cache needs "
                         f"max_len >= 1, got {max_len}")
    return fam.cache_struct(cfg, batch, max_len, dtype=dtype, device=device)


# --------------------------------------------------------------------- #
# the frontend families' inputs
# --------------------------------------------------------------------- #

def has_frontend(cfg: ModelConfig) -> bool:
    return cfg.arch_type in ("vlm",) + ENCDEC_FAMILIES


def text_len(cfg: ModelConfig, seq_len: int) -> int:
    """Text tokens after the frontend stub's share of the sequence."""
    if has_frontend(cfg):
        return max(seq_len - cfg.frontend_tokens, 1)
    return seq_len


def concrete_inputs(cfg: ModelConfig, mode: str, batch: int, seq_len: int,
                    seed: int = 0, *, dtype=torch.bfloat16, device="cuda"):
    """Small real inputs of a ``"train"`` or ``"prefill"`` step, as the
    reference's: ``text_len`` tokens (int64) drawn by numpy from
    ``seed``, ``labels`` the tokens rolled by one, and the stub
    frontend's normals (B, frontend_tokens, frontend_dim) in ``dtype``:
    ``prefix_emb`` for the VLM (and for the enc-dec's prefill),
    ``src_emb`` for the enc-dec's training batch."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"concrete_inputs: mode {mode!r} is not 'train' "
                         f"or 'prefill' (build a decode cache with "
                         f"cache_struct)")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size,
                        (batch, text_len(cfg, seq_len))).astype(np.int64)

    def t(a, dt):
        return torch.from_numpy(a).to(device=device, dtype=dt)

    out = {"tokens": t(toks, torch.int64)}
    if mode == "train":
        out["labels"] = t(np.roll(toks, -1, axis=1), torch.int64)
    if has_frontend(cfg):
        emb = rng.normal(0, 1, (batch, cfg.frontend_tokens,
                                cfg.frontend_dim))
        key = ("src_emb" if mode == "train"
               and cfg.arch_type in ENCDEC_FAMILIES else "prefix_emb")
        out[key] = t(emb, dtype)
    return out


# --------------------------------------------------------------------- #
# workload inputs and their shardings
# --------------------------------------------------------------------- #

def _meta(shape, dtype):
    """A shape-and-dtype stand-in (the reference's
    ``jax.ShapeDtypeStruct``): a tensor on the meta device, no memory."""
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_struct(cfg: ModelConfig, batch: int, seq_len: int):
    st = text_len(cfg, seq_len)
    out = {"tokens": _meta((batch, st), torch.int64),
           "labels": _meta((batch, st), torch.int64)}
    if has_frontend(cfg):
        key = "prefix_emb" if cfg.arch_type == "vlm" else "src_emb"
        out[key] = _meta((batch, cfg.frontend_tokens, cfg.frontend_dim),
                         torch.bfloat16)
    return out


def prefill_struct(cfg: ModelConfig, batch: int, seq_len: int):
    out = {"tokens": _meta((batch, text_len(cfg, seq_len)), torch.int64)}
    if has_frontend(cfg):
        out["prefix_emb"] = _meta(
            (batch, cfg.frontend_tokens, cfg.frontend_dim), torch.bfloat16)
    return out


def decode_struct(cfg: ModelConfig, batch: int, seq_len: int,
                  dtype=torch.bfloat16):
    """The decode step's inputs on the meta device: a decode cache of
    ``seq_len`` positions is never allocated."""
    from repro_torch.serving import cache as sc   # serving imports this
    data = cache_struct(cfg, batch, seq_len, dtype=dtype, device="meta")
    return {"cache": sc.DenseKVCache(data=data,
                                     lengths=_meta((batch,), torch.int32)),
            "token": _meta((batch, 1), torch.int64)}


def input_specs(cfg: ModelConfig, shape: InputShape):
    """Stand-ins of every model input of a workload shape."""
    if shape.mode == "train":
        return train_batch_struct(cfg, shape.global_batch, shape.seq_len)
    if shape.mode == "prefill":
        return prefill_struct(cfg, shape.global_batch, shape.seq_len)
    return decode_struct(cfg, shape.global_batch, shape.seq_len)


def _batch_axes(batch: int, multi_pod: bool):
    need = 32 if multi_pod else 16
    if batch % need == 0:
        return fsdp_axis(multi_pod)
    if batch % 16 == 0:
        return "data"
    return None


def _cache_spec(leaf_shape, b_axes, leading_layer: bool,
                seq_shard: bool = False) -> P:
    """The batch dim over the data axes; the last dim over 'model' when it
    is a multiple of 16 (head_dim / feature shards), or with
    ``seq_shard`` the KV sequence dim (the flash-decode layout)."""
    spec = [None] * len(leaf_shape)
    bdim = 1 if leading_layer else 0
    if len(leaf_shape) > bdim:
        spec[bdim] = b_axes
    sdim = bdim + 1
    if (seq_shard and len(leaf_shape) >= sdim + 2
            and leaf_shape[sdim] % 16 == 0):
        spec[sdim] = "model"
    elif leaf_shape[-1] % 16 == 0 and len(leaf_shape) >= 2:
        spec[-1] = "model"
    return P(*spec)


def _map_leaves(fn, tree):
    from repro_torch.serving import cache as sc   # serving imports this
    if isinstance(tree, sc.DenseKVCache):
        return sc.DenseKVCache(data=_map_leaves(fn, tree.data),
                               lengths=_map_leaves(fn, tree.lengths))
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def input_shardings(cfg: ModelConfig, shape: InputShape,
                    multi_pod: bool = False,
                    cache_seq_shard: bool = False):
    """The spec tree of :func:`input_specs`' inputs, the reference's
    rules: batches over the data axes when they divide; decode caches
    (layer-stacked, the hybrid's a list) by :func:`_cache_spec`, their
    int32 position arrays replicated."""
    b = _batch_axes(shape.global_batch, multi_pod)
    if shape.mode in ("train", "prefill"):
        struct = input_specs(cfg, shape)
        return {k: P(b, None, None) if v.dim() == 3 else P(b, None)
                for k, v in struct.items()}
    struct = decode_struct(cfg, shape.global_batch, shape.seq_len)
    layer_stacked = cfg.arch_type != "hybrid"

    def spec_of(leaf):
        if leaf.dim() == 0:
            return P()
        if leaf.shape[-1] == 1 and leaf.dim() == 2:      # token (B, 1)
            return P(b, None)
        if leaf.dtype == torch.int32:                    # positions
            return P(*([None] * leaf.dim()))
        return _cache_spec(tuple(leaf.shape), b,
                           layer_stacked and leaf.dim() >= 3,
                           seq_shard=cache_seq_shard)

    return {"cache": _map_leaves(spec_of, struct["cache"]),
            "token": P(b, None)}
