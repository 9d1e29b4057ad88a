"""Load the reference package's parameters into the port's model.

``from_jax_params`` takes the reference's parameter pytree as nested
dicts of numpy arrays (``jax.tree.map(np.asarray, params)`` on the
reference side), so this module never imports JAX.  The reference's
layout, by family (``arch_type``):

- both: ``embed.tok`` (V, d), ``embed.lm_head`` (d, V) unless tied;
  ``final_norm`` (d,);
- dense: ``layers.*`` stacked along a leading L dim:
  ``attn.w_q/w_k/w_v/w_o``, ``mlp.w_up/w_down[/w_gate]``,
  ``norm1``/``norm2`` (L, d);
- ssm (Mamba-2): ``layers.mixer.*`` (``w_z``, ``w_x``, ``w_B``, ``w_C``,
  ``w_dt``, ``dt_bias``, ``A_log``, ``D``, ``conv_w``, ``conv_b``,
  ``norm``, ``w_out``) and ``layers.norm`` (L, d), stacked along L.

The leading L dim is split into the ``ModuleList``; matrices keep their
``(d_in, d_out)`` layout (the port multiplies ``x @ W`` as the
reference does).  Norm scales are zero-initialised and used as
``(1 + scale)`` in both packages, so they copy as they are, in float32.
Matrices, the conv and the embedding are cast once to ``dtype``: the
compute dtype to serve, float32 (with ``trainable=True``) to train; the
SSD's per-head parameters stay float32.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.mamba2 import Mamba2
from repro_torch.models.transformer import Transformer


def _copy(dst: torch.Tensor, src: np.ndarray, name: str) -> None:
    src = np.asarray(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: reference shape {tuple(src.shape)} != "
                         f"port shape {tuple(dst.shape)}")
    dst.data.copy_(torch.from_numpy(np.array(src)))   # a writable copy


def _embed_and_final(model, tree) -> None:
    emb = tree["embed"]
    _copy(model.tok, emb["tok"], "embed.tok")
    if model.lm_head is not None:
        _copy(model.lm_head, emb["lm_head"], "embed.lm_head")
    elif "lm_head" in emb:
        raise ValueError("tied config, but the tree has embed.lm_head")
    _copy(model.final_norm, tree["final_norm"], "final_norm")


def _dense(tree, cfg: ModelConfig, dtype, device) -> Transformer:
    model = Transformer(cfg, dtype=dtype, device=device)
    _embed_and_final(model, tree)
    layers = tree["layers"]
    for i, layer in enumerate(model.layers):
        _copy(layer.norm1, layers["norm1"][i], f"layers.norm1[{i}]")
        _copy(layer.norm2, layers["norm2"][i], f"layers.norm2[{i}]")
        for n in ("w_q", "w_k", "w_v", "w_o"):
            _copy(getattr(layer.attn, n), layers["attn"][n][i],
                  f"layers.attn.{n}[{i}]")
        for n in ("w_up", "w_down", "w_gate"):
            w = getattr(layer.mlp, n)
            if w is not None:
                _copy(w, layers["mlp"][n][i], f"layers.mlp.{n}[{i}]")
    return model


def _ssm(tree, cfg: ModelConfig, dtype, device) -> Mamba2:
    model = Mamba2(cfg, dtype=dtype, device=device)
    _embed_and_final(model, tree)
    layers = tree["layers"]
    for i, blk in enumerate(model.layers):
        _copy(blk.norm, layers["norm"][i], f"layers.norm[{i}]")
        for n, w in blk.mixer.named_parameters():
            _copy(w, layers["mixer"][n][i], f"layers.mixer.{n}[{i}]")
    return model


_FAMILIES = {"dense": _dense, "ssm": _ssm}


def from_jax_params(tree: Dict[str, Any], cfg: ModelConfig, *,
                    dtype=torch.bfloat16, device="cuda",
                    trainable: bool = False):
    """Build the port's model of ``cfg``'s family (``Transformer`` for
    dense, ``Mamba2`` for ssm) from the reference's parameter pytree
    (numpy arrays); ``trainable`` turns on the parameters' gradients."""
    load = _FAMILIES.get(cfg.arch_type)
    if load is None:
        raise NotImplementedError(
            f"from_jax_params: arch_type {cfg.arch_type!r} is not ported")
    return load(tree, cfg, dtype, device).requires_grad_(trainable)
