"""Load the reference package's parameters into the port's model.

``from_jax_params`` takes the reference's parameter pytree as nested
dicts of numpy arrays (``jax.tree.map(np.asarray, params)`` on the
reference side), so this module never imports JAX.  The reference's
layout:

- ``embed.tok`` (V, d), ``embed.lm_head`` (d, V) unless tied;
- ``layers.*`` stacked along a leading L dim: ``attn.w_q/w_k/w_v/w_o``,
  ``mlp.w_up/w_down[/w_gate]``, ``norm1``/``norm2`` (L, d);
- ``final_norm`` (d,).

The leading L dim is split into the ``ModuleList``; matrices keep their
``(d_in, d_out)`` layout (the port multiplies ``x @ W`` as the
reference does).  Norm scales are zero-initialised and used as
``(1 + scale)`` in both packages, so they copy as they are, in float32.
Matrices and the embedding are cast once to ``dtype``, the compute
dtype.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import Transformer


def _copy(dst: torch.Tensor, src: np.ndarray, name: str) -> None:
    src = np.asarray(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: reference shape {tuple(src.shape)} != "
                         f"port shape {tuple(dst.shape)}")
    dst.data.copy_(torch.from_numpy(np.array(src)))   # a writable copy


def from_jax_params(tree: Dict[str, Any], cfg: ModelConfig, *,
                    dtype=torch.bfloat16, device="cuda") -> Transformer:
    """Build the port's ``Transformer`` from the reference's parameter
    pytree (numpy arrays) of the dense family."""
    model = Transformer(cfg, dtype=dtype, device=device)
    emb = tree["embed"]
    _copy(model.tok, emb["tok"], "embed.tok")
    if model.lm_head is not None:
        _copy(model.lm_head, emb["lm_head"], "embed.lm_head")
    elif "lm_head" in emb:
        raise ValueError("tied config, but the tree has embed.lm_head")
    _copy(model.final_norm, tree["final_norm"], "final_norm")
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
