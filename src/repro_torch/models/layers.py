"""Shared building blocks: RMSNorm, RoPE, the SwiGLU/GeLU MLP, the LM
head and the init rules (``repro.models.layers`` in PyTorch).

Weights are ``(d_in, d_out)`` matrices used as ``x @ W``, the
reference's layout, so weights load one to one (no transpose into
``nn.Linear``).  The reference keeps float32 weights and casts them at
every matmul (``x @ W.astype(x.dtype)``); the cast is deterministic, so
the port holds the cast copy, made once when the weights are created or
loaded, and multiplies by it directly.  Norm scales stay float32: the
norm adds them to 1 in float32.
"""
from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import backend as KB


# --------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------- #

def param(shape, *, dtype, device) -> nn.Parameter:
    """An uninitialised inference weight (``init_weights`` or
    ``weights.from_jax_params`` fills it)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def trunc_normal_(t: torch.Tensor, std: float,
                  generator: torch.Generator) -> None:
    """Fill ``t`` with std·N(0, 1) truncated at ±3 std (the reference's
    ``trunc_normal``), drawn in float32 from ``generator`` and cast."""
    w = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    nn.init.trunc_normal_(w, mean=0.0, std=std, a=-3.0 * std, b=3.0 * std,
                          generator=generator)
    t.data.copy_(w)


def out_std(n_layers: int) -> float:
    """Std of the output projections (attention ``w_o``, MLP ``w_down``),
    scaled down with depth; every other matrix uses 0.02."""
    return 0.02 / math.sqrt(2 * max(n_layers, 1))


# --------------------------------------------------------------------- #
# norms / activations
# --------------------------------------------------------------------- #

def rmsnorm(x, scale, eps: float = 1e-5):
    """Through ``kernels.backend``: the kernel on the card, the plain
    version on the CPU."""
    return KB.rmsnorm(x, scale, eps=eps)


def act_fn(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": partial(F.gelu, approximate="tanh")}[name]


# --------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------- #

def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S).
    Split-half rotation in float32, cast back to x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)           # (hd/2,)
    angles = positions[..., None].float() * freqs            # (..., S, hd/2)
    angles = angles[..., None, :]                            # (..., S, 1, hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- #
# MLP
# --------------------------------------------------------------------- #

class MLP(nn.Module):
    """SwiGLU (``act="silu"``: gate, up, down) or plain GeLU (up, down)."""

    def __init__(self, d_model: int, d_ff: int, act: str, *, dtype,
                 device):
        super().__init__()
        self.w_up = param((d_model, d_ff), dtype=dtype, device=device)
        self.w_down = param((d_ff, d_model), dtype=dtype, device=device)
        self.w_gate = (param((d_model, d_ff), dtype=dtype, device=device)
                       if act == "silu" else None)

    def init_weights(self, generator: torch.Generator, n_layers: int):
        trunc_normal_(self.w_up, 0.02, generator)
        trunc_normal_(self.w_down, out_std(n_layers), generator)
        if self.w_gate is not None:
            trunc_normal_(self.w_gate, 0.02, generator)


def mlp(p: MLP, x, act: str):
    up = x @ p.w_up
    if p.w_gate is not None:
        h = act_fn(act)(x @ p.w_gate) * up
    else:
        h = act_fn(act)(up)
    return h @ p.w_down


# --------------------------------------------------------------------- #
# lm head
# --------------------------------------------------------------------- #

def lm_head_matrix(model) -> torch.Tensor:
    """(d, padded_vocab): the untied head, or the tied embedding's
    transpose."""
    if model.lm_head is not None:
        return model.lm_head
    return model.tok.T
