"""GQA self-attention with RoPE (``repro.models.attention`` in PyTorch):
the projections and ``attn_forward``, whose causal core goes through
``kernels.backend.attention`` — the flash kernels on the card, the plain
version on the CPU.  Full causal attention only: sliding windows and the
ring cache come with a later slice."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import backend as KB
from repro_torch.models.layers import apply_rope, out_std, param, \
    trunc_normal_


class Attention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 head_dim: int, *, dtype, device):
        super().__init__()
        self.w_q = param((d_model, n_heads * head_dim), dtype=dtype,
                         device=device)
        self.w_k = param((d_model, n_kv_heads * head_dim), dtype=dtype,
                         device=device)
        self.w_v = param((d_model, n_kv_heads * head_dim), dtype=dtype,
                         device=device)
        self.w_o = param((n_heads * head_dim, d_model), dtype=dtype,
                         device=device)

    def init_weights(self, generator: torch.Generator, n_layers: int):
        for w in (self.w_q, self.w_k, self.w_v):
            trunc_normal_(w, 0.02, generator)
        trunc_normal_(self.w_o, out_std(n_layers), generator)


def attn_forward(p: Attention, x, *, n_heads: int, n_kv_heads: int,
                 head_dim: int, rope_theta: float, positions=None):
    """Causal self-attention over x: (B, S, d).  Returns (out (B, S, d),
    (k, v) each (B, S, Hkv, hd) after RoPE) — the K/V a cache stores."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q = (x @ p.w_q.to(x.dtype)).reshape(B, S, n_heads, head_dim)
    k = (x @ p.w_k.to(x.dtype)).reshape(B, S, n_kv_heads, head_dim)
    v = (x @ p.w_v.to(x.dtype)).reshape(B, S, n_kv_heads, head_dim)
    if rope_theta:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    o = KB.attention(q, k, v).reshape(B, S, n_heads * head_dim)
    return o @ p.w_o.to(x.dtype), (k, v)
