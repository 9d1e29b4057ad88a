"""Plain PyTorch versions of the hand-written kernels.

Each computes the same function as its kernel, in float32, with the
reference package's masks and clamps.  ``kernels.backend`` runs them for
tensors on the CPU; on the card they are what each kernel is held
against.  They repeat the kernels' arithmetic and are no yardstick of
speed.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def rmsnorm_ref(x, scale, eps: float = 1e-5):
    """x: (..., d); scale: (d,).  y = x·rsqrt(mean(x²)+eps)·(1+scale) in
    float32, returned in x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def attention_ref(q, k, v, *, causal: bool = True):
    """q: (B, H, S, hd); k, v: (B, Hkv, S, hd) with H % Hkv == 0.
    Naive softmax attention in float32.  Returns (out (B, H, S, hd) in
    q's dtype, lse (B·H, S) float32) — the flash forward's two
    outputs."""
    B, H, S, hd = q.shape
    G = H // k.shape[1]
    k = k.float().repeat_interleave(G, dim=1)
    v = v.float().repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) / math.sqrt(hd)
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", torch.exp(s - lse[..., None]), v)
    return o.to(q.dtype), lse.reshape(B * H, S)


def ragged_decode_ref(q, k, v, lengths):
    """q: (B, H, hd) one query per request at position ``lengths[b]``;
    k, v: (B, Hkv, Skv, hd); lengths: (B,) int.  Keys 0..lengths[b]
    inclusive are valid (slot ``lengths[b]`` holds the token just
    written).  Returns (B, H, hd) in q's dtype."""
    B, H, hd = q.shape
    Skv = k.shape[2]
    G = H // k.shape[1]
    k = k.float().repeat_interleave(G, dim=1)
    v = v.float().repeat_interleave(G, dim=1)
    s = torch.einsum("bhd,bhkd->bhk", q.float(), k) / math.sqrt(hd)
    kpos = torch.arange(Skv, device=q.device)
    valid = kpos[None, :] <= lengths.to(q.device).long()[:, None]   # (B, Skv)
    s = s.masked_fill(~valid[:, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", p, v).to(q.dtype)
