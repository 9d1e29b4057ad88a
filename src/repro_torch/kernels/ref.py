"""Plain PyTorch versions of the hand-written kernels.

Each computes the same function as its kernel, in float32, with the
reference package's masks and clamps.  ``kernels.backend`` runs the
forward ones for tensors on the CPU, where torch's autograd
differentiates them; the backward ones (``*_bwd_ref``) write out the
reference's backward kernels.  On the card they are what each kernel is
held against.  They repeat the kernels' arithmetic and are no yardstick
of speed.
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


def rmsnorm_bwd_ref(x, scale, g, eps: float = 1e-5):
    """The VJP of ``rmsnorm_ref`` written out as the reference's backward
    kernel computes it, in float32: rr = rsqrt(mean(x²)+eps), x̂ = x·rr,
    gs = g·(1+scale); dx = rr·(gs − x̂·mean(gs·x̂)) in x's dtype and
    dscale = Σ_rows g·x̂ in float32."""
    x32, g32 = x.float(), g.float()
    rr = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    xh = x32 * rr
    gs = g32 * (1.0 + scale.float())
    proj = (gs * xh).mean(dim=-1, keepdim=True)
    dx = rr * (gs - xh * proj)
    dscale = (g32 * xh).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale


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


def flash_bwd_ref(q, k, v, out, lse, do):
    """The VJP of causal ``attention_ref`` as the reference's backward
    kernels compute it, in float32: p = exp(s − lse) with the causal
    mask, Δ = rowsum(do·out), ds = p·(do·vᵀ − Δ)·scale; dq = ds·k,
    dk = dsᵀ·q and dv = pᵀ·do per query head, then summed over each GQA
    group.  q, out, do: (B, H, S, hd); k, v: (B, Hkv, S, hd); lse
    (B·H, S).  Returns (dq, dk, dv) in q's dtype."""
    B, H, S, hd = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    q32, do32 = q.float(), do.float()
    k32 = k.float().repeat_interleave(G, dim=1)
    v32 = v.float().repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q32, k32) * scale
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - lse.reshape(B, H, S, 1))
    delta = (do32 * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", do32, v32) - delta) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k32)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q32)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do32)
    dk = dk.reshape(B, Hkv, G, S, hd).sum(dim=2)
    dv = dv.reshape(B, Hkv, G, S, hd).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
