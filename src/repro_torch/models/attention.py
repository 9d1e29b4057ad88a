"""GQA self-attention with RoPE (``repro.models.attention`` in PyTorch):
the projections, the chunked online-softmax attention with sliding
windows, ``attn_forward``, the full and ring KV caches and the one-token
``decode_attn``.

Where each attention goes:

- A full causal layer (``window=None``) goes through
  ``kernels.backend.attention``: the flash kernels on the card, the
  plain version on the CPU.
- A windowed layer, and a bidirectional one (the enc-dec encoder, and
  its cross-attention in training and prefill), goes through
  ``chunked_attention`` on both devices, as the reference's does (its
  windowed and bidirectional layers stay on the XLA chunked scan: there
  is no Pallas kernel for either).  This is attention the reference
  computes outside any kernel, in plain array ops, not a plain version
  standing in for a kernel.
- Every form of ``decode_attn`` goes through
  ``kernels.backend.paged_decode_attention``: the ragged decode kernel's
  gathered-window entry on the card, ``ragged_decode_ref`` on the CPU.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import backend as KB
from repro_torch.parallel import weight
from repro_torch.models.layers import P, apply_rope, out_std, param, \
    trunc_normal_

NEG_INF = -1e30


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


def attention_specs(fsdp, lead: tuple = ()):
    """Column-parallel q/k/v (heads over ``model``), row-parallel o."""
    return {"w_q": P(*lead, fsdp, "model"),
            "w_k": P(*lead, fsdp, "model"),
            "w_v": P(*lead, fsdp, "model"),
            "w_o": P(*lead, "model", fsdp)}


# --------------------------------------------------------------------- #
# chunked attention
# --------------------------------------------------------------------- #

def _mask(qpos, kpos, *, causal: bool, window: Optional[int], kv_len=None):
    """(..., Sq, Sk) boolean mask from absolute positions; keys at
    position -1 (padding, empty ring slots) are never valid."""
    q = qpos[..., :, None]
    k = kpos[..., None, :]
    m = k >= 0
    if causal:
        m = m & (k <= q)
    if window is not None:
        m = m & (k > q - window)
    if kv_len is not None:
        m = m & (k < kv_len)
    return m


def _attend(qg, k, v, qpos, kpos, *, causal, window, kv_len, scale):
    """One (query block × key chunk) of attention with GQA grouping.
    qg: (B, Sq, Hkv, G, hd) float32; k, v: (B, Sk, Hkv, hd).  Returns
    the un-normalised online-softmax terms (o, m, l), float32."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    mask = _mask(qpos, kpos, causal=causal, window=window, kv_len=kv_len)
    s = torch.where(mask[:, None, None] if mask.dim() == 3 else mask, s,
                    NEG_INF)
    m = s.amax(dim=-1)                                   # (B, Hkv, G, Sq)
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    return o, m, p.sum(dim=-1)


def chunked_attention(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None, q_offset=0, kv_len=None,
                      kpos=None, chunk: int = 1024):
    """Online-softmax attention over key chunks, scores and accumulators
    in float32.  q: (B, Sq, H, hd); k, v: (B, Sk, Hkv, hd).  ``q_offset``
    is the absolute position of q[:, 0]: an int, a 0-d tensor or a
    (B, 1) tensor of per-row offsets.  ``kv_len`` (scalar or
    broadcastable to (B, Sq, Sk)) admits keys below it; ``kpos`` (Sk,)
    gives the keys' absolute positions (a ring cache's ``pos``), by
    default 0..Sk-1.  Keys are padded to a chunk multiple with position
    -1.  Returns (B, Sq, H, hd) in q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    if kpos is None:
        kpos = torch.arange(Sk, device=q.device)
    chunk = min(chunk, Sk)
    if Sk % chunk:
        pad = chunk - Sk % chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kpos = torch.cat([kpos, kpos.new_full((pad,), -1)])
        Sk += pad
    qg = q.float().reshape(B, Sq, Hkv, G, hd)
    acc = q.new_zeros((B, Hkv, G, Sq, hd), dtype=torch.float32)
    m = q.new_full((B, Hkv, G, Sq), NEG_INF, dtype=torch.float32)
    l = q.new_zeros((B, Hkv, G, Sq), dtype=torch.float32)
    for c in range(0, Sk, chunk):
        o_c, m_c, l_c = _attend(qg, k[:, c:c + chunk], v[:, c:c + chunk],
                                qpos, kpos[c:c + chunk], causal=causal,
                                window=window, kv_len=kv_len, scale=scale)
        m_new = torch.maximum(m, m_c)
        corr, corr_c = torch.exp(m - m_new), torch.exp(m_c - m_new)
        acc = acc * corr[..., None] + o_c * corr_c[..., None]
        l = l * corr + l_c * corr_c
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]            # (B,Hkv,G,Sq,hd)
    return out.movedim(3, 1).reshape(B, Sq, H, hd).to(q.dtype)


# --------------------------------------------------------------------- #
# the attention block
# --------------------------------------------------------------------- #

def attn_forward(p: Attention, x, *, n_heads: int, n_kv_heads: int,
                 head_dim: int, rope_theta: float,
                 window: Optional[int] = None, positions=None,
                 causal: bool = True, tp=None):
    """Self-attention over x: (B, S, d).  Causal and full: the flash
    kernels on the card.  Causal within a sliding ``window``, or
    bidirectional (``causal=False``, the enc-dec encoder):
    ``chunked_attention``, as the reference's XLA path (it has no Pallas
    kernel for either).  Returns (out (B, S, d), (k, v) each (B, S, Hkv,
    hd) after RoPE) — the K/V a cache stores.  On a mesh (``tp``) the
    projections are this rank's H/M query and Hkv/M KV heads (the GQA
    ratio kept), ``w_o`` its rows, and the output is summed over the
    model group."""
    B, S, _ = x.shape
    dt = x.dtype
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if tp is not None:
        n_heads //= tp.n_model
        n_kv_heads //= tp.n_model
        x = tp.to_model(x)
    q = (x @ weight(p.w_q, dt, tp)).reshape(B, S, n_heads, head_dim)
    k = (x @ weight(p.w_k, dt, tp)).reshape(B, S, n_kv_heads, head_dim)
    v = (x @ weight(p.w_v, dt, tp)).reshape(B, S, n_kv_heads, head_dim)
    if rope_theta:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    if causal and window is None:
        o = KB.attention(q, k, v)
    else:
        o = chunked_attention(q, k, v, causal=causal, window=window)
    o = o.reshape(B, S, n_heads * head_dim) @ weight(p.w_o, dt, tp)
    return (o if tp is None else tp.from_model(o)), (k, v)


# --------------------------------------------------------------------- #
# KV caches
# --------------------------------------------------------------------- #

def init_cache(batch: int, max_len: int, n_kv_heads: int, head_dim: int,
               *, dtype=torch.bfloat16, device="cuda"):
    """Full (non-ring) KV cache: slot s holds absolute position s."""
    shape = (batch, max_len, n_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_ring_cache(batch: int, window: int, n_kv_heads: int,
                    head_dim: int, *, dtype=torch.bfloat16, device="cuda"):
    """Empty ring cache of ``window`` slots; ``pos`` (window,) int32 is
    each slot's absolute position, -1 while empty."""
    cache = init_cache(batch, window, n_kv_heads, head_dim, dtype=dtype,
                       device=device)
    cache["pos"] = torch.full((window,), -1, dtype=torch.int32,
                              device=device)
    return cache


def ring_from_prefill(k, v, S: int, W: int, dtype=None):
    """A ring cache of W slots from prefill K/V (B, S, Hkv, hd): position
    p sits at slot p mod W, for S < W (slots S.. empty) and S >= W (the
    last W positions), so decode's ``slot = pos mod W`` overwrites
    exactly the entry that left the window."""
    dtype = dtype or k.dtype
    dev = k.device
    if S >= W:
        idx = torch.remainder(torch.arange(W, device=dev) - S, W)
        pos = S - W + idx                     # slot j <- the last W's idx[j]
        k_ring, v_ring = k[:, S - W:][:, idx], v[:, S - W:][:, idx]
    else:
        pad = (0, 0, 0, 0, 0, W - S)
        k_ring, v_ring = F.pad(k, pad), F.pad(v, pad)
        pos = torch.cat([torch.arange(S, device=dev),
                         torch.full((W - S,), -1, device=dev)])
    return {"k": k_ring.to(dtype), "v": v_ring.to(dtype),
            "pos": pos.to(torch.int32)}


def decode_attn(p: Attention, x, cache, cache_len, *, n_heads: int,
                n_kv_heads: int, head_dim: int, rope_theta: float,
                window: Optional[int] = None):
    """One-token decode: x (B, 1, d) against ``cache``, which is written
    in place (``index_copy_`` at device indices, so a captured CUDA graph
    can replay the step) and returned.  Three forms:

    - a full cache {"k", "v"} (B, max_len, Hkv, hd) at one depth:
      ``cache_len`` an int or a 0-d tensor, the new token's position;
    - a full cache at per-request depths: ``cache_len`` (B,) int;
    - a ring {"k", "v", "pos"} of W slots at one depth, its ``pos``
      updated in place.  Per-request depths raise, as the reference's
      do: the rows share one ``pos``.

    The attention is the ragged decode (``kernels.backend.
    paged_decode_attention``), whose ``lengths[b]`` admits slots
    0..lengths[b] of row b.  For a full cache that is each row's
    position.  For a ring it is ``min(pos, W - 1)``: slots fill in order
    (from ``ring_from_prefill`` or an empty ring decoded from position
    0) until the first wrap, and after it every one of the W slots holds
    one of the last W positions, all inside the window (W =
    min(window, max_len)).  The keys carry RoPE at their own positions,
    so the order of the slots does not matter.  A full cache with a
    window raises: a windowed layer decodes from its ring.  The cache's
    dtype must be x's.  Returns (out (B, 1, d), cache)."""
    B = x.shape[0]
    kc, vc = cache["k"], cache["v"]
    if kc.dtype != x.dtype:
        raise TypeError(f"decode_attn: cache dtype {kc.dtype} differs from "
                        f"x's {x.dtype}")
    pos = torch.as_tensor(cache_len, device=x.device).long()
    ragged = pos.dim() == 1
    rows = pos if ragged else pos.expand(B)               # (B,) positions
    q = (x @ p.w_q).reshape(B, 1, n_heads, head_dim)
    k = (x @ p.w_k).reshape(B, 1, n_kv_heads, head_dim)
    v = (x @ p.w_v).reshape(B, 1, n_kv_heads, head_dim)
    if rope_theta:
        q = apply_rope(q, rows[:, None], rope_theta)
        k = apply_rope(k, rows[:, None], rope_theta)
    W = kc.shape[1]
    if "pos" in cache:
        if ragged:
            raise ValueError(
                "per-request cache_len needs a full cache; ring caches "
                "share one position array across the batch")
        if window is not None and W > window:
            raise ValueError(f"ring of {W} slots is wider than the window "
                             f"{window}")
        slot = torch.remainder(pos, W).reshape(1)
        kc.index_copy_(1, slot, k)
        vc.index_copy_(1, slot, v)
        cache["pos"].index_copy_(0, slot, pos.reshape(1).to(torch.int32))
        lengths = rows.clamp(max=W - 1)
    else:
        if window is not None:
            raise ValueError("a windowed layer decodes from a ring cache "
                             "(ring_from_prefill, init_ring_cache)")
        if ragged:
            flat = torch.arange(B, device=x.device) * W + rows
            kc.view(B * W, n_kv_heads, head_dim).index_copy_(0, flat, k[:, 0])
            vc.view(B * W, n_kv_heads, head_dim).index_copy_(0, flat, v[:, 0])
        else:
            kc.index_copy_(1, pos.reshape(1), k)
            vc.index_copy_(1, pos.reshape(1), v)
        lengths = rows
    o = KB.paged_decode_attention(q, kc, vc,
                                  lengths.to(torch.int32).contiguous())
    return o.reshape(B, 1, n_heads * head_dim) @ p.w_o, cache
