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
- ``decode_attn_tp``, the decode step on a data × model mesh, attends
  over a cache cut by the reference's ``input_shardings``: over
  head_dim (the default) through ``kernels.backend.decode_scores`` and
  ``decode_softmax_pv`` around an all-reduce of the scores, or over the
  sequence through ``kernels.backend.decode_partial`` and
  ``merge_decode_partials`` after an all-gather of the ranks' softmax
  states.  No cache byte moves between ranks.  ``cross_decode_tp`` is
  the enc-dec's cross-attention there (only q gathered; its K/V cut on
  head_dim or on the frames); ``cache_to_box`` re-cuts a prompt's K/V
  to the cache's box.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import backend as KB
from repro_torch.parallel import head_block, kv_block, uneven_heads, weight
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
    G = H // max(Hkv, 1)                 # a rank with no heads: H = Hkv = 0
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

def project_kv(p: Attention, x, *, n_heads: int, n_kv_heads: int,
               head_dim: int, tp=None):
    """K and V of x (B, S, d), each (B, S, Hkv', hd), before RoPE: every
    KV head, or on a mesh (``tp``; x already through ``to_model``) the KV
    heads this rank's H/M query heads attend to.  Where the model axis
    divides the KV heads they are the rank's own Hkv/M; where it does not
    (MQA, and GQA with Hkv mod M ≠ 0) ``w_k`` and ``w_v`` hold the spec's
    column blocks, whose products are gathered whole over the model group
    and cut to the heads of ``parallel.kv_block``."""
    B, S, _ = x.shape
    dt = x.dtype
    k = x @ weight(p.w_k, dt, tp)
    v = x @ weight(p.w_v, dt, tp)
    if tp is None or n_kv_heads % tp.n_model == 0:
        n = n_kv_heads if tp is None else n_kv_heads // tp.n_model
        return (k.reshape(B, S, n, head_dim), v.reshape(B, S, n, head_dim))
    k, v = (tp.model_gather(t, -1).reshape(B, S, n_kv_heads, head_dim)
            for t in (k, v))
    if uneven_heads(n_heads, tp):
        return k, v
    first, n = kv_block(n_heads, n_kv_heads, tp.n_model, tp.model_index)
    return k[:, :, first:first + n], v[:, :, first:first + n]


def rank_heads(tp, q, k, v, *, n_heads: int, n_kv_heads: int,
               head_dim: int):
    """Query heads the model axis does not divide (``parallel.
    uneven_heads``): q (B, S, H·hd/M), the rank's columns of ``w_q``'s
    product, and k, v (B, S, Hkv, hd), every KV head -> the rank's block
    of whole query heads (``parallel.head_block``: ceil(H/M), the last
    ranks fewer or none) and the KV heads they attend to.  q's columns
    are gathered over the model group (one all-gather) and cut to the
    block; k and v are cut to a GQA block where the rank's heads take
    whole groups or lie in one, else to one KV head a query head."""
    B, S = q.shape[:2]
    first, n = head_block(n_heads, tp.n_model, tp.model_index)
    q = tp.model_gather(q, -1).reshape(B, S, n_heads, head_dim)
    q = q[:, :, first:first + n]
    G = n_heads // n_kv_heads
    lo = first // G
    hi = (first + n - 1) // G + 1 if n else lo
    if n and (hi - lo == 1 or (first % G == 0 and n % G == 0)):
        return q, k[:, :, lo:hi], v[:, :, lo:hi]
    idx = torch.arange(first, first + n, device=k.device) // G
    return q, k.index_select(2, idx), v.index_select(2, idx)


def rank_cols(tp, o, *, n_heads: int, head_dim: int):
    """The way back of :func:`rank_heads`: o (B, S, n·hd), the output of
    the rank's block of heads -> the rank's H·hd/M columns of every
    head's output, the rows of ``w_o`` it holds.  Each rank's block,
    padded to ceil(H/M) heads, is gathered over the model group (one
    all-gather) and the rank's columns kept; the gather's backward sums
    the grads over the group and keeps the rank's block."""
    per = -(-n_heads // tp.n_model) * head_dim
    o = F.pad(o, (0, per - o.shape[-1]))
    w = n_heads * head_dim // tp.n_model
    return tp.model_gather(o, -1).narrow(-1, tp.model_index * w, w)


def attn_forward(p: Attention, x, *, n_heads: int, n_kv_heads: int,
                 head_dim: int, rope_theta: float,
                 window: Optional[int] = None, positions=None,
                 causal: bool = True, tp=None, seq: bool = False):
    """Self-attention over x: (B, S, d).  Causal and full: the flash
    kernels on the card.  Causal within a sliding ``window``, or
    bidirectional (``causal=False``, the enc-dec encoder):
    ``chunked_attention``, as the reference's XLA path (it has no Pallas
    kernel for either).  Returns (out (B, S, d), (k, v) each (B, S, Hkv,
    hd) after RoPE) — the K/V a cache stores.  On a mesh (``tp``) the
    projections are this rank's H/M query heads and the KV heads they
    attend to (``project_kv``: its Hkv/M, or the gathered heads where the
    model axis does not divide them), ``w_o`` its rows, and the output
    is summed over the model group.  Where the axis does not divide the
    query heads the rank attends with its block of whole heads
    (``rank_heads``, ``rank_cols``) and returns every KV head.  With
    ``seq`` x is the rank's S/M rows of the cut residual: gathered along
    S first (so q, k, v and the K/V returned cover the whole S), the
    output reduce-scattered back to the rank's rows."""
    dt = x.dtype
    if tp is not None:
        x = tp.enter(x, seq)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q = x @ weight(p.w_q, dt, tp)
    k, v = project_kv(p, x, n_heads=n_heads, n_kv_heads=n_kv_heads,
                      head_dim=head_dim, tp=tp)
    if rope_theta:
        k = apply_rope(k, positions, rope_theta)
    kv = (k, v)
    uneven = uneven_heads(n_heads, tp)
    if uneven:
        q, k, v = rank_heads(tp, q, k, v, n_heads=n_heads,
                             n_kv_heads=n_kv_heads, head_dim=head_dim)
    else:
        q = q.reshape(B, S, -1, head_dim)
    if rope_theta:
        q = apply_rope(q, positions, rope_theta)
    if causal and window is None:
        o = KB.attention(q, k, v)
    else:
        o = chunked_attention(q, k, v, causal=causal, window=window)
    o = o.reshape(B, S, -1)
    if uneven:
        o = rank_cols(tp, o, n_heads=n_heads, head_dim=head_dim)
    o = o @ weight(p.w_o, dt, tp)
    return (o if tp is None else tp.leave(o, seq)), kv


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


# --------------------------------------------------------------------- #
# sharded serving: the caches cut over the model group
# --------------------------------------------------------------------- #

def qkv_whole(p: Attention, x, *, n_heads: int, n_kv_heads: int,
              head_dim: int, tp):
    """q (B, S, H, hd) and k, v (B, S, Hkv, hd) of x (B, S, d), every
    head, on a mesh: each rank multiplies its column blocks of ``w_q``,
    ``w_k`` and ``w_v`` and the products are gathered over the model
    group in one all-gather (the ranks' blocks are the heads' columns in
    order)."""
    B, S, _ = x.shape
    dt = x.dtype
    ws = [weight(w, dt, tp) for w in (p.w_q, p.w_k, p.w_v)]
    cols = torch.cat([x @ w for w in ws], dim=-1)
    g = tp.gather_model(cols[None], 0).permute(1, 2, 0, 3)   # (B,S,M,c)
    cq, ck = ws[0].shape[1], ws[1].shape[1]
    return (g[..., :cq].reshape(B, S, n_heads, head_dim),
            g[..., cq:cq + ck].reshape(B, S, n_kv_heads, head_dim),
            g[..., cq + ck:].reshape(B, S, n_kv_heads, head_dim))


def kv_to_box(tp, t, *, n_heads: int, n_kv_heads: int, dim: int):
    """The re-cut of a prompt's K or V: t (B, S, Hkv', hd), the KV heads
    this rank's query heads attend to (``project_kv``'s), -> every KV
    head's block along ``dim`` (1: the sequence, 3: head_dim), the
    rank's M-th part.  Where the model axis divides the KV heads, one
    all-to-all; where it does not, each rank holds one head, shared with
    its neighbours (``parallel.kv_block``): the ranks' heads are
    gathered, one copy of each kept, and the block cut; a rank that holds
    every KV head (MQA) cuts its block with no collective."""
    M = tp.n_model
    if n_kv_heads % M == 0:
        return tp.model_all_to_all(t, split_dim=dim, cat_dim=2)
    if t.shape[2] == n_kv_heads:
        n = t.shape[dim] // M
        return t.narrow(dim, tp.model_index * n, n).contiguous()
    parts = tp.gather_model(t[None], 0)                    # (M, B, S, 1, hd)
    owner = {}
    for r in range(M):
        owner.setdefault(kv_block(n_heads, n_kv_heads, M, r)[0], r)
    whole = torch.cat([parts[owner[h]] for h in range(n_kv_heads)], dim=2)
    n = whole.shape[dim] // M
    return whole.narrow(dim, tp.model_index * n, n).contiguous()


def cache_to_box(tp, k, v, *, slots: int, ring: bool, dim: int,
                 n_heads: int, n_kv_heads: int):
    """A layer's decode cache in the rank's box, from its prompt's K/V
    (B, S, Hkv', hd) after RoPE (the KV heads the rank's query heads
    attend to, ``project_kv``'s): a full cache of ``slots`` positions,
    the prompt in its first S and zeros after, or a ring of ``slots``
    (``ring_from_prefill``, its whole ``pos`` kept), each re-cut along
    ``dim`` (1: the sequence, 3: head_dim) by :func:`kv_to_box`.
    Returns {"k", "v"} (and the ring's "pos")."""
    S = k.shape[1]
    pos = None
    if ring:
        r = ring_from_prefill(k, v, S, slots)
        k, v, pos = r["k"], r["v"], r["pos"]
    elif dim == 1:               # the sequence cut: its blocks of the cap
        k, v = (F.pad(t, (0, 0, 0, 0, 0, slots - S)) for t in (k, v))
    out = {}
    for n, t in (("k", k), ("v", v)):
        t = kv_to_box(tp, t, n_heads=n_heads, n_kv_heads=n_kv_heads,
                      dim=dim)
        if not ring and dim == 3:
            t = F.pad(t, (0, 0, 0, 0, 0, slots - S))
        out[n] = t
    if pos is not None:
        out["pos"] = pos
    return out


def merge_decode_partials(parts):
    """The sequence cut's combine: parts (M, B, H, hd + 2) float32, each
    rank's (m, l, acc) over its keys (``kernels.backend.
    decode_partial``), merged in rank order as the decode kernel merges
    its splits (so the bits do not depend on which rank arrived first).
    Returns (B, H, hd) float32, acc / l with l clamped at 1e-30."""
    m, l, acc = parts[0, ..., 0], parts[0, ..., 1], parts[0, ..., 2:]
    for part in parts[1:]:
        mx = torch.maximum(m, part[..., 0])
        ca, cb = torch.exp(m - mx), torch.exp(part[..., 0] - mx)
        l = l * ca + part[..., 1] * cb
        acc = acc * ca[..., None] + part[..., 2:] * cb[..., None]
        m = mx
    return acc / l.clamp_min(1e-30)[..., None]


def _write_owned(c, idx, own, new) -> None:
    """c (N, ...) flat cache rows: row idx[i] <- new[i] where own[i], else
    left as it was (rewritten with itself): no host sync."""
    c.index_copy_(0, idx, torch.where(own.reshape(-1, *[1] * (new.dim() - 1)),
                                      new, c.index_select(0, idx)))


def decode_attn_tp(p: Attention, x, cache, cache_len, *, n_heads: int,
                   n_kv_heads: int, head_dim: int, rope_theta: float,
                   window: Optional[int], tp, cut, seq_len: int):
    """``decode_attn`` on a mesh, against the rank's blocks of a cut
    cache, written in place.  x (B, 1, d): the rank's rows; cache {"k",
    "v"} (B, S', Hkv, hd') (and a ring's whole "pos" (W,)); cache_len the
    rows' positions as ``decode_attn`` takes them; ``cut`` (dim, start,
    stop) of the layer's K/V over 'model' (dim 1: the sequence, of
    ``seq_len`` slots whole; dim 3: head_dim).

    The new token's q, k and v are gathered whole (``qkv_whole``) and
    rotated whole (RoPE pairs dim i with i + hd/2, which the head_dim cut
    would split).  The head_dim cut: every rank writes its slice of the
    new key, scores its slice of every head (``decode_scores``), the
    scores are summed over the group, and each rank takes the softmax
    and P V over its slice of V; the output (B, H, hd/M) is re-cut to the
    rank's heads by an all-to-all.  The sequence cut: only the rank whose
    block holds a row's position (a ring's slot) writes it; each rank's
    softmax state over its keys is gathered and merged in rank order.
    Then the rank's heads through the row-parallel ``w_o``.  Returns
    (out (B, 1, d), cache)."""
    B = x.shape[0]
    kc, vc = cache["k"], cache["v"]
    pos = torch.as_tensor(cache_len, device=x.device).long()
    rows = pos if pos.dim() == 1 else pos.expand(B)
    q, k, v = qkv_whole(p, x, n_heads=n_heads, n_kv_heads=n_kv_heads,
                        head_dim=head_dim, tp=tp)
    if rope_theta:
        q = apply_rope(q, rows[:, None], rope_theta)
        k = apply_rope(k, rows[:, None], rope_theta)
    dim, lo, hi = cut
    ring = "pos" in cache
    if ring:
        if pos.dim() == 1:
            raise ValueError(
                "per-request cache_len needs a full cache; ring caches "
                "share one position array across the batch")
        slot = torch.remainder(pos, seq_len).reshape(1)
        cache["pos"].index_copy_(0, slot, pos.reshape(1).to(torch.int32))
        lengths = rows.clamp(max=seq_len - 1)
        at = slot.expand(B)
    else:
        if window is not None:
            raise ValueError("a windowed layer decodes from a ring cache")
        lengths = rows
        at = rows
    n = kc.shape[1]
    flat_k = kc.view(B * n, *kc.shape[2:])
    flat_v = vc.view(B * n, *vc.shape[2:])
    base = torch.arange(B, device=x.device) * n
    if dim == 3:
        flat_k.index_copy_(0, base + at, k[:, 0, :, lo:hi])
        flat_v.index_copy_(0, base + at, v[:, 0, :, lo:hi])
    else:
        local = at - lo
        own = (local >= 0) & (local < n)
        idx = base + local.clamp(0, n - 1)
        _write_owned(flat_k, idx, own, k[:, 0])
        _write_owned(flat_v, idx, own, v[:, 0])
    return _attend_cut(p, q[:, 0], kc, vc, lengths, cut, head_dim=head_dim,
                       tp=tp, dtype=x.dtype), cache


def _attend_cut(p: Attention, q, k, v, lengths, cut, *, head_dim: int, tp,
                dtype):
    """One token's attention over the rank's blocks of a cut cache, then
    the row-parallel ``w_o``.  q (B, H, hd) every head, whole; k, v (B,
    S', Hkv, hd') the rank's blocks; lengths (B,) each row's last valid
    key, a whole-cache position; ``cut`` (dim, start, stop) of the blocks
    in those dims (1: the keys, 3: head_dim).  The head_dim cut: the
    rank's slice of every head scored (``decode_scores``), the scores
    summed over the group, softmax and P V over its V slice with the
    whole head's scale, the output re-cut to the rank's H·hd/M columns
    (the rows of ``w_o`` it holds) by an all-to-all, or where the model
    axis does not divide the heads by an all-gather.  The key cut: the
    rank's softmax states over its keys (``decode_partial``), gathered
    and merged in rank order, the rank's columns kept.  Returns out (B,
    1, d), summed over the group."""
    B, H = q.shape[:2]
    dim, lo, hi = cut
    cols = H * head_dim // tp.n_model
    if dim == 3:
        L32 = lengths.to(torch.int32).contiguous()
        s = KB.decode_scores(q[..., lo:hi], k, L32)
        if tp.n_model > 1:
            tp.all_reduce(s, tp.model_group, "model_all_reduce")
        o = KB.decode_softmax_pv(s, v, L32, head_dim=head_dim)
        if H % tp.n_model == 0:
            o = tp.model_all_to_all(o, split_dim=1, cat_dim=2)
        else:               # no head boundary at the rank's columns
            o = tp.gather_model(o[None], 0).permute(1, 2, 0, 3)
            o = o.reshape(B, -1)[:, tp.model_slice(cols)]
    else:
        part = KB.decode_partial(q, k, v,
                                 (lengths - lo).to(torch.int32).contiguous())
        o = merge_decode_partials(tp.gather_model(part[None], 0))
        o = o.reshape(B, -1)[:, tp.model_slice(cols)].to(dtype)
    o = o.reshape(B, 1, -1) @ weight(p.w_o, dtype, tp)
    return tp.from_model(o)


def cross_decode_tp(p: Attention, x, ek, ev, *, n_heads: int,
                    head_dim: int, tp, cut, frames: int):
    """The enc-dec's cross-attention for one token on a mesh, against the
    rank's blocks of the layer's ``ek``/``ev`` (B, Hkv, Se', hd'), the
    decode kernel's layout, read through their (B, Se', Hkv, hd') views;
    every one of the ``frames`` frames of every row is valid.  x (B, 1,
    d): the rank's rows; ``cut`` (dim, start, stop) of the blocks over
    'model' in the views' dims (1: the frames, 3: head_dim).  Only q
    moves: each rank multiplies its column block of ``w_q`` and the
    products are gathered whole over the model group (no RoPE; no cache
    byte is written or moved).  Then ``decode_attn_tp``'s attention over
    a cut cache.  Returns out (B, 1, d)."""
    B = x.shape[0]
    q = tp.gather_model(x[:, 0] @ weight(p.w_q, x.dtype, tp), -1)
    last = torch.full((B,), frames - 1, dtype=torch.int32, device=x.device)
    return _attend_cut(p, q.reshape(B, n_heads, head_dim),
                       ek.transpose(1, 2), ev.transpose(1, 2), last, cut,
                       head_dim=head_dim, tp=tp, dtype=x.dtype)
