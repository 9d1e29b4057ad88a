"""Plain PyTorch versions of the hand-written kernels.

Each computes the same function as its kernel, in float32, with the
reference package's masks and clamps.  ``kernels.backend`` runs the
forward ones for tensors on the CPU, where torch's autograd
differentiates them; the backward ones (``*_bwd_ref``) write out the
reference's backward kernels.  ``overlap_norm_ref`` is the kernel
benchmark's overlap probe.  ``ssd_chunk_ref`` is the SSD chunk
kernel's (the CPU runs the whole scan, ``models.mamba2.ssd_chunked``),
and ``ssd_ref`` the SSD's sequential definition.  ``rglru_scan_ref`` and
``rglru_scan_bwd_ref`` are the RG-LRU scan kernels' (a kernel of the
port with no Pallas counterpart: the reference scans in XLA).  On the
card they are what each kernel is held against.  They repeat the
kernels' arithmetic and are no yardstick of speed.
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


def overlap_norm_ref(x, eps: float = 1e-5):
    """The streaming normalize of the kernel benchmark's overlap probe:
    x (rows, d) float32 -> x·rsqrt(mean(x²)+eps), float32 (the
    reference's ``_overlap_kernel``, whose out-buffers are float32)."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)


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


def rmsnorm_split_sumsq_ref(x, scale):
    """The split row's pass a: each row of x (rows, d), this rank's d of
    its columns, as its float32 sum of x² (scale unused)."""
    return x.float().square().sum(dim=-1)


def rmsnorm_split_dot_ref(x, scale, g):
    """The split row's partial dot: each row's float32 sum of
    g·(1+scale)·x over this rank's columns."""
    return (g.float() * (1.0 + scale.float()) * x.float()).sum(dim=-1)


def rmsnorm_split_fwd_ref(x, scale, ss, d_full: int, eps: float = 1e-5):
    """y = x·rsqrt(ss/d_full + eps)·(1+scale) in float32, returned in x's
    dtype; ss (rows,) the whole rows' sums of squares."""
    rr = torch.rsqrt(ss[:, None] / d_full + eps)
    return (x.float() * rr * (1.0 + scale.float())).to(x.dtype)


def rmsnorm_split_bwd_ref(x, scale, g, ss, dot, d_full: int,
                          eps: float = 1e-5):
    """``rmsnorm_bwd_ref`` over this rank's columns of the rows, from the
    whole rows' ss and dot (rows,): mean(gs·x̂) = rr·dot/d_full, so dx =
    rr·(gs − x̂·rr·dot/d_full) in x's dtype, dscale = Σ_rows g·x̂ over the
    rank's columns in float32."""
    x32, g32 = x.float(), g.float()
    rr = torch.rsqrt(ss[:, None] / d_full + eps)
    xh = x32 * rr
    gs = g32 * (1.0 + scale.float())
    dx = rr * (gs - xh * (dot[:, None] * rr / d_full))
    return dx.to(x.dtype), (g32 * xh).sum(dim=0)


# the split row's plain ops, in the order ``kernels.rmsnorm.SplitRMSNorm``
# takes them (sumsq, dot, fwd, bwd)
RMSNORM_SPLIT = (rmsnorm_split_sumsq_ref, rmsnorm_split_dot_ref,
                 rmsnorm_split_fwd_ref, rmsnorm_split_bwd_ref)


def attention_ref(q, k, v, *, causal: bool = True):
    """q: (B, H, S, hd); k, v: (B, Hkv, S, hd) with H % Hkv == 0.
    Naive softmax attention in float32.  Returns (out (B, H, S, hd) in
    q's dtype, lse (B·H, S) float32) — the flash forward's two
    outputs."""
    B, H, S, hd = q.shape
    G = H // max(k.shape[1], 1)          # a rank with no heads: H = Hkv = 0
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


def decode_partial_ref(q, k, v, lengths):
    """The sequence cut's partial (``kernels.paged.ragged_decode_partial``):
    q (B, H, hd) whole heads; k, v (B, Skv, Hkv, hd) the rank's block of
    the keys; lengths (B,) int, keys 0..lengths[b] of the block valid
    (none when negative).  Returns (B, H, hd + 2) float32: m, the largest
    valid score (scaled by 1/sqrt(hd); NEG_INF when none), l = Σ exp(s −
    m) and acc = Σ exp(s − m)·v over the valid keys."""
    B, H, hd = q.shape
    Skv, G = k.shape[1], H // k.shape[2]
    k = k.float().repeat_interleave(G, dim=2)
    v = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k) / math.sqrt(hd)
    valid = (torch.arange(Skv, device=q.device)[None, :]
             <= lengths.to(q.device).long()[:, None])[:, None, :]
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]) * valid
    acc = torch.einsum("bhk,bkhd->bhd", p, v)
    return torch.cat([m[..., None], p.sum(dim=-1)[..., None], acc], dim=-1)


def decode_scores_ref(q, k, lengths):
    """The head_dim cut's pass 1 (``kernels.paged.decode_scores``): q (B,
    H, hd_r) and k (B, Skv, Hkv, hd_r), the rank's slices of the heads'
    dims; lengths (B,) int.  Returns the unscaled partial scores (B, H,
    Skv) float32 of keys 0..lengths[b], zeros past them (the kernel
    leaves those unwritten)."""
    Skv, G = k.shape[1], q.shape[1] // k.shape[2]
    k = k.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k)
    valid = (torch.arange(Skv, device=q.device)[None, :]
             <= lengths.to(q.device).long()[:, None])[:, None, :]
    return s.masked_fill(~valid, 0.0)


def decode_softmax_pv_ref(s, v, lengths, head_dim: int):
    """The head_dim cut's pass 2 (``kernels.paged.decode_softmax_pv``): s
    (B, H, Skv) float32 scores summed over the group; v (B, Skv, Hkv,
    hd_r) the rank's slice of V; lengths (B,) int.  The softmax of
    s/sqrt(``head_dim``) (the whole head's) over keys 0..lengths[b], the
    sum l clamped at 1e-30 as the kernel clamps it, then P V.  Returns
    (B, H, hd_r) in v's dtype."""
    Skv, G = v.shape[1], s.shape[1] // v.shape[2]
    valid = (torch.arange(Skv, device=s.device)[None, :]
             <= lengths.to(s.device).long()[:, None])[:, None, :]
    x = (s / math.sqrt(head_dim)).masked_fill(~valid, NEG_INF)
    p = torch.exp(x - x.amax(dim=-1, keepdim=True)) * valid
    o = torch.einsum("bhk,bkhd->bhd", p,
                     v.float().repeat_interleave(G, dim=2))
    return (o / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)).to(v.dtype)


def paged_decode_ref(q, pool_layer, pages, lengths, *, page_size: int):
    """``ragged_decode_ref`` over the keys a page table names: the
    request's window gathered from the pool (``serving.cache.
    gather_pages``), then attended.  q: (B, H, hd); pool_layer:
    (n_pages, page_size, 2·Hkv, hd), kv head j's K at index 2j and its V
    at 2j + 1; pages: (B, P) int64, key s of request b at row
    s % page_size of page pages[b, s // page_size]; lengths: (B,) int.
    Returns (B, H, hd) in q's dtype."""
    from repro_torch.serving.cache import gather_pages   # import cycle
    k, v = gather_pages(pool_layer, pages, page_size=page_size)
    return ragged_decode_ref(q, k.transpose(1, 2), v.transpose(1, 2),
                             lengths)


def _ssd_dtype(x):
    """The SSD's arithmetic type: float32, or float64 for float64 inputs
    (a float64 evaluation is what the card's checks hold both the kernel
    and the float32 plain version to at the full-width shapes)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _scan16(x, reverse: bool):
    """Inclusive (or reverse) cumsum along the last dim in XLA's CPU
    order: in blocks of 16 steps from index 0, each output the sum of its
    window taken in increasing index order, the blocks' totals scanned
    the same way and added to each block."""
    n = x.shape[-1]
    if n > 16:
        nb = -(-n // 16)
        blocks = torch.nn.functional.pad(x, (0, nb * 16 - n))
        inner = _scan16(blocks.reshape(*x.shape[:-1], nb, 16), reverse)
        tot = _scan16(inner[..., 0 if reverse else -1], reverse)
        carry = torch.nn.functional.pad(
            tot[..., 1:] if reverse else tot[..., :-1],
            (0, 1) if reverse else (1, 0))
        out = (inner + carry[..., None]).reshape(*x.shape[:-1], nb * 16)
        return out[..., :n]
    if not reverse:
        out = [x[..., 0]]
        for i in range(1, n):
            out.append(out[-1] + x[..., i])
        return torch.stack(out, dim=-1)
    out = x.clone()
    for t in range(1, n):               # out_i = x_i + x_{i+1} + ... in order
        out[..., :n - t] = out[..., :n - t] + x[..., t:]
    return out


class _Cumsum16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return _scan16(x.movedim(dim, -1), False).movedim(-1, dim)

    @staticmethod
    def backward(ctx, g):
        return _scan16(g.movedim(ctx.dim, -1), True).movedim(-1, ctx.dim), \
            None


def cumsum16(x, dim: int):
    """Inclusive cumsum along ``dim`` in the reference's order of sums,
    forward and backward: XLA's lowering of ``jnp.cumsum`` on the CPU
    adds in blocks of 16 steps (``_scan16``), and its transpose is the
    reverse cumsum in the same blocks.  ``torch.cumsum`` sums in another
    order, a few float32 ulp of |cum| apart per step, which the SSD's
    decay exp(cum_i − cum_j) turns into a relative error of the same
    size; in the reference's order the SSD's plain versions agree with
    the reference to the rounding of their other sums."""
    return _Cumsum16.apply(x, dim % x.dim())


def ssd_ref(x, dt, A, Bm, Cm, D):
    """The sequential SSD recurrence (the definition).

    x: (B, S, H, P); dt: (B, S, H) (post-softplus); A: (H,) negative;
    Bm, Cm: (B, S, N) (one group shared by the heads); D: (H,).
    h_t = exp(dt_t·A)·h_{t-1} + dt_t·B_t ⊗ x_t;  y_t = C_t·h_t + D·x_t.
    Returns (y in x's dtype, h_final (B, H, P, N) in the arithmetic
    type)."""
    ct = _ssd_dtype(x)
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    x32, dt32, A32 = x.to(ct), dt.to(ct), A.to(ct)
    B32, C32, D32 = Bm.to(ct), Cm.to(ct), D.to(ct)
    h = torch.zeros(Bsz, H, P, N, dtype=ct, device=x.device)
    ys = []
    for t in range(S):
        a = torch.exp(dt32[:, t] * A32)                        # (B, H)
        dBx = torch.einsum("bh,bn,bhp->bhpn", dt32[:, t], B32[:, t],
                           x32[:, t])
        h = h * a[:, :, None, None] + dBx
        y = torch.einsum("bhpn,bn->bhp", h, C32[:, t])
        ys.append(y + D32[None, :, None] * x32[:, t])
    return torch.stack(ys, dim=1).to(x.dtype), h


def ssd_chunk_ref(xh, dt, A, Bm, Cm, chunk: int):
    """The SSD chunk kernel's three outputs, per chunk c of ``chunk``
    steps and head h:

    - y_intra (B, S, H, P): (C·Bᵀ ⊙ decay ⊙ dt) x within the chunk, with
      decay_ij = exp(cum_i − cum_j) for j ≤ i and 0 above the diagonal;
    - states (B, nc, H, N, P): Σ_j exp(T − cum_j)·dt_j·B_j ⊗ x_j;
    - T (B, nc, H): Σ_j dt_j·A,

    where cum is the inclusive cumsum of dt·A inside the chunk, summed in
    the reference's order (``cumsum16``).  A ragged S counts as padded
    with dt = 0 steps (x, B, C zero), as the reference pads it; y_intra
    keeps S rows.  The decay is masked before the ``exp``, so the masked
    entries (cum_i − cum_j > 0, which overflows once |dt·A|·Q passes
    ~88) are never evaluated.  Float32 arithmetic (float64 for float64
    inputs)."""
    ct = _ssd_dtype(xh)
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = chunk
    nc = -(-S // Q)
    pad = nc * Q - S
    x = torch.nn.functional.pad(xh.to(ct), (0, 0, 0, 0, 0, pad))
    d = torch.nn.functional.pad(dt.to(ct), (0, 0, 0, pad))
    Bp = torch.nn.functional.pad(Bm.to(ct), (0, 0, 0, pad))
    Cp = torch.nn.functional.pad(Cm.to(ct), (0, 0, 0, pad))
    xc = x.reshape(Bsz, nc, Q, H, P)
    dtc = d.reshape(Bsz, nc, Q, H)
    Bc, Cc = Bp.reshape(Bsz, nc, Q, N), Cp.reshape(Bsz, nc, Q, N)
    cum = cumsum16(dtc * A.to(ct), dim=2)                      # (B,nc,Q,H)
    T = cum[:, :, -1]
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,nc,i,j,H)
    above = torch.ones(Q, Q, dtype=torch.bool, device=xh.device).triu(1)
    decay = torch.exp(diff.masked_fill(above[:, :, None], -math.inf))
    M = CB[..., None] * decay * dtc[:, :, None, :, :]
    y = torch.einsum("bcijh,bcjhp->bcihp", M, xc)
    y = y.reshape(Bsz, nc * Q, H, P)[:, :S]
    sdecay = torch.exp(T[:, :, None] - cum) * dtc              # (B,nc,Q,H)
    states = torch.einsum("bcjn,bcjhp->bchnp", Bc, xc * sdecay[..., None])
    return y, states, T


# --------------------------------------------------------------------- #
# the RG-LRU linear recurrence
# --------------------------------------------------------------------- #

def _scan_in_chunk(a, b):
    """Inclusive scan of the pairs (a_t, b_t) along dim 1 under the
    reference's ``_combine`` ((a1, b1), (a2, b2)) -> (a1·a2, b1·a2 + b2),
    by doubling: log2(Q) passes, each combining step t with step t − k.
    Returns (a_cum, b_loc): h_t = b_loc_t + a_cum_t·h_{-1}."""
    k, Q = 1, a.shape[1]
    while k < Q:
        a, b = (torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1),
                torch.cat([b[:, :k], b[:, :-k] * a[:, k:] + b[:, k:]], dim=1))
        k *= 2
    return a, b


def rglru_scan_ref(a, b, h0=None, chunk: int = 512):
    """The linear recurrence h_t = a_t·h_{t−1} + b_t as the reference
    computes it (``repro.models.rglru.rglru_scan`` after its gates): the
    sequence in chunks of ``chunk`` steps, a ragged tail padded with
    a = 1, b = 0 steps (the state carried unchanged), an associative
    scan within each chunk and the carry across chunks.  a, b: (B, S, W)
    float32; h0: (B, W) or None (zeros).  Returns (hs (B, S, W), h_last
    (B, W)) in float32 (float64 for float64 inputs); torch's autograd
    differentiates it."""
    B, S, W = a.shape
    Q = min(chunk, S)
    ct = _ssd_dtype(a)
    a, b = a.to(ct), b.to(ct)
    if S % Q:
        pad = Q - S % Q
        a = torch.nn.functional.pad(a, (0, 0, 0, pad), value=1.0)
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    h = (torch.zeros(B, W, dtype=ct, device=a.device) if h0 is None
         else h0.to(ct))
    outs = []
    for c in range(0, a.shape[1], Q):
        a_cum, b_loc = _scan_in_chunk(a[:, c:c + Q], b[:, c:c + Q])
        hc = b_loc + a_cum * h[:, None, :]
        outs.append(hc)
        h = hc[:, -1]
    return torch.cat(outs, dim=1)[:, :S], h


def rglru_scan_bwd_ref(a, hs, h0, dhs, dh_last, chunk: int = 512):
    """The VJP of ``rglru_scan_ref`` written out as the backward kernel
    computes it: the reverse sweep g_t = dhs_t + a_{t+1}·g_{t+1}, seeded
    with dh_last at t = S − 1, run as the same chunked scan over the
    reversed sequence; db_t = g_t, da_t = g_t·h_{t−1} (h_{−1} = h0, or
    0) and dh0 = a_0·g_0.  dhs, dh_last, h0 may be None (zeros).
    Returns (da, db, dh0) in float32 (float64 for float64 inputs)."""
    ct = _ssd_dtype(a)
    a, hs = a.to(ct), hs.to(ct)
    B, S, W = a.shape
    zeros = torch.zeros(B, W, dtype=ct, device=a.device)
    coef = torch.cat([a[:, 1:], torch.ones_like(a[:, :1])], dim=1)
    u = torch.zeros_like(a) if dhs is None else dhs.to(ct)
    g, _ = rglru_scan_ref(coef.flip(1), u.flip(1),
                          None if dh_last is None else dh_last.to(ct),
                          chunk=chunk)
    g = g.flip(1)
    h_prev = torch.cat([(zeros if h0 is None else h0.to(ct))[:, None],
                        hs[:, :-1]], dim=1)
    return g * h_prev, g, a[:, 0] * g[:, 0]
