"""Plain PyTorch versions of the hand-written kernels.

Each computes the same function as its kernel, in float32, with the
reference package's masks and clamps.  ``kernels.backend`` runs the
forward ones for tensors on the CPU, where torch's autograd
differentiates them; the backward ones (``*_bwd_ref``) write out the
reference's backward kernels.  ``ssd_chunk_ref`` is the SSD chunk
kernel's (the CPU runs the whole scan, ``models.mamba2.ssd_chunked``),
and ``ssd_ref`` the SSD's sequential definition.  On the card they are what each kernel is
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
