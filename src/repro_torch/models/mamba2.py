"""Mamba-2 SSD (state-space duality, arXiv:2405.21060) in PyTorch: the
training forward and loss (``repro.models.mamba2``).

Training uses the chunked SSD algorithm: the sequence splits into chunks
of Q tokens; within a chunk the recurrence is a masked quadratic form,
across chunks a small (H, P, N) state is carried.  On the card the
chunk terms run in the hand-written kernel (``kernels.backend.ssd``); on
the CPU, and in the card's backward, they run in ``ssd_chunked`` here.
The reference stacks its layers along a leading L dim and scans them;
here each block is a module of a ``ModuleList`` and the loop is Python.
Serving (``prefill``, ``decode_step`` and the recurrent ``ssd_step``)
comes with the Mamba-2 state-serving slice.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels import backend as KB
from repro_torch.kernels.ref import cumsum16
from repro_torch.models.layers import (cross_entropy_chunked, lm_head_matrix,
                                       out_std, param, rmsnorm,
                                       trunc_normal_)


def _dims(cfg: ModelConfig):
    s = cfg.ssm or SSMConfig()
    di = s.d_inner(cfg.d_model)
    return s, di, s.n_ssm_heads(cfg.d_model), s.head_dim, s.d_state


# --------------------------------------------------------------------- #
# modules and init
# --------------------------------------------------------------------- #

class Mamba2Mixer(nn.Module):
    """The SSD mixer's weights in the reference's layout: the input
    projections ``w_z``, ``w_x`` (d, d_inner), ``w_B``, ``w_C`` (d, N),
    ``w_dt`` (d, H), the depthwise causal conv ``conv_w`` (K, d_inner +
    2N) and ``conv_b``, the output projection ``w_out`` (d_inner, d), in
    the model's dtype; ``dt_bias``, ``A_log``, ``D`` (H,) and the gated
    norm's scale ``norm`` (d_inner,) in float32."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        s, di, H, _, N = _dims(cfg)
        d = cfg.d_model
        f32 = torch.float32
        self.w_z = param((d, di), dtype=dtype, device=device)
        self.w_x = param((d, di), dtype=dtype, device=device)
        self.w_B = param((d, N), dtype=dtype, device=device)
        self.w_C = param((d, N), dtype=dtype, device=device)
        self.w_dt = param((d, H), dtype=dtype, device=device)
        self.dt_bias = param((H,), dtype=f32, device=device)
        self.A_log = param((H,), dtype=f32, device=device)
        self.D = param((H,), dtype=f32, device=device)
        self.conv_w = param((s.d_conv, di + 2 * N), dtype=dtype,
                            device=device)
        self.conv_b = param((di + 2 * N,), dtype=dtype, device=device)
        self.norm = param((di,), dtype=f32, device=device)
        self.w_out = param((di, d), dtype=dtype, device=device)

    def init_weights(self, generator: torch.Generator, n_layers: int):
        """The reference's rules: dense std 0.02, ``w_out`` the
        depth-scaled out std, ``dt_bias`` the inverse softplus of dt
        log-spaced over [1e-3, 1e-1], ``A_log = log(1..H)``, ``D = 1``,
        ``conv_w`` std 0.2, zero ``conv_b`` and norm scale."""
        for w in (self.w_z, self.w_x, self.w_B, self.w_C, self.w_dt):
            trunc_normal_(w, 0.02, generator)
        H = self.A_log.shape[0]
        dev = self.A_log.device
        dt = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1), H,
                                      device=dev))
        self.dt_bias.data.copy_(dt + torch.log(-torch.expm1(-dt)))
        self.A_log.data.copy_(torch.log(torch.arange(
            1, H + 1, dtype=torch.float32, device=dev)))
        self.D.data.fill_(1.0)
        trunc_normal_(self.conv_w, 0.2, generator)
        self.conv_b.data.zero_()
        self.norm.data.zero_()
        trunc_normal_(self.w_out, out_std(n_layers), generator)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.norm = param((cfg.d_model,), dtype=torch.float32, device=device)
        self.mixer = Mamba2Mixer(cfg, dtype=dtype, device=device)


class Mamba2(nn.Module):
    """The Mamba-2 LM's weights: the embedding (tied as the head unless
    the config unties it), one ``Block`` (pre-norm, mixer) per layer and
    the final norm.  ``dtype`` is the dtype of the matrices, the conv
    and the embedding (float32 master weights for training); the norm
    scales and the SSD's per-head parameters are float32.  Parameters
    start uninitialised and frozen; call ``init_weights`` or load them
    with ``weights.from_jax_params``, and ``requires_grad_`` to train."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        if cfg.arch_type != "ssm":
            raise ValueError(f"Mamba2 is the ssm family, got "
                             f"{cfg.arch_type!r}")
        self.cfg = cfg
        d, V = cfg.d_model, cfg.padded_vocab
        self.tok = param((V, d), dtype=dtype, device=device)
        self.lm_head = (None if cfg.tie_embeddings
                        else param((d, V), dtype=dtype, device=device))
        self.final_norm = param((d,), dtype=torch.float32, device=device)
        self.layers = nn.ModuleList(
            Block(cfg, dtype=dtype, device=device)
            for _ in range(cfg.n_layers))

    @property
    def dtype(self) -> torch.dtype:
        return self.tok.dtype

    @property
    def device(self) -> torch.device:
        return self.tok.device

    def init_weights(self, generator: torch.Generator) -> "Mamba2":
        """The reference's init rules, drawn from ``generator`` (which
        must live on the model's device)."""
        trunc_normal_(self.tok, 0.02, generator)
        if self.lm_head is not None:
            trunc_normal_(self.lm_head, 0.02, generator)
        self.final_norm.data.zero_()
        for blk in self.layers:
            blk.norm.data.zero_()
            blk.mixer.init_weights(generator, self.cfg.n_layers)
        return self


Model = Mamba2


# --------------------------------------------------------------------- #
# the depthwise causal conv and the chunked SSD scan
# --------------------------------------------------------------------- #

def causal_conv1d(x, w, b):
    """Depthwise causal conv.  x: (B, S, C); w: (K, C); b: (C,).  The K
    shifted products are summed in x's dtype in the order i = 0..K-1, as
    the reference does (``F.conv1d`` would run a float32 convolution in
    TF32 through cuDNN)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, 0:S] * w[0].to(x.dtype)
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def ssd_chunked(xh, dt, A, Bm, Cm, D, *, chunk: int, h0=None):
    """Chunked SSD (the reference's, in float32).

    xh: (B, S, H, P); dt: (B, S, H) (post-softplus); A: (H,) negative;
    Bm, Cm: (B, S, N) (one group shared by the heads); D: (H,).
    Returns (y (B, S, H, P) in xh's dtype, h_final (B, H, P, N)
    float32).  A ragged S is padded with dt = 0 steps (the state is
    carried, nothing added).

    The intra-chunk decay exp(cum_i − cum_j) is masked to j ≤ i *before*
    the exp: above the diagonal cum_i − cum_j > 0, whose exp overflows
    to inf once |dt·A|·Q passes ~88, and the reference's
    ``where(mask, exp(diff), 0)`` then has a NaN gradient (0·inf).  The
    forward values are the reference's; the gradients equal its
    gradients wherever those are finite."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    S_orig = S
    if S % Q:
        pad = Q - S % Q
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        S += pad
    nc = S // Q

    xc = xh.float().reshape(Bsz, nc, Q, H, P)
    dtc = dt.float().reshape(Bsz, nc, Q, H)
    Bc = Bm.float().reshape(Bsz, nc, Q, N)
    Cc = Cm.float().reshape(Bsz, nc, Q, N)
    cum = cumsum16(dtc * A, dim=2)                            # (B,nc,Q,H)
    T = cum[:, :, -1]                                         # (B,nc,H)

    # intra-chunk quadratic part
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)              # (B,nc,Q,Q)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,nc,i,j,H)
    above = torch.ones(Q, Q, dtype=torch.bool, device=xh.device).triu(1)
    decay = torch.exp(diff.masked_fill(above[:, :, None], -math.inf))
    M = CB[..., None] * decay * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M, xc)

    # chunk-final states: S_c = Σ_j exp(T − cum_j) dt_j B_j ⊗ x_j
    sdecay = torch.exp(T[:, :, None] - cum) * dtc             # (B,nc,Q,H)
    Sc = torch.einsum("bcjn,bcjhp->bchpn", Bc, xc * sdecay[..., None])

    # scan across chunks
    h = (torch.zeros(Bsz, H, P, N, dtype=torch.float32, device=xh.device)
         if h0 is None else h0)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * torch.exp(T[:, c])[:, :, None, None] + Sc[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                     # (B,nc,H,P,N)

    # inter-chunk contribution: C_i · h_prev decayed by exp(cum_i)
    y_inter = torch.einsum("bcin,bchpn->bcihp", Cc, h_prevs) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    y = y + D[None, None, :, None] * xh.float()
    return y[:, :S_orig].to(xh.dtype), h


# --------------------------------------------------------------------- #
# mixer, blocks and the loss
# --------------------------------------------------------------------- #

def mixer_forward(m: Mamba2Mixer, x, cfg: ModelConfig):
    """x: (B, S, d) -> (B, S, d).  The SSD scan and the gated output norm
    run through ``kernels.backend`` (the kernels on the card)."""
    s, di, H, P, N = _dims(cfg)
    B_, S, _ = x.shape
    z = x @ m.w_z.to(x.dtype)
    xin = x @ m.w_x.to(x.dtype)
    Bm = x @ m.w_B.to(x.dtype)
    Cm = x @ m.w_C.to(x.dtype)
    dt = F.softplus((x @ m.w_dt.to(x.dtype)).float() + m.dt_bias)
    xbc = torch.cat([xin, Bm, Cm], dim=-1)
    xbc = F.silu(causal_conv1d(xbc, m.conv_w, m.conv_b))
    xin, Bm, Cm = torch.split(xbc, [di, N, N], dim=-1)
    xh = xin.reshape(B_, S, H, P)          # a view: the kernel reads strides
    A = -torch.exp(m.A_log)
    y, _ = KB.ssd(xh, dt, A, Bm, Cm, m.D, chunk=s.chunk_size)
    y = y.reshape(B_, S, di)
    y = rmsnorm(y * F.silu(z), m.norm, cfg.norm_eps)
    return y @ m.w_out.to(x.dtype)


def _block(blk: Block, x, cfg: ModelConfig):
    return x + mixer_forward(blk.mixer, rmsnorm(x, blk.norm, cfg.norm_eps),
                             cfg)


def forward_hidden(model: Mamba2, cfg: ModelConfig, tokens, *,
                   dtype=torch.bfloat16, remat: bool = True):
    """tokens: (B, S) int -> final hidden states (B, S, d) in ``dtype``.
    The embedding is cast to ``dtype`` before the gather, as the
    reference does.  ``remat`` recomputes each block in the backward
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of
    its scan body); it changes memory, not the numbers."""
    x = F.embedding(tokens, model.tok.to(dtype))
    for blk in model.layers:
        if remat:
            x = checkpoint(_block, blk, x, cfg, use_reentrant=False)
        else:
            x = _block(blk, x, cfg)
    return rmsnorm(x, model.final_norm, cfg.norm_eps)


def loss_fn(model: Mamba2, cfg: ModelConfig, batch, *, z_loss: float = 0.0,
            dtype=torch.bfloat16, remat: bool = True):
    """batch: ``tokens`` and ``labels`` (B, S) int64, optional ``mask``
    (B, S) float32.  Returns (loss, metrics) as the reference: the loss
    and ``ce_loss`` (both with the z-loss term) and ``z_sq``."""
    h = forward_hidden(model, cfg, batch["tokens"], dtype=dtype,
                       remat=remat)
    labels = batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    loss, z_sq = cross_entropy_chunked(h, lm_head_matrix(model), labels,
                                       mask, cfg.vocab_size, z_loss=z_loss)
    return loss, {"ce_loss": loss, "z_sq": z_sq, "loss": loss}
