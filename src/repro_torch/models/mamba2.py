"""Mamba-2 SSD (state-space duality, arXiv:2405.21060) in PyTorch: the
training forward and loss, the exact-length prefill and the recurrent
decode step (``repro.models.mamba2``).

Training and prefill use the chunked SSD algorithm: the sequence splits
into chunks of Q tokens; within a chunk the recurrence is a masked
quadratic form, across chunks a small (H, P, N) state is carried.  On
the card the chunk terms run in the hand-written kernel
(``kernels.backend.ssd``); on the CPU, and in the card's backward, they
run in ``ssd_chunked`` here.  Decode is the O(1) recurrent step
(``ssd_step``) on a state of one (H, P, N) float32 SSD state and the
last d_conv − 1 conv inputs per layer and request.
The reference stacks its layers along a leading L dim and scans them;
here each block is a module of a ``ModuleList`` and the loop is Python.

On a data × model mesh the forward and the prefill cut the residual
along the sequence by default (``seq_shard=True``, the reference's
``residual_spec``): the mixer enters on the gathered rows (the conv and
the SSD need the whole S) and leaves by the reduce-scatter of ``w_out``'s
partial sums; the block norms and the final norm run on the rank's rows.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels import backend as KB
from repro_torch.kernels.ref import cumsum16
from repro_torch.models.layers import (P, copy_whole_, embed, embed_specs,
                                       fsdp_axis, lm_head_matrix, lm_loss,
                                       out_std, param, recompute, rmsnorm,
                                       trunc_normal_, whole_shape)
from repro_torch.parallel import seq_of, tp_of, weight


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
        H = whole_shape(self.A_log)[0]
        dev = self.A_log.device
        dt = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1), H,
                                      device=dev))
        copy_whole_(self.dt_bias, dt + torch.log(-torch.expm1(-dt)))
        copy_whole_(self.A_log, torch.log(torch.arange(
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


def mixer_specs(fsdp, lead: tuple = ()):
    return {"w_z": P(*lead, fsdp, "model"),
            "w_x": P(*lead, fsdp, "model"),
            "w_B": P(*lead, fsdp, None),
            "w_C": P(*lead, fsdp, None),
            "w_dt": P(*lead, fsdp, None),
            "dt_bias": P(*lead, None),
            "A_log": P(*lead, None),
            "D": P(*lead, None),
            "conv_w": P(*lead, None, "model"),
            "conv_b": P(*lead, "model"),
            "norm": P(*lead, "model"),
            "w_out": P(*lead, "model", fsdp)}


def param_specs(cfg: ModelConfig, multi_pod: bool = False):
    """The reference's spec tree (its leaf paths; ``lead`` is its
    stacked layer dim)."""
    f = fsdp_axis(multi_pod)
    return {"embed": embed_specs(cfg.tie_embeddings, f),
            "layers": {"mixer": mixer_specs(f, lead=(None,)),
                       "norm": P(None, None)},
            "final_norm": P(None)}


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

def mixer_forward(m: Mamba2Mixer, x, cfg: ModelConfig, *,
                  with_state: bool = False, tp=None, seq: bool = False):
    """x: (B, S, d) -> (B, S, d).  The SSD scan and the gated output norm
    run through ``kernels.backend`` (the kernels on the card).  With
    ``with_state`` also the state a decode step continues from:
    {"h": the SSD's final state (B, H, P, N) float32, "conv": the last
    d_conv − 1 conv inputs (B, d_conv − 1, d_inner + 2N)}, zero rows on
    the left of a sequence shorter than that, as the causal conv pads
    it.  On a mesh (``tp``, training) the mixer is head-parallel: see
    ``_mixer_tp``."""
    if tp is not None:
        return _mixer_tp(m, x, cfg, tp, with_state=with_state, seq=seq)
    s, di, H, P, N = _dims(cfg)
    B_, S, _ = x.shape
    z = x @ m.w_z.to(x.dtype)
    xin = x @ m.w_x.to(x.dtype)
    Bm = x @ m.w_B.to(x.dtype)
    Cm = x @ m.w_C.to(x.dtype)
    dt = F.softplus((x @ m.w_dt.to(x.dtype)).float() + m.dt_bias)
    xbc_in = torch.cat([xin, Bm, Cm], dim=-1)
    xbc = F.silu(causal_conv1d(xbc_in, m.conv_w, m.conv_b))
    xin, Bm, Cm = torch.split(xbc, [di, N, N], dim=-1)
    xh = xin.reshape(B_, S, H, P)          # a view: the kernel reads strides
    A = -torch.exp(m.A_log)
    y, h_final = KB.ssd(xh, dt, A, Bm, Cm, m.D, chunk=s.chunk_size)
    y = y.reshape(B_, S, di)
    y = rmsnorm(y * F.silu(z), m.norm, cfg.norm_eps)
    out = y @ m.w_out.to(x.dtype)
    if not with_state:
        return out
    K = s.d_conv
    tail = F.pad(xbc_in, (0, 0, K - 1, 0))[:, -(K - 1):]
    return out, {"h": h_final, "conv": tail}


def _mixer_tp(m: Mamba2Mixer, x, cfg: ModelConfig, tp, *,
              with_state: bool = False, seq: bool = False):
    """The mixer on this rank's H/M SSD heads.  ``w_z`` and ``w_x`` are
    column-parallel (the heads' d_inner/M channels), ``w_out``
    row-parallel; ``w_B``, ``w_C`` and ``w_dt`` and the per-head
    parameters are whole on every model rank, so their outputs (B and C
    before the conv, dt after the softplus, A, D) pass ``to_model``
    before the rank takes its heads.  The conv's weights are cut over
    the concatenated (x, B, C) channels, which is not the heads' cut:
    they are gathered over the model group and the rank takes its heads'
    x channels and all of B's and C's.  The gated norm normalises over
    the whole d_inner from the ranks' parts (``kernels.backend.
    rmsnorm_split``).  With ``with_state`` also the rank's state: "h"
    (B, H/M, P, N) of its heads and "conv" the whole conv tail (B,
    d_conv − 1, d_inner + 2N), the heads' x channels gathered.  With
    ``seq`` x is the rank's rows of the cut residual: gathered along S
    first (every consumer of the gathered rows gives whole grads, so the
    gather's backward only keeps the rank's rows), the output
    reduce-scattered back to them."""
    if seq:
        x = tp.seq_gather(x, whole_grad=True)
    s, di, H, P, N = _dims(cfg)
    B_, S, _ = x.shape
    dt_ = x.dtype
    hs = tp.model_slice(H // tp.n_model)
    cs = tp.model_slice(di // tp.n_model)
    xm = tp.to_model(x)
    z = xm @ weight(m.w_z, dt_, tp)
    xin = xm @ weight(m.w_x, dt_, tp)
    Bm = tp.to_model(x @ weight(m.w_B, dt_, tp))
    Cm = tp.to_model(x @ weight(m.w_C, dt_, tp))
    dt = tp.to_model(F.softplus((x @ weight(m.w_dt, dt_, tp)).float()
                                + m.dt_bias))[..., hs]
    A = tp.to_model(-torch.exp(m.A_log))[hs]
    D = tp.to_model(m.D)[hs]
    conv_w, conv_b = (tp.model_gather(w, -1) for w in (m.conv_w, m.conv_b))
    conv_w = torch.cat([conv_w[:, cs], conv_w[:, di:]], dim=-1)
    conv_b = torch.cat([conv_b[cs], conv_b[di:]])
    xbc_in = torch.cat([xin, Bm, Cm], dim=-1)
    xbc = F.silu(causal_conv1d(xbc_in, conv_w, conv_b))
    xin, Bm, Cm = torch.split(xbc, [cs.stop - cs.start, N, N], dim=-1)
    xh = xin.reshape(B_, S, hs.stop - hs.start, P)
    y, h_final = KB.ssd(xh, dt, A, Bm, Cm, D, chunk=s.chunk_size)
    y = y.reshape(B_, S, -1) * F.silu(z)
    y = KB.rmsnorm_split(y, m.norm, d_full=di, reduce=tp.sum_over_model,
                         eps=cfg.norm_eps)
    out = tp.leave(y @ weight(m.w_out, dt_, tp), seq)
    if not with_state:
        return out
    K = s.d_conv
    tail = F.pad(xbc_in, (0, 0, K - 1, 0))[:, -(K - 1):]
    w = cs.stop - cs.start
    tail = torch.cat([tp.model_gather(tail[..., :w], -1), tail[..., w:]],
                     dim=-1)
    return out, {"h": h_final, "conv": tail}


def _block(blk: Block, x, cfg: ModelConfig, tp=None, seq: bool = False):
    return x + mixer_forward(blk.mixer, rmsnorm(x, blk.norm, cfg.norm_eps),
                             cfg, tp=tp, seq=seq)


def forward_hidden(model: Mamba2, cfg: ModelConfig, tokens, *,
                   dtype=torch.bfloat16, remat: bool = True,
                   seq_shard: bool = True):
    """tokens: (B, S) int -> final hidden states (B, S, d) in ``dtype``.
    The embedding is cast to ``dtype`` before the gather, as the
    reference does.  ``remat`` recomputes each block in the backward
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of
    its scan body); it changes memory, not the numbers.  A model cut to
    a mesh (``parallel.shard``) runs its mixers head-parallel, the
    embedding vocab-parallel; with ``seq_shard`` and ``parallel.seq_cut``
    of S the residual is cut along the sequence (the module's
    docstring), the block norms and the final norm recorded as partial
    (``TensorParallel.note_partial``; the reference norms the cut
    residual, ``mamba2.py:280``) and the final hiddens gathered whole."""
    tp = tp_of(model)
    seq = seq_of(tp, tokens.shape[1], seq_shard)
    x = embed(model, tokens, dtype, tp, seq)
    if seq:
        tp.note_partial(model.final_norm, *(b.norm for b in model.layers))
    for blk in model.layers:
        if remat:
            x = recompute(_block, blk, x, cfg, tp, seq)
        else:
            x = _block(blk, x, cfg, tp, seq)
    h = rmsnorm(x, model.final_norm, cfg.norm_eps)
    return tp.seq_gather(h) if seq else h


def loss_fn(model: Mamba2, cfg: ModelConfig, batch, *, z_loss: float = 0.0,
            dtype=torch.bfloat16, remat: bool = True,
            seq_shard: bool = True):
    """batch: ``tokens`` and ``labels`` (B, S) int64, optional ``mask``
    (B, S) float32.  Returns (loss, metrics) as the reference: the loss
    and ``ce_loss`` (both with the z-loss term) and ``z_sq``.
    ``seq_shard`` as in ``forward_hidden``; ``registry.loss_fn`` passes
    none, as the reference's ``loss_fn`` (``mamba2.py:284``) swallows it
    in ``**_``, so training through the registry always cuts."""
    h = forward_hidden(model, cfg, batch["tokens"], dtype=dtype,
                       remat=remat, seq_shard=seq_shard)
    tp = tp_of(model)
    loss, z_sq = lm_loss(model, cfg, h, batch, z_loss, tp,
                         gathered=seq_of(tp, batch["tokens"].shape[1],
                                         seq_shard))
    return loss, {"ce_loss": loss, "z_sq": z_sq, "loss": loss}


# --------------------------------------------------------------------- #
# serving: the recurrent step, prefill and decode
# --------------------------------------------------------------------- #

def ssd_update(h, x, dt, A, Bv):
    """The state's half of ``ssd_step``: h·exp(dt·A) + dt·B ⊗ x in
    float32 (over the N of Bv (B, N), all or a block of them)."""
    dt32 = dt.float()
    a = torch.exp(dt32 * A)                                   # (B, H)
    dBx = (dt32[:, :, None] * x.float())[..., None] \
        * Bv.float()[:, None, None, :]                        # (B, H, P, N)
    return h * a[:, :, None, None] + dBx


def ssd_step(h, x, dt, A, Bv, Cv, D):
    """One recurrent SSD step (the reference's ``ssd_step``).  h: (B, H,
    P, N) float32; x: (B, H, P); dt: (B, H) (post-softplus); A, D: (H,)
    float32; Bv, Cv: (B, N).  h' = h·exp(dt·A) + dt·B ⊗ x and
    y = h'·C + D·x, in float32.  Returns (h' float32, y in x's dtype)."""
    h = ssd_update(h, x, dt, A, Bv)
    y = torch.einsum("bhpn,bn->bhp", h, Cv.float())
    y = y + D[None, :, None] * x.float()
    return h, y.to(x.dtype)


def conv_step(buf, w, b):
    """The depthwise conv's output at the newest of ``buf``'s d_conv rows
    (B, d_conv, C), its products summed in buf's dtype in the order
    i = 0..K−1 as ``causal_conv1d`` sums them, then SiLU."""
    out = buf[:, 0] * w[0]
    for i in range(1, w.shape[0]):
        out = out + buf[:, i] * w[i]
    return F.silu(out + b)


def mixer_decode(m: Mamba2Mixer, x, state, cfg: ModelConfig):
    """One token through the mixer.  x: (B, 1, d); state: {"h": (B, H, P,
    N) float32, "conv": (B, d_conv − 1, d_inner + 2N)}.  The conv runs
    over the carried rows and the new one, its K products summed in x's
    dtype in the order i = 0..K−1 as ``causal_conv1d`` sums them; the
    gated norm runs through ``kernels.backend``.  Returns (out (B, 1, d),
    the new state)."""
    _, di, H, P, N = _dims(cfg)
    B_ = x.shape[0]
    xt = x[:, 0]
    z = xt @ m.w_z.to(x.dtype)
    xin = xt @ m.w_x.to(x.dtype)
    Bm = xt @ m.w_B.to(x.dtype)
    Cm = xt @ m.w_C.to(x.dtype)
    dt = F.softplus((xt @ m.w_dt.to(x.dtype)).float() + m.dt_bias)
    xbc = torch.cat([xin, Bm, Cm], dim=-1)                    # (B, di+2N)
    buf = torch.cat([state["conv"], xbc[:, None]], dim=1)
    xbc = conv_step(buf, m.conv_w.to(x.dtype), m.conv_b.to(x.dtype))
    xin, Bm, Cm = torch.split(xbc, [di, N, N], dim=-1)
    h, y = ssd_step(state["h"], xin.reshape(B_, H, P), dt,
                    -torch.exp(m.A_log), Bm, Cm, m.D)
    y = rmsnorm(y.reshape(B_, di) * F.silu(z), m.norm, cfg.norm_eps)
    return (y @ m.w_out.to(x.dtype))[:, None], {"h": h, "conv": buf[:, 1:]}


def state_struct(cfg: ModelConfig, batch: int, *, dtype=torch.bfloat16,
                 device="cuda"):
    """Zeroed decode state for ``batch`` rows (the reference's
    ``_state_struct``; its ``_cache_struct`` is this, since the state is
    O(1) in the length): "h" (L, batch, H, P, N) float32, "conv" (L,
    batch, d_conv − 1, d_inner + 2N) in ``dtype``."""
    s, di, H, P, N = _dims(cfg)
    L = cfg.n_layers
    return {"h": torch.zeros(L, batch, H, P, N, dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(L, batch, s.d_conv - 1, di + 2 * N,
                                dtype=dtype, device=device)}


def _state_cut(layout, name: str, whole_dims):
    """(dim, start, stop) of a layer's state leaf cut over 'model', in the
    layer's dims (the leaf's less its L), or None where it is whole over
    'model'; a cut the port does not serve raises."""
    cut = layout.model_cut(name)
    if cut is None:
        return None
    if cut[0] - 1 not in whole_dims:
        raise NotImplementedError(f"state leaf {name!r} cut "
                                  f"{layout.specs[name]}")
    return cut[0] - 1, cut[1], cut[2]


def _h_to_box(tp, h, cut):
    """The prefill's final state of the rank's heads (B, H/M, P, N) -> the
    state's box: its heads' block as it is, its block of N (an
    all-to-all: N out, heads in), or every head (an all-gather)."""
    if cut is None:
        return tp.model_gather(h, 1)
    if cut[0] == 1:
        return h
    return tp.model_all_to_all(h, split_dim=3, cat_dim=1)


def _prefill_tp(model: Mamba2, cfg: ModelConfig, tokens, layout,
                seq_shard: bool = True):
    """``prefill`` on a mesh: the rank's rows, the mixers head-parallel
    (the SSD chunk kernel on the rank's heads, as in training); each
    layer's final state re-cut to the state's box (``_h_to_box``) and the
    conv tail cut to its channels.  With ``seq_shard`` and
    ``parallel.seq_cut`` of S the residual is cut along the sequence, as
    the reference's prefill cuts it (``mamba2.py:313``); the states come
    from the gathered rows, and the last position's hidden from the last
    model rank (``TensorParallel.last_row``).  Returns (the rank's vocab
    columns of the last logits, the rank's state blocks)."""
    tp = model.tp
    h_cut = _state_cut(layout, "h", (1, 3))
    c_cut = _state_cut(layout, "conv", (2,))
    seq = seq_of(tp, tokens.shape[1], seq_shard)
    x = embed(model, tokens, model.dtype, tp, seq)
    hs, convs = [], []
    for blk in model.layers:
        y, st = _mixer_tp(blk.mixer, rmsnorm(x, blk.norm, cfg.norm_eps), cfg,
                          tp, with_state=True, seq=seq)
        x = x + y
        hs.append(_h_to_box(tp, st["h"], h_cut))
        conv = st["conv"]
        convs.append(conv if c_cut is None else conv[..., c_cut[1]:c_cut[2]])
    x = rmsnorm(tp.last_row(x, seq), model.final_norm, cfg.norm_eps)
    return (x @ tp.head(model, x.dtype)).float(), \
        {"h": torch.stack(hs), "conv": torch.stack(convs)}


def _mixer_decode_tp(m: Mamba2Mixer, x, state, cfg: ModelConfig, tp,
                     h_cut, c_cut):
    """One token through the mixer on a mesh, the state the rank's blocks:
    the conv over the rank's channels of (x, B, C) (its block of
    ``conv_w``, or the whole conv gathered where the state is whole),
    its output gathered; the SSD step on the state's cut (its N: the
    partial y summed over the group in float32, D·x added after; its
    heads; or whole); the gated norm over the rank's heads (the split
    row) and the row-parallel ``w_out``."""
    _, di, H, P, N = _dims(cfg)
    B_ = x.shape[0]
    dt_ = x.dtype
    xt = x[:, 0]
    hs = tp.model_slice(H // tp.n_model)
    cs = tp.model_slice(di // tp.n_model)
    z = xt @ weight(m.w_z, dt_, tp)
    xin = tp.model_gather(xt @ weight(m.w_x, dt_, tp), -1)
    Bm = xt @ weight(m.w_B, dt_, tp)
    Cm = xt @ weight(m.w_C, dt_, tp)
    dt = F.softplus((xt @ weight(m.w_dt, dt_, tp)).float() + m.dt_bias)
    xbc = torch.cat([xin, Bm, Cm], dim=-1)                   # (B, di+2N)
    conv_w, conv_b = m.conv_w.to(dt_), m.conv_b.to(dt_)
    if c_cut is None:
        conv_w, conv_b = (tp.model_gather(w, -1) for w in (conv_w, conv_b))
    else:
        xbc = xbc[:, c_cut[1]:c_cut[2]]
    buf = torch.cat([state["conv"], xbc[:, None]], dim=1)
    out = conv_step(buf, conv_w, conv_b)
    if c_cut is not None:
        out = tp.model_gather(out, -1)
    xin, Bm, Cm = torch.split(out, [di, N, N], dim=-1)
    xh = xin.reshape(B_, H, P)
    A = -torch.exp(m.A_log)
    if h_cut is not None and h_cut[0] == 1:                  # its heads
        h, y = ssd_step(state["h"], xh[:, hs], dt[:, hs], A[hs], Bm, Cm,
                        m.D[hs])
    else:
        # the state's N (all of them, or the rank's): y's partial sum
        # over them, D·x added after the sum
        ns = slice(None) if h_cut is None else slice(h_cut[1], h_cut[2])
        h = ssd_update(state["h"], xh, dt, A, Bm[:, ns])
        y = torch.einsum("bhpn,bn->bhp", h, Cm[:, ns].float())
        if h_cut is not None:
            tp.all_reduce(y, tp.model_group, "model_all_reduce")
        y = (y + m.D[None, :, None] * xh.float()).to(dt_)[:, hs]
    y = y.reshape(B_, -1) * F.silu(z)
    y = KB.rmsnorm_split(y, m.norm, d_full=di, reduce=tp.sum_over_model,
                         eps=cfg.norm_eps)
    out = tp.from_model(y @ weight(m.w_out, dt_, tp))
    return out[:, None], {"h": h, "conv": buf[:, 1:]}


def _decode_tp(model: Mamba2, cfg: ModelConfig, state, token, layout):
    """``decode_step`` on a mesh: the rank's rows and state blocks."""
    tp = model.tp
    h_cut = _state_cut(layout, "h", (1, 3))
    c_cut = _state_cut(layout, "conv", (2,))
    x = embed(model, token, model.dtype, tp)
    hs, convs = [], []
    for blk, h, conv in zip(model.layers, state["h"], state["conv"]):
        y, st = _mixer_decode_tp(blk.mixer,
                                 rmsnorm(x, blk.norm, cfg.norm_eps),
                                 {"h": h, "conv": conv}, cfg, tp, h_cut,
                                 c_cut)
        x = x + y
        hs.append(st["h"])
        convs.append(st["conv"])
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    return (x @ tp.head(model, x.dtype)).float(), \
        {"h": torch.stack(hs), "conv": torch.stack(convs)}


def prefill(model: Mamba2, cfg: ModelConfig, tokens, layout=None,
            seq_shard: bool = True):
    """Run the prompt, tokens (B, S) int, at its exact length in the
    model's dtype.  Returns (logits (B, 1, V) float32 at the last
    position, the decode state {"h": (L, B, H, P, N) float32, "conv":
    (L, B, d_conv − 1, d_inner + 2N)}).

    The reference keeps ``xbc[:, -(d_conv-1):]`` as the conv state, which
    holds fewer rows than that for a prompt shorter than d_conv − 1
    (its ``scatter_state`` then fails at S = 2 and broadcasts one row
    into every slot at S = 1).  Here the missing rows are zeros, the
    padding the causal conv reads there.  On a mesh (``layout``, the
    state's ``parallel.CacheLayout``) see ``_prefill_tp``; ``seq_shard``
    changes nothing on one process."""
    if layout is not None:
        return _prefill_tp(model, cfg, tokens, layout, seq_shard)
    x = F.embedding(tokens, model.tok)
    hs, convs = [], []
    for blk in model.layers:
        y, st = mixer_forward(blk.mixer, rmsnorm(x, blk.norm, cfg.norm_eps),
                              cfg, with_state=True)
        x = x + y
        hs.append(st["h"])
        convs.append(st["conv"])
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    return (x[:, -1:] @ lm_head_matrix(model)).float(), \
        {"h": torch.stack(hs), "conv": torch.stack(convs)}


def decode_step(model: Mamba2, cfg: ModelConfig, state, token,
                layout=None):
    """One token per row through every layer.  token: (B, 1) int; state:
    leaves (L, B, ...) as ``prefill`` returns them.  The recurrent step
    needs no position: the state is the history.  Returns (logits (B, 1,
    V) float32, the new state); ``state`` is left as it was.  On a mesh
    (``layout``) the rows, the state blocks and the logits are the
    rank's (``_decode_tp``)."""
    if layout is not None:
        return _decode_tp(model, cfg, state, token, layout)
    x = F.embedding(token, model.tok)
    hs, convs = [], []
    for blk, h, conv in zip(model.layers, state["h"], state["conv"]):
        y, st = mixer_decode(blk.mixer, rmsnorm(x, blk.norm, cfg.norm_eps),
                             {"h": h, "conv": conv}, cfg)
        x = x + y
        hs.append(st["h"])
        convs.append(st["conv"])
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    return (x @ lm_head_matrix(model)).float(), \
        {"h": torch.stack(hs), "conv": torch.stack(convs)}
