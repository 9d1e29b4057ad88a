"""Shared building blocks: RMSNorm, RoPE, the SwiGLU/GeLU MLP, the LM
head, the chunked cross-entropy and the init rules
(``repro.models.layers`` in PyTorch).

Weights are ``(d_in, d_out)`` matrices used as ``x @ W``, the
reference's layout, so weights load one to one (no transpose into
``nn.Linear``).  The reference keeps float32 weights and casts them at
every matmul (``x @ W.astype(x.dtype)``); the port does the same with
``W.to(x.dtype)``.  Training holds float32 master weights, and the cast
carries the gradient back to them.  Serving holds the matrices already
in the compute dtype, where ``W.to(x.dtype)`` is ``W`` itself: no copy.
Norm scales stay float32: the norm adds them to 1 in float32.
"""
from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import backend as KB
from repro_torch.parallel import weight


# --------------------------------------------------------------------- #
# sharding specs
# --------------------------------------------------------------------- #

class P(tuple):
    """A partition spec (the reference's ``jax.sharding.PartitionSpec``,
    without JAX): one entry a dim of the array, ``None`` (whole on every
    rank), a mesh axis name (split over it) or a tuple of names (split
    over their product, the first major).  ``launch.mesh.shard_box``
    turns it into a rank's block."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def fsdp_axis(multi_pod: bool):
    """The axis (or axes) weights and batches are FSDP/data sharded over."""
    return ("pod", "data") if multi_pod else "data"


def mlp_specs(act: str, fsdp, lead: tuple = ()):
    base = {"w_up": P(*lead, fsdp, "model"),
            "w_down": P(*lead, "model", fsdp)}
    if act == "silu":
        base["w_gate"] = P(*lead, fsdp, "model")
    return base


def embed_specs(tie: bool, fsdp):
    """The token embedding split by vocab rows over ``model``, the
    untied head by vocab columns."""
    p = {"tok": P("model", fsdp)}
    if not tie:
        p["lm_head"] = P(fsdp, "model")
    return p


# --------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------- #

def param(shape, *, dtype, device) -> nn.Parameter:
    """An uninitialised weight (``init_weights`` or
    ``weights.from_jax_params`` fills it), frozen until a trainer asks
    for gradients (``requires_grad_``)."""
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
# recompute in the backward
# --------------------------------------------------------------------- #

def recompute(fn, *args):
    """``fn(*args)``, recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant).  No forward here draws
    random numbers (there is no dropout), so the recompute stashes no
    RNG state: the result is the same, and a CUDA graph capture, during
    which the card's generator state cannot be read, can run it."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


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


def mlp(p: MLP, x, act: str, tp=None):
    """On a mesh (``tp``, a ``parallel.TensorParallel``) up and gate are
    column-parallel and down row-parallel: this rank's d_ff/M columns,
    the output summed over the model group."""
    dt = x.dtype
    if tp is not None:
        x = tp.to_model(x)
    up = x @ weight(p.w_up, dt, tp)
    if p.w_gate is not None:
        h = act_fn(act)(x @ weight(p.w_gate, dt, tp)) * up
    else:
        h = act_fn(act)(up)
    out = h @ weight(p.w_down, dt, tp)
    return out if tp is None else tp.from_model(out)


# --------------------------------------------------------------------- #
# lm head
# --------------------------------------------------------------------- #

def lm_head_matrix(model) -> torch.Tensor:
    """(d, padded_vocab): the untied head, or the tied embedding's
    transpose."""
    if model.lm_head is not None:
        return model.lm_head
    return model.tok.T


def cross_entropy_chunked(h, W, labels, mask, logical_vocab: int, *,
                          z_loss: float = 0.0, chunk: int = 512, tp=None):
    """Loss over (B, S, d) hiddens against (B, S) labels without holding
    the (B, S, V) logits: the sequence goes in chunks of ``chunk``
    tokens, each chunk's float32 logits recomputed in the backward
    (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``
    of its scan body; the ragged remainder is not recomputed, as
    there).  Logits of the padded vocab (ids >= ``logical_vocab``) are
    masked to -1e30.  Returns (loss, z_sq) as float32 token means; the
    loss includes ``z_loss · z_sq``.

    On a mesh (``tp``) ``W`` holds this rank's vocab columns (d, V/M) and
    the loss is vocab-parallel: the row max (no grad: the logsumexp's
    value and grad do not depend on it), the sum of exps and the
    target's logit are reduced over the model group, and z-loss comes
    from the same logsumexp."""
    S, V = h.shape[1], W.shape[-1]
    chunk = min(chunk, S)
    n_chunks = S // chunk
    rem = S - n_chunks * chunk
    lo = 0
    if tp is not None:
        h, lo = tp.to_model(h), tp.vocab_start(V)
    vocab_ok = torch.arange(lo, lo + V, device=h.device) < logical_vocab

    def chunk_loss(hc, yc, mc):
        logits = (hc @ W.to(hc.dtype)).float()
        logits = torch.where(vocab_ok, logits, -1e30)
        if tp is None:
            z = torch.logsumexp(logits, dim=-1)
            ll = torch.gather(logits, -1, yc[..., None])[..., 0]
        else:
            m = tp.max_over_model(logits.amax(dim=-1))
            s = torch.exp(logits - m[..., None]).sum(dim=-1)
            local = yc - lo
            inside = (local >= 0) & (local < V)
            ll = torch.gather(logits, -1,
                              local.clamp(0, V - 1)[..., None])[..., 0]
            s, ll = tp.from_model(torch.stack(
                [s, torch.where(inside, ll, 0.0)])).unbind()
            z = m + torch.log(s)
        nll = (z - ll) * mc
        return torch.stack([nll.sum(), (z.square() * mc).sum(), mc.sum()])

    tot = torch.zeros(3, dtype=torch.float32, device=h.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        tot = tot + recompute(chunk_loss, h[:, sl], labels[:, sl],
                              mask[:, sl])
    if rem:
        tot = tot + chunk_loss(h[:, -rem:], labels[:, -rem:],
                               mask[:, -rem:])
    loss_sum, z_sq, n_tok = tot.unbind()
    n_tok = torch.clamp(n_tok, min=1.0)
    loss = loss_sum / n_tok
    if z_loss:
        loss = loss + z_loss * z_sq / n_tok
    return loss, z_sq / n_tok
