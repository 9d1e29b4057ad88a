"""The hot-path ops, in the models' tensor layouts.

The counterpart of ``repro.kernels.backend``, without a backend switch:
the device of the input picks the code.

- A tensor on the CPU runs the plain PyTorch version (``kernels.ref``),
  the path the CPU tests hold against the JAX package; torch's autograd
  differentiates it.
- A tensor on a CUDA device runs the hand-written kernel, or the call
  raises (no nvcc, a failed build, an unsupported shape).  ``rmsnorm``
  and ``attention`` are ``torch.autograd.Function``s there, whose
  backward is the backward kernel; ``ssd``'s backward recomputes
  through the plain chunked scan, as the reference's does (it has no
  backward kernel).  Nothing falls back to the plain version or to the
  CPU.
- Any other device raises.

The ops take the models' layouts (attention: (B, S, H, hd)); the kernels
read strides, so the transposes here are views, not copies.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged as _paged
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd as _ssd


def _on_card(t: torch.Tensor, op: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{op}: no implementation for device {t.device}; "
                     f"the port runs on 'cuda' (kernels) or 'cpu' (plain "
                     f"versions)")


def rmsnorm(x, scale, *, eps: float = 1e-5):
    """x: (..., d); scale: (d,) float32.  y = x·rsqrt(mean(x²)+eps)·
    (1+scale), in x's dtype."""
    if _on_card(x, "rmsnorm"):
        return _rn.rmsnorm(x, scale, eps)
    return _ref.rmsnorm_ref(x, scale, eps)


def attention(q, k, v):
    """Causal self-attention in the models' layout: q (B, S, H, hd),
    k/v (B, S, Hkv, hd) -> (B, S, H, hd).  On the card the flash kernels
    mask a ragged S themselves, so nothing is padded."""
    if _on_card(q, "attention"):
        return _fa.attention(q, k, v)
    out, _lse = _ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=True)
    return out.transpose(1, 2)


def paged_decode_attention(q, k, v, lengths):
    """Ragged single-token decode attention over a gathered page window
    (the serving hot path; see ``repro_torch.serving.cache``).

    q: (B, 1, H, hd), the new token's query at per-request position
    ``lengths[b]``; k, v: (B, Skv, Hkv, hd) whose slot ``s`` holds
    absolute position ``s``; lengths: (B,) int32.  Keys 0..lengths[b]
    inclusive are valid (slot ``lengths[b]`` is the token just written);
    everything later contributes nothing.  Returns (B, 1, H, hd)."""
    qt = q[:, 0]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    if _on_card(q, "paged_decode_attention"):
        out = _paged.ragged_decode_attention(qt, kt, vt, lengths)
    else:
        out = _ref.ragged_decode_ref(qt, kt, vt, lengths)
    return out[:, None]


def ssd(xh, dt, A, Bm, Cm, D, *, chunk: int):
    """The Mamba-2 SSD scan: xh (B, S, H, P), dt (B, S, H) float32
    (post-softplus), A (H,) float32, Bm/Cm (B, S, N) in xh's dtype, D
    (H,) float32 -> (y (B, S, H, P) in xh's dtype, h_final (B, H, P, N)
    float32).  On the card the chunk kernel's forward with the plain
    recompute backward; on the CPU the plain chunked scan."""
    if _on_card(xh, "ssd"):
        return _ssd.ssd(xh, dt, A, Bm, Cm, D, chunk=chunk)
    from repro_torch.models.mamba2 import ssd_chunked    # import cycle
    return ssd_chunked(xh, dt, A, Bm, Cm, D, chunk=chunk)
