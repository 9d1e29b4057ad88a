"""Causal GQA flash attention on the card, forward and backward: the
wrappers of ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` and the
``torch.autograd.Function`` that joins them.

Replaces the TPU kernels of ``src/repro/kernels/flash_attention.py``:
``_flash_kernel`` (``flash_fwd``, through ``_flash_fwd``),
``_bwd_dq_kernel`` (``flash_bwd_dq``) and ``_bwd_dkv_kernel``
(``flash_bwd_dkv``), both through ``_flash_bwd`` (``flash_bwd``), and
``_flash_with_vjp`` (``attention``).  Like
``_flash_fwd`` the forward returns the output and the float32
log-sum-exp rows ``lse`` (B·H, S), which the backward reads.  The kernels
mask the ragged tail themselves, so ``S`` need not be a multiple of any
block and nothing is padded.  The plain versions are
``kernels.ref.attention_ref`` and ``kernels.ref.flash_bwd_ref``;
``kernels.backend.attention`` picks by the device of the input.  A
call with no heads (a rank of a model axis that does not divide the
query heads may hold none) launches nothing; a call on meta tensors
(the dry-run) allocates its outputs and counts its operations
(``_build.shape_only``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

# launches of each kernel since the count was last set to 0
launches = 0            # flash_fwd
dq_launches = 0         # flash_bwd_dq
dkv_launches = 0        # flash_bwd_dkv

HEAD_DIMS = (32, 64, 128)

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_int64] * 12
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_DQ_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                + [ctypes.c_int64] * 15
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_DKV_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                 + [ctypes.c_int64] * 18
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _check(name: str, q, k, v) -> int:
    code = _build.dtype_code(name, q, k, v)
    B, H, S, hd = q.shape
    Hkv = k.shape[1]
    if tuple(k.shape) != (B, Hkv, S, hd) or k.shape != v.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if H and (Hkv < 1 or H % Hkv):
        raise ValueError(f"{name}: n_heads={H} not a multiple of "
                         f"n_kv_heads={Hkv}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {HEAD_DIMS}")
    for t in (q, k, v):
        _build.check_rows(name, t)
    return code


def _pairs(q) -> float:
    """The (query, key) pairs causal attention over q (B, H, S, hd)
    scores: B·H·S·(S+1)/2 (the count of the kernels' bounds)."""
    B, H, S, _ = q.shape
    return B * H * S * (S + 1) / 2


def _bsh(*tensors):
    """The (b, s, h) element strides of (B, H, S, hd) views."""
    out = []
    for t in tensors:
        out += [t.stride(0), t.stride(2), t.stride(1)]
    return out


def _like(t: torch.Tensor) -> torch.Tensor:
    """An empty (B, H, S, hd) view of a fresh (B, S, H, hd) buffer: the
    models' layout, so the caller's transpose back is free."""
    B, H, S, hd = t.shape
    return torch.empty(B, S, H, hd, dtype=t.dtype,
                       device=t.device).transpose(1, 2)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q: (B, H, S, hd); k, v: (B, Hkv, S, hd) with H % Hkv == 0, on one
    CUDA device, float32 or bfloat16, head_dim 32, 64 or 128 and
    contiguous.
    Any other strides are read as they are, so transposed views of the
    models' (B, S, H, hd) layout cost no copy.

    Returns (out (B, H, S, hd) in q's dtype — a view of a (B, S, H, hd)
    buffer — and lse (B·H, S) float32)."""
    name = "flash_fwd"
    code = _check(name, q, k, v)
    B, H, S, hd = q.shape
    out = _like(q)
    lse = torch.empty(B * H, S, dtype=torch.float32, device=q.device)
    if B * H * S == 0:              # a rank with no heads: nothing to launch
        return out, lse
    if _build.shape_only(q, 4 * hd * _pairs(q)):
        return out, lse
    fn = _build.function(name, _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), B, H, k.shape[1], S, hd,
                 *_bsh(q, k, v, out), 1.0 / math.sqrt(hd), code,
                 _build.stream_of(q))
    _build.check(err, name)
    _build.count(globals(), "launches", q)
    return out, lse


def _check_rows_of(name: str, q, lse, *tensors) -> None:
    B, H, S, _ = q.shape
    for t in tensors:
        _build.check_rows(name, t)
    for t in lse:
        if t.dtype != torch.float32 or tuple(t.shape) != (B * H, S) \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name}: lse and delta must be contiguous "
                             f"float32 ({B * H}, {S}) on {q.device}")


def flash_bwd_dq(q, k, v, do, lse, delta):
    """dq of the backward (kernel ``flash_bwd_dq``): q, k, v as for the
    forward, ``do`` (B, H, S, hd) in q's dtype, ``lse`` and ``delta``
    (B·H, S) float32.  Returns dq, a (B, H, S, hd) view of a fresh
    buffer in the models' layout."""
    name = "flash_bwd_dq"
    code = _check(name, q, k, v)
    _build.dtype_code(name, q, do)
    _check_rows_of(name, q, (lse, delta), do)
    B, H, S, hd = q.shape
    dq = _like(q)
    if B * H * S == 0 or _build.shape_only(q, 6 * hd * _pairs(q)):
        return dq
    fn = _build.function(name, _DQ_ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H,
                 k.shape[1], S, hd, *_bsh(q, k, v, do, dq),
                 1.0 / math.sqrt(hd), code, _build.stream_of(q))
    _build.check(err, name)
    _build.count(globals(), "dq_launches", q)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta):
    """dk and dv of the backward (kernel ``flash_bwd_dkv``), summed over
    each GQA group inside the kernel; arguments as for
    ``flash_bwd_dq``.  Returns (dk, dv), (B, Hkv, S, hd) views of fresh
    buffers in the models' layout."""
    name = "flash_bwd_dkv"
    code = _check(name, q, k, v)
    _build.dtype_code(name, q, do)
    _check_rows_of(name, q, (lse, delta), do)
    B, H, S, hd = q.shape
    dk, dv = _like(k), _like(v)
    if B * H * S == 0 or _build.shape_only(q, 8 * hd * _pairs(q)):
        return dk, dv
    fn = _build.function(name, _DKV_ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), B, H, k.shape[1], S, hd,
                 *_bsh(q, k, v, do, dk, dv), 1.0 / math.sqrt(hd), code,
                 _build.stream_of(q))
    _build.check(err, name)
    _build.count(globals(), "dkv_launches", q)
    return dk, dv


def flash_bwd(q, k, v, out, lse, do):
    """The VJP of ``flash_fwd``: q, k, v as for the forward, ``out`` and
    ``lse`` the forward's outputs at them, ``do`` the output's gradient
    (B, H, S, hd).  Returns (dq, dk, dv) in q's dtype, each a view of a
    fresh buffer in the models' layout.

    Strides: q, k, v, out and do are read through their strides with no
    copy when head_dim is contiguous and every row starts 16-byte
    aligned; only a ``do`` that breaks this (autograd may hand any
    layout back) is copied once.  ``delta = rowsum(do·out)`` is one plain
    torch reduction before the kernels, as in the reference; then the dq
    kernel and the dk/dv kernel launch."""
    B, H, S, hd = q.shape
    if tuple(do.shape) != (B, H, S, hd) or tuple(out.shape) != (B, H, S, hd):
        raise ValueError(f"flash_bwd: do {tuple(do.shape)} and out "
                         f"{tuple(out.shape)} must be q's shape "
                         f"{tuple(q.shape)}")
    if not _build.rows_aligned(do):
        do = do.contiguous()
    _build.dtype_code("flash_bwd", q, out, do)
    delta = (do.float() * out.float()).sum(-1).reshape(B * H, S) \
        .contiguous()
    dq = flash_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """Causal attention in the models' layout, q (B, S, H, hd), k/v (B, S,
    Hkv, hd).  Saves (q, k, v, out, lse) as the reference's ``fwd``
    does; under ``torch.utils.checkpoint`` the recomputed forward saves
    its own pair, so ``lse`` always comes from the forward of the
    ``out`` it pairs with."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_fwd(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2))
        o = out.transpose(1, 2)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(*(t.transpose(1, 2) for t in (q, k, v, o)),
                               lse, do.transpose(1, 2))
        return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """Differentiable causal GQA attention on the card in the models'
    layout: q (B, S, H, hd), k/v (B, S, Hkv, hd) -> (B, S, H, hd)."""
    return _Flash.apply(q, k, v)
