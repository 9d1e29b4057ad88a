"""Causal GQA flash-attention forward on the card: the wrapper of
``csrc/flash_fwd.cu``.

Replaces the TPU kernel
``src/repro/kernels/flash_attention.py::_flash_kernel`` (through
``_flash_fwd``).  Like ``_flash_fwd`` it returns the output and the
float32 log-sum-exp rows ``lse`` (B·H, S), which a backward pass reads.
The kernel masks the ragged tail itself, so ``S`` need not be a multiple
of any block and nothing is padded.  The plain version is
``kernels.ref.attention_ref``; ``kernels.backend.attention`` picks
between the two by the device of the input.  Forward only: the backward
kernels come with the training slice.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

# launches of the kernel since the count was last set to 0
launches = 0

HEAD_DIMS = (64, 128)

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_int64] * 12
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q: (B, H, S, hd); k, v: (B, Hkv, S, hd) with H % Hkv == 0, on one
    CUDA device, float32 or bfloat16, head_dim 64 or 128 and contiguous.
    Any other strides are read as they are, so transposed views of the
    models' (B, S, H, hd) layout cost no copy.

    Returns (out (B, H, S, hd) in q's dtype — a view of a (B, S, H, hd)
    buffer — and lse (B·H, S) float32)."""
    global launches
    name = "flash_fwd"
    code = _build.dtype_code(name, q, k, v)
    B, H, S, hd = q.shape
    Hkv = k.shape[1]
    if tuple(k.shape) != (B, Hkv, S, hd) or k.shape != v.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"{name}: n_heads={H} not a multiple of "
                         f"n_kv_heads={Hkv}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {HEAD_DIMS}")
    for t in (q, k, v):
        _build.check_rows(name, t)
    out = torch.empty(B, S, H, hd, dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty(B * H, S, dtype=torch.float32, device=q.device)
    strides = []
    for t in (q, k, v, out):                # (b, s, h) of a (B, H, S) view
        strides += [t.stride(0), t.stride(2), t.stride(1)]
    fn = _build.function(name, _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), B, H, Hkv, S, hd, *strides,
                 1.0 / math.sqrt(hd), code, _build.stream_of(q))
    _build.check(err, name)
    launches += 1
    return out, lse
