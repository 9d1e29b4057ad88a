"""Ragged single-token decode attention on the card: the wrapper of
``csrc/paged_decode.cu``.

Replaces the TPU kernel ``src/repro/kernels/paged.py::_ragged_kernel``
(through ``ragged_decode_attention``).  One query token per request, at
absolute position ``lengths[b]``, attends over the request's gathered
page window; keys ``0..lengths[b]`` inclusive are valid and the kernel
reads no key past them, so page remainders, stale slots and the null
page beyond a request's reach are never touched.  The plain version is
``kernels.ref.ragged_decode_ref``; ``kernels.backend.
paged_decode_attention`` picks between the two by the device of the
input.  Inference only: there is no backward.
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
             + [ctypes.c_int64] * 10
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def ragged_decode_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, hd) single-token queries; k, v: (B, Hkv, Skv, hd) with
    H % Hkv == 0; lengths: (B,) int32 — all on one CUDA device, q/k/v
    float32 or bfloat16 with head_dim 64 or 128 contiguous.  Other
    strides are read as they are (the transposed, head-interleaved views
    of a gathered page window cost no copy).  Returns (B, H, hd) in q's
    dtype."""
    global launches
    name = "ragged_decode"
    code = _build.dtype_code(name, q, k, v)
    B, H, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Hkv, Skv, hd) or k.shape != v.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"{name}: n_heads={H} not a multiple of "
                         f"n_kv_heads={Hkv}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {HEAD_DIMS}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,) \
            or lengths.device != q.device or not lengths.is_contiguous():
        raise ValueError(f"{name}: lengths must be contiguous int32 ({B},) "
                         f"on {q.device}, got {lengths.dtype} "
                         f"{tuple(lengths.shape)} on {lengths.device}")
    for t in (q, k, v):
        _build.check_rows(name, t)
    out = torch.empty(B, H, hd, dtype=q.dtype, device=q.device)
    fn = _build.function(name, _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(), B, H, Hkv, Skv, hd,
                 q.stride(0), q.stride(1),
                 k.stride(0), k.stride(2), k.stride(1),
                 v.stride(0), v.stride(2), v.stride(1),
                 out.stride(0), out.stride(1),
                 1.0 / math.sqrt(hd), code, _build.stream_of(q))
    _build.check(err, name)
    launches += 1
    return out
