"""RMSNorm forward on the card: the wrapper of ``csrc/rmsnorm.cu``.

Replaces the TPU kernel ``src/repro/kernels/rmsnorm.py::_rmsnorm_kernel``
(through ``_pallas_fwd``).  Bound by bytes on the H100; the source says
what its design does about that.  The plain version is
``kernels.ref.rmsnorm_ref``; ``kernels.backend.rmsnorm`` picks between
the two by the device of the input.  Forward only: the backward comes
with the training slice.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# launches of the kernel since the count was last set to 0
launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
             ctypes.c_void_p]


def rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d) float32 or bfloat16 on a CUDA device, contiguous;
    scale: (d,) float32 on the same device.  Returns
    x·rsqrt(mean(x²)+eps)·(1+scale) in x's dtype."""
    global launches
    name = "rmsnorm_fwd"
    code = _build.dtype_code(name, x)
    d = x.shape[-1]
    if scale.dtype != torch.float32 or tuple(scale.shape) != (d,) \
            or scale.device != x.device:
        raise ValueError(f"{name}: scale must be float32 ({d},) on "
                         f"{x.device}, got {scale.dtype} "
                         f"{tuple(scale.shape)} on {scale.device}")
    if not x.is_contiguous() or not scale.is_contiguous():
        raise ValueError(f"{name}: x and scale must be contiguous")
    _build.check_rows(name, x)
    _build.check_rows(name, scale)
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:                       # nothing to launch, nothing counted
        return out
    fn = _build.function(name, _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d,
                 eps, code, _build.stream_of(x))
    _build.check(err, name)
    launches += 1
    return out
