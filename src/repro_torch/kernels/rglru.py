"""The RG-LRU linear recurrence on the card: the wrappers of
``csrc/rglru_scan.cu`` and the ``torch.autograd.Function`` that joins
the forward kernel to the backward one.

Replaces no Pallas kernel: the reference scans h_t = a_t·h_{t−1} + b_t
in XLA (``src/repro/models/rglru.py::rglru_scan``: an associative scan
inside chunks of 512 steps, a sequential carry across them) and lets
JAX differentiate it.  The port gives it a kernel pair because it is
the RG-LRU hybrid's one hot operation with no kernel: ``rglru_scan_fwd``
(the recurrence) and ``rglru_scan_bwd`` (the reverse sweep).  Their
plain versions are ``kernels.ref.rglru_scan_ref`` (the reference's
chunked scan, which torch's autograd differentiates on the CPU) and
``kernels.ref.rglru_scan_bwd_ref``; ``kernels.backend.rglru_scan``
picks by the device of the input.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# launches of each kernel since the count was last set to 0
launches = 0            # rglru_scan_fwd
bwd_launches = 0        # rglru_scan_bwd

_FWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
    ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
    ctypes.c_void_p]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(name, a, *others):
    """a: (B, S, W) float32 contiguous on a CUDA device; each of
    ``others`` None, of a's shape, or (B, W), float32 contiguous on a's
    device."""
    if a.device.type != "cuda" or a.dtype != torch.float32 \
            or a.dim() != 3 or not a.is_contiguous():
        raise ValueError(f"{name}: a must be a contiguous float32 (B, S, W) "
                         f"tensor on a CUDA device, got {a.dtype} "
                         f"{tuple(a.shape)} on {a.device}")
    B, S, W = a.shape
    for t in others:
        if t is None:
            continue
        if t.dtype != torch.float32 or t.device != a.device \
                or not t.is_contiguous() \
                or tuple(t.shape) not in ((B, S, W), (B, W)):
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}: want contiguous float32 "
                             f"({B}, {S}, {W}) or ({B}, {W}) on {a.device}")
    return B, S, W


def rglru_scan_fwd(a: torch.Tensor, b: torch.Tensor,
                   h0: torch.Tensor = None):
    """h_t = a_t·h_{t−1} + b_t from h0 (zeros when None).  a, b: (B, S,
    W) float32 contiguous on one CUDA device; h0: (B, W).  Returns
    float32 (hs (B, S, W), h_last (B, W))."""
    name = "rglru_scan_fwd"
    B, S, W = _check(name, a, b, h0)
    if b.shape != a.shape or (h0 is not None
                              and tuple(h0.shape) != (B, W)):
        raise ValueError(f"{name}: shapes a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, h0 "
                         f"{None if h0 is None else tuple(h0.shape)}")
    hs = torch.empty_like(a)
    h_last = torch.empty(B, W, dtype=torch.float32, device=a.device)
    fn = _build.function(name, _FWD_ARGTYPES)
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), _ptr(h0), hs.data_ptr(),
                 h_last.data_ptr(), B, S, W, _build.stream_of(a))
    _build.check(err, name)
    _build.count(globals(), "launches", a)
    return hs, h_last


def rglru_scan_bwd(a: torch.Tensor, hs: torch.Tensor, h0, dhs, dh_last,
                   want_dh0: bool = True):
    """The reverse sweep of ``rglru_scan_fwd``: g_t = dhs_t +
    a_{t+1}·g_{t+1} seeded with dh_last, da_t = g_t·h_{t−1}, db_t = g_t,
    dh0 = a_0·g_0.  a, hs, dhs: (B, S, W); h0, dh_last: (B, W); h0, dhs
    and dh_last may be None (zeros).  Returns float32 (da, db, dh0),
    dh0 None unless ``want_dh0``."""
    name = "rglru_scan_bwd"
    B, S, W = _check(name, a, hs, h0, dhs, dh_last)
    if hs.shape != a.shape or (dhs is not None and dhs.shape != a.shape) \
            or any(t is not None and tuple(t.shape) != (B, W)
                   for t in (h0, dh_last)):
        raise ValueError(f"{name}: shapes do not match a {tuple(a.shape)}")
    da = torch.empty_like(a)
    db = torch.empty_like(a)
    dh0 = (torch.empty(B, W, dtype=torch.float32, device=a.device)
           if want_dh0 else None)
    fn = _build.function(name, _BWD_ARGTYPES)
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), hs.data_ptr(), _ptr(h0), _ptr(dhs),
                 _ptr(dh_last), da.data_ptr(), db.data_ptr(), _ptr(dh0),
                 B, S, W, _build.stream_of(a))
    _build.check(err, name)
    _build.count(globals(), "bwd_launches", a)
    return da, db, dh0


class _RGLRUScan(torch.autograd.Function):
    """Forward ``rglru_scan_fwd``, backward ``rglru_scan_bwd``.  Saves a,
    the float32 hs and h0: the backward needs h_{t−1}, and the reference
    differentiates its float32 intermediates.  No host sync and nothing
    allocated outside torch's allocator, so a CUDA graph captures both
    directions."""

    @staticmethod
    def forward(ctx, a, b, h0):
        hs, h_last = rglru_scan_fwd(a, b, h0)
        ctx.save_for_backward(a, hs, h0)
        ctx.set_materialize_grads(False)
        return hs, h_last

    @staticmethod
    def backward(ctx, dhs, dh_last):
        a, hs, h0 = ctx.saved_tensors
        if dhs is None and dh_last is None:
            return None, None, None
        want_dh0 = h0 is not None and ctx.needs_input_grad[2]
        da, db, dh0 = rglru_scan_bwd(
            a, hs, h0, None if dhs is None else dhs.contiguous(),
            None if dh_last is None else dh_last.contiguous(), want_dh0)
        return da, db, dh0


def rglru_scan(a, b, h0=None):
    """Differentiable h_t = a_t·h_{t−1} + b_t on the card (both
    directions in kernels).  a, b: (B, S, W) float32; h0: (B, W) float32
    or None.  Returns (hs (B, S, W), h_last (B, W)), float32."""
    return _RGLRUScan.apply(a.contiguous(), b.contiguous(),
                            None if h0 is None else h0.float().contiguous())
