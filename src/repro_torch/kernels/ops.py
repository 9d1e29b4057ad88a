"""Thin public wrappers of the kernels (``repro.kernels.ops`` in
PyTorch): ``flash_attention`` in the kernels' (B, H, S, hd) layout,
``rmsnorm`` and ``ssd``.  Model code calls ``kernels.backend``, which
these wrap; they add no kernel.

``use_pallas=True`` goes through ``kernels.backend``: the hand-written
kernel for a CUDA tensor, its plain version for a CPU one (the device
picks, as everywhere in the port).  ``use_pallas=False`` is mapped here,
explicitly, to the plain versions of ``kernels.ref`` on either device:
``attention_ref``, ``rmsnorm_ref`` and, for ``ssd``, the naive
sequential ``ssd_ref``, not the chunked scan (the reference's
``use_pallas=False`` keeps that historical choice).  There is no
environment variable and no backend switch (the reference's
``REPRO_NO_PALLAS`` has no counterpart).

The port's flash kernels are causal; ``flash_attention(causal=False)``
runs ``models.attention.chunked_attention``, the chunked online-softmax
attention the models' bidirectional layers run on both devices (the
reference's Pallas kernel takes ``causal=False``; the port has no
bidirectional kernel yet, ``ROADMAP.md`` Queue 2).
"""
from __future__ import annotations

from repro_torch.kernels import backend as _backend
from repro_torch.kernels import ref as _ref


def flash_attention(q, k, v, *, causal: bool = True,
                    use_pallas: bool = True):
    """q: (B, H, S, hd); k, v: (B, Hkv, S, hd) with H % Hkv == 0 ->
    (B, H, S, hd) in q's dtype."""
    if not use_pallas:
        return _ref.attention_ref(q, k, v, causal=causal)[0]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if causal:
        return _backend.attention(qt, kt, vt).transpose(1, 2)
    from repro_torch.models.attention import chunked_attention
    return chunked_attention(qt, kt, vt, causal=False).transpose(1, 2)


def rmsnorm(x, scale, *, eps: float = 1e-5, use_pallas: bool = True):
    """x: (..., d); scale: (d,) float32 -> x·rsqrt(mean(x²)+eps)·(1+scale)
    in x's dtype."""
    if not use_pallas:
        return _ref.rmsnorm_ref(x, scale, eps)
    return _backend.rmsnorm(x, scale, eps=eps)


def ssd(xh, dt, A, Bm, Cm, D, *, chunk: int = 128, use_pallas: bool = True):
    """The Mamba-2 SSD scan: xh (B, S, H, P), dt (B, S, H) float32, A (H,),
    Bm/Cm (B, S, N), D (H,) -> (y (B, S, H, P), h_final (B, H, P, N))."""
    if not use_pallas:
        return _ref.ssd_ref(xh, dt, A, Bm, Cm, D)
    return _backend.ssd(xh, dt, A, Bm, Cm, D, chunk=chunk)
