"""Mamba-2 SSD on the card: the wrapper of ``csrc/ssd_chunk.cu``, the
full forward around it, and the ``torch.autograd.Function`` that joins
it to a recompute backward.

Replaces ``src/repro/kernels/ssd.py``: ``_ssd_chunk_kernel``
(``ssd_chunk``), ``_ssd_forward`` (``ssd_forward``) and
``_ssd_with_vjp`` / ``ssd_full`` (``_SSD``, ``ssd``).  The kernel computes
each chunk's intra-chunk output, its final state and its total log-decay
``T``; the cross-chunk recurrence (``nc`` steps on (B, H, N, P) float32
states) and the inter-chunk correction stay in PyTorch, as the reference
keeps them in XLA.  The reference has no backward kernel for SSD: its
VJP recomputes through the plain chunked scan, and so does ``_SSD``.
The plain versions are ``kernels.ref.ssd_chunk_ref`` (of the kernel)
and ``models.mamba2.ssd_chunked`` (of the whole scan);
``kernels.backend.ssd`` picks by the device of the input.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import cumsum16

# launches of the kernel since the count was last set to 0
launches = 0            # ssd_chunk

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
             + [ctypes.c_int64] * 10 + [ctypes.c_int, ctypes.c_void_p])

MAX_HEAD_DIM = 64
MAX_D_STATE = 128
MAX_CHUNK = 1024


def ssd_chunk(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bm: torch.Tensor, Cm: torch.Tensor, chunk: int):
    """The intra-chunk SSD terms on the card (kernel ``ssd_chunk``).

    xh: (B, S, H, P) float32 or bfloat16, head_dim contiguous, read
    through its strides; dt: (B, S, H) float32 (post-softplus), any
    strides; A: (H,) float32; Bm, Cm: (B, S, N) in xh's dtype, N
    contiguous, read through their strides.  P <= 64 and N <= 128, both
    multiples of 4; rows 16-byte aligned.  A ragged S is read as padded
    with dt = 0 steps, so nothing is copied.

    Returns float32 (y_intra (B, S, H, P), states (B, nc, H, N, P),
    T (B, nc, H)) with nc = ceil(S / chunk): ``kernels.ref.
    ssd_chunk_ref``'s outputs."""
    global launches
    name = "ssd_chunk"
    code = _build.dtype_code(name, xh, Bm, Cm)
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = int(chunk)
    for t, what in ((dt, "dt"), (A, "A")):
        if t.dtype != torch.float32 or t.device != xh.device:
            raise ValueError(f"{name}: {what} must be float32 on "
                             f"{xh.device}, got {t.dtype} on {t.device}")
    if tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,) \
            or tuple(Bm.shape) != (B, S, N) or Cm.shape != Bm.shape:
        raise ValueError(f"{name}: shapes x {tuple(xh.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(Bm.shape)}, C {tuple(Cm.shape)}")
    if P > MAX_HEAD_DIM or P % 4 or N > MAX_D_STATE or N % 4:
        raise ValueError(f"{name}: head_dim {P} (<= {MAX_HEAD_DIM}) and "
                         f"d_state {N} (<= {MAX_D_STATE}) must be "
                         f"multiples of 4")
    if not 1 <= Q <= MAX_CHUNK:
        raise ValueError(f"{name}: chunk {Q} not in [1, {MAX_CHUNK}]")
    for t in (xh, Bm, Cm):
        _build.check_rows(name, t)
    A = A.contiguous()
    nc = -(-S // Q)
    y = torch.empty(B, S, H, P, dtype=torch.float32, device=xh.device)
    states = torch.empty(B, nc, H, N, P, dtype=torch.float32,
                         device=xh.device)
    T = torch.empty(B, nc, H, dtype=torch.float32, device=xh.device)
    fn = _build.function(name, _ARGTYPES)
    with torch.cuda.device(xh.device):
        err = fn(xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), y.data_ptr(), states.data_ptr(),
                 T.data_ptr(), B, S, H, P, N, Q, xh.stride(0),
                 xh.stride(1), xh.stride(2), dt.stride(0), dt.stride(1),
                 dt.stride(2), Bm.stride(0), Bm.stride(1), Cm.stride(0),
                 Cm.stride(1), code, _build.stream_of(xh))
    _build.check(err, name)
    launches += 1
    return y, states, T


def ssd_forward(xh, dt, A, Bm, Cm, D, *, chunk: int):
    """The full SSD on the card (the reference's ``_ssd_forward``): the
    kernel's intra-chunk terms, then the cross-chunk recurrence as a
    loop over the nc chunks on float32 (B, H, N, P) states, the
    inter-chunk term C_i·h_prev·exp(cum_i) and D·x.  Arguments as for
    ``ssd_chunk``, and D (H,) float32.

    Returns (y (B, S, H, P) in xh's dtype, h_final (B, H, P, N)
    float32): the kernel's states are (N, P), the carried state is
    swapped at the end, as the reference swaps it."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(int(chunk), S)
    y_intra, states, T = ssd_chunk(xh, dt, A, Bm, Cm, Q)
    nc = T.shape[1]
    h = torch.zeros(B, H, N, P, dtype=torch.float32, device=xh.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * torch.exp(T[:, c])[:, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                    # (B,nc,H,N,P)
    # the ragged tail as dt = 0 steps (C zero) for the inter-chunk term
    pad = nc * Q - S
    dtp = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad))
    Cp = torch.nn.functional.pad(Cm.float(), (0, 0, 0, pad))
    cum = cumsum16(dtp.reshape(B, nc, Q, H) * A, dim=2)
    y_inter = torch.einsum("bcin,bchnp->bcihp", Cp.reshape(B, nc, Q, N),
                           h_prevs) * torch.exp(cum)[..., None]
    y = y_intra + y_inter.reshape(B, nc * Q, H, P)[:, :S]
    y = y + D[None, None, :, None] * xh.float()
    return y.to(xh.dtype), h.transpose(-1, -2)


class _SSD(torch.autograd.Function):
    """Forward ``ssd_forward`` (the kernel); backward the VJP of the
    plain chunked scan ``models.mamba2.ssd_chunked``, recomputed from
    the saved inputs under autograd, as the reference's
    ``_ssd_with_vjp`` pulls its cotangents through ``ssd_chunked``.  The
    gradients through the card's path are therefore those of the plain
    path, at the cost of one plain forward in the backward."""

    @staticmethod
    def forward(ctx, xh, dt, A, Bm, Cm, D, chunk):
        ctx.save_for_backward(xh, dt, A, Bm, Cm, D)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return ssd_forward(xh, dt, A, Bm, Cm, D, chunk=chunk)

    @staticmethod
    def backward(ctx, gy, gh):
        from repro_torch.models.mamba2 import ssd_chunked   # import cycle
        need = ctx.needs_input_grad[:6]
        if gy is None and gh is None:
            return (None,) * 7
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            y, h = ssd_chunked(*leaves, chunk=ctx.chunk)
            outs = [(o, g) for o, g in ((y, gy), (h, gh)) if g is not None]
            grads = iter(torch.autograd.grad(
                [o for o, _ in outs], [t for t, n in zip(leaves, need) if n],
                [g for _, g in outs], allow_unused=True))
        return (*(next(grads) if n else None for n in need), None)


def ssd(xh, dt, A, Bm, Cm, D, *, chunk: int):
    """Differentiable SSD on the card: the kernel forward, the plain
    recompute backward.  Returns (y, h_final (B, H, P, N))."""
    return _SSD.apply(xh, dt, A, Bm, Cm, D, int(chunk))
