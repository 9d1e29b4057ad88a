"""Ragged single-token decode attention on the card: the wrappers of
``csrc/paged_decode.cu``.

Replaces the TPU kernel ``src/repro/kernels/paged.py::_ragged_kernel``
(through ``ragged_decode_attention``).  One query token per request, at
absolute position ``lengths[b]``, attends over the request's keys
``0..lengths[b]`` inclusive; the kernel reads no key past them, so page
remainders, stale slots and the null page beyond a request's reach are
never touched.  Two entries launch the same kernel:

- ``paged_decode_attention_pool`` reads K and V through the page table
  straight from the pool (the serving step's path): no window is
  gathered.  Its plain version is ``kernels.ref.paged_decode_ref``.
- ``ragged_decode_attention`` takes a gathered window, read as one page
  a request.  Its plain version is ``kernels.ref.ragged_decode_ref``.

``kernels.backend`` picks between kernel and plain version by the
device of the input.  Inference only: there is no backward.  Launches
on one device share a buffer of counters that every launch leaves at
zero, so they run on one stream at a time.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

# launches of the kernel since the count was last set to 0
launches = 0

HEAD_DIMS = (32, 64, 128, 256)

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
             + [ctypes.c_int64] * 11
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

# per (device, B): the page table arange(B)[:, None] of a gathered
# window; the kernel's (keys a split, query heads a group)
_tables: Dict[Tuple[torch.device, int], torch.Tensor] = {}
_layout: Tuple[int, int] = ()


def layout() -> Tuple[int, int]:
    """(keys a split, query heads a block serves at most) of the built
    kernel, read from the library once."""
    global _layout
    if not _layout:
        fn = _build.function("paged_decode_layout",
                             [ctypes.POINTER(ctypes.c_int)] * 2)
        split, heads = ctypes.c_int(), ctypes.c_int()
        fn(ctypes.byref(split), ctypes.byref(heads))
        _layout = (split.value, heads.value)
    return _layout


def _launch(name, q, k, v, pages, lengths, page_size: int):
    """q (B, H, hd); k, v (n_pages, page_size, Hkv, hd) views; pages (B,
    P) int64; lengths (B,) int32, all checked for one CUDA device and
    q's dtype by the caller.  Returns out (B, H, hd)."""
    B, H, hd = q.shape
    Hkv = k.shape[2]
    P = pages.shape[1]
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"{name}: n_heads={H} not a multiple of "
                         f"n_kv_heads={Hkv}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {HEAD_DIMS}")
    if k.shape != v.shape or tuple(k.shape[1:]) != (page_size, Hkv, hd):
        raise ValueError(f"{name}: k {tuple(k.shape)}, v {tuple(v.shape)}"
                         f", page_size {page_size}, head_dim {hd}")
    if k.shape[0] >= 2 ** 31:
        raise ValueError(f"{name}: {k.shape[0]} pages; at most 2^31 - 1")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,) \
            or lengths.device != q.device or not lengths.is_contiguous():
        raise ValueError(f"{name}: lengths must be contiguous int32 ({B},) "
                         f"on {q.device}, got {lengths.dtype} "
                         f"{tuple(lengths.shape)} on {lengths.device}")
    if pages.dtype != torch.int64 or pages.dim() != 2 \
            or pages.shape[0] != B or pages.device != q.device \
            or (P > 1 and pages.stride(1) != 1):
        raise ValueError(f"{name}: pages must be int64 ({B}, P) with unit "
                         f"column stride on {q.device}, got {pages.dtype} "
                         f"{tuple(pages.shape)} on {pages.device}")
    for t in (q, k, v):
        _build.check_rows(name, t)
    code = _build.dtype_code(name, q, k, v)
    out = torch.empty(B, H, hd, dtype=q.dtype, device=q.device)
    # split states (m, l, acc) when a window spans several splits, and a
    # counter per (request, kv head, group of query heads)
    split, heads = layout()
    n_split = -(-(P * page_size) // split)
    part = torch.empty(B * H * n_split * (hd + 2) if n_split > 1 else 0,
                       dtype=torch.float32, device=q.device)
    G = H // Hkv
    ctr = _build.counters("paged_decode", q.device,
                          B * Hkv * (1 if G == 1 else -(-G // heads)))
    fn = _build.function("paged_decode", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pages.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(), part.data_ptr(),
                 ctr.data_ptr(), B, H, Hkv, P, page_size, hd,
                 q.stride(0), q.stride(1),
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 pages.stride(0), out.stride(0), out.stride(1),
                 1.0 / math.sqrt(hd), code, _build.stream_of(q))
    _build.check(err, name)
    _build.count(globals(), "launches", q)
    return out


def paged_decode_attention_pool(q: torch.Tensor, pool_layer: torch.Tensor,
                                pages: torch.Tensor, lengths: torch.Tensor,
                                *, page_size: int) -> torch.Tensor:
    """q: (B, H, hd) single-token queries; pool_layer: (n_pages,
    page_size, 2 * Hkv, hd), head-interleaved (kv head j's K at index 2j,
    its V at 2j + 1); pages: (B, P) int64 page table, key s of request b
    at row s % page_size of page pages[b, s // page_size]; lengths: (B,)
    int32.  All on one CUDA device, q and the pool of one dtype (float32
    or bfloat16), head_dim 32, 64, 128 or 256.  Returns (B, H, hd) in q's
    dtype."""
    name = "paged_decode_attention_pool"
    _build.dtype_code(name, q, pool_layer)
    if pool_layer.dim() != 4 or pool_layer.shape[1] != page_size \
            or pool_layer.shape[2] % 2:
        raise ValueError(f"{name}: pool_layer {tuple(pool_layer.shape)} is "
                         f"not (n_pages, {page_size}, 2 * Hkv, hd)")
    return _launch(name, q, pool_layer[:, :, 0::2], pool_layer[:, :, 1::2],
                   pages, lengths, page_size)


def ragged_decode_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, hd) single-token queries; k, v: (B, Hkv, Skv, hd) with
    H % Hkv == 0; lengths: (B,) int32 — all on one CUDA device, q/k/v
    float32 or bfloat16 with head_dim 32, 64, 128 or 256 contiguous.  Other
    strides are read as they are (the transposed, head-interleaved views
    of a gathered page window cost no copy).  The kernel reads the
    window as one page a request.  Returns (B, H, hd) in q's dtype."""
    name = "ragged_decode"
    _build.dtype_code(name, q, k, v)
    B, H, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Hkv, Skv, hd) or k.shape != v.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    table = _tables.get((q.device, B))
    if table is None:
        table = torch.arange(B, device=q.device)[:, None]
        _tables[(q.device, B)] = table
    return _launch(name, q, k.transpose(1, 2), v.transpose(1, 2), table,
                   lengths, Skv)
