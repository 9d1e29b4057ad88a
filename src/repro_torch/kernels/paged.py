"""Ragged single-token decode attention on the card: the wrappers of
``csrc/paged_decode.cu`` and ``csrc/decode_cut.cu``.

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

The caches of sharded decode (``models.attention.decode_attn_tp``) are
cut over the model group, and three more entries serve them:

- ``ragged_decode_partial`` (the sequence cut): the same kernel stopped
  at the rank's merged softmax state (m, l, acc) over its own keys.
  Plain version ``kernels.ref.decode_partial_ref``.
- ``decode_scores`` and ``decode_softmax_pv`` (the head_dim cut): a
  rank's partial scores over its slice of head_dim, then, after their
  sum over the group, the softmax and P V over its slice of V: the two
  kernels of ``csrc/decode_cut.cu``, a block serving every query head of
  a KV head, over tiles of keys that ``cut_tiles`` sizes.  Plain
  versions ``kernels.ref.decode_scores_ref`` and
  ``decode_softmax_pv_ref``.

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

# launches of each entry's kernel since the count was last set to 0: the
# whole heads', the sequence cut's partial, the head_dim cut's two passes
launches = 0
partial_launches = 0
scores_launches = 0
softmax_pv_launches = 0

HEAD_DIMS = (32, 64, 128, 256)
# a head_dim cut in 2-16 parts: the rank's slice
SLICE_DIMS = (4, 8, 16, 32, 64, 128)
# the kernel's modes (``Mode`` in csrc/paged_decode.cu)
_WHOLE, _PARTIAL = 0, 1

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
             + [ctypes.c_int64] * 11
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])
_SCORE_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_int64] * 7 + [ctypes.c_int, ctypes.c_void_p])
_PV_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                + [ctypes.c_int64] * 7
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

# per (device, B): the page table arange(B)[:, None] of a gathered
# window; the kernels' layout; SMs by device index
_tables: Dict[Tuple[torch.device, int], torch.Tensor] = {}
_layout: Tuple[int, ...] = ()
_sms: Dict[int, int] = {}
# kSplit and kGroupHeads of csrc/paged_decode.cu, kMaxHeads and kMaxTile
# of csrc/decode_cut.cu, for shape-only calls, which never load the
# library (chip_smoke.py holds them to ``layout()``)
SOURCE_LAYOUT = (128, 4, 16, 64)
# the head_dim cut's kernels (``cut_tiles``): pass 1's tiles a block at
# most; pass 2's splits of a row at most, which its last block merges;
# the SMs a shape-only call sizes for (an H100's)
CUT_MAX_PER = 8
PV_MAX_SPLITS = 16
H100_SMS = 132


def layout() -> Tuple[int, ...]:
    """(keys a split, query heads a block serves at most) of the built
    decode kernel, then (query heads of a KV head, keys a tile) at most
    of the head_dim cut's kernels, read from the library once."""
    global _layout
    if not _layout:
        vals = []
        for name in ("paged_decode_layout", "decode_cut_layout"):
            fn = _build.function(name, [ctypes.POINTER(ctypes.c_int)] * 2)
            a, b = ctypes.c_int(), ctypes.c_int()
            fn(ctypes.byref(a), ctypes.byref(b))
            vals += [a.value, b.value]
        _layout = tuple(vals)
    return _layout


def _sm_count(device: torch.device) -> int:
    """The SMs of ``device``; an H100's for a shape-only (meta) call."""
    if device.type == "meta":
        return H100_SMS
    if device.index not in _sms:
        _sms[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sms[device.index]


def cut_tiles(B: int, Hkv: int, Skv: int, n_sm: int,
              merge: bool = False) -> Tuple[int, int]:
    """(keys a tile, tiles a block) of the head_dim cut's kernels: a
    block takes one (request, KV head) and ``per`` tiles of its keys, and
    waits about one round trip for every tile past the first (a 2-stage
    ring).  Pass 1: tiles of 64 keys where the B × Hkv rows give 2 blocks
    an SM at one tile a block, else 32; more tiles a block (up to
    ``CUT_MAX_PER``) only where the tiles outnumber 24 blocks an SM
    (three waves of the 8 blocks an SM holds).  Pass 2 (``merge``), whose
    last block of a row merges the row's splits, a chain of dependent
    loads that costs more than a tile: tiles of 64 keys, at least 2 a
    block, as many (up to ``CUT_MAX_PER``) as still give 2 blocks an SM,
    and at most ``PV_MAX_SPLITS`` splits a row."""
    rows = B * Hkv
    if merge:
        n_tiles = -(-Skv // 64)
        per = max(2, min(CUT_MAX_PER, rows * n_tiles // (2 * n_sm)),
                  -(-n_tiles // PV_MAX_SPLITS))
        return 64, min(n_tiles, per)
    tile = 64 if rows * -(-Skv // 64) >= 2 * n_sm else 32
    n_tiles = -(-Skv // tile)
    return tile, max(1, min(CUT_MAX_PER, n_tiles,
                            rows * n_tiles // (24 * n_sm)))


def _align(t: torch.Tensor) -> int:
    """The row alignment the kernel's loads need: 16 bytes, or 8 for a
    slice of 4 bfloat16 elements (one 8-byte load a row)."""
    return min(16, t.shape[-1] * t.element_size())


def _launch(name, q, k, v, pages, lengths, page_size: int, *,
            mode: int = _WHOLE, counter: str = "launches"):
    """q (B, H, hd); k, v (n_pages, page_size, Hkv, hd) views; pages (B,
    P) int64; lengths (B,) int32, all checked for one CUDA device and one
    dtype by the caller.  Returns out (B, H, hd), or for the partial mode
    the states (B, H, hd + 2) float32."""
    B, H = q.shape[:2]
    hd = v.shape[3]
    Hkv = v.shape[2]
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
    dev = v.device
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,) \
            or lengths.device != dev or not lengths.is_contiguous():
        raise ValueError(f"{name}: lengths must be contiguous int32 ({B},) "
                         f"on {dev}, got {lengths.dtype} "
                         f"{tuple(lengths.shape)} on {lengths.device}")
    if pages.dtype != torch.int64 or pages.dim() != 2 \
            or pages.shape[0] != B or pages.device != dev \
            or (P > 1 and pages.stride(1) != 1):
        raise ValueError(f"{name}: pages must be int64 ({B}, P) with unit "
                         f"column stride on {dev}, got {pages.dtype} "
                         f"{tuple(pages.shape)} on {pages.device}")
    for t in (q, k, v):
        _build.check_rows(name, t)
    code = _build.dtype_code(name, q, k, v)
    if mode == _PARTIAL:
        fin = torch.empty(B, H, hd + 2, dtype=torch.float32, device=dev)
        out = fin
    else:
        fin = None
        out = torch.empty(B, H, hd, dtype=v.dtype, device=dev)
    # split states (m, l, acc) when a window spans several splits, and a
    # counter per (request, kv head, group of query heads)
    split, heads = (SOURCE_LAYOUT if dev.type == "meta" else layout())[:2]
    n_split = -(-(P * page_size) // split)
    part = torch.empty(B * H * n_split * (hd + 2) if n_split > 1 else 0,
                       dtype=torch.float32, device=dev)
    # a shape-only call cannot read the lengths: every slot counts
    if _build.shape_only(v, B * P * page_size * H * 4 * hd):
        return out
    G = H // Hkv
    ctr = _build.counters("paged_decode", dev,
                          B * Hkv * (1 if G == 1 else -(-G // heads)))
    fn = _build.function("paged_decode", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pages.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(), part.data_ptr(),
                 ctr.data_ptr(), 0 if fin is None else fin.data_ptr(),
                 B, H, Hkv, P, page_size, hd, q.stride(0), q.stride(1),
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 pages.stride(0), out.stride(0), out.stride(1),
                 1.0 / math.sqrt(hd), mode, code, _build.stream_of(v))
    _build.check(err, name)
    _build.count(globals(), counter, v)
    return out


def _table(device, B: int) -> torch.Tensor:
    """The page table arange(B)[:, None] of a window read as one page a
    request."""
    table = _tables.get((device, B))
    if table is None:
        table = torch.arange(B, device=device)[:, None]
        _tables[(device, B)] = table
    return table


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
    return _launch(name, q, k.transpose(1, 2), v.transpose(1, 2),
                   _table(q.device, B), lengths, Skv)


def ragged_decode_partial(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """The sequence cut's partial: q (B, H, hd) whole heads; k, v (B, Skv,
    Hkv, hd), the rank's block of each request's keys; lengths (B,)
    int32, the request's length less the block's first position (keys
    0..lengths[b] of the block are valid; none when it is negative).  On
    one CUDA device, float32 or bfloat16, head_dim 32, 64, 128 or 256.
    Returns (B, H, hd + 2) float32: each (request, head)'s softmax state
    (m, l, acc) over the block's valid keys, scores scaled by
    1/sqrt(hd); an empty block gives (-1e30, 0, 0...)."""
    name = "ragged_decode_partial"
    if k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)}, v {tuple(v.shape)} "
                         f"are not one (B, Skv, Hkv, hd) shape")
    B, Skv = k.shape[:2]
    return _launch(name, q, k, v, _table(q.device, B), lengths, Skv,
                   mode=_PARTIAL, counter="partial_launches")


def _cut_args(name, x, kv, lengths):
    """Check the head_dim cut's operands: x (B, H, ...) on kv's device;
    kv (B, Skv, Hkv, hd_r) with hd_r in ``SLICE_DIMS``, rows aligned;
    lengths (B,) contiguous int32; at most ``SOURCE_LAYOUT[2]`` query
    heads a KV head.  Returns (B, H, Hkv, Skv, hd_r)."""
    if kv.dim() != 4:
        raise ValueError(f"{name}: cache {tuple(kv.shape)} is not (B, Skv, "
                         f"Hkv, hd)")
    B, Skv, Hkv, hd = kv.shape
    H = x.shape[1]
    if x.shape[0] != B or Hkv < 1 or H % Hkv:
        raise ValueError(f"{name}: {tuple(x.shape)} against the cache "
                         f"{tuple(kv.shape)}")
    if H // Hkv > SOURCE_LAYOUT[2]:
        raise ValueError(f"{name}: {H // Hkv} query heads a KV head; the "
                         f"kernels take at most {SOURCE_LAYOUT[2]}")
    if hd not in SLICE_DIMS:
        raise ValueError(f"{name}: head_dim slice {hd} not in {SLICE_DIMS}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,) \
            or lengths.device != kv.device or not lengths.is_contiguous():
        raise ValueError(f"{name}: lengths must be contiguous int32 ({B},) "
                         f"on {kv.device}")
    _build.check_rows(name, kv, _align(kv))
    return B, H, Hkv, Skv, hd


def decode_scores(q: torch.Tensor, k: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """The head_dim cut's pass 1: q (B, H, hd_r), the rank's slice of each
    query head's dims (any strides, head_dim contiguous); k (B, Skv,
    Hkv, hd_r), its slice of the cache (any strides, head_dim
    contiguous); lengths (B,) int32.  On one CUDA device, float32 or
    bfloat16, hd_r 4, 8, 16, 32, 64 or 128, H / Hkv at most 16.  Returns
    s (B, H, Skv) float32, the partial dot products (unscaled) of keys
    0..lengths[b]; later entries are left unwritten."""
    name = "decode_scores"
    code = _build.dtype_code(name, q, k)
    B, H, Hkv, Skv, hd = _cut_args(name, q, k, lengths)
    if tuple(q.shape) != (B, H, hd):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}")
    _build.check_rows(name, q, _align(q))
    s = torch.empty(B, H, Skv, dtype=torch.float32, device=q.device)
    tile, per = cut_tiles(B, Hkv, Skv, _sm_count(q.device))
    if _build.shape_only(q, 2 * B * Skv * H * hd):
        return s
    fn = _build.function("decode_scores", _SCORE_ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), lengths.data_ptr(),
                 s.data_ptr(), B, H, Hkv, Skv, hd, tile, per, q.stride(0),
                 q.stride(1), k.stride(0), k.stride(1), k.stride(2),
                 s.stride(0), s.stride(1), code, _build.stream_of(q))
    _build.check(err, name)
    _build.count(globals(), "scores_launches", q)
    return s


def pv_scratch(B: int, H: int, Hkv: int, Skv: int, hd: int,
               n_sm: int) -> Tuple[int, int, int]:
    """(keys a tile, tiles a block, float32 elements of the split states)
    of ``decode_softmax_pv``: B · H · n_split · (hd + 4) when a row spans
    n_split > 1 splits, else none."""
    tile, per = cut_tiles(B, Hkv, Skv, n_sm, merge=True)
    n_split = -(-Skv // (tile * per))
    return tile, per, B * H * n_split * (hd + 4) if n_split > 1 else 0


def decode_softmax_pv(s: torch.Tensor, v: torch.Tensor,
                      lengths: torch.Tensor, *,
                      head_dim: int) -> torch.Tensor:
    """The head_dim cut's pass 2: s (B, H, Skv) float32, the scores summed
    over the model group (unit key stride); v (B, Skv, Hkv, hd_r), the
    rank's slice of the cache's V (any strides, head_dim contiguous);
    lengths (B,) int32.  The softmax of s/sqrt(``head_dim``) (the WHOLE
    head's) over keys 0..lengths[b], then P V over the slice.  Returns
    (B, H, hd_r) in v's dtype."""
    name = "decode_softmax_pv"
    code = _build.dtype_code(name, v)
    B, H, Hkv, Skv, hd = _cut_args(name, s, v, lengths)
    dev = v.device
    if s.dtype != torch.float32 or s.device != dev \
            or tuple(s.shape) != (B, H, Skv) or s.stride(2) != 1:
        raise ValueError(f"{name}: scores must be float32 ({B}, {H}, "
                         f"{Skv}) with unit key stride on {dev}, got "
                         f"{s.dtype} {tuple(s.shape)} on {s.device}")
    out = torch.empty(B, H, hd, dtype=v.dtype, device=dev)
    tile, per, n_part = pv_scratch(B, H, Hkv, Skv, hd, _sm_count(dev))
    part = torch.empty(n_part, dtype=torch.float32, device=dev)
    if _build.shape_only(v, B * Skv * H * (2 * hd + 4)):
        return out
    ctr = _build.counters("decode_cut", dev, B * Hkv)
    fn = _build.function("decode_softmax_pv", _PV_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(s.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                 out.data_ptr(), part.data_ptr(), ctr.data_ptr(), B, H, Hkv,
                 Skv, hd, tile, per, s.stride(0), s.stride(1), v.stride(0),
                 v.stride(1), v.stride(2), out.stride(0), out.stride(1),
                 1.0 / math.sqrt(head_dim), code, _build.stream_of(v))
    _build.check(err, name)
    _build.count(globals(), "softmax_pv_launches", v)
    return out
