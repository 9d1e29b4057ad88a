"""The streaming normalize on the card: the wrapper of ``csrc/overlap.cu``.

Replaces the TPU kernel ``benchmarks/bench_kernels.py::_overlap_kernel``
(through ``_overlap_call``): y = x·rsqrt(mean(x²)+1e-5) over float32 rows,
row-blocks of ``block_rows`` rows streamed through a ring of ``depth``
shared-memory stages by bulk asynchronous copies.  It is the kernel
benchmark's copy/compute-overlap probe (``repro_torch.bench.kernels``),
on no model's path.  The plain version is ``kernels.ref.overlap_norm_ref``.

Unlike the reference, which leaves the tail rows unwritten when ``rows``
is not a multiple of ``block_rows``, the wrapper refuses such a call.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# launches of the kernel since the count was last set to 0
launches = 0            # overlap_norm

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
    ctypes.c_void_p]


def smem_bytes(block_rows: int, d: int, depth: int) -> int:
    """Shared memory of one block: ``depth`` in- and ``depth`` out-stages
    of block_rows × d float32, and ``depth`` 8-byte mbarriers."""
    return 2 * depth * block_rows * d * 4 + 8 * depth


def smem_budget(device) -> int:
    """The dynamic shared memory a block may opt in to on ``device``
    (232,448 bytes on the H100)."""
    return torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin


def grid_of(n_blocks: int, device) -> int:
    """The persistent grid: one block per SM, or per row-block if fewer."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(n_blocks, sms)


def overlap_norm(x: torch.Tensor, *, block_rows: int,
                 depth: int) -> torch.Tensor:
    """x: (rows, d) float32 on a CUDA device, contiguous and 16-byte
    aligned, with d·4 a multiple of 16 and rows a multiple of
    ``block_rows``.  Returns x·rsqrt(mean(x²)+1e-5) (float32), streamed
    through ``depth`` stages of ``block_rows`` rows.  Raises on anything
    else, and when the stages do not fit the card's shared memory."""
    global launches
    name = "overlap_norm"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: takes float32, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be 2-D and contiguous, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    rows, d = x.shape
    if block_rows < 1 or depth < 1:
        raise ValueError(f"{name}: block_rows={block_rows} and "
                         f"depth={depth} must be >= 1")
    if (d * 4) % 16 or x.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be 16-byte aligned for the "
                         f"bulk copies (d={d})")
    if rows % block_rows:
        raise ValueError(f"{name}: rows={rows} is not a multiple of "
                         f"block_rows={block_rows}")
    need = smem_bytes(block_rows, d, depth)
    budget = smem_budget(x.device)
    if need > budget:
        raise ValueError(f"{name}: {depth} stages of {block_rows}x{d} "
                         f"float32 need {need} bytes of shared memory, "
                         f"over the card's {budget}")
    out = torch.empty_like(x)
    n_blocks = rows // block_rows
    if n_blocks == 0:                   # nothing to launch, nothing counted
        return out
    fn = _build.function(name, _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), n_blocks, block_rows, d,
                 depth, grid_of(n_blocks, x.device), _build.stream_of(x))
    _build.check(err, name)
    launches += 1
    return out
