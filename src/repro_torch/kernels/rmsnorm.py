"""RMSNorm on the card, forward and backward: the wrappers of
``csrc/rmsnorm.cu`` and the ``torch.autograd.Function`` that joins them.

Replaces the TPU kernels ``src/repro/kernels/rmsnorm.py::_rmsnorm_kernel``
(``rmsnorm_fwd``) and ``::_rmsnorm_bwd_kernel`` (``rmsnorm_bwd``), and
``_rmsnorm_with_vjp`` (``rmsnorm``).  Bound by bytes on the H100; the
source says what the designs do about that.  The plain versions are
``kernels.ref.rmsnorm_ref`` and ``kernels.ref.rmsnorm_bwd_ref``;
``kernels.backend.rmsnorm`` picks by the device of the input.

The split row (:class:`SplitRMSNorm`): the same norm over a row whose
columns are cut over a model group, each rank holding its own (Mamba-2's
gated norm on a mesh).  Its forward sums each row's squares on the rank
(``split_sumsq``), all-reduces the sums, and normalises the rank's
columns (``split_fwd``); its backward sums each row's g·(1+scale)·x on
the rank (``split_dot``), all-reduces them, and forms dx and the rank's
dscale (``split_bwd``).  Their plain versions are ``kernels.ref``'s
``rmsnorm_split_*_ref``; ``kernels.backend.rmsnorm_split`` picks by the
device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# launches of each kernel since the count was last set to 0
launches = 0            # rmsnorm_fwd
bwd_launches = 0        # rmsnorm_bwd
split_sumsq_launches = 0   # rmsnorm_split_dot, sums of squares
split_fwd_launches = 0     # rmsnorm_split_fwd
split_dot_launches = 0     # rmsnorm_split_dot, the backward's dot
split_bwd_launches = 0     # rmsnorm_split_bwd

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_float, ctypes.c_int,
                                         ctypes.c_void_p]
_SCRATCH_ARGTYPES = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
_SPLIT_DOT_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
    ctypes.c_void_p]
_SPLIT_FWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_SPLIT_BWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
SPLIT_CHUNK = 32        # rows a block of the split backward sums dscale over

# the forward's layout (csrc/rmsnorm.cu: kFwdThreads, kVec)
FWD_THREADS = 512       # the most threads a block has
VEC = 4                 # the most 16-byte vectors a lane holds of a row
_WARPS = (1, 2, 4, 8, 16)
_sms = {}               # SMs of each device, read once


def fwd_layout(rows: int, d: int, dtype_code: int, sms: int):
    """(warps_per_row, rows_per_block, blocks, staged) of the forward
    kernel for ``rows`` ≥ 1 rows of ``d`` in dtype code 0 (float32) or 1
    (bfloat16) on a card of ``sms`` SMs.

    The kernel sums a row in one order fixed by d (groups of 32 vectors,
    added in group order), so a row's bits do not depend on the layout,
    which follows the call.  A call with more rows than the card holds at
    once, in full blocks of the fewest warps whose lanes hold a row at
    ``VEC`` vectors of 16 bytes each, is bound by the bytes in flight and
    takes the staged form (x copied through shared memory) in that
    layout.  Any other call, and rows longer than 16 warps hold, is bound
    by latency and takes the register form: a block a row, of the fewest
    warps whose lanes hold it at one vector each (16 warps and up to
    ``VEC`` vectors a lane for a longer row, which past 16 warps' worth
    is walked a chunk at a time)."""
    nvec = d // (8 if dtype_code == 1 else 4)
    most = FWD_THREADS // 32
    held = next((w for w in _WARPS if w * 32 * VEC >= nvec), None)
    if held is not None and rows > sms * (most // held):
        rpb = most // held
        return held, rpb, -(-rows // rpb), 1
    return next((w for w in _WARPS if w * 32 >= nvec), most), 1, rows, 0


def _sm_count(device: torch.device) -> int:
    if device.index not in _sms:
        _sms[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sms[device.index]


def _bwd_scratch(rows: int, d: int, code: int):
    """(float32 partial rows, int32 counters) the backward kernel needs for
    this call, or None when d is too long for it."""
    fn = _build.function("rmsnorm_bwd_scratch", _SCRATCH_ARGTYPES)
    part, ctrs = ctypes.c_int(), ctypes.c_int()
    if not fn(rows, d, code, ctypes.byref(part), ctypes.byref(ctrs)):
        return None
    return part.value, ctrs.value


def _check_scale(name: str, x: torch.Tensor, scale: torch.Tensor) -> None:
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


def rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d) float32 or bfloat16 on a CUDA device, contiguous;
    scale: (d,) float32 on the same device.  Returns
    x·rsqrt(mean(x²)+eps)·(1+scale) in x's dtype, from one launch laid
    out by ``fwd_layout``: a row's bits depend on that row, scale, eps, d
    and the dtype alone, not on the rows around it."""
    name = "rmsnorm_fwd"
    code = _build.dtype_code(name, x)
    _check_scale(name, x, scale)
    d = x.shape[-1]
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0 or _build.shape_only(x, 4 * x.numel()):
        return out                      # nothing to launch, nothing counted
    layout = fwd_layout(rows, d, code, _sm_count(x.device))
    fn = _build.function(name, _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d,
                 eps, code, *layout, _build.stream_of(x))
    _build.check(err, name)
    _build.count(globals(), "launches", x)
    return out


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                eps: float = 1e-5):
    """The VJP of ``rmsnorm_fwd`` at x for the output gradient g (x's
    shape and dtype).  x and scale as for the forward; g is read as it
    is when contiguous and copied once otherwise.  d up to 16384
    (bfloat16) or 8192 (float32).  Returns (dx in x's dtype, dscale (d,)
    float32), both from one launch: the kernel sums dscale over the rows
    itself, in a fixed order."""
    name = "rmsnorm_bwd"
    if g.shape != x.shape:
        raise ValueError(f"{name}: g {tuple(g.shape)} != x "
                         f"{tuple(x.shape)}")
    g = g.contiguous()
    code = _build.dtype_code(name, x, g)
    _check_scale(name, x, scale)
    _build.check_rows(name, g)
    d = x.shape[-1]
    dx = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return dx, torch.zeros_like(scale)
    if _build.shape_only(x, 12 * x.numel()):
        # the scratch partials are sized by the library from the card's
        # SMs (a few MB), so a shape-only call leaves them out
        return dx, torch.empty_like(scale)
    scratch = _bwd_scratch(rows, d, code)
    if scratch is None:
        raise ValueError(f"{name}: d={d} is longer than a block holds "
                         f"(16384 in bfloat16, 8192 in float32)")
    part = torch.empty(scratch[0], d, dtype=torch.float32, device=x.device)
    dscale = torch.empty_like(scale)
    ctrs = _build.counters(name, x.device, scratch[1])
    fn = _build.function(name, _BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr(),
                 dscale.data_ptr(), part.data_ptr(), ctrs.data_ptr(), rows,
                 d, eps, code, _build.stream_of(x))
    _build.check(err, name)
    _build.count(globals(), "bwd_launches", x)
    return dx, dscale


class _RMSNorm(torch.autograd.Function):
    """Forward ``rmsnorm_fwd``, backward ``rmsnorm_bwd``; like the
    reference's custom VJP it saves x and scale, not rsqrt(mean(x²)),
    which the backward recomputes."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm_fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, g, ctx.eps)
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """Differentiable RMSNorm on the card: the forward kernel, and under
    autograd the backward kernel."""
    return _RMSNorm.apply(x, scale, eps)


# --------------------------------------------------------------------- #
# the split row
# --------------------------------------------------------------------- #

def _split_check(name: str, x, scale, like=(), sums=()) -> int:
    """The dtype code of a split-row call: x (rows, d) and the ``like``
    tensors of its shape and dtype, contiguous; ``sums`` float32 (rows,)
    row sums."""
    code = _build.dtype_code(name, x, *like)
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be (rows, d), got "
                         f"{tuple(x.shape)}")
    _check_scale(name, x, scale)
    for t in like:
        if t.shape != x.shape or not t.is_contiguous():
            raise ValueError(f"{name}: {tuple(t.shape)} against x "
                             f"{tuple(x.shape)}, contiguous")
        _build.check_rows(name, t)
    for t in sums:
        if t.dtype != torch.float32 or tuple(t.shape) != (x.shape[0],) \
                or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name}: row sums must be float32 "
                             f"({x.shape[0]},) on {x.device}")
    return code


def _split_dot(name: str, attr: str, x, scale, g):
    code = _split_check(name, x, scale, like=() if g is None else (g,))
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    if _build.shape_only(x, (2 if g is None else 3) * x.numel()):
        return out
    fn = _build.function("rmsnorm_split_dot", _SPLIT_DOT_ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), 0 if g is None else g.data_ptr(),
                 scale.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
                 code, _build.stream_of(x))
    _build.check(err, name)
    _build.count(globals(), attr, x)
    return out


def split_sumsq(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (rows, d) float32 or bfloat16 on the card, contiguous; scale
    (d,) float32 (checked, not read) -> each row's float32 sum of x² over
    its d columns, from one launch."""
    return _split_dot("rmsnorm_split_sumsq", "split_sumsq_launches", x,
                      scale, None)


def split_dot(x: torch.Tensor, scale: torch.Tensor,
              g: torch.Tensor) -> torch.Tensor:
    """Each row's float32 sum of g·(1+scale)·x over its d columns (x, g
    (rows, d) of one dtype), from one launch."""
    return _split_dot("rmsnorm_split_dot", "split_dot_launches", x, scale,
                      g.contiguous())


def split_fwd(x: torch.Tensor, scale: torch.Tensor, ss: torch.Tensor,
              d_full: int, eps: float = 1e-5) -> torch.Tensor:
    """y = x·rsqrt(ss/d_full + eps)·(1+scale) in x's dtype, ss (rows,)
    float32 the whole rows' sums of squares, from one launch."""
    name = "rmsnorm_split_fwd"
    code = _split_check(name, x, scale, sums=(ss,))
    y = torch.empty_like(x)
    if x.shape[0] == 0 or _build.shape_only(x, 4 * x.numel()):
        return y
    n = x.numel() // (8 if code == 1 else 4)
    blocks = max(1, min(-(-n // 256), _sm_count(x.device) * 8))
    fn = _build.function(name, _SPLIT_FWD_ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), scale.data_ptr(), ss.data_ptr(), y.data_ptr(),
                 x.shape[0], x.shape[1], d_full, eps, code, blocks,
                 _build.stream_of(x))
    _build.check(err, name)
    _build.count(globals(), "split_fwd_launches", x)
    return y


def split_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
              ss: torch.Tensor, dot: torch.Tensor, d_full: int,
              eps: float = 1e-5):
    """(dx in x's dtype, dscale (d,) float32) of the split row from the
    whole rows' ss and dot (rows,) float32: one call of two launches
    (dx with each chunk of ``SPLIT_CHUNK`` rows' dscale partial, then the
    partials summed in chunk order)."""
    name = "rmsnorm_split_bwd"
    g = g.contiguous()
    code = _split_check(name, x, scale, like=(g,), sums=(ss, dot))
    rows, d = x.shape
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    part = torch.empty(max(-(-rows // SPLIT_CHUNK), 1), d,
                       dtype=torch.float32, device=x.device)
    if _build.shape_only(x, 12 * x.numel()):
        return dx, dscale
    fn = _build.function(name, _SPLIT_BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), scale.data_ptr(), g.data_ptr(), ss.data_ptr(),
                 dot.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
                 part.data_ptr(), rows, d, d_full, SPLIT_CHUNK, eps, code,
                 _build.stream_of(x))
    _build.check(err, name)
    _build.count(globals(), "split_bwd_launches", x)
    return dx, dscale


# the card's split-row ops, in the order ``SplitRMSNorm`` takes them
SPLIT = (split_sumsq, split_dot, split_fwd, split_bwd)


class SplitRMSNorm(torch.autograd.Function):
    """RMSNorm of rows cut over a group: x (..., d) holds this rank's d of
    each row's ``d_full`` columns and scale (d,) their scales.
    ``reduce`` sums a float32 (rows,) tensor over the group (returning
    the sum); ``ops`` are (sumsq, dot, fwd, bwd): ``SPLIT`` on the card,
    ``kernels.ref.RMSNORM_SPLIT`` on the CPU.  The forward saves x, scale
    and the whole rows' sums of squares (no second all-reduce in the
    backward); the backward all-reduces the rows' partial dot before dx.
    dscale is the rank's columns' own."""

    @staticmethod
    def forward(ctx, x, scale, eps, d_full, reduce, ops):
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        ss = reduce(ops[0](x2, scale))
        ctx.save_for_backward(x2, scale, ss)
        ctx.eps, ctx.d_full, ctx.reduce, ctx.ops = eps, d_full, reduce, ops
        ctx.shape = shape
        return ops[2](x2, scale, ss, d_full, eps).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        x2, scale, ss = ctx.saved_tensors
        g2 = g.reshape(x2.shape)
        dot = ctx.reduce(ctx.ops[1](x2, scale, g2))
        dx, dscale = ctx.ops[3](x2, scale, g2, ss, dot, ctx.d_full, ctx.eps)
        return dx.reshape(ctx.shape), dscale, None, None, None, None
