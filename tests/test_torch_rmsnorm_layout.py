"""The RMSNorm forward kernel's layout (``kernels.rmsnorm.fwd_layout``),
on the CPU: a layout that holds the row for every d the wrapper takes,
the form and the warps a row each call takes (the fewest that hold a row
at four vectors a lane for calls the card does not hold at once, at one
vector a lane and a block a row for the others), that the grid covers
the rows, that the
constants agree with ``csrc/rmsnorm.cu``, and that the wrapper hands
the layout to the C entry with the argument types it declares.  The
kernel sums a row in one order fixed by d whatever the layout; that a
row's bits do not depend on the call is held on the card
(``tests/test_torch_card.py``).
"""
import contextlib
import ctypes
import re

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.kernels import _build
from repro_torch.kernels import rmsnorm as RN


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these small models run many small ops, which
    the thread pools of several test workers on a shared CPU slow down
    many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BF16, F32 = 1, 0
ELEMS = {BF16: 8, F32: 4}           # elements of a 16-byte vector


def _lanes_hold(wpr, code, vec=RN.VEC):
    """Elements the lanes of ``wpr`` warps hold at ``vec`` vectors each."""
    return wpr * 32 * vec * ELEMS[code]


def _fewest(d, code, vec):
    """The fewest warps of 1-16 that hold a row of d at ``vec`` vectors a
    lane, or None."""
    return next((w for w in (1, 2, 4, 8, 16)
                 if _lanes_hold(w, code, vec) >= d), None)


@pytest.mark.parametrize("code", [BF16, F32])
def test_every_d_gets_the_fewest_warps_that_hold_it(code):
    step = ELEMS[code]
    for d in range(step, 65536 + 1, step):
        for rows in (8, 1000, 8192):
            wpr, rpb, blocks, staged = RN.fwd_layout(rows, d, code, 132)
            assert wpr in (1, 2, 4, 8, 16)
            assert 1 <= rpb and rpb * wpr * 32 <= min(RN.FWD_THREADS, 1024)
            assert blocks * rpb >= rows
            if staged:               # four vectors a lane, in one chunk
                assert wpr == _fewest(d, code, RN.VEC)
                # its shared memory: rows_per_block rows of d
                assert rpb * d * 16 // ELEMS[code] <= 32 * 1024
            else:                    # a block a row: one vector a lane,
                assert wpr == (_fewest(d, code, 1) or 16)   # or 16 warps
                assert (rpb, blocks) == (1, rows)


@pytest.mark.parametrize("rows,d,code,wpr", [
    # training micro-batches: the fewest warps at four vectors a lane
    (8192, 1024, BF16, 1), (8192, 2560, BF16, 4), (8192, 3072, BF16, 4),
    (8192, 5120, BF16, 8), (8192, 1016, BF16, 1), (8192, 1032, BF16, 2),
    (8192, 16384, BF16, 16), (8192, 32768, BF16, 16), (8192, 1024, F32, 2),
    (8192, 3072, F32, 8), (8192, 8192, F32, 16), (8192, 16384, F32, 16),
    # a decode step and prefills: one vector a lane
    (8, 1024, BF16, 4), (1024, 1024, BF16, 4), (8, 1024, F32, 8),
    (8, 2560, BF16, 16), (8, 5120, BF16, 16), (8, 512, BF16, 2)])
def test_warps_a_row_at_the_models_widths(rows, d, code, wpr):
    assert RN.fwd_layout(rows, d, code, 132)[0] == wpr


@settings(max_examples=200, deadline=None)
@given(rows=st.integers(1, 1 << 20), sms=st.integers(1, 264),
       d=st.integers(1, 8192), code=st.sampled_from([BF16, F32]))
def test_layout_follows_the_call(rows, sms, d, code):
    d *= ELEMS[code]
    wpr, rpb, blocks, staged = RN.fwd_layout(rows, d, code, sms)
    # every row has a block, and no block is left without a row
    assert blocks * rpb >= rows > (blocks - 1) * rpb
    assert rpb * wpr * 32 <= RN.FWD_THREADS
    held = _fewest(d, code, RN.VEC)
    most = RN.FWD_THREADS // 32
    # staged: rows of one chunk, more than full blocks on every SM hold
    assert staged == int(held is not None and rows > sms * (most // held))
    if staged:
        assert (wpr, rpb) == (held, most // held)
    else:                            # a block a row
        assert (wpr, rpb, blocks) == (_fewest(d, code, 1) or most, 1, rows)


@pytest.mark.parametrize("rows,d,layout", [
    (8, 1024, (4, 1, 8, 0)),          # a decode step: a block a row
    (64, 1024, (4, 1, 64, 0)),        # prompt buckets
    (512, 1024, (4, 1, 512, 0)),
    (1024, 1024, (4, 1, 1024, 0)),    # a prefill of 1024
    (8192, 1024, (1, 16, 512, 1)),    # a training micro-batch, staged
    (8192, 2560, (4, 4, 2048, 1)),    # Mamba-2's block norm
    (8192, 5120, (8, 2, 4096, 1)),    # Mamba-2's gated norm
    (8192, 32768, (16, 1, 8192, 0))])  # long rows: registers, in chunks
def test_layout_at_the_models_shapes(rows, d, layout):
    assert RN.fwd_layout(rows, d, BF16, 132) == layout


def test_constants_match_the_source():
    src = (_build.CSRC / "rmsnorm.cu").read_text()
    assert int(re.search(r"constexpr int kFwdThreads = (\d+);",
                         src).group(1)) == RN.FWD_THREADS
    assert int(re.search(r"constexpr int kVec = (\d+);",
                         src).group(1)) == RN.VEC
    assert re.search(r"extern \"C\" int rmsnorm_fwd\(const void\* x, "
                     r"const void\* scale, void\* out,\s+int rows, int d, "
                     r"float eps, int dtype,\s+int warps_per_row, "
                     r"int rows_per_block, int blocks,\s+int staged, "
                     r"void\* stream\)", src)


@pytest.mark.parametrize("shape,dtype", [((8, 1024), torch.bfloat16),
                                         ((2, 512, 2560), torch.bfloat16),
                                         ((3, 3072), torch.float32)])
def test_wrapper_passes_the_layout(monkeypatch, shape, dtype):
    """The wrapper's call of the C entry, with the card faked: one call,
    as many arguments as ``_ARGTYPES`` declares, the layout of
    ``fwd_layout`` at the card's SM count, one launch counted."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    def function(name, argtypes):
        assert name == "rmsnorm_fwd" and argtypes == RN._ARGTYPES
        return entry

    code = 1 if dtype == torch.bfloat16 else 0
    monkeypatch.setattr(RN._build, "dtype_code", lambda name, *t: code)
    monkeypatch.setattr(RN._build, "function", function)
    monkeypatch.setattr(RN._build, "stream_of", lambda t: 7)
    monkeypatch.setattr(RN.torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(RN, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(RN, "launches", 0)
    x = torch.zeros(shape, dtype=dtype)
    RN.rmsnorm_fwd(x, torch.zeros(shape[-1]), 1e-5)
    rows, d = x.numel() // shape[-1], shape[-1]
    (args,) = calls
    assert len(args) == len(RN._ARGTYPES)
    assert args[3:7] == (rows, d, 1e-5, code)
    assert args[7:11] == RN.fwd_layout(rows, d, code, 132)
    assert args[11] == 7 and RN.launches == 1
    assert RN._ARGTYPES[7:11] == [ctypes.c_int] * 4
