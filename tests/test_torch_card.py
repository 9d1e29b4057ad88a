"""The hand-written CUDA kernels on the card, each against its plain
version, the serving engine (dense, and Mamba-2 from the state pool)
and one training step of the dense model and of Mamba-2 on the card
against the same on the CPU, and a CI-sized
run of the kernel benchmark; in the built library's machine code, that
the bfloat16 flash forward, dq and dk/dv and the bfloat16 SSD chunk
kernel run on the tensor cores; that the RMSNorm backward is one
launch; and that the engines' CUDA graphs replay their eager steps bit
for bit, count launches through replays, capture nothing new for a
short chunk or after a reset, and read a pool defragmented between
replays.  The blocking ``Server`` (full cache and sliding-window ring)
on the card against the CPU and against its own eager steps, the ring's
prefill plus decode against the prefill of the whole, and the engine
against its solo Server oracle.  The RG-LRU scan kernels against their
plain versions and under a captured graph, the ragged decode at head_dim
256, and the RG-LRU hybrid trained and served on the card against the
CPU.  The enc-dec (seamless-m4t-medium) trained and served and the
VLM (internvl2-76b) served with its prefix, on the card against the
CPU; the kernels at their GQA groups of 8 and 7 and at d 8192.  The
decode kernels of the cut caches (sharded serving): the head_dim cut's
scores and softmax-P·V passes and the sequence cut's partial, each
against its plain version at llama3.2-3b's decode shape (GQA 24/8, hd
128 cut in 2 and 4, Skv 4,096, lengths 0 and Skv − 1 among them), and
their M parts summed or merged against the whole-head decode kernel; the
head_dim cut at every group size of the repo's configs (1-16 query heads
a KV head) in both cache layouts, at lengths around the key tile, its
scores pass leaving entries past a length untouched, and in bfloat16 on
the tensor cores.

Every test here needs an NVIDIA card and skips without one.  The file
imports no JAX, so it runs on the card's machine as it is:

    python -m pytest -m gpu tests/test_torch_card.py

Tolerances: 2e-5 in float32 (sums in another order), 2e-2 in bfloat16
(one rounding of the output), TF32 off.  The SSD chunk kernel at
mamba2-2.7b's decay (A down to -80, Q = 256: cum reaches ~-2000 within
a chunk, where float32 sums of it differ by ~1e-4 relative) is held to
a float64 evaluation of its plain version instead: its error must not
exceed twice the float32 plain version's.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import backend as KB
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import overlap as OV
from repro_torch.kernels import ref
from repro_torch.kernels import rglru as RG
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels import ssd as SSD
from repro_torch.kernels import paged as PG
from repro_torch.models import registry as R
from repro_torch.serving import GenerationRequest, ServingEngine
from repro_torch.serving import cache as SC

pytestmark = pytest.mark.gpu

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
DTYPES = [torch.float32, torch.bfloat16]
# lengths that start, fill, cross and overrun the bf16 flash kernels'
# 16-row warp tiles and 32/64-row block tiles, at hd 64 (MHA) and hd 128
# (GQA groups of 3)
FLASH_EDGES = ([(2, 4, 4, S, 64) for S in (1, 15, 16, 63, 64, 65, 129)]
               + [(1, 6, 2, S, 128) for S in (1, 15, 16, 63, 64, 65, 129)])
# hd 32, the paper's figure LMs (4 heads of 32, S = 64, B up to 128): their
# shapes, a ragged S, GQA, and the tile edges
FLASH_HD32 = ([(8, 4, 4, 64, 32), (128, 4, 4, 64, 32), (2, 4, 4, 77, 32),
               (2, 4, 2, 64, 32), (1, 4, 2, 77, 32)]
              + [(2, 4, 2, S, 32) for S in (1, 15, 16, 63, 65, 129)])
# hd 128 at the last families' GQA groups: internvl2-76b's 64/8 and
# yi-34b's 56/8 (a group of 7), ragged lengths and the VLM's prefill
FLASH_GQA = [(1, 64, 8, 77, 128), (1, 56, 8, 65, 128), (1, 56, 8, 1024, 128),
             (1, 64, 8, 1088, 128)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    tol = BF16 if dtype == torch.bfloat16 else F32
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(8, 1024), (1, 1000, 1024), (37, 64),
                                   (3, 3072), (2, 512, 2560),
                                   (2, 512, 5120), (2, 8192),
                                   (2, 1088, 8192)])
def test_rmsnorm_kernel(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    s = 0.1 * torch.randn(shape[-1], generator=g, device=cuda)
    got = RN.rmsnorm_fwd(x, s, 1e-5)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    _close(got, ref.rmsnorm_ref(x, s, 1e-5), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,d,parts", [(8, 512, 2), (77, 2560, 1),
                                          (4096, 5120, 2), (4096, 5120, 4)])
def test_split_rmsnorm_kernels(cuda, dtype, rows, d, parts):
    """The split row's four kernels, a row cut in ``parts`` as that many
    model ranks hold it, each against its plain version on the same
    inputs (the row sums added as the all-reduce adds them)."""
    g = torch.Generator(device=cuda).manual_seed(rows + parts)
    x = torch.randn(rows, d, generator=g, device=cuda).to(dtype)
    gy = torch.randn(rows, d, generator=g, device=cuda).to(dtype)
    s = 0.1 * torch.randn(d, generator=g, device=cuda)
    xs, gs, ss_ = (t.chunk(parts, -1) for t in (x, gy, s))
    xs, gs = ([t.contiguous() for t in ts] for ts in (xs, gs))
    ss_ = [t.contiguous() for t in ss_]
    sums = [RN.split_sumsq(a, b) for a, b in zip(xs, ss_)]
    dots = [RN.split_dot(a, b, c) for a, b, c in zip(xs, ss_, gs)]
    for a, b, c, su, do in zip(xs, ss_, gs, sums, dots):
        torch.testing.assert_close(su, ref.rmsnorm_split_sumsq_ref(a, b),
                                   rtol=2e-5, atol=1e-3)
        torch.testing.assert_close(do, ref.rmsnorm_split_dot_ref(a, b, c),
                                   rtol=2e-5, atol=1e-3)
    ss, dot = sum(sums), sum(dots)
    for a, b, c in zip(xs, ss_, gs):
        _close(RN.split_fwd(a, b, ss, d), ref.rmsnorm_split_fwd_ref(
            a, b, ss, d), dtype)
        dx, ds = RN.split_bwd(a, b, c, ss, dot, d)
        wdx, wds = ref.rmsnorm_split_bwd_ref(a, b, c, ss, dot, d)
        torch.cuda.synchronize()
        _close(dx, wdx, dtype)
        torch.testing.assert_close(ds, wds, rtol=2e-5, atol=2e-5 * float(
            wds.abs().max()))


# the forward's warps a row switch at these d: for a few rows (one vector
# a lane) 1 -> 2 -> ... -> 16 warps, then up to 4 vectors a lane, then
# chunks of 16 warps' worth; for 8192 rows (4 vectors a lane, staged)
# 1 -> ... -> 16 warps, then chunks.  Each switch and 8 on either side.
_FWD_SWITCHES = {torch.bfloat16: (256, 512, 1024, 2048, 4096, 16384),
                 torch.float32: (128, 256, 512, 1024, 2048, 8192)}
_FWD_EDGES = [(dt, d + e) for dt, ds in _FWD_SWITCHES.items() for d in ds
              for e in (-8, 0, 8)]
_FWD_STAGED_SWITCHES = {torch.bfloat16: (1024, 2048, 4096, 8192, 16384),
                        torch.float32: (512, 1024, 2048, 4096, 8192)}


@pytest.mark.parametrize("dtype,d", _FWD_EDGES + [(torch.bfloat16, 32768),
                                                  (torch.float32, 16384),
                                                  (torch.bfloat16, 8),
                                                  (torch.float32, 4)])
def test_rmsnorm_fwd_layout_edges(cuda, dtype, d):
    """Widths at each switch of the forward's layout for a few rows and
    rows longer than 16 warps hold (walked a chunk at a time), at 1, 7, 8
    and 9 rows."""
    g = torch.Generator(device=cuda).manual_seed(d)
    s = 0.1 * torch.randn(d, generator=g, device=cuda)
    for rows in (1, 7, 8, 9):
        x = torch.randn(rows, d, generator=g, device=cuda).to(dtype)
        got = RN.rmsnorm_fwd(x, s, 1e-5)
        torch.cuda.synchronize()
        _close(got, ref.rmsnorm_ref(x, s, 1e-5), dtype)


@pytest.mark.parametrize("dtype,d", [
    (torch.bfloat16, 1024), (torch.bfloat16, 2560), (torch.bfloat16, 5120),
    (torch.bfloat16, 32768), (torch.float32, 1024), (torch.float32, 16384)]
    + [(dt, d + e) for dt, ds in _FWD_STAGED_SWITCHES.items() for d in ds
       for e in (-8, 8)])
def test_rmsnorm_fwd_8192_rows(cuda, dtype, d):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(8192, d, generator=g, device=cuda).to(dtype)
    s = 0.1 * torch.randn(d, generator=g, device=cuda)
    got = RN.rmsnorm_fwd(x, s, 1e-5)
    torch.cuda.synchronize()
    _close(got, ref.rmsnorm_ref(x, s, 1e-5), dtype)


@pytest.mark.parametrize("dtype,d", [
    (torch.bfloat16, 1024), (torch.bfloat16, 2560), (torch.bfloat16, 5120),
    (torch.bfloat16, 32768), (torch.float32, 3072), (torch.float32, 16384)])
def test_rmsnorm_fwd_row_bits_do_not_depend_on_the_call(cuda, dtype, d):
    """A row's output has the same bits whether it comes alone, among the
    first k rows or among 8192 (other layouts and forms: a block a row at
    one vector a lane in registers for the first, the fewest warps at four
    vectors a lane staged in shared memory for the last where a row fits
    16 warps), and from call to call; one CUDA kernel a call."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(8192, d, generator=g, device=cuda).to(dtype)
    s = 0.1 * torch.randn(d, generator=g, device=cuda)
    full = RN.rmsnorm_fwd(x, s, 1e-5)
    torch.cuda.synchronize()
    before = RN.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        again = RN.rmsnorm_fwd(x, s, 1e-5)
        torch.cuda.synchronize()
    kernels = [e.key for e in prof.key_averages()
               for _ in range(e.count)
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "rmsnorm_fwd" in kernels[0], kernels
    assert RN.launches == before + 1
    assert torch.equal(again, full)
    for k in (9, 1000):
        assert torch.equal(RN.rmsnorm_fwd(x[:k], s, 1e-5), full[:k])
    for i in (0, 5, 4097, 8191):
        assert torch.equal(RN.rmsnorm_fwd(x[i:i + 1], s, 1e-5)[0], full[i])


@pytest.mark.parametrize("dtype,d", [
    (torch.bfloat16, 1024), (torch.bfloat16, 1032), (torch.bfloat16, 2560),
    (torch.bfloat16, 5120), (torch.float32, 3072)])
def test_rmsnorm_fwd_same_bits_in_every_layout(cuda, monkeypatch, dtype, d):
    """The kernel sums a row in one order fixed by d: every layout the C
    entry takes (1-16 warps a row; the register form a block a row, the
    staged one, where it holds the row, 1 or all rows a block; one block
    or one a row) gives the same bits as the wrapper's own."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(300, d, generator=g, device=cuda).to(dtype)
    s = 0.1 * torch.randn(d, generator=g, device=cuda)
    want = RN.rmsnorm_fwd(x, s, 1e-5)
    nvec = d // (8 if dtype == torch.bfloat16 else 4)
    for wpr in (1, 2, 4, 8, 16):
        for staged in (0, 1):
            if staged and wpr * 32 * RN.VEC < nvec:
                continue
            for rpb in sorted({1, 16 // wpr if staged else 1}):
                for blocks in (1, -(-300 // rpb)):
                    layout = (wpr, rpb, blocks, staged)
                    monkeypatch.setattr(RN, "fwd_layout",
                                        lambda *a, lay=layout: lay)
                    got = RN.rmsnorm_fwd(x, s, 1e-5)
                    torch.cuda.synchronize()
                    assert torch.equal(got, want), layout


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,Hkv,S,hd", [
    (1, 16, 16, 1024, 64),      # seesaw-150m prefill
    (8, 16, 16, 1024, 64),      # seesaw-150m training
    (1, 24, 8, 1000, 128),      # llama3.2-3b heads, ragged tail
    (2, 4, 2, 77, 64),
    (1, 2, 1, 1, 128),
] + FLASH_EDGES + FLASH_HD32 + FLASH_GQA)
def test_flash_fwd_kernel(cuda, B, H, Hkv, S, hd, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    # the models' (B, S, H, hd) layout, read as transposed views
    q = torch.randn(B, S, H, hd, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, S, Hkv, hd, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, S, Hkv, hd, generator=g, device=cuda).to(dtype)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    out, lse = FA.flash_fwd(qt, kt, vt)
    torch.cuda.synchronize()
    want, want_lse = ref.attention_ref(qt, kt, vt)
    assert out.dtype == dtype and lse.dtype == torch.float32
    _close(out, want, dtype)
    _close(lse, want_lse, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,Hkv,Skv,hd", [
    (8, 16, 16, 1024, 64),      # seesaw-150m decode, 8 slots
    (8, 24, 8, 1000, 128),      # llama3.2-3b heads
    (3, 4, 1, 20, 64),
    (4, 4, 2, 128, 32),         # bench.serve's LM: 4 heads of 32, GQA 2
    (8, 4, 4, 1024, 32),        # the figure LMs' heads, MHA, 8 splits
    (3, 16, 4, 300, 32),        # two groups of 4 query heads a kv head
    (2, 16, 1, 2048, 256),      # recurrentgemma's ring: MQA, 4 groups
    (3, 8, 2, 300, 256),        # hd 256, GQA 4
    (2, 2, 2, 130, 256),        # hd 256, MHA
    (2, 64, 8, 2048, 128),      # internvl2-76b: GQA 8, two blocks of 4
    (8, 56, 8, 300, 128),       # yi-34b: GQA 7, a block of 4 and a tail of 3
    (2, 16, 16, 1024, 64),      # seamless's cross-attention over its frames
])
def test_ragged_decode_kernel(cuda, B, H, Hkv, Skv, hd, dtype):
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(B, 1, H, hd, generator=g, device=cuda).to(dtype)
    # a gathered head-interleaved window, split into strided K/V views
    kv = torch.randn(B, Skv, 2 * Hkv, hd, generator=g, device=cuda).to(dtype)
    k, v = kv[:, :, 0::2], kv[:, :, 1::2]
    lengths = torch.randint(0, Skv, (B,), generator=g, device=cuda,
                            dtype=torch.int32)
    lengths[0], lengths[-1] = 0, Skv - 1
    got = KB.paged_decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    want = ref.ragged_decode_ref(q[:, 0], k.transpose(1, 2),
                                 v.transpose(1, 2), lengths)
    _close(got[:, 0], want, dtype)


def _page_table(cuda, B, H, Hkv, hd, ps, window, dtype, seed):
    """A random pool and a shuffled page table for B requests: lengths
    ps - 1, ps, ps + 1 (the page edges), an inactive slot (length 0,
    all-null row), the window's last key window - 1, the rest random.
    Live pages are distinct, shuffled ids; the other entries are the null
    page 0, whose data is random too."""
    rng = np.random.default_rng(seed)
    P = window // ps
    lens = rng.integers(1, window, B)
    lens[:5] = [ps - 1, ps, ps + 1, 0, window - 1]
    need = [0 if b == 3 else n // ps + 1 for b, n in enumerate(lens)]
    n_pages = sum(need) + 5
    ids = rng.permutation(np.arange(1, n_pages))
    pages = np.zeros((B, P), np.int64)
    used = 0
    for b, n in enumerate(need):
        pages[b, :n] = ids[used:used + n]
        used += n
    g = torch.Generator(device=cuda).manual_seed(seed)
    pool = torch.randn(n_pages, ps, 2 * Hkv, hd, generator=g,
                       device=cuda).to(dtype)
    q = torch.randn(B, H, hd, generator=g, device=cuda).to(dtype)
    return (q, pool, torch.from_numpy(pages).to(cuda),
            torch.from_numpy(lens.astype(np.int32)).to(cuda))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ps", [1, 4, 16])
@pytest.mark.parametrize("H,Hkv,hd,window", [
    (16, 16, 64, 1024),         # seesaw-150m decode
    (24, 8, 128, 1008),         # llama3.2-3b heads
    (4, 2, 32, 128),            # bench.serve's LM (hd 32, GQA 2)
    (4, 4, 32, 1024),           # hd 32, MHA
    (16, 1, 256, 512),          # hd 256, MQA (recurrentgemma's heads)
    (56, 8, 128, 256),          # yi-34b's GQA 7
])
def test_paged_decode_kernel(cuda, H, Hkv, hd, window, ps, dtype):
    """The kernel reading K and V through the page table, against the
    plain gather-then-attend, at page sizes 1, 4 and 16."""
    q, pool, pages, lengths = _page_table(cuda, 8, H, Hkv, hd, ps, window,
                                          dtype, seed=ps)
    before = PG.launches
    got = PG.paged_decode_attention_pool(q, pool, pages, lengths,
                                         page_size=ps)
    torch.cuda.synchronize()
    assert PG.launches == before + 1 and got.dtype == dtype
    _close(got, ref.paged_decode_ref(q, pool, pages, lengths, page_size=ps),
           dtype)
    # the same call again: the split counters were left at zero
    again = PG.paged_decode_attention_pool(q, pool, pages, lengths,
                                           page_size=ps)
    assert torch.equal(got, again)


def test_serving_on_card_reads_pages_in_place(cuda, monkeypatch):
    """The card's decode step reads K and V through the page table: no
    window is gathered (the plain version would gather one)."""
    def boom(*args, **kwargs):
        raise AssertionError("gathered a page window on the card")

    monkeypatch.setattr(SC, "gather_pages", boom)
    cfg = ModelConfig(name="card-tiny", arch_type="dense", n_layers=2,
                      d_model=128, n_heads=2, n_kv_heads=1, head_dim=64,
                      d_ff=256, vocab_size=256, max_seq_len=64,
                      rope_theta=1e4)
    model = R.init_model(cfg, seed=0, dtype=torch.float32, device=cuda)
    eng = ServingEngine(cfg, model, dtype=torch.float32, decode_slots=2,
                        page_size=4, max_len=32)
    before = PG.launches
    for n in (3, 9, 17):
        eng.submit(GenerationRequest(prompt=np.arange(n, dtype=np.int32),
                                     max_new_tokens=5))
    done = eng.drain()
    assert len(done) == 3 and all(len(r.tokens) == 5 for r in done)
    assert PG.launches > before and eng.pool.n_used == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(8, 1024, 1024), (1000, 3072), (37, 64),
                                   (3, 5, 256), (4, 2048, 2560),
                                   (4, 2048, 5120),
                                   (150, 2560)])    # fewer rows than blocks
def test_rmsnorm_bwd_kernel(cuda, shape, dtype):
    g_ = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(shape, generator=g_, device=cuda).to(dtype)
    s = 0.1 * torch.randn(shape[-1], generator=g_, device=cuda)
    g = torch.randn(shape, generator=g_, device=cuda).to(dtype)
    dx, ds = RN.rmsnorm_bwd(x, s, g, 1e-5)
    torch.cuda.synchronize()
    want_dx, want_ds = ref.rmsnorm_bwd_ref(x, s, g, 1e-5)
    assert dx.dtype == dtype and ds.dtype == torch.float32
    _close(dx, want_dx, dtype)
    # dscale is a float32 sum over every row, taken in another order: its
    # error is held to 2e-5 of the sum of the terms' magnitudes
    x32 = x.float().reshape(-1, shape[-1])
    xh = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + 1e-5)
    mag = (g.float().reshape(-1, shape[-1]) * xh).abs().sum(0)
    assert bool(((ds - want_ds).abs() <= 2e-5 * mag + 1e-6).all())


@pytest.mark.parametrize("shape", [(8192, 1024), (8192, 5120), (3, 256)])
def test_rmsnorm_bwd_is_one_launch(cuda, shape):
    """dx and dscale come from one CUDA kernel: no torch reduction (or any
    other kernel) runs after it, and two calls give the same bits."""
    from torch.profiler import ProfilerActivity, profile
    g_ = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(shape, generator=g_, device=cuda).bfloat16()
    s = 0.1 * torch.randn(shape[-1], generator=g_, device=cuda)
    g = torch.randn(shape, generator=g_, device=cuda).bfloat16()
    first = RN.rmsnorm_bwd(x, s, g, 1e-5)     # the counters are made here
    torch.cuda.synchronize()
    before = RN.bwd_launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        dx, ds = RN.rmsnorm_bwd(x, s, g, 1e-5)
        torch.cuda.synchronize()
    kernels = [e.key for e in prof.key_averages()
               for _ in range(e.count)
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "rmsnorm_bwd" in kernels[0], kernels
    assert RN.bwd_launches == before + 1
    assert torch.equal(dx, first[0]) and torch.equal(ds, first[1])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,Hkv,S,hd", [
    (8, 16, 16, 1024, 64),      # seesaw-150m training
    (1, 24, 8, 1000, 128),      # llama3.2-3b heads, ragged tail
    (2, 4, 2, 77, 64),
    (1, 4, 1, 33, 128),
] + FLASH_EDGES + FLASH_HD32 + FLASH_GQA)
def test_flash_bwd_kernels(cuda, B, H, Hkv, S, hd, dtype):
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(B, S, H, hd, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, S, Hkv, hd, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, S, Hkv, hd, generator=g, device=cuda).to(dtype)
    do = torch.randn(B, S, H, hd, generator=g, device=cuda).to(dtype)
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    out, lse = FA.flash_fwd(qt, kt, vt)
    got = FA.flash_bwd(qt, kt, vt, out, lse, dot)
    torch.cuda.synchronize()
    want = ref.flash_bwd_ref(qt, kt, vt, out, lse, dot)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        _close(a, b, dtype)


@pytest.fixture
def sass(cuda):
    """The build module, where the toolkit's cuobjdump can read the
    library's machine code."""
    from repro_torch.kernels import _build
    if _build.cuobjdump() is None:
        pytest.skip("needs the CUDA toolkit's cuobjdump")
    return _build


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd_dq",
                                  "flash_bwd_dkv"])
def test_bf16_flash_kernels_run_on_tensor_cores(sass, name):
    """The bfloat16 instantiations (hd 32, 64 and 128) hold mma.sync
    (HMMA in the SASS), the float32 ones none; ptxas spills nothing at hd
    64.  (At hd 32 the dk/dv kernel spills 8 bytes at 168 registers.)"""
    lib = sass.build()
    hmma = sass.sass_counts(lib, "HMMA")
    bf16 = {n: c for n, c in hmma.items() if f"{name}_mma_kernel" in n}
    f32 = {n: c for n, c in hmma.items() if f"{name}_kernelILi" in n}
    assert len(bf16) == 3 and len(f32) == 3, sorted(hmma)
    assert all(c > 0 for c in bf16.values()), bf16
    assert all(c == 0 for c in f32.values()), f32
    report = sass.ptxas_report(lib)
    hd64 = [n for n in bf16 if "ILi64E" in n]
    assert len(hd64) == 1
    r = report[hd64[0]]
    assert r["spill_stores"] == 0 and r["spill_loads"] == 0, r


def test_bf16_ssd_chunk_runs_on_tensor_cores(sass):
    """The bfloat16 SSD chunk kernel holds mma.sync (HMMA in the SASS) and
    spills nothing; its float32 form holds none."""
    lib = sass.build()
    hmma = sass.sass_counts(lib, "HMMA")
    bf16 = {n: c for n, c in hmma.items() if "ssd_chunk_mma_kernel" in n}
    f32 = {n: c for n, c in hmma.items() if "ssd_chunk_kernelIfE" in n}
    assert len(bf16) == 1 and len(f32) == 1, sorted(hmma)
    assert all(c > 0 for c in bf16.values()), bf16
    assert all(c == 0 for c in f32.values()), f32
    r = sass.ptxas_report(lib)[next(iter(bf16))]
    assert r["spill_stores"] == 0 and r["spill_loads"] == 0, r


def test_autograd_on_card_launches_the_backward_kernels(cuda):
    """backend.rmsnorm and backend.attention on CUDA tensors: the
    gradients come from the backward kernels (counted) and equal those
    of autograd through the plain versions."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(2, 40, 64, generator=g, device=cuda, requires_grad=True)
    s = torch.zeros(64, device=cuda, requires_grad=True)
    q = torch.randn(2, 40, 4, 64, generator=g, device=cuda,
                    requires_grad=True)
    k = torch.randn(2, 40, 2, 64, generator=g, device=cuda,
                    requires_grad=True)
    before = (RN.bwd_launches, FA.dq_launches, FA.dkv_launches)
    y = KB.rmsnorm(x, s).square().sum() + KB.attention(q, k, k).sum()
    got = torch.autograd.grad(y, (x, s, q, k))
    assert (RN.bwd_launches, FA.dq_launches, FA.dkv_launches) == \
        tuple(c + 1 for c in before)
    out, _ = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                               k.transpose(1, 2))
    y2 = ref.rmsnorm_ref(x, s).square().sum() + out.sum()
    for a, b in zip(got, torch.autograd.grad(y2, (x, s, q, k))):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_train_step_on_card_matches_cpu(cuda):
    """One loss and its grads on the card (kernels) against the CPU
    (plain versions), float32, same weights; then AdamW applied on each
    device to the same grads at a fixed LR."""
    from repro_torch.optim import optimizers as O
    cfg = ModelConfig(name="card-train", arch_type="dense", n_layers=2,
                      d_model=128, n_heads=2, n_kv_heads=1, head_dim=64,
                      d_ff=256, vocab_size=300, max_seq_len=64,
                      rope_theta=1e4)
    cpu = R.init_model(cfg, seed=0, dtype=torch.float32, device="cpu",
                       trainable=True)
    card = R.init_model(cfg, seed=0, dtype=torch.float32, device="cpu",
                        trainable=True).to(cuda)
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, 300, (2, 49))).long()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        b = {n: t.to(dev) for n, t in batch.items()}
        loss, _ = R.loss_fn(model, cfg, b, z_loss=1e-4, dtype=torch.float32)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[dev] = (float(loss.detach()), [g.cpu() for g in grads])
    assert abs(out["cpu"][0] - out["cuda"][0]) < 1e-4
    for a, b in zip(out["cpu"][1], out["cuda"][1]):
        assert float((a - b).abs().max()) <= 1e-3 * float(a.abs().max())
    params = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        opt = O.adamw()
        p = dict(model.named_parameters())
        grads = {n: g.to(dev) for n, g in zip(p, out["cpu"][1])}
        opt.update(grads, opt.init(p), p, torch.tensor(1e-3))
        params[dev] = [t.detach().cpu() for t in p.values()]
    for a, b in zip(params["cpu"], params["cuda"]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_rmsnorm_zero_rows_launches_nothing(cuda):
    before = RN.launches
    got = RN.rmsnorm_fwd(torch.zeros(0, 64, device=cuda),
                         torch.zeros(64, device=cuda))
    assert got.shape == (0, 64) and RN.launches == before


def test_wrappers_raise_on_unsupported(cuda):
    q = torch.zeros(1, 2, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_fwd(q, q, q)
    kv = torch.zeros(1, 2, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        PG.ragged_decode_attention(q[:, :, 0], kv, kv,
                                   torch.zeros(1, dtype=torch.int32,
                                               device=cuda))
    x = torch.zeros(2, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        RN.rmsnorm_fwd(x, torch.zeros(64, device=cuda))


def test_engine_on_card_matches_cpu(cuda):
    """The engine on the card (kernels) against the same engine on the
    CPU (plain versions), float32, head_dim 64 so the kernels take it."""
    cfg = ModelConfig(name="card-tiny", arch_type="dense", n_layers=2,
                      d_model=128, n_heads=2, n_kv_heads=1, head_dim=64,
                      d_ff=256, vocab_size=256, max_seq_len=64,
                      rope_theta=1e4)
    cpu = R.init_model(cfg, seed=0, dtype=torch.float32, device="cpu")
    card = R.init_model(cfg, seed=0, dtype=torch.float32,
                        device="cpu").to(cuda)
    rng = np.random.default_rng(6)
    reqs = [(rng.integers(0, 256, (s,)).astype(np.int32), n)
            for s, n in zip((3, 9, 17, 5, 12), (6, 4, 8, 10, 5))]
    outs = []
    for model in (cpu, card):
        eng = ServingEngine(cfg, model, dtype=torch.float32,
                            decode_slots=2, page_size=4, max_len=32)
        for p, n in reqs:
            eng.submit(GenerationRequest(prompt=p, max_new_tokens=n))
        outs.append({r.rid: r.tokens for r in eng.drain()})
    assert outs[0].keys() == outs[1].keys()
    for rid in outs[0]:
        np.testing.assert_array_equal(outs[0][rid], outs[1][rid])


def _ssd_inputs(cuda, B, S, H, P, N, dtype, seed, mamba_decay):
    """x, B, C as views of one (B, S, H·P + 2N) tensor, as the mixer
    hands them to the kernel.  ``mamba_decay``: mamba2-2.7b's init
    (A = -(1..H), dt around its log-spaced [1e-3, 1e-1]); else the
    reference's kernel tests' small decays."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    di = H * P
    xbc = torch.randn(B, S, di + 2 * N, generator=g, device=cuda).to(dtype)
    xh = xbc[..., :di].reshape(B, S, H, P)
    Bm, Cm = xbc[..., di:di + N], xbc[..., di + N:]
    if mamba_decay:
        lo, hi = torch.log(torch.tensor(1e-3)), torch.log(torch.tensor(1e-1))
        dt0 = torch.exp(torch.linspace(float(lo), float(hi), H,
                                       device=cuda))
        bias = dt0 + torch.log(-torch.expm1(-dt0))
        dt = torch.nn.functional.softplus(
            bias + 0.5 * torch.randn(B, S, H, generator=g, device=cuda))
        A = -torch.arange(1, H + 1, dtype=torch.float32, device=cuda)
    else:
        dt = torch.nn.functional.softplus(
            torch.randn(B, S, H, generator=g, device=cuda))
        A = -torch.exp(0.3 * torch.randn(H, generator=g, device=cuda))
    return xh, dt, A, Bm, Cm


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,P,N,Q", [
    (2, 96, 4, 32, 16, 32),     # tests/test_kernels.py::TestSSD
    (1, 128, 2, 64, 32, 64),
    (2, 100, 3, 16, 8, 32),     # ragged S
    (2, 64, 8, 64, 16, 32),     # the reduced mamba2
    (4, 2048, 8, 64, 16, 32),   # its heads at B=4, S=2048
])
def test_ssd_chunk_kernel(cuda, B, S, H, P, N, Q, dtype):
    xh, dt, A, Bm, Cm = _ssd_inputs(cuda, B, S, H, P, N, dtype, 8, False)
    got = SSD.ssd_chunk(xh, dt, A, Bm, Cm, Q)
    torch.cuda.synchronize()
    want = ref.ssd_chunk_ref(xh, dt, A, Bm, Cm, Q)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape
        _close(a, b, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,mamba_decay,Q", [
    (1, 2048, 80, True, 256),   # mamba2-2.7b's heads and decay
    (1, 1000, 80, True, 256),
    (1, 300, 5, False, 256),    # its head shapes, ragged, cum to ~-200
    (4, 2048, 80, True, 256),   # its training micro-batch
    (1, 600, 4, False, 512),    # a chunk longer than the bf16 mma kernel's
])
def test_ssd_chunk_kernel_at_full_chunk(cuda, B, S, H, mamba_decay, Q,
                                        dtype):
    """mamba2-2.7b's head shapes (P=64, N=128) over whole chunks, where
    |cum| grows to the hundreds or thousands: the kernel's error against
    a float64 evaluation of the plain version is at most twice the
    float32 plain version's."""
    xh, dt, A, Bm, Cm = _ssd_inputs(cuda, B, S, H, 64, 128, dtype, 9,
                                    mamba_decay)
    got = SSD.ssd_chunk(xh, dt, A, Bm, Cm, Q)
    torch.cuda.synchronize()
    plain = ref.ssd_chunk_ref(xh, dt, A, Bm, Cm, Q)
    exact = ref.ssd_chunk_ref(*(t.double() for t in (xh, dt, A, Bm, Cm)),
                              Q)
    for a, p, e in zip(got, plain, exact):
        assert torch.isfinite(a).all()
        err, perr = (float((t.double() - e).abs().max()) for t in (a, p))
        assert err <= 2 * perr + 1e-12, (err, perr)


def test_ssd_on_card_matches_plain_scan(cuda):
    """backend.ssd on CUDA tensors: the kernel forward (counted) within
    2e-5 of the plain scan, and grads equal to the plain scan's (the
    backward recomputes through it)."""
    xh, dt, A, Bm, Cm = _ssd_inputs(cuda, 2, 100, 3, 16, 8, torch.float32,
                                    10, False)
    D = torch.full((3,), 0.5, device=cuda)
    leaves = [t.detach().clone().requires_grad_()
              for t in (xh, dt, A, Bm, Cm, D)]
    before = SSD.launches
    y, h = KB.ssd(*leaves, chunk=32)
    assert SSD.launches == before + 1
    from repro_torch.models.mamba2 import ssd_chunked
    leaves2 = [t.detach().clone().requires_grad_()
               for t in (xh, dt, A, Bm, Cm, D)]
    wy, wh = ssd_chunked(*leaves2, chunk=32)
    _close(y, wy, torch.float32)
    _close(h, wh, torch.float32)
    gy = torch.randn_like(y)
    got = torch.autograd.grad((y * gy).sum() + h.sum(), leaves)
    want = torch.autograd.grad((wy * gy).sum() + wh.sum(), leaves2)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_mamba2_train_step_on_card_matches_cpu(cuda):
    """One reduced mamba2 loss and its grads on the card (kernels) against
    the CPU (plain versions), float32, same weights: loss within 1e-4,
    grads within 1e-3 of each tensor's largest |grad|; the chunk kernel
    runs twice per layer under remat."""
    from repro_torch.configs import get_config
    cfg = get_config("mamba2-2.7b").reduced()
    cpu = R.init_model(cfg, seed=0, dtype=torch.float32, device="cpu",
                       trainable=True)
    card = R.init_model(cfg, seed=0, dtype=torch.float32, device="cpu",
                        trainable=True).to(cuda)
    rng = np.random.default_rng(11)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 81))).long()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    before = SSD.launches
    for dev, model in (("cpu", cpu), ("cuda", card)):
        b = {n: t.to(dev) for n, t in batch.items()}
        loss, _ = R.loss_fn(model, cfg, b, z_loss=1e-4, dtype=torch.float32)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[dev] = (float(loss.detach()), [g.cpu() for g in grads])
    assert SSD.launches == before + 2 * cfg.n_layers
    assert abs(out["cpu"][0] - out["cuda"][0]) < 1e-4
    for a, b in zip(out["cpu"][1], out["cuda"][1]):
        assert float((a - b).abs().max()) <= 1e-3 * float(a.abs().max())


def test_mamba2_state_engine_on_card_matches_cpu(cuda, monkeypatch):
    """The reduced mamba2 served in the engine's state mode on the card
    (the chunk and RMSNorm kernels, graphs replayed after the first
    prefill and decode) against the same engine on the CPU (plain
    versions), float32, same weights: the same tokens, one prefill entry
    per prompt length, and on the card the kernels' launches exactly,
    ``ssd_chunk`` L a prefill and the RMSNorm forward 2L+1 a prefill and
    a decode step, with the plain versions never called."""
    from repro_torch.configs import get_config
    from repro_torch.models import mamba2 as M
    cfg = get_config("mamba2-2.7b").reduced()
    cpu = R.init_model(cfg, seed=3, dtype=torch.float32, device="cpu")
    card = R.init_model(cfg, seed=3, dtype=torch.float32,
                        device="cpu").to(cuda)
    rng = np.random.default_rng(12)
    sizes, news = (2, 40, 77, 40, 5, 100), (6, 4, 9, 5, 7, 3)
    reqs = [(rng.integers(0, cfg.vocab_size, (s,)).astype(np.int32), n)
            for s, n in zip(sizes, news)]
    outs, engines = [], []
    for model in (cpu, card):
        if model is card:
            def refuse(*a, **k):
                raise AssertionError("a plain version ran on the card")
            for mod, name in ((ref, "rmsnorm_ref"), (ref, "ssd_chunk_ref"),
                              (M, "ssd_chunked")):
                monkeypatch.setattr(mod, name, refuse)
            before = (SSD.launches, RN.launches)
        eng = ServingEngine(cfg, model, dtype=torch.float32,
                            decode_slots=2, max_len=128)
        for p, n in reqs:
            eng.submit(GenerationRequest(prompt=p, max_new_tokens=n))
        outs.append({r.rid: r.tokens.tolist() for r in eng.drain()})
        engines.append(eng)
    assert outs[0] == outs[1]
    eng = engines[1]
    L = cfg.n_layers
    assert (SSD.launches - before[0], RN.launches - before[1]) == \
        (L * len(sizes), (2 * L + 1) * (len(sizes) + eng.steps))
    assert eng.n_prefill_executables == len(set(sizes))
    assert eng.executables == eng.executable_budget
    # every prompt length but the first one's (eager), and the decode
    assert eng.captures == len(set(sizes))
    assert eng.pool.n_used == 0


# --------------------------------------------------------------------- #
# the kernel benchmark's overlap probe
# --------------------------------------------------------------------- #

OVERLAP_CASES = (
    # the benchmark's 8192 x 512 sweep; the configs over the card's
    # shared memory must raise
    [(8192, 512, b, k) for b in (1, 2, 4, 8, 16, 32) for k in (1, 2, 4, 8)]
    + [(64, 512, 16, 1), (64, 512, 4, 8),   # fewer row-blocks than SMs
       (4096, 256, 16, 4),      # deeper than the row-blocks of a block
       (4096, 256, 1, 2), (2048, 256, 4, 8),
       (8192, 512, 1, 16),      # deeper than the stores waited on
       (264, 1028, 2, 3), (1000, 4, 8, 2)])


@pytest.mark.parametrize("rows,d,block_rows,depth", OVERLAP_CASES)
def test_overlap_norm_kernel(cuda, rows, d, block_rows, depth):
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn(rows, d, generator=g, device=cuda)
    if OV.smem_bytes(block_rows, d, depth) > OV.smem_budget(cuda):
        with pytest.raises(ValueError, match="shared memory"):
            OV.overlap_norm(x, block_rows=block_rows, depth=depth)
        return
    before = OV.launches
    got = OV.overlap_norm(x, block_rows=block_rows, depth=depth)
    torch.cuda.synchronize()
    assert OV.launches == before + 1
    _close(got, ref.overlap_norm_ref(x), torch.float32)


def test_overlap_norm_raises_on_unsupported(cuda):
    x = torch.randn(512, 64, device=cuda)
    with pytest.raises(ValueError, match="multiple of block_rows"):
        OV.overlap_norm(x[:500], block_rows=64, depth=2)
    with pytest.raises(TypeError, match="float32"):
        OV.overlap_norm(x.bfloat16(), block_rows=64, depth=2)
    with pytest.raises(ValueError, match="contiguous"):
        OV.overlap_norm(x.t(), block_rows=16, depth=2)
    with pytest.raises(ValueError, match="16-byte"):
        OV.overlap_norm(x[:, :6].contiguous(), block_rows=64, depth=2)
    with pytest.raises(ValueError, match="shared memory"):
        OV.overlap_norm(x, block_rows=512, depth=2)
    with pytest.raises(ValueError, match="CUDA"):
        OV.overlap_norm(x.cpu(), block_rows=64, depth=2)


def test_bench_kernels_ci_on_card(cuda, tmp_path):
    """``python -m repro_torch.bench.kernels --ci`` through its main: every
    sweep row timed and within 2e-5 of the plain version, every overlap
    config within 2e-5 of the plain version, and the kernels of the path
    launched."""
    from repro_torch.bench import kernels as BK
    counts = (RN, "launches"), (RN, "bwd_launches"), (FA, "launches"), \
        (FA, "dq_launches"), (FA, "dkv_launches"), (SSD, "launches"), \
        (OV, "launches")
    before = [getattr(m, a) for m, a in counts]
    res = BK.main(["--ci", "--out", str(tmp_path / "bench.json")])
    assert all(getattr(m, a) > b for (m, a), b in zip(counts, before))
    for section in ("attention", "rmsnorm", "ssd"):
        assert len(res[section]) == 1
        row = res[section][0]
        for key in ("kernel_fwd_ms", "kernel_bwd_ms", "plain_fwd_ms",
                    "plain_bwd_ms"):
            assert np.isfinite(row[key])
        # outputs and grads within 2e-5 abs/rel of the plain version's
        assert max(row["fwd_err"], *row["grad_err"].values()) <= 2e-5, row
    ov = res["overlap"]
    assert len(ov["configs"]) == 8 and all("ms" in c for c in ov["configs"])
    assert max(c["max_err"] for c in ov["configs"]) <= 2e-5
    assert ov["bound_by"] == "bytes" and ov["library_ms"] > 0


# --------------------------------------------------------------------- #
# CUDA graphs: the engines' compile cache
# --------------------------------------------------------------------- #

GRAPH_CFG = ModelConfig(name="card-graphs", arch_type="dense", n_layers=2,
                        d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
                        d_ff=512, vocab_size=512, max_seq_len=128,
                        rope_theta=1e4)
GRAPH_SEQ = 64


def _graph_trainer(max_device_batch=4):
    """A bf16 AdamW trainer on the card at a constant LR after a short
    warmup (the graphs read the staged LR, so it must change)."""
    from repro_torch.configs import (OptimizerConfig, RunConfig,
                                     ScheduleConfig)
    from repro_torch.train.trainer import Trainer
    run = RunConfig(model=GRAPH_CFG,
                    schedule=ScheduleConfig(kind="constant", base_lr=3e-3,
                                            warmup_frac=0.5),
                    optimizer=OptimizerConfig(kind="adamw",
                                              weight_decay=0.1),
                    seq_len=GRAPH_SEQ, global_batch_size=4,
                    total_tokens=GRAPH_SEQ * 4 * 16, dtype="bfloat16")
    return Trainer(run, device="cuda", max_device_batch=max_device_batch)


def _stacked(cuda, k, B, seed):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, GRAPH_CFG.vocab_size,
                                         (k, B, GRAPH_SEQ + 1)))
    return {"tokens": toks[..., :-1].to(cuda),
            "labels": toks[..., 1:].to(cuda)}


def _clone_state(model, opt_state):
    import copy
    return copy.deepcopy(model), {
        k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict)
            else v.clone()) for k, v in opt_state.items()}


def _assert_same_state(a, b):
    (ma, oa), (mb, ob) = a, b
    for (n, p), q in zip(ma.named_parameters(), mb.parameters()):
        assert torch.equal(p, q), n
    assert oa.keys() == ob.keys()
    for k in oa:
        if isinstance(oa[k], dict):
            for n in oa[k]:
                assert torch.equal(oa[k][n], ob[k][n]), (k, n)
        else:
            assert torch.equal(oa[k], ob[k]), k


@pytest.mark.parametrize("micro", [1, 2])
def test_train_replay_equals_eager_step(cuda, micro):
    """From one cloned state, a replayed step and the eager step it was
    captured from give the same parameters, AdamW state (the step count
    included) and metrics, bit for bit, at the capture and at later
    replays (the count and the staged LR advance)."""
    tr = _graph_trainer()
    eng, st = tr.engine, tr.state
    B = 4 * micro
    eng.run_chunk(st.model, st.opt_state, 0, _stacked(cuda, 1, 4, 0),
                  step=0)                           # the eager first step
    assert eng.captures == 0
    tok, step = 4 * GRAPH_SEQ, 1
    for seed in (1, 2, 3):
        batch = _stacked(cuda, 1, B, seed)
        twin = _clone_state(st.model, st.opt_state)
        _, _, m = eng.run_chunk(st.model, st.opt_state, tok, batch,
                                step=step)
        ent = eng.step_for(B)
        assert ent.graph is not None and eng.captures == 1
        _, _, want = ent.grad(*twin, {k: v[0] for k, v in batch.items()},
                              m["lr"][0].to(cuda))
        torch.cuda.synchronize()
        _assert_same_state((st.model, st.opt_state), twin)
        for name, v in want.items():
            assert torch.equal(m[name][0], v), name
        tok, step = tok + B * GRAPH_SEQ, step + 1
    assert int(st.opt_state["count"]) == 4


def test_replay_counts_the_captured_launches(cuda):
    """A capture adds nothing to the launch counters; each replay adds
    what the eager step launches."""
    from repro_torch import graphs as G
    tr = _graph_trainer()
    eng, st = tr.engine, tr.state
    c0 = G.launch_counts()
    eng.run_chunk(st.model, st.opt_state, 0, _stacked(cuda, 1, 4, 0),
                  step=0)
    eager = tuple(b - a for a, b in zip(c0, G.launch_counts()))
    L = GRAPH_CFG.n_layers
    assert eager[:5] == (4 * L + 1, 2 * L + 1, 2 * L, L, L)
    deltas = []
    for i in range(3):
        c = G.launch_counts()
        eng.run_chunk(st.model, st.opt_state, 0, _stacked(cuda, 1, 4, i),
                      step=1 + i)
        deltas.append(tuple(b - a for a, b in zip(c, G.launch_counts())))
    assert eng.step_for(4).graph.launches == eager
    assert deltas == [eager] * 3


def test_n_valid_and_reset_capture_nothing_new(cuda):
    """A short chunk replays the key's graph and leaves its rows past
    n_valid zero; the serving engine's reset keeps its graphs."""
    tr = _graph_trainer()
    eng, st = tr.engine, tr.state
    eng.run_chunk(st.model, st.opt_state, 0, _stacked(cuda, 1, 4, 0),
                  step=0)
    for n in (3, 1, 2):
        _, _, m = eng.run_chunk(st.model, st.opt_state, 0,
                                _stacked(cuda, 3, 4, n), n_valid=n, step=1)
        assert eng.captures == 1 and len(eng._cache) == 1
        assert bool((m["loss"][n:] == 0).all())
        assert bool((m["loss"][:n] > 0).all())
    model = R.init_model(GRAPH_CFG, seed=0, dtype=torch.bfloat16,
                         device=cuda)
    srv = ServingEngine(GRAPH_CFG, model, dtype=torch.bfloat16,
                        decode_slots=3, page_size=16, max_len=96)
    rng = np.random.default_rng(3)
    for wave in range(2):
        for s in (5, 20, 40, 7):
            srv.submit(GenerationRequest(
                prompt=rng.integers(0, 512, (s,)).astype(np.int32),
                max_new_tokens=6))
        srv.drain()
        if wave == 0:
            seen = (srv.captures, srv.executables)
            srv.reset()
    assert (srv.captures, srv.executables) == seen
    assert srv.n_decode_executables == 1
    assert srv.executables <= srv.executable_budget


def _serving(cuda):
    model = R.init_model(GRAPH_CFG, seed=1, dtype=torch.bfloat16,
                         device=cuda)
    return model, ServingEngine(GRAPH_CFG, model, dtype=torch.bfloat16,
                                decode_slots=4, page_size=16, max_len=96)


def _graph_requests(seed=4):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 512, (s,)).astype(np.int32), n)
            for s, n in zip((9, 30, 17, 50, 3, 24), (12, 9, 20, 6, 15, 8))]


def test_decode_replay_equals_eager(cuda):
    """The decode graph's replay against the eager decode on a copy of the
    pool, from the same packed input: next tokens and pool bit for
    bit."""
    from repro_torch.serving import engine as SE
    model, eng = _serving(cuda)
    for p, n in _graph_requests():
        eng.submit(GenerationRequest(prompt=p, max_new_tokens=n))
    seen = []
    inputs = eng._decode_inputs
    eng._decode_inputs = lambda active: seen.append(inputs(active)) or \
        seen[-1]
    checked = 0
    while not eng.done:
        ent = eng._decode_fns.get(eng.decode_slots)
        if ent is None or ent.graph is None or eng.n_pending:
            eng.step()          # no graph yet, or a prefill comes first
            continue
        kv0 = eng.pool.kv.clone()
        eng.step()
        want = SE._decode_packed(model, GRAPH_CFG, kv0,
                                 torch.from_numpy(seen[-1]).to(cuda),
                                 slots=eng.decode_slots, page_size=16)
        torch.cuda.synchronize()
        assert torch.equal(ent.graph.out, want)
        assert torch.equal(eng.pool.kv, kv0)
        checked += 1
    assert checked >= 5 and eng.captures >= 2


def test_defrag_between_decode_replays_is_transparent(cuda):
    """Defrag writes the permuted pool back in place, so the decode graph
    captured before it reads the compacted pool: the same tokens as an
    engine that never defrags."""
    _, plain = _serving(cuda)
    _, defragged = _serving(cuda)
    for eng in (plain, defragged):
        for p, n in _graph_requests(5):
            eng.submit(GenerationRequest(prompt=p, max_new_tokens=n))
    kv = defragged.pool.kv
    while not plain.done:
        ev = plain.step()
        defragged.defrag()
        assert defragged.step() == ev
    assert defragged.pool.kv is kv
    assert defragged._decode_fns[4].graph is not None


def test_async_snapshot_and_in_place_restore_under_replays(cuda, tmp_path):
    """The async save's snapshot holds the state of its step while later
    replays update the live tensors in place (the writer reads it on a
    stream of its own); a restore into the trainer whose graph is
    captured copies in place, and its replays then give the bits of the
    steps that followed the save, with no capture."""
    tr = _graph_trainer()
    eng, st = tr.engine, tr.state
    eng.run_chunk(st.model, st.opt_state, 0, _stacked(cuda, 1, 4, 0),
                  step=0)                           # the eager first step
    eng.run_chunk(st.model, st.opt_state, 4 * GRAPH_SEQ,
                  _stacked(cuda, 1, 4, 1), step=1)  # capture and replay
    st.step, st.tokens_seen = 2, 2 * 4 * GRAPH_SEQ
    saved = _clone_state(st.model, st.opt_state)
    path = str(tmp_path / "ck")
    tr.save_checkpoint(path, block=False)

    def two_more():
        ms = []
        for i, seed in enumerate((2, 3)):
            _, _, m = eng.run_chunk(st.model, st.opt_state,
                                    (2 + i) * 4 * GRAPH_SEQ,
                                    _stacked(cuda, 1, 4, seed), step=2 + i)
            ms.append({k: v.clone() for k, v in m.items()})
        torch.cuda.synchronize()
        return ms

    want = two_more()
    after = _clone_state(st.model, st.opt_state)
    tr.close()
    captures = eng.captures
    meta = tr.restore_checkpoint(path, verify=True)
    assert (meta["step"], tr.state.step) == (2, 2)
    _assert_same_state((st.model, st.opt_state), saved)
    got = two_more()
    assert eng.captures == captures == 1
    _assert_same_state((st.model, st.opt_state), after)
    for a, b in zip(got, want):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_capture_while_an_async_save_streams(cuda, tmp_path):
    """A graph captured on the step loop's stream while the checkpoint
    writer copies on its own (here ~18k slices of 1 KiB) is not
    invalidated (the capture is thread-local), its replay equals the
    eager step, and the save commits."""
    tr = _graph_trainer()
    eng, st = tr.engine, tr.state
    eng.run_chunk(st.model, st.opt_state, 0, _stacked(cuda, 1, 4, 0),
                  step=0)                           # the eager first step
    st.step, st.tokens_seen = 1, 4 * GRAPH_SEQ
    tr._ckpt_manager = eng.make_checkpoint_manager(chunk_bytes=1024)
    path = str(tmp_path / "ck")
    tr.save_checkpoint(path, block=False)
    assert tr.checkpoint_manager.in_flight
    twin = _clone_state(st.model, st.opt_state)
    batch = _stacked(cuda, 1, 8, 1)
    _, _, m = eng.run_chunk(st.model, st.opt_state, 4 * GRAPH_SEQ, batch,
                            step=1)                 # B=8: a capture
    ent = eng.step_for(8)
    assert ent.graph is not None and eng.captures == 1
    _, _, want = ent.grad(*twin, {k: v[0] for k, v in batch.items()},
                          m["lr"][0].to(cuda))
    torch.cuda.synchronize()
    _assert_same_state((st.model, st.opt_state), twin)
    for name, v in want.items():
        assert torch.equal(m[name][0], v), name
    tr.close()
    from repro_torch.train import checkpoint as CKPT
    assert CKPT.read_meta(path)["step"] == 1


def test_background_capture_while_another_key_replays(cuda):
    """The next batch size's graph captured in a thread (the adaptive
    cut's prewarm) while the loop replays another key's: every replay
    equals the eager step bit for bit and adds exactly the eager step's
    launches, the capture adds none, and the prewarmed key's first chunk
    replays its graph (no capture of its own) equal to its eager step,
    with twice the launches (two micro-batches)."""
    import gc

    from repro_torch import graphs as G
    from repro_torch.kernels import _build
    tr = _graph_trainer(max_device_batch=4)
    eng, st = tr.engine, tr.state
    c0 = G.launch_counts()
    eng.run_chunk(st.model, st.opt_state, 0, _stacked(cuda, 1, 4, 0),
                  step=0)                           # the eager first step
    eager = tuple(b - a for a, b in zip(c0, G.launch_counts()))
    eng.run_chunk(st.model, st.opt_state, 0, _stacked(cuda, 1, 4, 1),
                  step=1)                           # B=4 captured inline
    assert eng.captures == 1
    t = eng.prewarm_async(8, 1, _stacked(cuda, 1, 4, 2))
    assert t is not None and eng.prewarm_async(8, 1, _stacked(
        cuda, 1, 4, 2)) is None                     # already warming
    # while a stream captures, CUDA refuses a device-wide sync
    # (torch.cuda.synchronize); the loop syncs its own stream only
    sync = torch.cuda.current_stream().synchronize
    during, step = 0, 2
    for seed in range(3, 40):
        alive = t.is_alive()
        batch = _stacked(cuda, 1, 4, seed)
        twin = _clone_state(st.model, st.opt_state)
        c = G.launch_counts()
        _, _, m = eng.run_chunk(st.model, st.opt_state, 0, batch,
                                step=step)
        sync()
        assert tuple(b - a for a, b in zip(c, G.launch_counts())) == eager
        _, _, want = eng._cache[(4, 1)].grad(
            *twin, {k: v[0] for k, v in batch.items()}, m["lr"][0].to(cuda))
        sync()
        _assert_same_state((st.model, st.opt_state), twin)
        for name, v in want.items():
            assert torch.equal(m[name][0], v), name
        during += alive and t.is_alive()
        step += 1
        if not t.is_alive() and during:
            break
    assert during > 0, "the capture ended before a replay overlapped it"
    batch = _stacked(cuda, 1, 8, 99)
    twin = _clone_state(st.model, st.opt_state)
    c = G.launch_counts()
    _, _, m = eng.run_chunk(st.model, st.opt_state, 0, batch, step=step)
    torch.cuda.synchronize()
    assert eng.captures == 2 and (8, 2) in eng.prewarm_wait_s
    ent = eng.step_for(8)
    assert ent.graph.launches == tuple(2 * x for x in eager)
    assert tuple(b - a for a, b in zip(c, G.launch_counts())) == \
        ent.graph.launches
    _, _, want = ent.grad(*twin, {k: v[0] for k, v in batch.items()},
                          m["lr"][0].to(cuda))
    torch.cuda.synchronize()
    _assert_same_state((st.model, st.opt_state), twin)
    for name, v in want.items():
        assert torch.equal(m[name][0], v), name
    assert gc.isenabled() and not _build._tallies


def test_failed_background_capture_raises_at_the_join(cuda):
    """A background capture that fails raises its error in the main
    thread where the key is next used; nothing falls back to the eager
    step, and the other key's graph goes on replaying."""
    import gc

    from repro_torch.kernels import _build
    tr = _graph_trainer(max_device_batch=4)
    eng, st = tr.engine, tr.state
    for i in range(2):
        eng.run_chunk(st.model, st.opt_state, 0, _stacked(cuda, 1, 4, i),
                      step=i)

    def broken(*a, **k):
        raise RuntimeError("capture failed: boom")

    eng.step_for(8).grad = broken
    t = eng.prewarm_async(8, 1, _stacked(cuda, 1, 4, 2))
    t.join(120)
    assert not t.is_alive()
    with pytest.raises(RuntimeError, match="boom"):
        eng.run_chunk(st.model, st.opt_state, 0, _stacked(cuda, 1, 8, 3),
                      step=2)
    assert eng.step_for(8).graph is None and eng.captures == 1
    _, _, m = eng.run_chunk(st.model, st.opt_state, 0,
                            _stacked(cuda, 1, 4, 4), step=2)
    assert bool(torch.isfinite(m["loss"]).all())
    assert gc.isenabled() and not _build._tallies


# --------------------------------------------------------------------- #
# the blocking Server over the full and ring caches
# --------------------------------------------------------------------- #

SERVER_CFG = dict(name="card-server", arch_type="dense", n_layers=2,
                  d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
                  d_ff=512, vocab_size=512, max_seq_len=4096,
                  rope_theta=1e4)


def _server_models(cuda, **kw):
    from repro_torch.train.serve import Server
    cfg = ModelConfig(**dict(SERVER_CFG, **kw))
    cpu = R.init_model(cfg, seed=3, dtype=torch.float32, device="cpu")
    card = R.init_model(cfg, seed=3, dtype=torch.float32,
                        device="cpu").to(cuda)
    return Server, cfg, cpu, card


def _generate(srv, toks, n):
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return srv.generate(toks, n)


@pytest.mark.parametrize("window", [None, 64])
def test_server_on_card_matches_cpu_and_its_eager_steps(cuda, window):
    """The Server on the card (a full cache, bucketed; or a ring of 64
    that the decode wraps) against the CPU's plain versions, float32:
    first-token logits within 1e-3, tokens equal; and a second batch
    through the captured decode graph equals an all-eager Server's."""
    Server, cfg, cpu, card = _server_models(cuda, sliding_window=window)
    rng = np.random.default_rng(21)
    batches = [(rng.integers(0, 512, (2, 60)), 20),
               (rng.integers(0, 512, (2, 75)), 12)]
    got = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        srv = Server(cfg, model, max_len=128, dtype=torch.float32)
        with torch.inference_mode():
            logits, _ = srv.prefill(torch.from_numpy(batches[0][0]).to(dev))
        got[dev] = (logits.cpu(), [_generate(srv, t, n) for t, n in batches])
    torch.testing.assert_close(got["cuda"][0], got["cpu"][0], atol=1e-3,
                               rtol=0)
    for a, b in zip(got["cuda"][1], got["cpu"][1]):
        np.testing.assert_array_equal(a, b)
    srv = Server(cfg, card, max_len=128, dtype=torch.float32)
    eager = Server(cfg, card, max_len=128, dtype=torch.float32)
    eager._warm = type("Never", (set,), {"add": lambda self, k: None})()
    for t, n in batches:
        np.testing.assert_array_equal(_generate(srv, t, n),
                                      _generate(eager, t, n))
    assert srv.captures == 1 and eager.captures == 0


def test_ring_prefill_and_decode_on_card_match_the_prefill(cuda):
    """A ring of 64: the prefill of p[:-k] then k decode steps against the
    prefill of p, within 1e-3 in float32, for S0 below, at and past the
    ring (the decode wraps it)."""
    _, cfg, _, card = _server_models(cuda, sliding_window=64)
    rng = np.random.default_rng(22)
    with torch.inference_mode():
        for S0, k in ((60, 10), (64, 5), (150, 8)):
            p = torch.from_numpy(rng.integers(0, 512, (2, S0 + k))).to(cuda)
            want, _ = R.prefill(card, cfg, p, cache_len_cap=4096)
            got, cache = R.prefill(card, cfg, p[:, :S0], cache_len_cap=4096)
            for i in range(S0, S0 + k):
                got, cache = R.decode_step(card, cfg, cache, p[:, i:i + 1])
            torch.testing.assert_close(got, want, atol=1e-3, rtol=0)


def test_engine_on_card_matches_solo_server(cuda):
    """The reference's oracle test on the card: ragged requests through
    the engine's 2 slots, each equal to its solo run through a Server
    sized to the engine's page window, float32."""
    Server, cfg, _, card = _server_models(cuda)
    eng = ServingEngine(cfg, card, decode_slots=2, page_size=16, max_len=96,
                        dtype=torch.float32)
    oracle = Server(cfg, card, max_len=eng.pages_per_slot * eng.page_size,
                    buckets=eng.buckets, dtype=torch.float32)
    rng = np.random.default_rng(23)
    reqs = [(rng.integers(0, 512, (s,)).astype(np.int32), n)
            for s, n in zip((3, 40, 17, 64, 9), (6, 12, 8, 20, 5))]
    for p, n in reqs:
        eng.submit(GenerationRequest(prompt=p, max_new_tokens=n))
    done = {r.rid: r.tokens for r in eng.drain()}
    for rid, (p, n) in enumerate(reqs):
        np.testing.assert_array_equal(done[rid], _generate(oracle, p[None],
                                                           n)[0])


# --------------------------------------------------------------------- #
# the RG-LRU scan kernels and the hybrid
# --------------------------------------------------------------------- #

def _scan_case(cuda, B, S, W, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    a = torch.rand(B, S, W, generator=g, device=cuda) * 0.95 + 0.04
    b = torch.randn(B, S, W, generator=g, device=cuda)
    h0 = torch.randn(B, W, generator=g, device=cuda)
    dhs = torch.randn(B, S, W, generator=g, device=cuda)
    dhl = torch.randn(B, W, generator=g, device=cuda)
    return a, b, h0, dhs, dhl


@pytest.mark.parametrize("B,S,W", [(2, 1, 32), (2, 77, 40), (1, 1030, 96),
                                   (4, 1024, 4096), (2, 2500, 4096)])
def test_rglru_scan_kernels(cuda, B, S, W):
    """The forward and the reverse sweep against the plain chunked scan
    and its written-out backward, with and without h0, dhs and dh_last:
    within 2e-5 of each output's max (float32, sums in another order:
    sequential FMAs against an associative scan)."""
    a, b, h0, dhs, dhl = _scan_case(cuda, B, S, W, S)
    for h in (None, h0):
        before = (RG.launches, RG.bwd_launches)
        hs, hl = RG.rglru_scan_fwd(a, b, h)
        torch.cuda.synchronize()
        whs, whl = ref.rglru_scan_ref(a, b, h)
        tol = 2e-5 * float(whs.abs().max())
        torch.testing.assert_close(hs, whs, atol=tol, rtol=0)
        torch.testing.assert_close(hl, whl, atol=tol, rtol=0)
        for d, dl in ((dhs, dhl), (dhs, None), (None, dhl)):
            got = RG.rglru_scan_bwd(a, hs, h, d, dl, h is not None)
            torch.cuda.synchronize()
            want = ref.rglru_scan_bwd_ref(a, whs, h, d, dl)
            for x, y in zip(got, want):
                if x is None:
                    assert h is None
                    continue
                torch.testing.assert_close(
                    x, y, atol=2e-5 * float(y.abs().max()), rtol=0)
        assert (RG.launches, RG.bwd_launches) == (before[0] + 1,
                                                  before[1] + 3)


def test_rglru_scan_raises_on_unsupported(cuda):
    a = torch.rand(2, 8, 4, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        RG.rglru_scan_fwd(a.double(), a.double())
    with pytest.raises(ValueError, match=r"\(2, 8, 4\)"):
        RG.rglru_scan_fwd(a, a[:, :4].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        RG.rglru_scan_fwd(a.transpose(0, 1), a.transpose(0, 1))


def test_rglru_scan_function_replays_in_a_graph(cuda):
    """``_RGLRUScan``'s forward and backward captured in one CUDA graph
    (graphs.Graph): a replay equals the eager call bit for bit, and the
    launch counters count through the replay."""
    from repro_torch import graphs as G
    a, b, h0, dhs, _ = _scan_case(cuda, 2, 300, 256, 5)
    leaves = [t.clone().requires_grad_() for t in (a, b, h0)]

    def step():
        hs, hl = RG.rglru_scan(*leaves)
        return torch.autograd.grad((hs * dhs).sum() + hl.sum(), leaves)

    want = [t.clone() for t in step()]
    graph = G.Graph(step, torch.cuda.graph_pool_handle())
    before = (RG.launches, RG.bwd_launches)
    got = graph.replay()
    torch.cuda.synchronize()
    assert (RG.launches, RG.bwd_launches) == (before[0] + 1, before[1] + 1)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def _hybrid_cfg():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("recurrentgemma-9b").reduced(),
                               n_layers=5)


def test_hybrid_train_step_on_card_matches_cpu(cuda):
    """The reduced recurrentgemma at 5 layers, float32: the loss within
    1e-4 of the CPU's and every grad within 1e-3 of its tensor's max;
    the scan kernel launched twice per recurrent layer (remat) and its
    backward once."""
    cfg = _hybrid_cfg()
    cpu = R.init_model(cfg, seed=4, dtype=torch.float32, device="cpu",
                       trainable=True)
    card = R.init_model(cfg, seed=4, dtype=torch.float32, device="cpu",
                        trainable=True).to(cuda)
    rng = np.random.default_rng(8)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 97))).long()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    before = (RG.launches, RG.bwd_launches)
    for dev, model in (("cpu", cpu), ("cuda", card)):
        b = {n: t.to(dev) for n, t in batch.items()}
        loss, _ = R.loss_fn(model, cfg, b, z_loss=1e-4, dtype=torch.float32)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[dev] = (float(loss.detach()), [g.cpu() for g in grads])
    assert (RG.launches, RG.bwd_launches) == (before[0] + 8, before[1] + 4)
    assert abs(out["cpu"][0] - out["cuda"][0]) < 1e-4
    for a, b in zip(out["cpu"][1], out["cuda"][1]):
        assert float((a - b).abs().max()) <= 1e-3 * float(a.abs().max())


def test_hybrid_server_on_card_matches_cpu(cuda):
    """The reduced recurrentgemma at 5 layers through the Server, float32:
    first-token logits within 1e-3 of the CPU's, tokens equal, for
    prompts of 1, 2 and 90 tokens (past the window of 64); then a second
    batch through the captured decode graph equals an all-eager
    Server's."""
    from repro_torch.train.serve import Server
    cfg = _hybrid_cfg()
    cpu = R.init_model(cfg, seed=6, dtype=torch.float32, device="cpu")
    card = R.init_model(cfg, seed=6, dtype=torch.float32,
                        device="cpu").to(cuda)
    rng = np.random.default_rng(24)
    batches = [(rng.integers(0, cfg.vocab_size, (2, S)), n)
               for S, n in ((90, 20), (1, 8), (2, 8))]
    got = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        srv = Server(cfg, model, max_len=128, dtype=torch.float32)
        with torch.inference_mode():
            logits, _ = srv.prefill(torch.from_numpy(batches[0][0]).to(dev))
        got[dev] = (logits.cpu(), [_generate(srv, t, n) for t, n in batches])
    torch.testing.assert_close(got["cuda"][0], got["cpu"][0], atol=1e-3,
                               rtol=0)
    for a, b in zip(got["cuda"][1], got["cpu"][1]):
        np.testing.assert_array_equal(a, b)
    srv = Server(cfg, card, max_len=128, dtype=torch.float32)
    eager = Server(cfg, card, max_len=128, dtype=torch.float32)
    eager._warm = type("Never", (set,), {"add": lambda self, k: None})()
    for t, n in batches[:1] * 2:
        np.testing.assert_array_equal(_generate(srv, t, n),
                                      _generate(eager, t, n))
    assert srv.captures == 1 and eager.captures == 0


# --------------------------------------------------------------------- #
# the enc-dec and the VLM prefix
# --------------------------------------------------------------------- #

def _frontend(cfg, B, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)


def test_encdec_train_step_on_card_matches_cpu(cuda):
    """The reduced seamless-m4t-medium (12 encoder layers), float32: the
    loss within 1e-4 of the CPU's and every grad within 1e-3 of its
    tensor's max; flash twice per decoder layer (remat), the encoder's
    and the cross-attention's bidirectional attention launching none."""
    from repro_torch.configs import get_config
    cfg = get_config("seamless-m4t-medium").reduced()
    cpu = R.init_model(cfg, seed=4, dtype=torch.float32, device="cpu",
                       trainable=True)
    card = R.init_model(cfg, seed=4, dtype=torch.float32, device="cpu",
                        trainable=True).to(cuda)
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 41))).long()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "src_emb": torch.from_numpy(_frontend(cfg, 2, 10))}
    out = {}
    before = FA.launches
    for dev, model in (("cpu", cpu), ("cuda", card)):
        b = {n: t.to(dev) for n, t in batch.items()}
        loss, _ = R.loss_fn(model, cfg, b, dtype=torch.float32)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[dev] = (float(loss.detach()), [g.cpu() for g in grads])
    assert FA.launches == before + 2 * cfg.n_layers
    assert abs(out["cpu"][0] - out["cuda"][0]) < 1e-4
    for a, b in zip(out["cpu"][1], out["cuda"][1]):
        assert float((a - b).abs().max()) <= 1e-3 * float(a.abs().max())


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-76b"])
def test_frontend_server_on_card_matches_cpu(cuda, arch):
    """The reduced seamless (source frames) and internvl (a patch prefix)
    through the Server, float32: first-token logits within 1e-3 of the
    CPU's, tokens equal; a second batch through the captured decode graph
    equals an all-eager Server's."""
    import warnings
    from repro_torch.configs import get_config
    from repro_torch.train.serve import Server
    cfg = get_config(arch).reduced()
    cpu = R.init_model(cfg, seed=6, dtype=torch.float32, device="cpu")
    card = R.init_model(cfg, seed=6, dtype=torch.float32,
                        device="cpu").to(cuda)
    rng = np.random.default_rng(25)
    toks, pre = rng.integers(0, cfg.vocab_size, (2, 11)), _frontend(cfg, 2, 26)

    def gen(srv):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return srv.generate(toks, 12, prefix_emb=pre)

    got = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        srv = Server(cfg, model, max_len=64, dtype=torch.float32)
        with torch.inference_mode():
            logits, _ = srv.prefill(torch.from_numpy(toks).to(dev), pre)
        got[dev] = (logits.cpu(), gen(srv))
    torch.testing.assert_close(got["cuda"][0], got["cpu"][0], atol=1e-3,
                               rtol=0)
    np.testing.assert_array_equal(got["cuda"][1], got["cpu"][1])
    srv = Server(cfg, card, max_len=64, dtype=torch.float32)
    eager = Server(cfg, card, max_len=64, dtype=torch.float32)
    eager._warm = type("Never", (set,), {"add": lambda self, k: None})()
    for _ in range(2):
        np.testing.assert_array_equal(gen(srv), gen(eager))
    assert srv.captures == 1 and eager.captures == 0


# --------------------------------------------------------------------- #
# the decode kernels of the cut caches
# --------------------------------------------------------------------- #

def _cut_case(cuda, dtype, B=16, H=24, Hkv=8, S=4096, hd=128):
    g = torch.Generator(device=cuda).manual_seed(30)
    q = torch.randn(B, H, hd, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, S, Hkv, hd, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, S, Hkv, hd, generator=g, device=cuda).to(dtype)
    lens = torch.randint(1, S - 1, (B,), generator=g, device=cuda)
    lens[:3] = torch.tensor([0, S - 1, 127])[:B]
    return q, k, v, lens.to(torch.int32)


def _blocks(t, M, dim, frames_major):
    """The M blocks of a cache (B, S, Hkv, hd) cut along ``dim`` (1 or 3),
    each as the rank holds it: contiguous (B, S', Hkv, hd'), or with
    ``frames_major`` the enc-dec's cross K/V layout (B, Hkv, S', hd')
    read through its (B, S', Hkv, hd') view."""
    n = t.shape[dim] // M
    store = t.transpose(1, 2) if frames_major else t
    sdim = {1: 2, 3: 3}[dim] if frames_major else dim
    return [store.narrow(sdim, i * n, n).contiguous().transpose(1, 2)
            if frames_major else store.narrow(sdim, i * n, n).contiguous()
            for i in range(M)]


def _check_head_dim_cut(cuda, q, k, v, lens, M, dtype, frames_major=False):
    """The head_dim cut's scores on each slice of q (a view of the whole
    q) against its K slice, softmax-P·V on the summed scores over each V
    slice, each against its plain version; the slices' outputs joined
    against the whole-head decode kernel."""
    hd, S = q.shape[-1], k.shape[1]
    w = hd // M
    valid = (torch.arange(S, device=cuda)[None, :]
             <= lens.long()[:, None])[:, None, :]
    ks, vs = (_blocks(t, M, 3, frames_major) for t in (k, v))
    parts = []
    for i in range(M):
        qs = q[..., i * w:(i + 1) * w]
        got = PG.decode_scores(qs, ks[i], lens)
        torch.cuda.synchronize()
        _close(torch.where(valid, got, 0.0),
               ref.decode_scores_ref(qs, ks[i], lens), dtype)
        parts.append(got)
    s = sum(parts)
    outs = []
    for i in range(M):
        got = PG.decode_softmax_pv(s, vs[i], lens, head_dim=hd)
        torch.cuda.synchronize()
        _close(got, ref.decode_softmax_pv_ref(s, vs[i], lens, hd), dtype)
        outs.append(got)
    whole = PG.ragged_decode_attention(q, k.transpose(1, 2),
                                       v.transpose(1, 2), lens)
    _close(torch.cat(outs, -1), whole, dtype)


def _check_sequence_cut(cuda, q, k, v, lens, M, dtype, frames_major=False):
    """The sequence cut's partial on each block of the keys against its
    plain version (m exact to float32's tolerance; l and acc relative to
    1 + the largest), the blocks merged in order against the whole-head
    decode kernel."""
    from repro_torch.models.attention import merge_decode_partials
    n = k.shape[1] // M
    ks, vs = (_blocks(t, M, 1, frames_major) for t in (k, v))
    parts = []
    for i in range(M):
        local = (lens - i * n).contiguous()
        got = PG.ragged_decode_partial(q, ks[i], vs[i], local)
        torch.cuda.synchronize()
        want = ref.decode_partial_ref(q, ks[i], vs[i], local)
        torch.testing.assert_close(got[..., 0], want[..., 0], **F32)
        scale = 1 + want[..., 1:].abs().amax(-1, keepdim=True)
        _close(got[..., 1:] / scale, want[..., 1:] / scale, dtype)
        parts.append(got)
    out = merge_decode_partials(torch.stack(parts)).to(dtype)
    whole = PG.ragged_decode_attention(q, k.transpose(1, 2),
                                       v.transpose(1, 2), lens)
    _close(out, whole, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M", [2, 4])
def test_head_dim_cut_decode_kernels(cuda, M, dtype):
    _check_head_dim_cut(cuda, *_cut_case(cuda, dtype), M, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M", [2, 4])
def test_sequence_cut_decode_partial(cuda, M, dtype):
    _check_sequence_cut(cuda, *_cut_case(cuda, dtype), M, dtype)


# the serving families' cut caches: recurrentgemma-9b's ring (MQA 16/1 at
# hd 256, 2,048 slots, full after the prompt wraps it) cut in 2 and 4,
# seamless-m4t-medium's cross K/V (MHA 16/16 at hd 64 over 1,024 frames,
# every frame valid, held frames-major) cut in 2, and starcoder2-3b's ring
# (GQA 24/2 at hd 128, 4,096 slots all valid) cut in 2
FAMILY_CUTS = {"ring": (dict(B=2, H=16, Hkv=1, S=2048, hd=256), (2, 4),
                        False),
               "cross": (dict(B=2, H=16, Hkv=16, S=1024, hd=64), (2,),
                         True),
               "ring_starcoder2": (dict(B=2, H=24, Hkv=2, S=4096, hd=128),
                                   (2,), False)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cache,M", [(c, m) for c, (_, ms, _) in
                                     FAMILY_CUTS.items() for m in ms])
def test_family_cut_decode_kernels(cuda, cache, M, dtype):
    shape, _, frames_major = FAMILY_CUTS[cache]
    q, k, v, _ = _cut_case(cuda, dtype, **shape)
    lens = torch.full((shape["B"],), shape["S"] - 1, dtype=torch.int32,
                      device=cuda)
    _check_head_dim_cut(cuda, q, k, v, lens, M, dtype, frames_major)
    _check_sequence_cut(cuda, q, k, v, lens, M, dtype, frames_major)


# the production meshes' model axis of 16: llama3.2-3b's head_dim 128 cut
# into slices of 8, granite-moe-1b-a400m's 64 into slices of 4 (4
# bfloat16 elements: 8-byte rows)
CUT16 = {"hd128": dict(B=8, H=24, Hkv=8, S=1024, hd=128),
         "hd64": dict(B=8, H=16, Hkv=8, S=1024, hd=64)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", sorted(CUT16))
def test_head_dim_cut_16_ways(cuda, shape, dtype):
    _check_head_dim_cut(cuda, *_cut_case(cuda, dtype, **CUT16[shape]), 16,
                        dtype)


# the query heads a KV head in the repo's configs: seamless and the seesaw
# presets 1, granite 2, llama3.2-3b 3, mistral-nemo and phi3.5-moe 4,
# yi-34b 7, internvl2-76b 8, starcoder2-3b 12, recurrentgemma-9b 16
CUT_GROUPS = (1, 2, 3, 4, 7, 8, 12, 16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("frames_major", [False, True])
@pytest.mark.parametrize("G", CUT_GROUPS)
def test_head_dim_cut_at_every_group(cuda, G, frames_major, dtype):
    """One block serves all G query heads of a KV head: hd 64 cut in 2
    (slices of 32: bf16 on the tensor cores) and in 8 (slices of 8: the
    CUDA cores), 2 KV heads, 300 keys (not a multiple of a tile)."""
    q, k, v, lens = _cut_case(cuda, dtype, B=3, H=2 * G, Hkv=2, S=300,
                              hd=64)
    for M in (2, 8):
        _check_head_dim_cut(cuda, q, k, v, lens, M, dtype, frames_major)


# (B, H, Hkv, Skv, hd): MQA 16/1 (tiles of 32 keys), GQA 24/8 (48 rows:
# tiles of 64); Skv a multiple of neither
TILE_EDGES = {"mqa": (6, 16, 1, 333, 128), "gqa": (6, 24, 8, 333, 64)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", sorted(TILE_EDGES))
def test_head_dim_cut_at_the_tile_edges(cuda, shape, dtype):
    """Lengths 0, tile − 2, tile − 1, tile (so tile − 1, tile and tile + 1
    keys), tile + 1 and Skv − 1, the tile the wrapper picks on this
    card; pass 2 spans several splits and merges them."""
    B, H, Hkv, S, hd = TILE_EDGES[shape]
    q, k, v, _ = _cut_case(cuda, dtype, B=B, H=H, Hkv=Hkv, S=S, hd=hd)
    tile, _ = PG.cut_tiles(B, Hkv, S, PG._sm_count(q.device))
    lens = torch.tensor([0, tile - 2, tile - 1, tile, tile + 1, S - 1],
                        dtype=torch.int32, device=cuda)
    for M in (2, 4):
        _check_head_dim_cut(cuda, q, k, v, lens, M, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_scores_past_a_length_are_left_untouched(cuda, dtype, monkeypatch):
    """Pass 1 writes keys 0..lengths[b] only: its output, filled with NaN
    before the launch, still holds NaN past each length."""
    B, H, Hkv, S, hd = TILE_EDGES["gqa"]
    q, k, _, _ = _cut_case(cuda, dtype, B=B, H=H, Hkv=Hkv, S=S, hd=hd)
    lens = torch.tensor([0, 30, 31, 64, 200, S - 1], dtype=torch.int32,
                        device=cuda)
    empty = torch.empty

    def nan_empty(*size, **kw):
        t = empty(*size, **kw)
        return t.fill_(float("nan")) if t.is_floating_point() else t

    monkeypatch.setattr(torch, "empty", nan_empty)
    for w in (32, 8):
        s = PG.decode_scores(q[..., :w], k[..., :w].contiguous(), lens)
        torch.cuda.synchronize()
        valid = (torch.arange(S, device=cuda)[None, :]
                 <= lens.long()[:, None])[:, None, :].expand_as(s)
        assert torch.isfinite(s[valid]).all()
        assert torch.isnan(s[~valid]).all()


def test_bf16_cut_scores_run_on_tensor_cores(sass):
    """The bfloat16 scores pass at slices of 16-128 holds mma.sync (HMMA
    in the SASS); at slices of 8 and 4, and in float32, none.  Neither
    pass spills in bfloat16 at slices of 128 (16 query heads a block)."""
    lib = sass.build()
    hmma = sass.sass_counts(lib, "HMMA")
    bf16 = {int(m.group(1)): c for n, c in hmma.items()
            if (m := re.search(r"cut_scores_kernelI13__nv_bfloat16Li(\d+)E",
                               n))}
    f32 = {int(m.group(1)): c for n, c in hmma.items()
           if (m := re.search(r"cut_scores_kernelIfLi(\d+)E", n))}
    assert sorted(bf16) == sorted(f32) == [4, 8, 16, 32, 64, 128], \
        sorted(hmma)
    assert all(bf16[hd] > 0 for hd in (16, 32, 64, 128)), bf16
    assert bf16[4] == bf16[8] == 0 and not any(f32.values()), (bf16, f32)
    report = sass.ptxas_report(lib)
    for kern in ("cut_scores_kernel", "cut_softmax_pv_kernel"):
        name = next(n for n in report
                    if f"{kern}I13__nv_bfloat16Li128E" in n)
        r = report[name]
        assert r["spill_stores"] == 0 and r["spill_loads"] == 0, (kern, r)


def test_cut_cache_kernels_raise_rather_than_fall_back(cuda):
    q, k, v, lens = _cut_case(cuda, torch.float32, B=4, S=256)
    with pytest.raises(ValueError, match="head_dim slice"):
        PG.decode_scores(q[..., :48], k[..., :48].contiguous(), lens)
    with pytest.raises(ValueError, match="int32"):
        PG.ragged_decode_partial(q, k, v, lens.long())
    with pytest.raises(ValueError, match="scores"):
        PG.decode_softmax_pv(torch.zeros(4, 24, 255, device=cuda),
                             v[..., :64].contiguous(), lens, head_dim=128)


# two gloo ranks sharing the card: the cut residual's reduce-scatter
# (parallel._SeqScatter) forward and backward on CUDA tensors, each
# rank's part and grad written for the test to hold to a float64 sum
SEQ_SCATTER_RANK = r'''
import sys
import torch
from repro_torch import parallel
from repro_torch.launch import mesh as M
from repro_torch.launch.train import maybe_init_distributed
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
assert maybe_init_distributed(f"127.0.0.1:{port}", 2, rank, device="cuda")
tp = parallel.TensorParallel(M.make_launch_mesh("1x2", distributed=True),
                             rank)
res = {}
for dtype in (torch.float32, torch.bfloat16):
    g = torch.Generator().manual_seed(100 + rank)
    x = torch.randn(3, 64, 40, generator=g).to(dtype).cuda()
    x.requires_grad_(True)
    y = tp.seq_scatter(x)
    gy = torch.randn(y.shape, generator=torch.Generator().manual_seed(
        7 + rank)).to(dtype).cuda()
    (gx,) = torch.autograd.grad(y, x, gy)
    res[str(dtype)] = {"x": x.detach().cpu(), "y": y.detach().cpu(),
                       "gy": gy.cpu(), "gx": gx.cpu(), "dev": y.device.type}
res["comms"] = tp.comms.summary()
torch.save(res, out)
torch.distributed.destroy_process_group()
'''


def test_seq_scatter_on_the_card(cuda, tmp_path):
    """Forward: each rank's S/M rows of the float32 sum of the two ranks'
    partials (cast back), against a float64 sum (float32 within 1e-6,
    bf16 within one rounding); backward: the grad all-gathered along S,
    both ranks' grads in rank order, exactly."""
    import os
    import socket
    import subprocess
    import sys
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    outs = [str(tmp_path / f"r{r}.pt") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", SEQ_SCATTER_RANK,
                               str(r), port, outs[r]], cwd=root, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        o, e = p.communicate(timeout=300)
        assert p.returncode == 0, e[-3000:]
    recs = [torch.load(o) for o in outs]
    for dtype in (torch.float32, torch.bfloat16):
        a, b = (r[str(dtype)] for r in recs)
        assert a["dev"] == "cuda"
        whole = a["x"].double() + b["x"].double()
        for r, rec in enumerate((a, b)):
            want = whole[:, 32 * r:32 * (r + 1)]
            tol = 1e-6 if dtype == torch.float32 else 8e-3
            err = float((rec["y"].double() - want).abs().max())
            assert err <= tol * float(want.abs().max()), (dtype, r, err)
            assert torch.equal(rec["gx"], torch.cat([a["gy"], b["gy"]], 1))
    c = recs[0]["comms"]
    assert c["model_reduce_scatter"]["calls"] == 2
    assert c["model_all_gather"]["calls"] == 2
