"""The rounding of the bfloat16 tensor-core flash kernels, on the CPU.

``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` run their bfloat16
forms on the tensor cores: bf16 inputs, float32 products and sums, and
the probabilities P (forward), dS (dq), Pᵀ and dSᵀ (dk/dv) rounded to
bf16 before the second product of each pair.  That rounding is the one arithmetic
difference from the float32 plain versions, and the kernels run only on
the card; so here plain torch repeats what the kernels compute (the
forward tile by tile, 64 keys at a time, with its online softmax) and is
held to the plain versions ``ref.attention_ref`` / ``ref.flash_bwd_ref``
at the bf16 tolerance of ``docs/kernels.md`` (2e-2 abs/rel) at the main
paths' shapes, and to the JAX reference's Pallas kernels (interpret
mode) at a small shape.  ``tests/test_torch_card.py`` holds the kernels
themselves to the plain versions on the card.

Also the build module's readers of what was compiled (ptxas's registers
and spills, instruction counts of ``cuobjdump -sass``), on fake reports.
"""
import math
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import _flash_bwd, _flash_fwd
from repro_torch.kernels import _build
from repro_torch.kernels import ref


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these small models run many small ops, which
    the thread pools of several test workers on a shared CPU slow down
    many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BF16 = dict(atol=2e-2, rtol=2e-2)
KEYS = 64               # keys per tile of the forward kernel


def mma_flash_fwd(q, k, v):
    """What ``flash_fwd_mma_kernel`` computes: q (B, H, S, hd), k, v (B,
    Hkv, S, hd) bf16 -> (out bf16, lse (B·H, S) float32).  Scores are
    float32 sums of bf16 products; the online softmax runs over 64-key
    tiles in float32; each tile's P is rounded to bf16 before P·V; l
    sums the unrounded P."""
    B, H, S, hd = q.shape
    G = H // k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    q32 = q.float()
    k32 = k.float().repeat_interleave(G, dim=1)
    v32 = v.float().repeat_interleave(G, dim=1)
    qpos = torch.arange(S)[:, None]
    m = torch.full((B, H, S), ref.NEG_INF)
    l = torch.zeros(B, H, S)
    o = torch.zeros(B, H, S, hd)
    for k0 in range(0, S, KEYS):
        kt = slice(k0, min(k0 + KEYS, S))
        s = q32 @ k32[:, :, kt].transpose(-1, -2)
        s = s.masked_fill(torch.arange(k0, kt.stop)[None, :] > qpos,
                          ref.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp((m - m_new) * scale)
        p = torch.exp((s - m_new[..., None]) * scale)
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + p.bfloat16().float() @ v32[:, :, kt]
        m = m_new
    l = l.clamp_min(1e-30)
    return ((o / l[..., None]).to(q.dtype),
            (m * scale + torch.log(l)).reshape(B * H, S))


def mma_flash_bwd_dkv(q, k, v, out, lse, do):
    """What ``flash_bwd_dkv_mma_kernel`` computes, per kv head: Sᵀ and dPᵀ
    as float32 sums of bf16 products, Pᵀ = exp(Sᵀ·scale − lse) masked to
    kpos ≤ qpos, dSᵀ = Pᵀ(dPᵀ − delta)·scale, both rounded to bf16 before
    dV = Pᵀ·dO and dK = dSᵀ·Q, the group summed in float32.  Returns
    (dk, dv) bf16 (B, Hkv, S, hd)."""
    B, H, S, hd = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    delta = (do.float() * out.float()).sum(-1)
    lse = lse.reshape(B, H, S)
    mask = torch.ones(S, S, dtype=torch.bool).tril()      # [q, key]
    dk = torch.zeros(B, Hkv, S, hd)
    dv = torch.zeros(B, Hkv, S, hd)
    for hk in range(Hkv):
        hs = slice(hk * G, (hk + 1) * G)
        q32, do32 = q[:, hs].float(), do[:, hs].float()
        k32, v32 = k[:, hk:hk + 1].float(), v[:, hk:hk + 1].float()
        s = q32 @ k32.transpose(-1, -2)                    # (B, G, q, key)
        p = torch.exp(s * scale - lse[:, hs, :, None]).masked_fill(~mask,
                                                                   0.0)
        dp = do32 @ v32.transpose(-1, -2)
        ds = p * (dp - delta[:, hs, :, None]) * scale
        dv[:, hk] = (p.bfloat16().float().transpose(-1, -2) @ do32).sum(1)
        dk[:, hk] = (ds.bfloat16().float().transpose(-1, -2) @ q32).sum(1)
    return dk.to(k.dtype), dv.to(v.dtype)


def mma_flash_bwd_dq(q, k, v, out, lse, do):
    """What ``flash_bwd_dq_mma_kernel`` computes: S and dP as float32 sums
    of bf16 products, P = exp(S·scale − lse) masked to kpos ≤ qpos,
    dS = P(dP − delta)·scale rounded to bf16 before dQ = dS·K, summed in
    float32.  Query head h reads kv head h // (H / Hkv).  Returns dq bf16
    (B, H, S, hd)."""
    B, H, S, hd = q.shape
    G = H // k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    k32 = k.float().repeat_interleave(G, dim=1)
    v32 = v.float().repeat_interleave(G, dim=1)
    mask = torch.ones(S, S, dtype=torch.bool).tril()      # [q, key]
    s = q.float() @ k32.transpose(-1, -2)
    p = torch.exp(s * scale - lse.reshape(B, H, S, 1)).masked_fill(~mask,
                                                                   0.0)
    ds = p * (do.float() @ v32.transpose(-1, -2) - delta) * scale
    return (ds.bfloat16().float() @ k32).to(q.dtype)


def _inputs(B, H, Hkv, S, hd, seed):
    """q, k, v, do (B, heads, S, hd) in bf16, from numpy normals."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((B, n, S, hd))
                                  .astype(np.float32)).bfloat16()
                 for n in (H, Hkv, Hkv, H))


def _close(got, want):
    torch.testing.assert_close(got.float(), want.float(), **BF16)


# the serving prefill's and training's heads (seesaw-150m), and
# llama3.2-3b's GQA heads with a ragged S
MAIN_SHAPES = [(1, 16, 16, 1024, 64), (1, 24, 8, 1000, 128)]
# lengths that start, fill, cross and overrun the kernels' tiles
EDGE_SHAPES = ([(2, 4, 4, S, 64) for S in (1, 15, 16, 63, 64, 65, 129)]
               + [(1, 6, 2, S, 128) for S in (1, 15, 16, 63, 64, 65, 129)])


@pytest.mark.parametrize("B,H,Hkv,S,hd", MAIN_SHAPES + EDGE_SHAPES)
def test_mma_forward_rounding_within_bf16_tolerance(B, H, Hkv, S, hd):
    q, k, v, _ = _inputs(B, H, Hkv, S, hd, seed=S)
    out, lse = mma_flash_fwd(q, k, v)
    want, want_lse = ref.attention_ref(q, k, v)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _close(out, want)
    _close(lse, want_lse)


@pytest.mark.parametrize("B,H,Hkv,S,hd", MAIN_SHAPES + EDGE_SHAPES)
def test_mma_dkv_rounding_within_bf16_tolerance(B, H, Hkv, S, hd):
    """dk and dv with P and dS rounded, against the float32 plain backward
    on the same out and lse (the forward's, as on the card)."""
    q, k, v, do = _inputs(B, H, Hkv, S, hd, seed=S + 1)
    out, lse = mma_flash_fwd(q, k, v)
    dk, dv = mma_flash_bwd_dkv(q, k, v, out, lse, do)
    _, want_dk, want_dv = ref.flash_bwd_ref(q, k, v, out, lse, do)
    _close(dk, want_dk)
    _close(dv, want_dv)


@pytest.mark.parametrize("B,H,Hkv,S,hd", MAIN_SHAPES + EDGE_SHAPES)
def test_mma_dq_rounding_within_bf16_tolerance(B, H, Hkv, S, hd):
    """dq with dS rounded, against the float32 plain backward on the same
    out and lse (the forward's, as on the card)."""
    q, k, v, do = _inputs(B, H, Hkv, S, hd, seed=S + 2)
    out, lse = mma_flash_fwd(q, k, v)
    dq = mma_flash_bwd_dq(q, k, v, out, lse, do)
    want_dq, _, _ = ref.flash_bwd_ref(q, k, v, out, lse, do)
    assert dq.dtype == torch.bfloat16
    _close(dq, want_dq)


@pytest.mark.parametrize("B,H,Hkv,S,hd,blk", [
    (1, 4, 4, 48, 64, 16),      # MHA at hd 64
    (2, 6, 2, 37, 128, 16),     # GQA groups of 3 at hd 128, ragged S
])
def test_mma_rounding_matches_jax_flash(B, H, Hkv, S, hd, blk):
    """The emulated kernels against the reference's Pallas flash forward
    and backward (interpret mode) on the same bf16 values."""
    q, k, v, do = _inputs(B, H, Hkv, S, hd, seed=7)
    # the reference's kernels need S a block multiple: zero-pad (padded
    # keys sit above every real query's causal reach) and slice
    Sp = -(-S // blk) * blk
    pad = ((0, 0), (0, 0), (0, Sp - S), (0, 0))
    jq, jk, jv, jdo = (jnp.asarray(np.pad(t.float().numpy(), pad))
                       for t in (q, k, v, do))
    jo, jlse = _flash_fwd(jq, jk, jv, causal=True, block_q=blk,
                          block_k=blk, interpret=True)
    jdq, jdk, jdv = _flash_bwd(jq, jk, jv, jo, jlse, jdo, causal=True,
                               block_q=blk, block_k=blk, interpret=True)
    out, lse = mma_flash_fwd(q, k, v)
    _close(out, torch.tensor(np.asarray(jo)[:, :, :S]))
    _close(lse, torch.tensor(np.asarray(jlse)[:, :S]))
    dq = mma_flash_bwd_dq(q, k, v, out, lse, do)
    _close(dq, torch.tensor(np.asarray(jdq)[:, :, :S]))
    dk, dv = mma_flash_bwd_dkv(q, k, v, out, lse, do)
    _close(dk, torch.tensor(np.asarray(jdk)[:, :, :S]))
    _close(dv, torch.tensor(np.asarray(jdv)[:, :, :S]))


# --------------------------------------------------------------------- #
# what the build compiled: ptxas's report and the SASS
# --------------------------------------------------------------------- #

PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Function properties for _Z6helperv
    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_Z3barPf' for 'sm_90a'
ptxas info    : Function properties for _Z3barPf
    24 bytes stack frame, 24 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 400 bytes cmem[0]
"""

SASS = """\
Fatbin elf code:
================
arch = sm_90a

\tcode for sm_90a
\t\tFunction : _Z3fooPf
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   HMMA.16816.F32.BF16 R24, R4, R8, R24 ;
        /*0020*/              @P0  HMMA.16816.F32.BF16 R28, R4, R10, R28 ;
        /*0030*/                   EXIT ;
\t\tFunction : _Z3barPf
        /*0000*/                   FFMA R1, R2, R3, R1 ;
        /*0010*/                   EXIT ;
"""


def test_ptxas_report_reads_registers_and_spills(tmp_path):
    lib = tmp_path / "librepro_kernels-x.so"
    lib.with_suffix(".ptxas.txt").write_text(PTXAS)
    assert _build.ptxas_report(lib) == {
        "_Z3fooPf": {"registers": 168, "spill_stores": 0, "spill_loads": 0},
        "_Z3barPf": {"registers": 255, "spill_stores": 24,
                     "spill_loads": 16}}


def test_sass_counts_counts_an_opcode_per_kernel(tmp_path, monkeypatch):
    listing = tmp_path / "sass.txt"
    listing.write_text(SASS)
    tool = tmp_path / "cuobjdump"
    tool.write_text(f"#!/bin/sh\ncat '{listing}'\n")
    tool.chmod(tool.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "cuobjdump", lambda: str(tool))
    lib = tmp_path / "lib.so"
    assert _build.sass_counts(lib, "HMMA") == {"_Z3fooPf": 2, "_Z3barPf": 0}
    assert _build.sass_counts(lib, "FFMA") == {"_Z3fooPf": 0, "_Z3barPf": 1}
    monkeypatch.setattr(_build, "cuobjdump", lambda: None)
    with pytest.raises(RuntimeError, match="cuobjdump"):
        _build.sass_counts(lib, "HMMA")
