"""The rounding of the bfloat16 tensor-core SSD chunk kernel, on the CPU.

``csrc/ssd_chunk.cu`` runs its bfloat16 form (chunks up to 256) on the
tensor cores: cum scanned in float64 and held as float32 pairs hi + lo
of cum·log2(e), C·Bᵀ as float32 sums of the exact products of the bf16
inputs, M = C·Bᵀ·2^((hi_i − hi_j) + (lo_i − lo_j))·dt_j formed in
float32 and split into ``TERMS`` bf16 terms (hi = bf16(M), mid =
bf16(M − hi), lo = bf16(M − hi − mid)) before M·x, and the state's
weighted operand B·w, w_j = exp(T − cum_j)·dt_j, split the same way
before (B·w)ᵀ·x; x is exact in bf16.  The products' sums run in
float32, restarted for every 64-step j tile and added into float32
totals.  The kernel runs only on the card, so here plain torch repeats
that arithmetic and is held:

- at mamba2-2.7b's decay and chunk, at the card's gate shape (B=4,
  S=2048, H=80, P=64, N=128, Q=256), and at small decays over a whole
  chunk (``tests/test_torch_card.py``'s (S=300, H=5) case, 8 draws), to
  the gate of ``chip_smoke.py``'s phase 1c and of those card tests: its
  error against a float64 evaluation of the plain version at most 1.5×
  the float32 plain version's (the card's gate is 2×; the margin is for
  the tensor cores' own rounding of the float32 sums).  ``TERMS`` is the
  fewest that holds it: a single bf16 rounding misses it by far at
  2.7B, which is why M and B·w are split at all, and two terms miss it
  at small decays;
- to the plain version ``ref.ssd_chunk_ref`` at small decays, within
  the bf16 tolerance of ``docs/kernels.md`` (2e-2);
- to the JAX reference's Pallas kernel (interpret mode) on bf16-valued
  inputs, within 1e-4: the split's ~2⁻¹⁷ relative rounding and float32
  sums in another order.

``tests/test_torch_card.py`` holds the kernel itself to the plain
version on the card.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ssd_chunk as j_ssd_chunk
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


TERMS = 3               # bf16 terms of M and of B·w in the kernel
TILE = 64               # steps of a j tile: the float32 sums restart
GATE = 1.5              # emulated error / plain float32 error, at most
BF16 = dict(atol=2e-2, rtol=2e-2)
LOG2E = 1.4426950408889634


def split_bf16(v: torch.Tensor, terms: int):
    """float32 v as ``terms`` bf16 values (held in float32) whose sum
    approaches v: each term the bf16 rounding of what the earlier ones
    left."""
    out = []
    for _ in range(terms):
        t = v.bfloat16().float()
        out.append(t)
        v = v - t
    return out


def _tiled_sum(a, b, terms):
    """Σ over j of a[..., i, j]·b[..., j, p], a split into bf16 terms,
    the float32 sums restarted every TILE steps of j and added in
    order."""
    out = 0.0
    for j0 in range(0, a.shape[-1], TILE):
        js = slice(j0, j0 + TILE)
        part = sum(t[..., js] @ b[..., js, :] for t in split_bf16(a, terms))
        out = out + part
    return out


def mma_ssd_chunk(xh, dt, A, Bm, Cm, chunk: int, terms: int = TERMS):
    """What ``ssd_chunk_mma_kernel`` computes, with ``ref.ssd_chunk_ref``'s
    arguments and outputs (xh, Bm, Cm bf16-valued)."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = chunk
    nc = -(-S // Q)
    pad = nc * Q - S
    x = torch.nn.functional.pad(xh.float(), (0, 0, 0, 0, 0, pad))
    d = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad))
    Bp = torch.nn.functional.pad(Bm.float(), (0, 0, 0, pad))
    Cp = torch.nn.functional.pad(Cm.float(), (0, 0, 0, pad))
    xc = x.reshape(Bsz, nc, Q, H, P).movedim(3, 2)            # (B,nc,H,Q,P)
    dc = d.reshape(Bsz, nc, Q, H).movedim(3, 2)               # (B,nc,H,Q)
    Bc, Cc = Bp.reshape(Bsz, nc, Q, N), Cp.reshape(Bsz, nc, Q, N)
    cum = torch.cumsum(dc.double() * A.double()[:, None], dim=-1)
    T = cum[..., -1]
    CB = (Cc @ Bc.transpose(-1, -2))[:, :, None]              # (B,nc,1,Q,Q)
    above = torch.ones(Q, Q, dtype=torch.bool).triu(1)
    c2 = cum * LOG2E
    hi = c2.float()
    lo = (c2 - hi.double()).float()
    e2 = ((hi[..., :, None] - hi[..., None, :])
          + (lo[..., :, None] - lo[..., None, :]))
    decay = torch.exp2(e2.masked_fill(above, -math.inf))
    M = CB * decay * dc[..., None, :]
    y = _tiled_sum(M, xc, terms)                              # (B,nc,H,Q,P)
    w = torch.exp((T[..., None] - cum).float()) * dc          # (B,nc,H,Q)
    Bw = Bc[:, :, None] * w[..., None]                        # (B,nc,H,Q,N)
    states = _tiled_sum(Bw.transpose(-1, -2), xc, terms)      # (B,nc,H,N,P)
    y = y.movedim(2, 3).reshape(Bsz, nc * Q, H, P)[:, :S]
    return y, states, T.float()


def _mamba_inputs(B, S, H, P, N, seed):
    """chip_smoke.py's phase-1c recipe in numpy: x, B and C bf16 from one
    (B, S, H·P + 2N) draw, mamba2-2.7b's init decay (A = −(1..H), dt =
    softplus around its log-spaced [1e-3, 1e-1])."""
    rng = np.random.default_rng(seed)
    di = H * P
    xbc = torch.from_numpy(rng.standard_normal((B, S, di + 2 * N))
                           .astype(np.float32)).bfloat16().float()
    xh = xbc[..., :di].reshape(B, S, H, P)
    Bm, Cm = xbc[..., di:di + N], xbc[..., di + N:]
    dt0 = np.exp(np.linspace(np.log(1e-3), np.log(1e-1), H))
    z = dt0 + np.log(-np.expm1(-dt0)) + 0.5 * rng.standard_normal((B, S, H))
    dt = torch.from_numpy(np.log1p(np.exp(z)).astype(np.float32))
    A = -torch.arange(1, H + 1, dtype=torch.float32)
    return xh, dt, A, Bm, Cm


def _small_inputs(B, S, H, P, N, seed):
    """``tests/test_torch_card.py``'s small decays in numpy: x, B and C
    bf16 from one (B, S, H·P + 2N) draw, dt = softplus(noise), A =
    −exp(0.3·noise)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    di = H * P
    xbc = torch.from_numpy(rng.standard_normal((B, S, di + 2 * N))
                           .astype(f)).bfloat16().float()
    xh = xbc[..., :di].reshape(B, S, H, P)
    Bm, Cm = xbc[..., di:di + N], xbc[..., di + N:]
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal((B, S, H))))
                          .astype(f))
    A = torch.from_numpy((-np.exp(0.3 * rng.standard_normal(H))).astype(f))
    return xh, dt, A, Bm, Cm


def _gate_ratios(inputs, heads_at_once):
    """Per output, the largest error against a float64 evaluation of the
    plain version, over the float32 plain version's, of the emulation
    with 1, 2 and TERMS terms; a few heads at a time, to bound memory."""
    xh, dt, A, Bm, Cm = inputs
    errs = {}
    for h0 in range(0, xh.shape[2], heads_at_once):
        hs = slice(h0, h0 + heads_at_once)
        args = (xh[:, :, hs], dt[:, :, hs], A[hs], Bm, Cm)
        exact = ref.ssd_chunk_ref(*(a.double() for a in args), 256)
        runs = {"plain": ref.ssd_chunk_ref(*args, 256)}
        for terms in sorted({1, 2, TERMS}):
            runs[terms] = mma_ssd_chunk(*args, 256, terms)
        for key, outs in runs.items():
            for name, o, e in zip(("y_intra", "states", "T"), outs, exact):
                err = float((o.double() - e).abs().max())
                errs[key, name] = max(errs.get((key, name), 0.0), err)
    return {(k, n): e / errs["plain", n] for (k, n), e in errs.items()
            if k != "plain"}


@pytest.fixture(scope="module")
def gate_ratios():
    """At the card's gate shapes: mamba2-2.7b's (B=4, S=2048, H=80, its
    decay), and small decays over a whole ragged chunk (B=1, S=300, H=5:
    cum reaches ~-180 inside the chunk), the largest ratio of 8 draws."""
    small = [_gate_ratios(_small_inputs(1, 300, 5, 64, 128, seed), 5)
             for seed in range(8)]
    return {"2.7b": _gate_ratios(_mamba_inputs(4, 2048, 80, 64, 128, 20),
                                 8),
            "small-decay": {k: max(r[k] for r in small) for k in small[0]}}


@pytest.mark.parametrize("case", ["2.7b", "small-decay"])
@pytest.mark.parametrize("name", ["y_intra", "states", "T"])
def test_split_terms_hold_the_gate(gate_ratios, case, name):
    ratio = gate_ratios[case][TERMS, name]
    assert ratio <= GATE, (case, name, ratio, gate_ratios[case])


@pytest.mark.parametrize("name", ["y_intra", "states"])
def test_one_bf16_rounding_misses_the_gate(gate_ratios, name):
    """Why M and B·w are split: rounded once to bf16 they miss the card's
    2x gate at 2.7B by more than an order of magnitude (110x and 570x
    here)."""
    assert gate_ratios["2.7b"][1, name] > 20, gate_ratios["2.7b"]


@pytest.mark.parametrize("name", ["y_intra", "states"])
def test_two_terms_miss_the_rule(gate_ratios, name):
    """Why three terms: with two, the largest ratio over the small-decay
    draws passes 1.5x (1.7x for y_intra, 6.0x for the states)."""
    assert gate_ratios["small-decay"][2, name] > GATE, \
        gate_ratios["small-decay"]


@pytest.mark.parametrize("B,S,H,P,N,Q", [
    (2, 96, 4, 32, 16, 32),     # tests/test_kernels.py::TestSSD
    (1, 128, 2, 64, 32, 64),
    (2, 100, 3, 16, 8, 32),     # ragged S
    (2, 64, 8, 64, 16, 32),     # the reduced mamba2
    (1, 300, 5, 64, 128, 256),  # mamba2-2.7b's head shapes, ragged
])
def test_mma_rounding_within_bf16_tolerance(B, S, H, P, N, Q):
    args = _small_inputs(B, S, H, P, N, seed=S)
    for got, want in zip(mma_ssd_chunk(*args, Q), ref.ssd_chunk_ref(*args,
                                                                    Q)):
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, **BF16)


@pytest.mark.parametrize("B,S,H,P,N,Q", [(2, 96, 4, 32, 16, 32),
                                         (1, 128, 2, 64, 32, 64)])
def test_mma_emulation_matches_jax_kernel(B, S, H, P, N, Q):
    """Against the reference's Pallas kernel in interpret mode (S a
    multiple of the chunk, as it takes)."""
    args = _small_inputs(B, S, H, P, N, seed=7)
    jy, js, jT = j_ssd_chunk(*(jnp.asarray(a.numpy()) for a in args),
                             chunk=Q, interpret=True)
    for got, want in zip(mma_ssd_chunk(*args, Q), (jy, js, jT)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)
