#!/usr/bin/env python3
"""Build the port's CUDA kernels, check them, serve seesaw-150m and train
it with a Seesaw batch ramp, train mamba2-2.7b with a Seesaw ramp, and
run the kernel benchmark on one NVIDIA card.

    python3 chip_smoke.py

Imports nothing of JAX and nothing of the JAX package ``repro``; it runs
``src/repro_torch`` from this checkout.

- Build: nvcc compiles ``src/repro_torch/csrc`` for sm_90a (one process
  per source, in parallel) into ``build/kernels``.  Then what was
  compiled is read back: the bfloat16 flash forward, dq and dk/dv kernels
  (hd 64 and 128) must hold HMMA (tensor-core mma.sync) instructions in
  their SASS (``cuobjdump -sass``) and their float32 forms none, and
  ptxas must report no spills for the bfloat16 ones at hd 64; likewise
  the bfloat16 SSD chunk kernel must hold HMMA and spill nothing and its
  float32 form hold none; HMMA counts, registers and spill bytes (the
  RMSNorm backward's too) go into the ``kernels`` line.
- Phase 1, kernels against their plain versions: RMSNorm forward, the
  causal GQA flash forward and the ragged decode, each on the serving
  path's shapes (seesaw-150m prefill at S=1024, decode at 8 slots over a
  1024-token window with ragged lengths) and on llama3.2-3b's GQA heads
  (H=24, Hkv=8, hd=128), in float32 (tolerance 2e-5) and bfloat16
  (2e-2), TF32 off; the flash forward also at S = 1, 15, 16, 63, 64, 65
  and 129 (hd 64, MHA; hd 128, GQA groups of 3), the edges of the bf16
  kernel's tiles.  The decode kernel twice: through its gathered-window
  entry (against ``ragged_decode_ref``), and reading K and V through the
  page table from a pool (``paged_decode_attention_pool``, against
  ``paged_decode_ref``) at page sizes 1, 4 and 16, with shuffled page
  ids, null-page entries, an inactive slot and lengths at the page edges
  and at the window's last key.  Then each kernel (``ms``), its plain
  version (``plain_ms``) and one PyTorch call that computes the same
  function (``library_ms``, a yardstick the port never calls) are timed
  with CUDA events, L2 flushed before every launch and the host's
  enqueue hidden behind a device spin (``Timer``), at the serving path's
  shapes in bfloat16; the decode also at lengths that fit one split of
  the kernel (no merge) and at full windows, its paged entry (page 16,
  the same lengths) beside its gathered one, and ``gather_pages`` alone
  at phase 2's table shape (8 x 64 pages of 16), the copy the page-table
  read spares the serving step.
- Phase 1d, the streaming normalize of the kernel benchmark's overlap
  probe (``kernels/overlap.py``, bulk asynchronous copies through a
  ring of ``depth`` shared-memory stages) against its plain version in
  float32 (2e-5): at 8192 x 512 at every (block_rows, depth) of the
  benchmark's sweep that fits the card's shared memory, and at edge
  shapes (fewer row-blocks than SMs, more depth than row-blocks per SM,
  d = 256, 1028 and 4, depth 3 and 16).  Then, for what the kernel's
  gap to its bound is made of, two reference times with the same timer:
  a device copy of the same 8192 x 512 and a kernel touching 4 bytes.
- Phase 2, the engine: ``get_config("seesaw-150m")`` unreduced, random
  weights from a seed, bfloat16, 8 decode slots, page 16, max_len 1024;
  16 seeded requests with prompts of 64-768 tokens and 32-128 new
  tokens, EOS off.  Every request must finish with exactly its
  max_new_tokens tokens in [0, vocab) and the pool must drain to 0 pages.
  The kernels' launch counts are set to 0 just before this run and read
  just after; each must be > 0.  A torch.profiler run of 8 more requests
  gives the device time per decode step.
- Phase 3, the card against the CPU: two of those requests, 8 new tokens
  each, in float32 through the same engine on the card (kernels) and on
  the CPU (plain versions), same weights.  First-token logits must agree
  within 1e-3 and the greedy tokens must be equal.
- Phase 1b, the backward kernels against their plain versions: RMSNorm
  backward at the training rows (8·1024 × 1024), at (1000 × 3072) and
  at 150 × 2560 (fewer rows than the kernel's grid has blocks);
  the flash backward (dq, dk/dv) at seesaw-150m's training shapes (B=8,
  S=1024, H=Hkv=16, hd=64) and at llama3.2-3b's GQA heads with a ragged
  S=1000, and at phase 1's edge lengths; float32 (2e-5) and bfloat16
  (2e-2), TF32 off.  At each of those shapes the flash forward's out and
  lse are held to ``attention_ref`` too before the backward reads them
  (``train_shape_max_abs_err`` in its ``kernels`` entry).  RMSNorm's
  dscale, a float32 sum over all rows, is held to 2e-5 of the sum of its
  terms' magnitudes.  Then each is timed as in phase 1 at the training
  shapes in bfloat16; ``library_ms`` is ``torch.autograd.grad`` through
  ``F.rms_norm`` and through ``F.scaled_dot_product_attention``, the
  forward outside the timed call; the RMSNorm backward's time includes
  dscale, summed inside its one launch.  The flash forward and the
  RMSNorm forward are timed at the training shape too, beside SDPA's
  forward / ``F.rms_norm`` and their bounds (``train_shape_*`` in their
  ``kernels`` entries).
- Phase 4, training at full width: seesaw-150m unreduced, bfloat16
  compute with float32 weights and AdamW state (β 0.9/0.95, clip 1.0),
  ``kind="seesaw"``, α=2, B0=8, two cuts, seq 1024, 24·8·1024 tokens,
  ``fuse_steps=4``, ``max_device_batch=8``, data ``MarkovLM(2048, 0)``:
  phases B = 8 / 16 / 32 over 16 / 2 / 1 steps, accumulating 1 / 2 / 4
  micro-batches.  Every loss must be finite, each step's LR, batch size
  and phase must be the plan's, the mean loss of the last 3 steps must
  be at least 0.5 below step 1's, and the five training kernels' launch
  counts (set to 0 just before the run, read just after) must equal
  what remat gives per micro-batch: RMSNorm forward 4L+1, backward
  2L+1, flash forward 2L, dq and dk/dv L each.  Reports tokens/s and
  wall time per step at each batch size, peak memory, and a
  torch.profiler breakdown of one more step at B=8.
- Phase 5, training on the card against the CPU in float32:
  seesaw-150m widths at 2 layers, S=256, B=2, the same weights on both.
  Loss within 1e-4; every grad within 1e-3 of its tensor's largest
  |grad|; AdamW applied on each device to the same (CPU) grads at a
  fixed LR within 1e-6.
- Phase 1c, the SSD chunk kernel against its plain version, and RMSNorm
  forward and backward at Mamba-2's widths (8192 rows of d = 2560 and
  5120, float32 2e-5 and bfloat16 2e-2, timed in bfloat16).  The kernel: at
  mamba2-2.7b's training shapes (B=4, S=2048, H=80, P=64, N=128, Q=256,
  x, B and C as views of one (B, S, 5376) tensor as the mixer hands
  them over) with its init's decay (A = -(1..80), dt around the
  log-spaced [1e-3, 1e-1]: cum reaches ~-2000 inside a chunk), and at a
  ragged S=1000; float32 and bfloat16.  There the kernel and the float32
  plain version are both held to a float64 evaluation of the plain
  version, and the kernel's error must be at most twice the plain
  version's (float32 sums of such a cum differ by ~1e-4 relative).  At
  small decays (the reduced config's heads, H=8, P=64, N=16, Q=32, and
  a ragged S=100) it is held to the plain version at 2e-5 / 2e-2.  Then
  timed as in phase 1 at the 2.7B shapes in bfloat16 (the bfloat16
  kernel runs on the tensor cores; ``tflops`` counts the causal work of
  the bound, not the split products); no single PyTorch call computes
  this function, so ``library_ms`` is null.
- Phase 6, mamba2-2.7b at full width and depth (64 layers, d_model
  2560, 80 SSD heads, 2.70B parameters), random weights from a seed:
  ``kind="seesaw"``, α=2, B0=4, two cuts, seq 2048, 11·4·2048 tokens,
  base LR 8e-4, ``fuse_steps=1``, ``max_device_batch=4``, bfloat16
  compute with float32 weights and AdamW, remat on, data
  ``MarkovLM(2048, 0)``: B = 4 / 8 / 16 over 7 / 1 / 1 steps, 13
  micro-batches.  Every loss and grad norm must be finite, each step's
  LR, batch size and phase the plan's, the last loss below the first,
  and the launch counts exactly, per micro-batch, ``ssd_chunk`` 2L,
  RMSNorm forward 4L+1 and backward 2L+1.  Reports tokens/s and wall
  time per step at each batch size, peak memory, and a torch.profiler
  breakdown of one more B=4 step.
- Phase 7, the reduced mamba2 in float32 on the card against the CPU,
  same weights: loss within 1e-4, grads within 1e-3 of each tensor's
  largest |grad|.

- Phase 8, the kernel benchmark: ``repro_torch.bench.kernels`` at full
  size through its ``main`` (the reference's attention, RMSNorm and SSD
  sweeps in float32, kernel and plain, forward and forward+backward; the
  overlap profile at 8192 x 512 over block rows 1-32 and depth 1-8),
  written to ``chiprun_out/bench_kernels.json``.  Every overlap config
  run must be within 2e-5 of the plain version; every sweep row must
  hold its four times, and its outputs and grads must be within 2e-5
  abs/rel of the plain version's on the same inputs (RMSNorm's dscale,
  a sum over every row, within 2e-5 of its terms' magnitude, as in
  phase 1b); the seven kernels
  on the benchmark's path
  (RMSNorm forward and backward, flash forward, dq, dk/dv, the SSD
  chunk, the overlap normalize) must each be launched in the run.

Prints the card's name and power limit, one ``kernels`` JSON line (the
eight kernels), one ``engine`` and one ``train`` JSON line, one
``mamba2`` JSON line, and last ``{"ok": true, "device": {...}}``; the
full record goes to ``chiprun_out/chip_smoke.json``.  Any failed check
raises, so the script exits non-zero before the last line.  Without a
CUDA device it exits with code 2 and prints no result.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.bench.timing import Timer, bound  # noqa: E402

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
DTYPES = (torch.float32, torch.bfloat16)
# (B, S, H, Hkv, hd, tag): lengths that start, fill, cross and overrun the
# bf16 flash kernels' 16-row warp tiles and 32/64-row block tiles, at hd 64
# (MHA) and hd 128 (GQA groups of 3)
FLASH_EDGES = tuple((B, S, H, Hkv, hd, f"edge-S{S}-hd{hd}")
                    for B, H, Hkv, hd in ((2, 4, 4, 64), (1, 6, 2, 128))
                    for S in (1, 15, 16, 63, 64, 65, 129))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def max_err(got, want, dtype) -> float:
    err = float((got.float() - want.float()).abs().max())
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    return err


# --------------------------------------------------------------------- #
# phase 1: kernels against their plain versions
# --------------------------------------------------------------------- #

def rmsnorm_case(RN, ref, rows, d, dtype, g):
    x = torch.randn(rows, d, generator=g, device="cuda").to(dtype)
    s = 0.1 * torch.randn(d, generator=g, device="cuda")
    got = RN.rmsnorm_fwd(x, s, 1e-5)
    torch.cuda.synchronize()
    return x, s, max_err(got, ref.rmsnorm_ref(x, s, 1e-5), dtype)


def flash_case(FA, ref, B, S, H, Hkv, hd, dtype, g):
    # the models' (B, S, H, hd) layout, read through transposed views
    q = torch.randn(B, S, H, hd, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, S, Hkv, hd, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, S, Hkv, hd, generator=g, device="cuda").to(dtype)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    out, lse = FA.flash_fwd(qt, kt, vt)
    torch.cuda.synchronize()
    want, want_lse = ref.attention_ref(qt, kt, vt)
    err = max_err(out, want, dtype)
    max_err(lse, want_lse, dtype)
    return (qt, kt, vt), err


def decode_case(PG, ref, B, Skv, H, Hkv, hd, dtype, g, rng):
    q = torch.randn(B, H, hd, generator=g, device="cuda").to(dtype)
    # a gathered head-interleaved page window, split into strided views
    kv = torch.randn(B, Skv, 2 * Hkv, hd, generator=g,
                     device="cuda").to(dtype)
    k, v = kv[:, :, 0::2].transpose(1, 2), kv[:, :, 1::2].transpose(1, 2)
    lens = rng.integers(64, Skv, B).astype(np.int32)
    lens[0] = 0                                  # an inactive slot
    lengths = torch.from_numpy(lens).cuda()
    got = PG.ragged_decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    err = max_err(got, ref.ragged_decode_ref(q, k, v, lengths), dtype)
    return (q, k, v, lengths, lens, kv), err


def paged_case(PG, ref, B, window, H, Hkv, hd, ps, dtype, g, rng):
    """A random pool and a shuffled page table: lengths ps - 1, ps, ps + 1
    (the page edges), an inactive slot (length 0, all-null row), the
    window's last key, the rest random; live pages distinct and shuffled,
    the other entries the null page 0, whose data is random too."""
    P = window // ps
    lens = rng.integers(1, window, B)
    lens[:5] = [ps - 1, ps, ps + 1, 0, window - 1]
    need = [0 if b == 3 else int(n) // ps + 1 for b, n in enumerate(lens)]
    n_pages = sum(need) + 5
    ids = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((B, P), np.int64)
    used = 0
    for b, n in enumerate(need):
        table[b, :n] = ids[used:used + n]
        used += n
    pool = torch.randn(n_pages, ps, 2 * Hkv, hd, generator=g,
                       device="cuda").to(dtype)
    q = torch.randn(B, H, hd, generator=g, device="cuda").to(dtype)
    pages = torch.from_numpy(table).cuda()
    lengths = torch.from_numpy(lens.astype(np.int32)).cuda()
    got = PG.paged_decode_attention_pool(q, pool, pages, lengths,
                                         page_size=ps)
    torch.cuda.synchronize()
    return max_err(got, ref.paged_decode_ref(q, pool, pages, lengths,
                                             page_size=ps), dtype)


def phase1(RN, FA, PG, ref):
    g = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    errors, inputs = [], {}
    for dtype in DTYPES:
        dn = str(dtype).replace("torch.", "")
        for rows, d, tag in ((1024, 1024, "prefill"), (8, 1024, "decode"),
                             (1000, 3072, "llama")):
            x, s, err = rmsnorm_case(RN, ref, rows, d, dtype, g)
            errors.append(("rmsnorm_fwd", tag, dn, err))
            inputs[("rmsnorm_fwd", tag, dn)] = (x, s)
        for B, S, H, Hkv, hd, tag in ((1, 1024, 16, 16, 64, "seesaw"),
                                      (1, 1000, 24, 8, 128, "llama"),
                                      *FLASH_EDGES):
            t, err = flash_case(FA, ref, B, S, H, Hkv, hd, dtype, g)
            errors.append(("flash_fwd", tag, dn, err))
            inputs[("flash_fwd", tag, dn)] = t
        for B, Skv, H, Hkv, hd, tag in ((8, 1024, 16, 16, 64, "seesaw"),
                                        (8, 1008, 24, 8, 128, "llama")):
            t, err = decode_case(PG, ref, B, Skv, H, Hkv, hd, dtype, g, rng)
            errors.append(("ragged_decode", tag, dn, err))
            inputs[("ragged_decode", tag, dn)] = t
            for ps in (1, 4, 16):
                err = paged_case(PG, ref, B, Skv, H, Hkv, hd, ps, dtype, g,
                                 rng)
                errors.append(("paged_decode", f"{tag}-ps{ps}", dn, err))
    for name, tag, dn, err in errors:
        log(f"phase 1: {name} {tag} {dn}: max |err| {err:.3g}")
    return errors, inputs


def paged_window(kv, ps, seed=0):
    """The gathered window kv (B, Skv, 2·Hkv, hd) scattered into a pool of
    pages of ``ps`` under a shuffled page table (every page of the window
    allocated, page 0 left null): (pool, pages (B, Skv / ps) int64)."""
    B, Skv = kv.shape[:2]
    P = Skv // ps
    ids = np.random.default_rng(seed).permutation(np.arange(1, B * P + 1))
    pages = torch.from_numpy(ids.reshape(B, P).astype(np.int64)).cuda()
    pool = torch.zeros(B * P + 1, ps, *kv.shape[2:], dtype=kv.dtype,
                       device="cuda")
    pool[pages] = kv.reshape(B, P, ps, *kv.shape[2:])
    return pool, pages


def measure(RN, FA, PG, ref, SC, inputs):
    """Kernel, plain and library times at the serving path's shapes in
    bfloat16, each with its bound; the decode kernel's paged entry at the
    same lengths with page 16 (which must agree with its gathered entry
    to 2e-2), and ``gather_pages`` alone at that table."""
    timer = Timer()
    bf = torch.bfloat16
    rows = {}

    def row(name, key, kernel, plain, library, b):
        rows[name] = dict(ms=timer(kernel), plain_ms=timer(plain),
                          library_ms=timer(library),
                          host_us=timer.host_us(kernel),
                          library_host_us=timer.host_us(library),
                          shape=key, **b)

    for tag in ("prefill", "decode"):
        x, s = inputs[("rmsnorm_fwd", tag, "bfloat16")]
        w = (1.0 + s).to(bf)
        d = x.shape[-1]
        row(f"rmsnorm_fwd/{tag}", f"x ({x.shape[0]}, {d}) bf16",
            lambda: RN.rmsnorm_fwd(x, s, 1e-5),
            lambda: ref.rmsnorm_ref(x, s, 1e-5),
            lambda: F.rms_norm(x, (d,), w, 1e-5),
            bound(2 * x.numel() * x.element_size() + 4 * d,
                  4 * x.numel(), bf))

    qt, kt, vt = inputs[("flash_fwd", "seesaw", "bfloat16")]
    B, H, S, hd = qt.shape
    es = qt.element_size()
    row("flash_fwd", f"q (B={B}, S={S}, H={H}, hd={hd}) bf16, causal",
        lambda: FA.flash_fwd(qt, kt, vt),
        lambda: ref.attention_ref(qt, kt, vt),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        bound(4 * qt.numel() * es + 4 * B * H * S,
              4 * B * H * hd * S * (S + 1) / 2, bf))

    q, k, v, lengths, lens, kv = inputs[("ragged_decode", "seesaw",
                                         "bfloat16")]
    B, H, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    keys = float(np.sum(lens.astype(np.int64) + 1))
    mask = (torch.arange(Skv, device="cuda")[None, :]
            <= lengths.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None]
    row("ragged_decode",
        f"q (B={B}, H={H}, hd={hd}), window Skv={Skv}, lengths "
        f"{lens.tolist()} bf16",
        lambda: PG.ragged_decode_attention(q, k, v, lengths),
        lambda: ref.ragged_decode_ref(q, k, v, lengths),
        lambda: F.scaled_dot_product_attention(q4, k, v, attn_mask=mask),
        bound(2 * q.numel() * es + 2 * keys * Hkv * hd * es + 4 * B,
              4 * keys * H * hd, bf))

    # the same window at lengths that fit one split of the kernel (no
    # merge) and at full windows (every split, then the merge)
    for tag, n in (("one_split", 100), ("full_window", Skv - 1)):
        ln = torch.full((B,), n, dtype=torch.int32, device="cuda")
        mk = (torch.arange(Skv, device="cuda")[None, :]
              <= ln.long()[:, None])[:, None, None, :]
        nk = float(B * (n + 1))
        row(f"ragged_decode/{tag}",
            f"the same q and window, every length {n}",
            lambda: PG.ragged_decode_attention(q, k, v, ln),
            lambda: ref.ragged_decode_ref(q, k, v, ln),
            lambda: F.scaled_dot_product_attention(q4, k, v, attn_mask=mk),
            bound(2 * q.numel() * es + 2 * nk * Hkv * hd * es + 4 * B,
                  4 * nk * H * hd, bf))

    # the same window and lengths read through a page table of 16
    ps = 16
    pool, pages = paged_window(kv, ps)
    want = PG.ragged_decode_attention(q, k, v, lengths)
    got = PG.paged_decode_attention_pool(q, pool, pages, lengths,
                                         page_size=ps)
    torch.cuda.synchronize()
    paged_vs_gathered = max_err(got, want, bf)
    n_table = float(np.sum((lens.astype(np.int64) + ps) // ps))
    rows["ragged_decode/paged"] = dict(
        ms=timer(lambda: PG.paged_decode_attention_pool(
            q, pool, pages, lengths, page_size=ps)),
        plain_ms=timer(lambda: ref.paged_decode_ref(
            q, pool, pages, lengths, page_size=ps)),
        host_us=timer.host_us(lambda: PG.paged_decode_attention_pool(
            q, pool, pages, lengths, page_size=ps)),
        max_abs_err_vs_gathered=paged_vs_gathered,
        shape=f"the same q and lengths, K/V read through a shuffled page "
              f"table ({B} x {pages.shape[1]} pages of {ps}) bf16",
        **bound(2 * q.numel() * es + 2 * keys * Hkv * hd * es + 4 * B
                + 8 * n_table, 4 * keys * H * hd, bf))
    rows["gather_pages"] = dict(
        ms=timer(lambda: SC.gather_pages(pool, pages, page_size=ps)),
        shape=f"pool[pages] of a ({B}, {pages.shape[1]}) table, pages of "
              f"{ps} x {2 * Hkv} x {hd} bf16: the window copy the serving "
              f"step made before each decode launch, per layer",
        **bound(2 * pool[pages].numel() * es + 8 * pages.numel(), 0, bf))
    return rows


# --------------------------------------------------------------------- #
# phase 1b: backward kernels against their plain versions
# --------------------------------------------------------------------- #

def dscale_rel_err(x, gy, ds, want, eps=1e-5) -> float:
    """RMSNorm's dscale is a float32 sum over every row, taken in another
    order than the plain version's: its error, over the sum of the
    terms' magnitudes, must stay within 2e-5."""
    d = x.shape[-1]
    x32 = x.float().reshape(-1, d)
    xh = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    mag = (gy.float().reshape(-1, d) * xh).abs().sum(0) + 1e-30
    rel = float(((ds - want).abs() / mag).max())
    if rel > 2e-5:
        raise AssertionError(f"dscale: error {rel:.3g} of the terms' "
                             f"magnitude > 2e-5")
    return rel


def phase1b(RN, FA, ref):
    g = torch.Generator(device="cuda").manual_seed(10)
    errors, inputs = [], {}
    for dtype in DTYPES:
        dn = str(dtype).replace("torch.", "")
        for rows, d, tag in ((8 * 1024, 1024, "train"),
                             (1000, 3072, "llama"),
                             (150, 2560, "few-rows")):
            x = torch.randn(rows, d, generator=g, device="cuda").to(dtype)
            s = 0.1 * torch.randn(d, generator=g, device="cuda")
            gy = torch.randn(rows, d, generator=g, device="cuda").to(dtype)
            dx, ds = RN.rmsnorm_bwd(x, s, gy, 1e-5)
            torch.cuda.synchronize()
            want_dx, want_ds = ref.rmsnorm_bwd_ref(x, s, gy, 1e-5)
            errors.append(("rmsnorm_bwd", tag, dn,
                           max_err(dx, want_dx, dtype)))
            errors.append(("rmsnorm_bwd/dscale_rel", tag, dn,
                           dscale_rel_err(x, gy, ds, want_ds)))
            inputs[("rmsnorm_bwd", tag, dn)] = (x, s, gy)
        for B, S, H, Hkv, hd, tag in ((8, 1024, 16, 16, 64, "seesaw"),
                                      (1, 1000, 24, 8, 128, "llama"),
                                      *FLASH_EDGES):
            q, k, v, do = (torch.randn(B, S, n, hd, generator=g,
                                       device="cuda").to(dtype)
                           for n in (H, Hkv, Hkv, H))
            qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
            out, lse = FA.flash_fwd(qt, kt, vt)
            torch.cuda.synchronize()
            # the forward at the shapes training gives it, before the
            # backward reads its out and lse
            want, want_lse = ref.attention_ref(qt, kt, vt)
            errors.append(("flash_fwd", f"bwd-{tag}", dn,
                           max_err(out, want, dtype)))
            max_err(lse, want_lse, dtype)
            del want, want_lse
            dq, dk, dv = FA.flash_bwd(qt, kt, vt, out, lse, dot)
            torch.cuda.synchronize()
            wq, wk, wv = ref.flash_bwd_ref(qt, kt, vt, out, lse, dot)
            errors.append(("flash_bwd_dq", tag, dn, max_err(dq, wq, dtype)))
            errors.append(("flash_bwd_dkv", tag, dn,
                           max(max_err(dk, wk, dtype),
                               max_err(dv, wv, dtype))))
            inputs[("flash_bwd", tag, dn)] = (qt, kt, vt, out, lse, dot)
            del dq, dk, dv, wq, wk, wv
    for name, tag, dn, err in errors:
        log(f"phase 1b: {name} {tag} {dn}: max |err| {err:.3g}")
    return errors, inputs


def measure_bwd(RN, FA, ref, inputs):
    """Backward kernel, plain and library times at the training shapes in
    bfloat16, each with its bound.  The plain version and the library
    call compute dq, dk and dv together, so the two flash rows share
    them."""
    timer = Timer(iters=20)
    bf = torch.bfloat16
    rows = {}

    x, s, gy = inputs[("rmsnorm_bwd", "train", "bfloat16")]
    n, d = x.shape
    es = x.element_size()
    xr = x.detach().clone().requires_grad_()
    w = (1.0 + s).to(bf).requires_grad_()
    y = F.rms_norm(xr, (d,), w, 1e-5)
    rows["rmsnorm_bwd"] = dict(
        ms=timer(lambda: RN.rmsnorm_bwd(x, s, gy, 1e-5)),
        plain_ms=timer(lambda: ref.rmsnorm_bwd_ref(x, s, gy, 1e-5)),
        library_ms=timer(lambda: torch.autograd.grad(
            y, (xr, w), gy, retain_graph=True)),
        host_us=timer.host_us(lambda: RN.rmsnorm_bwd(x, s, gy, 1e-5)),
        shape=f"x, g ({n}, {d}) bf16; dx and dscale from one launch",
        **bound(3 * n * d * es + 8 * d, 12 * n * d, bf))
    del xr, w, y
    # the forward at the training shape (4L+1 launches a micro-batch)
    wb = (1.0 + s).to(bf)
    rows["rmsnorm_fwd/train"] = dict(
        ms=timer(lambda: RN.rmsnorm_fwd(x, s, 1e-5)),
        plain_ms=timer(lambda: ref.rmsnorm_ref(x, s, 1e-5)),
        library_ms=timer(lambda: F.rms_norm(x, (d,), wb, 1e-5)),
        shape=f"x ({n}, {d}) bf16",
        **bound(2 * n * d * es + 4 * d, 4 * n * d, bf))

    qt, kt, vt, out, lse, dot = inputs[("flash_bwd", "seesaw", "bfloat16")]
    B, H, S, hd = qt.shape
    Hkv = kt.shape[1]
    es = qt.element_size()
    delta = (dot.float() * out.float()).sum(-1).reshape(B * H, S) \
        .contiguous()
    pairs = B * H * S * (S + 1) / 2
    reads = (2 * B * H + 2 * B * Hkv) * S * hd * es + 8 * B * H * S
    qa, ka, va = (t.detach().clone().requires_grad_() for t in (qt, kt, vt))
    o = F.scaled_dot_product_attention(qa, ka, va, is_causal=True)
    plain_ms = timer(lambda: ref.flash_bwd_ref(qt, kt, vt, out, lse, dot))
    library_ms = timer(lambda: torch.autograd.grad(
        o, (qa, ka, va), dot, retain_graph=True))
    shape = f"q (B={B}, S={S}, H={H}, hd={hd}) bf16, causal"
    rows["flash_bwd_dq"] = dict(
        ms=timer(lambda: FA.flash_bwd_dq(qt, kt, vt, dot, lse, delta)),
        plain_ms=plain_ms, library_ms=library_ms,
        host_us=timer.host_us(
            lambda: FA.flash_bwd_dq(qt, kt, vt, dot, lse, delta)),
        shape=shape, **bound(reads + B * H * S * hd * es, 6 * hd * pairs,
                             bf))
    rows["flash_bwd_dkv"] = dict(
        ms=timer(lambda: FA.flash_bwd_dkv(qt, kt, vt, dot, lse, delta)),
        plain_ms=plain_ms, library_ms=library_ms,
        host_us=timer.host_us(
            lambda: FA.flash_bwd_dkv(qt, kt, vt, dot, lse, delta)),
        shape=shape, **bound(reads + 2 * B * Hkv * S * hd * es,
                             8 * hd * pairs, bf))
    rows["flash_bwd"] = dict(
        ms=timer(lambda: FA.flash_bwd(qt, kt, vt, out, lse, dot)),
        shape=shape + "; delta, dq and dk/dv")
    # the forward at the training shape, as remat launches it 2L times a
    # micro-batch
    rows["flash_fwd/train"] = dict(
        ms=timer(lambda: FA.flash_fwd(qt, kt, vt)),
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        shape=shape,
        **bound((2 * B * H + 2 * B * Hkv) * S * hd * es + 4 * B * H * S,
                4 * hd * pairs, bf))
    return rows


def compiled_report(_build, lib):
    """What the build made of the flash, SSD chunk and RMSNorm backward
    kernels: per instantiation, the count of HMMA (mma.sync)
    instructions in its SASS (``cuobjdump -sass``) and ptxas's registers
    and spill bytes.  The bfloat16 forward, dq and dk/dv kernels must
    hold HMMA and spill nothing at hd 64, the bfloat16 SSD chunk kernel
    must hold HMMA and spill nothing; their float32 forms must hold
    none."""
    regs = _build.ptxas_report(lib)
    hmma = _build.sass_counts(lib, "HMMA")
    out = {}
    for mangled, r in regs.items():
        m = re.search(r"(flash_[a-z_]+?_kernel)ILi(\d+)E", mangled)
        if m:
            name, hd = m.groups()
            # the CUDA-core forms are float32 alone, the mma forms
            # bfloat16 alone
            dtype = "bfloat16" if name.endswith("_mma_kernel") else "float32"
            out[f"{name}<{dtype}, hd {hd}>"] = dict(hmma=hmma[mangled], **r)
        if "ssd_chunk_mma_kernel" in mangled:
            out["ssd_chunk_mma_kernel<bfloat16>"] = dict(hmma=hmma[mangled],
                                                         **r)
        m = re.search(r"(ssd_chunk|rmsnorm_bwd)_kernelI(f|13__nv_bfloat16)E",
                      mangled)
        if m:
            dtype = "float32" if m.group(2) == "f" else "bfloat16"
            out[f"{m.group(1)}_kernel<{dtype}>"] = dict(hmma=hmma[mangled],
                                                        **r)
    tc, f32 = (out["ssd_chunk_mma_kernel<bfloat16>"],
               out["ssd_chunk_kernel<float32>"])
    if not tc["hmma"] > 0 or f32["hmma"] != 0 \
            or tc["spill_stores"] or tc["spill_loads"]:
        raise AssertionError(f"ssd_chunk: HMMA and spills in the bf16 form "
                             f"{tc}, HMMA in the f32 form {f32}")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        for hd in (64, 128):
            tc = out[f"{name}_mma_kernel<bfloat16, hd {hd}>"]
            f32 = out[f"{name}_kernel<float32, hd {hd}>"]
            if not tc["hmma"] > 0 or f32["hmma"] != 0:
                raise AssertionError(f"{name} hd {hd}: HMMA in the bf16 "
                                     f"form {tc}, in the f32 form {f32}")
            if hd == 64 and (tc["spill_stores"] or tc["spill_loads"]):
                raise AssertionError(f"{name} bf16 hd 64 spills: {tc}")
    return out


# --------------------------------------------------------------------- #
# phase 1c: the SSD chunk kernel against its plain version
# --------------------------------------------------------------------- #

def ssd_inputs(B, S, H, P, N, dtype, g, mamba_decay):
    """x, B, C as views of one (B, S, H·P + 2N) tensor, as the mixer hands
    them to the kernel.  ``mamba_decay``: mamba2-2.7b's init (A =
    -(1..H), dt = softplus(dt_bias + 0.5·noise) around its log-spaced
    [1e-3, 1e-1]); else small decays (A = -exp(0.3·noise), dt =
    softplus(noise))."""
    di = H * P
    xbc = torch.randn(B, S, di + 2 * N, generator=g, device="cuda").to(dtype)
    xh = xbc[..., :di].reshape(B, S, H, P)
    Bm, Cm = xbc[..., di:di + N], xbc[..., di + N:]
    noise = torch.randn(B, S, H, generator=g, device="cuda")
    if mamba_decay:
        dt0 = torch.exp(torch.linspace(np.log(1e-3), np.log(1e-1), H,
                                       device="cuda"))
        dt = F.softplus(dt0 + torch.log(-torch.expm1(-dt0)) + 0.5 * noise)
        A = -torch.arange(1, H + 1, dtype=torch.float32, device="cuda")
    else:
        dt = F.softplus(noise)
        A = -torch.exp(0.3 * torch.randn(H, generator=g, device="cuda"))
    return xh, dt, A, Bm, Cm


def phase1c(SSD, RN, ref):
    """Errors: at small decays the largest |kernel - plain| over the three
    outputs, held to TOL; at mamba2-2.7b's decay the largest error of the
    kernel and of the float32 plain version against a float64 evaluation
    of the plain version, the kernel's at most twice the plain's.  And
    RMSNorm forward and backward at Mamba-2's widths (the block norm at
    d=2560, the gated norm at d=5120, 8192 rows: one micro-batch)."""
    g = torch.Generator(device="cuda").manual_seed(20)
    errors, f64, inputs = [], [], {}
    for dtype in DTYPES:
        dn = str(dtype).replace("torch.", "")
        for d in (2560, 5120):
            x, sc, err = rmsnorm_case(RN, ref, 8192, d, dtype, g)
            errors.append(("rmsnorm_fwd", f"mamba2-d{d}", dn, err))
            gy = torch.randn(8192, d, generator=g, device="cuda").to(dtype)
            dx, ds = RN.rmsnorm_bwd(x, sc, gy, 1e-5)
            torch.cuda.synchronize()
            want_dx, want_ds = ref.rmsnorm_bwd_ref(x, sc, gy, 1e-5)
            errors.append(("rmsnorm_bwd", f"mamba2-d{d}", dn,
                           max_err(dx, want_dx, dtype)))
            errors.append(("rmsnorm_bwd/dscale_rel", f"mamba2-d{d}", dn,
                           dscale_rel_err(x, gy, ds, want_ds)))
            inputs[("rmsnorm", d, dn)] = (x, sc, gy)
        for B, S, H, P, N, Q, tag in ((2, 256, 8, 64, 16, 32, "reduced"),
                                      (2, 100, 8, 64, 16, 32, "ragged")):
            args = ssd_inputs(B, S, H, P, N, dtype, g, False)
            got = SSD.ssd_chunk(*args, Q)
            torch.cuda.synchronize()
            want = ref.ssd_chunk_ref(*args, Q)
            errors.append(("ssd_chunk", tag, dn, max(
                max_err(a, b, dtype) for a, b in zip(got, want))))
        for B, S, tag in ((4, 2048, "2.7b"), (1, 1000, "2.7b-ragged")):
            args = ssd_inputs(B, S, 80, 64, 128, dtype, g, True)
            got = SSD.ssd_chunk(*args, 256)
            torch.cuda.synchronize()
            plain = ref.ssd_chunk_ref(*args, 256)
            exact = ref.ssd_chunk_ref(*(t.double() for t in args), 256)
            for out, a, p, e in zip(("y_intra", "states", "T"), got, plain,
                                    exact):
                err = float((a.double() - e).abs().max())
                perr = float((p.double() - e).abs().max())
                if not (err <= 2 * perr and bool(torch.isfinite(a).all())):
                    raise AssertionError(
                        f"ssd_chunk {tag} {dn} {out}: error {err:.3g} vs "
                        f"float64, plain float32 {perr:.3g}")
                f64.append({"shape": tag, "dtype": dn, "output": out,
                            "kernel_err": err, "plain_err": perr,
                            "kernel_vs_plain": float((a - p).abs().max()),
                            "exact_max_abs": float(e.abs().max())})
            errors.append(("ssd_chunk", tag, dn,
                           max(float((a - p).abs().max())
                               for a, p in zip(got, plain))))
            if tag == "2.7b":
                inputs[("ssd", dn)] = args
            del got, plain, exact
            torch.cuda.empty_cache()
    for name, tag, dn, err in errors:
        log(f"phase 1c: {name} {tag} {dn}: max |err| {err:.3g}")
    for r in f64:
        log(f"phase 1c: vs float64 {r}")
    return errors, f64, inputs


def measure_ssd(SSD, RN, ref, inputs):
    """Kernel and plain times at mamba2-2.7b's training shapes in
    bfloat16, with the bound.  Bytes: x, B, C and dt read once, y_intra
    and the states written once in float32.  Operations: the causal
    halves of C·Bᵀ (2N per entry) and of M·x (2P per entry) and the
    state's 2·Q·N·P, per (b, chunk, head) cell.  RMSNorm forward and
    backward at Mamba-2's widths, timed as in phases 1 and 1b."""
    timer = Timer(iters=20)
    bf = torch.bfloat16
    rows = {}
    for d in (2560, 5120):
        x, sc, gy = inputs[("rmsnorm", d, "bfloat16")]
        n = x.shape[0]
        w = (1.0 + sc).to(bf)
        xr = x.detach().clone().requires_grad_()
        wr = w.detach().clone().requires_grad_()
        y = F.rms_norm(xr, (d,), wr, 1e-5)
        rows[f"rmsnorm_fwd/mamba2-d{d}"] = dict(
            ms=timer(lambda: RN.rmsnorm_fwd(x, sc, 1e-5)),
            plain_ms=timer(lambda: ref.rmsnorm_ref(x, sc, 1e-5)),
            library_ms=timer(lambda: F.rms_norm(x, (d,), w, 1e-5)),
            shape=f"x ({n}, {d}) bf16",
            **bound(4 * n * d + 4 * d, 4 * n * d, bf))
        rows[f"rmsnorm_bwd/mamba2-d{d}"] = dict(
            ms=timer(lambda: RN.rmsnorm_bwd(x, sc, gy, 1e-5)),
            plain_ms=timer(lambda: ref.rmsnorm_bwd_ref(x, sc, gy, 1e-5)),
            library_ms=timer(lambda: torch.autograd.grad(
                y, (xr, wr), gy, retain_graph=True)),
            shape=f"x, g ({n}, {d}) bf16",
            **bound(6 * n * d + 8 * d, 12 * n * d, bf))
        del xr, wr, y
    xh, dt, A, Bm, Cm = inputs[("ssd", "bfloat16")]
    B, S, H, P = xh.shape
    N, Q = Bm.shape[-1], 256
    nc = -(-S // Q)
    es = xh.element_size()
    n_bytes = (B * S * H * P * es + 2 * B * S * N * es + 4 * B * S * H
               + 4 * H + 4 * B * S * H * P + 4 * B * nc * H * N * P
               + 4 * B * nc * H)
    n_ops = B * nc * H * (Q * (Q + 1) * (N + P) + 2 * Q * N * P)
    rows["ssd_chunk"] = dict(
        ms=timer(lambda: SSD.ssd_chunk(xh, dt, A, Bm, Cm, Q)),
        plain_ms=timer(lambda: ref.ssd_chunk_ref(xh, dt, A, Bm, Cm, Q)),
        library_ms=None,
        library_note="no single PyTorch call computes the SSD chunk terms",
        host_us=timer.host_us(lambda: SSD.ssd_chunk(xh, dt, A, Bm, Cm, Q)),
        shape=f"x (B={B}, S={S}, H={H}, P={P}) bf16 strided as in the "
              f"mixer, N={N}, Q={Q}",
        **bound(n_bytes, n_ops, bf))
    rows["ssd_chunk"]["tflops"] = n_ops / rows["ssd_chunk"]["ms"] / 1e9
    return rows


# --------------------------------------------------------------------- #
# phase 1d: the overlap kernel against its plain version
# --------------------------------------------------------------------- #

def phase1d(OV, ref):
    """The streaming normalize against ``overlap_norm_ref`` in float32
    (2e-5): at the benchmark's 8192 x 512 at every (block_rows, depth)
    of its sweep whose stages fit the card's shared memory, and at edge
    shapes.  Returns [(rows, d, block_rows, depth, max |err|)], the
    configs over budget as (rows, d, block_rows, depth, None), and the
    times of a device copy of the 8192 x 512 input (``copy_ms``) and of
    a kernel touching 4 bytes (``launch_floor_ms``)."""
    from repro_torch.bench.kernels import OVERLAP
    g = torch.Generator(device="cuda").manual_seed(30)
    rows, d, blocks, depths = OVERLAP[False]
    cases = [(rows, d, b, k) for b in blocks for k in depths]
    cases += [
        (64, 512, 16, 1),       # 4 row-blocks: fewer than SMs
        (64, 512, 4, 8),        # 16 row-blocks, deeper than each one
        (4096, 256, 16, 4),     # 256 row-blocks: ~2 a block, depth 4
        (4096, 256, 1, 2), (4096, 256, 8, 8),               # d = 256
        (8192, 512, 1, 16),     # deeper than the 8 stores waited on
        (264, 1028, 2, 3),      # d not a power of 2, odd depth
        (1000, 4, 8, 2)]        # 16-byte rows, one vector each
    budget = OV.smem_budget("cuda")
    out, xs = [], {}
    for n, dd, b, k in cases:
        if OV.smem_bytes(b, dd, k) > budget:
            out.append((n, dd, b, k, None))
            continue
        if (n, dd) not in xs:
            xs[(n, dd)] = torch.randn(n, dd, generator=g, device="cuda")
        x = xs[(n, dd)]
        got = OV.overlap_norm(x, block_rows=b, depth=k)
        torch.cuda.synchronize()
        out.append((n, dd, b, k,
                    max_err(got, ref.overlap_norm_ref(x), torch.float32)))
    for n, dd, b, k, err in out:
        log(f"phase 1d: overlap_norm {n}x{dd} block_rows {b} depth {k}: "
            + ("over the shared memory budget" if err is None
               else f"max |err| {err:.3g}"))
    timer = Timer(iters=20)
    x = xs[(rows, d)]
    y = torch.empty_like(x)
    probes = {"copy_ms": timer(lambda: y.copy_(x)),
              "launch_floor_ms": timer(lambda: y[:1, :1].zero_())}
    log(f"phase 1d: {probes}")
    return out, probes


# --------------------------------------------------------------------- #
# phase 8: the kernel benchmark
# --------------------------------------------------------------------- #

def phase8(ctr):
    """``python -m repro_torch.bench.kernels`` at full size through its
    ``main``, writing ``chiprun_out/bench_kernels.json``.  The launch
    counters ``ctr`` are set to 0 just before and read just after; each
    must be > 0.  Every overlap config run must be within 2e-5 of the
    plain version, at least one at depth 1 and one deeper; every sweep
    row must hold its four times, and its outputs' and grads' errors
    (``fwd_err``, ``grad_err``: |kernel - plain| / (1 + |plain|), for
    RMSNorm's dscale / its terms' magnitude) must be within TOL[float32],
    whose atol and rtol are equal."""
    import contextlib
    from repro_torch.bench import kernels as BK
    for mod, attr in ctr.values():
        setattr(mod, attr, 0)
    with contextlib.redirect_stdout(sys.stderr):
        res = BK.main(["--out", os.path.join(OUT_DIR, "bench_kernels.json")])
    torch.cuda.synchronize()
    launches = {name: getattr(mod, attr) for name, (mod, attr)
                in ctr.items()}
    for name, c in launches.items():
        if c <= 0:
            raise AssertionError(f"benchmark: kernel {name} never launched")
    times = ("kernel_fwd_ms", "kernel_bwd_ms", "plain_fwd_ms",
             "plain_bwd_ms")
    tol = TOL[torch.float32]["atol"]
    assert tol == TOL[torch.float32]["rtol"]
    for section, cfgs in (("attention", BK.ATTENTION[False]),
                          ("rmsnorm", BK.RMSNORM[False]),
                          ("ssd", BK.SSD[False])):
        if len(res[section]) != len(cfgs):
            raise AssertionError(f"benchmark: {section} has "
                                 f"{len(res[section])} rows of {len(cfgs)}")
        for row in res[section]:
            if not all(np.isfinite(row.get(t, np.nan)) for t in times):
                raise AssertionError(f"benchmark: {section} row {row}")
            errs = [row["fwd_err"], *row["grad_err"].values()]
            if not all(e <= tol for e in errs):
                raise AssertionError(f"benchmark: {section} row {row}: "
                                     f"kernel vs plain over {tol}")
    ov = res["overlap"]
    ran = [c for c in ov["configs"] if "ms" in c]
    bad = [c for c in ran if not c["max_err"] <= 2e-5]
    if bad or not any(c["buffer_depth"] == 1 for c in ran) \
            or not any(c["buffer_depth"] >= 2 for c in ran):
        raise AssertionError(f"benchmark: overlap configs {ov['configs']}")
    skipped = [c for c in ov["configs"] if "skipped" in c]
    return {"launches": launches, "overlap": ov,
            "skipped": [(c["block_rows"], c["buffer_depth"])
                        for c in skipped],
            "errors": {s: max(max(r["fwd_err"], *r["grad_err"].values())
                              for r in res[s])
                       for s in ("attention", "rmsnorm", "ssd")},
            "rows": {s: len(res[s]) for s in ("attention", "rmsnorm",
                                              "ssd")}}


# --------------------------------------------------------------------- #
# phases 2 and 3: the engine
# --------------------------------------------------------------------- #

def requests(cfg, n=16, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = int(rng.integers(64, 769))
        out.append((rng.integers(0, cfg.vocab_size, s).astype(np.int32),
                    int(rng.integers(32, 129))))
    return out


def phase2(cfg, R, serving, kernel_modules):
    model = R.init_model(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    eng = serving.ServingEngine(cfg, model, decode_slots=8, page_size=16,
                                max_len=1024, dtype=torch.bfloat16)
    # warm-up (cuBLAS handles, allocator), outside the counted run
    eng.submit(serving.GenerationRequest(
        prompt=np.arange(64, dtype=np.int32), max_new_tokens=4))
    eng.drain()
    eng.reset()
    reqs = requests(cfg)
    for m in kernel_modules:
        m.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(serving.GenerationRequest(prompt=prompt,
                                                 max_new_tokens=n))
            for prompt, n in reqs]
    done = {r.rid: r for r in eng.drain()}
    results = [done.get(rid) for rid in rids]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {m.__name__.rsplit(".", 1)[-1]: m.launches
                for m in kernel_modules}

    if len(done) != len(reqs) or None in results:
        raise AssertionError(f"{len(done)} of {len(reqs)} finished")
    n_tok = 0
    for rid, res, (prompt, n) in zip(rids, results, reqs):
        toks = res.tokens
        if len(toks) != n or res.finish_reason != "length":
            raise AssertionError(f"rid {rid}: {len(toks)} tokens, "
                                 f"{res.finish_reason}, want {n}")
        if toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"rid {rid}: token out of [0, vocab)")
        n_tok += len(toks)
    if eng.pool.n_used != 0:
        raise AssertionError(f"{eng.pool.n_used} pages still in use")
    for name, c in launches.items():
        if c <= 0:
            raise AssertionError(f"kernel {name} never launched")
    return eng, {"requests": len(reqs), "tokens": n_tok,
            "prompt_tokens": int(sum(len(p) for p, _ in reqs)),
            "decode_steps": eng.steps, "wall_s": wall,
            "tok_per_s": n_tok / wall, "mean_occupancy":
            eng.mean_occupancy(), "launches": launches,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def profile_engine(cfg, eng, serving):
    """Where the time goes: torch.profiler over a short run of the warm
    phase-2 engine (8 more requests, 16 new tokens each).  Sums device
    time by kernel; the device's busy share is that sum over the wall
    time of the window (the profiler's own cost is in the wall time)."""
    from torch.profiler import ProfilerActivity, profile
    reqs = requests(cfg, n=8, seed=1)
    for prompt, _ in reqs:
        eng.submit(serving.GenerationRequest(prompt=prompt,
                                             max_new_tokens=16))
    torch.cuda.synchronize()
    steps0 = eng.steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.drain()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    steps = eng.steps - steps0
    avgs = prof.key_averages()
    kernels = []
    for e in avgs:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((e.self_device_time_total, e.key, e.count))
    kernels.sort(reverse=True)
    busy_us = sum(k[0] for k in kernels)
    with open(os.path.join(OUT_DIR, "profile.txt"), "w") as f:
        f.write(avgs.table(sort_by="self_device_time_total", row_limit=40))
        f.write("\n")
        f.write(avgs.table(sort_by="self_cpu_time_total", row_limit=40))
    decode_us = sum(us for us, name, _ in kernels
                    if "paged_decode_kernel" in name)
    return {"wall_us": wall_us, "device_busy_us": busy_us,
            "device_busy_share": busy_us / wall_us,
            "decode_steps": steps,
            "device_us_per_decode_step": busy_us / steps,
            "decode_kernel_us": decode_us,
            "decode_kernel_share_of_device": decode_us / busy_us,
            "top_kernels": [
                {"us": us, "name": name[:90], "count": n}
                for us, name, n in kernels[:12]]}


def phase3(cfg, R, serving, transformer):
    card = R.init_model(cfg, seed=1, dtype=torch.float32, device="cuda")
    cpu = transformer.Transformer(cfg, dtype=torch.float32, device="cpu")
    cpu.load_state_dict(card.state_dict())
    reqs = requests(cfg)[:2]
    out = {}
    for dev, model in (("cuda", card), ("cpu", cpu)):
        logits = []
        with torch.inference_mode():
            for prompt, _ in reqs:
                toks = torch.from_numpy(prompt.astype(np.int64))[None]
                lens = torch.tensor([len(prompt)], dtype=torch.int32)
                lg, _, _ = R.prefill_ragged(model, cfg, toks.to(dev),
                                            lens.to(dev))
                logits.append(lg.cpu())
        eng = serving.ServingEngine(cfg, model, decode_slots=2,
                                    page_size=16, max_len=1024,
                                    dtype=torch.float32)
        for prompt, _ in reqs:
            eng.submit(serving.GenerationRequest(prompt=prompt,
                                                 max_new_tokens=8))
        toks = {r.rid: r.tokens.tolist() for r in eng.drain()}
        out[dev] = (logits, toks)
    diff = max(float((a - b).abs().max())
               for a, b in zip(out["cuda"][0], out["cpu"][0]))
    if diff > 1e-3:
        raise AssertionError(f"first-token logits differ by {diff:.3g}")
    if out["cuda"][1] != out["cpu"][1]:
        raise AssertionError(f"tokens differ: card {out['cuda'][1]}, "
                             f"cpu {out['cpu'][1]}")
    return {"first_token_logit_max_abs_diff": diff,
            "tokens": out["cuda"][1]}


# --------------------------------------------------------------------- #
# phases 4 and 5: training
# --------------------------------------------------------------------- #

def counters(RN, FA):
    """Each training kernel's launch counter: (module, attribute)."""
    return {"rmsnorm_fwd": (RN, "launches"),
            "rmsnorm_bwd": (RN, "bwd_launches"),
            "flash_fwd": (FA, "launches"),
            "flash_bwd_dq": (FA, "dq_launches"),
            "flash_bwd_dkv": (FA, "dkv_launches")}


def run_ramp(run, ctr, *, fuse_steps, max_device_batch, want):
    """Train ``run`` on the card through ``Trainer`` over its whole Seesaw
    plan, on ``MarkovLM(2048, seed 0)``, with every engine call timed to
    a sync.  ``want`` = (batch sizes, steps per phase, micro-batches per
    step), checked before the run.  The launch counters ``ctr`` are set
    to 0 just before the run and read just after.  Checks that every
    loss and grad norm is finite and every step's LR, batch size and
    phase are the plan's; returns the trainer and the run's numbers."""
    from repro_torch.data import MarkovLM, PhaseDataLoader
    from repro_torch.train.trainer import Trainer
    tr = Trainer(run, device="cuda", fuse_steps=fuse_steps,
                 max_device_batch=max_device_batch)
    plan, eng, seq = tr.plan, tr.engine, run.seq_len
    steps = plan.steps_per_phase(seq)
    micro = [eng.micro_batches(b) for b in plan.batch_sizes()]
    if (plan.batch_sizes(), steps, micro) != want:
        raise AssertionError(f"plan: batches {plan.batch_sizes()}, steps "
                             f"{steps}, micro-batches {micro}; want {want}")
    loader = PhaseDataLoader(MarkovLM(2048, seed=0), plan, seq,
                             device="cuda")
    # each engine call timed to a sync: (batch size, steps, seconds)
    chunks = []
    run_chunk = eng.run_chunk

    def timed(model, opt_state, tokens_seen, stacked, n_valid=None,
              step=None):
        t = time.perf_counter()
        out = run_chunk(model, opt_state, tokens_seen, stacked,
                        n_valid=n_valid, step=step)
        torch.cuda.synchronize()
        chunks.append((next(iter(stacked.values())).shape[1], n_valid,
                       time.perf_counter() - t))
        return out

    eng.run_chunk = timed
    for mod, attr in ctr.values():
        setattr(mod, attr, 0)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = tr.run(loader)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: getattr(mod, attr) for name, (mod, attr)
                in ctr.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    eng.run_chunk = run_chunk

    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    if len(hist) != sum(steps) or not all(np.isfinite(losses + norms)):
        raise AssertionError(f"{len(hist)} steps, losses {losses}, grad "
                             f"norms {norms}")
    tok = 0
    for i, h in enumerate(hist):
        ph = plan.realized_phase_at(tok, seq)
        want_lr = float(eng.lr_fn(float(tok), i))
        if (h["lr"], h["batch_size"], h["phase"]) != \
                (want_lr, ph.batch_size, ph.index):
            raise AssertionError(f"step {i + 1}: lr {h['lr']}, batch "
                                 f"{h['batch_size']}, phase {h['phase']}; "
                                 f"plan {want_lr}, {ph.batch_size}, "
                                 f"{ph.index}")
        tok += ph.batch_size * seq
    # wall per step at each batch size; the first chunk (cuBLAS set-up,
    # the allocator's first growth) is left out of the first batch size's
    stats = {}
    for b in plan.batch_sizes():
        timed_chunks = [(n, dt) for i, (bb, n, dt) in enumerate(chunks)
                        if bb == b and not (i == 0 and len(chunks) > 1)]
        n = sum(c[0] for c in timed_chunks)
        sec = sum(c[1] for c in timed_chunks)
        stats[str(b)] = {"wall_s_per_step": sec / n,
                         "tok_per_s": b * seq * n / sec,
                         "steps_timed": n}
    mb = sum(n * m for n, m in zip(steps, micro))
    return tr, {"steps": len(hist), "plan_steps": steps,
                "batch_sizes": plan.batch_sizes(), "micro_batches": micro,
                "wall_s": wall, "tokens": hist[-1]["tokens"],
                "tok_per_s": hist[-1]["tokens"] / wall,
                "per_batch_size": stats, "peak_mem_gb": peak,
                "loss_first": losses[0], "loss_last": losses[-1],
                "loss_last3": float(np.mean(losses[-3:])),
                "losses": losses, "grad_norms": norms,
                "lrs": [h["lr"] for h in hist], "launches": launches,
                "chunks": chunks, "micro_batches_run": mb}


def check_launches(out, want_per_micro_batch):
    """The counts of the run must be exactly ``want`` per micro-batch."""
    mb = out["micro_batches_run"]
    want = {k: v * mb for k, v in want_per_micro_batch.items()}
    if out["launches"] != want:
        raise AssertionError(f"launches {out['launches']}, remat gives "
                             f"{want}")
    out["launches_per_micro_batch"] = want_per_micro_batch


def phase4(cfg, RN, FA):
    from repro_torch.configs import (OptimizerConfig, RunConfig,
                                     ScheduleConfig)
    run = RunConfig(model=cfg,
                    schedule=ScheduleConfig(kind="seesaw", alpha=2.0,
                                            n_cuts=2),
                    optimizer=OptimizerConfig(kind="adamw", beta1=0.9,
                                              beta2=0.95, grad_clip=1.0),
                    seq_len=1024, global_batch_size=8,
                    total_tokens=24 * 8 * 1024, dtype="bfloat16")
    tr, out = run_ramp(run, counters(RN, FA), fuse_steps=4,
                       max_device_batch=8,
                       want=([8, 16, 32], [16, 2, 1], [1, 2, 4]))
    losses = out["losses"]
    drop = losses[0] - float(np.mean(losses[-3:]))
    if drop < 0.5:
        raise AssertionError(f"loss fell {drop:.3f} < 0.5 nats: {losses}")
    L = cfg.n_layers
    check_launches(out, {"rmsnorm_fwd": 4 * L + 1, "rmsnorm_bwd": 2 * L + 1,
                         "flash_fwd": 2 * L, "flash_bwd_dq": L,
                         "flash_bwd_dkv": L})
    return tr, out


def profile_train(tr, step_s: float, batch: int, name: str):
    """Where the time goes: torch.profiler over one more optimizer step at
    the first batch size of the ramp on the trained model.  Device time
    by kernel; the busy share is that sum over the window's wall time,
    which holds the profiler's own host cost, and ``busy_share_of_step``
    the same sum over ``step_s``, the ramp's unprofiled wall time of a
    step at that batch size.  The table goes to ``chiprun_out/<name>``."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import MarkovLM
    raw = MarkovLM(2048, seed=1).sample(0, batch, tr.cfg.seq_len)
    batch = {k: torch.from_numpy(v.astype(np.int64))[None].cuda()
             for k, v in raw.items()}
    st = tr.state

    def one():
        tr.engine.run_chunk(st.model, st.opt_state, 0, batch, n_valid=1,
                            step=0)

    one()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        one()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    avgs = prof.key_averages()
    kernels = sorted(((e.self_device_time_total, e.key, e.count)
                      for e in avgs
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     reverse=True)
    busy_us = sum(k[0] for k in kernels)
    host_launches = sum(e.count for e in avgs if e.key == "cudaLaunchKernel")
    with open(os.path.join(OUT_DIR, name), "w") as f:
        f.write(avgs.table(sort_by="self_device_time_total", row_limit=50))
    return {"wall_us": wall_us, "device_busy_us": busy_us,
            "device_busy_share": busy_us / wall_us,
            "busy_share_of_step": busy_us / (step_s * 1e6),
            "device_kernels": sum(k[2] for k in kernels),
            "cuda_launch_kernel_calls": host_launches,
            "top_kernels": [{"us": us, "name": name[:70], "count": n}
                            for us, name, n in kernels[:15]]}


def phase5(cfg, R, O):
    """seesaw-150m widths at 2 layers, float32, on the card and the CPU
    with the same weights: loss, grads, and AdamW on the same grads."""
    import dataclasses
    from repro_torch.data import MarkovLM
    small = dataclasses.replace(cfg, n_layers=2)
    cpu = R.init_model(small, seed=3, dtype=torch.float32, device="cpu",
                       trainable=True)
    card = R.init_model(small, seed=3, dtype=torch.float32, device="cpu",
                        trainable=True).cuda()
    raw = MarkovLM(2048, seed=2).sample(0, 2, 256)
    out = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        batch = {k: torch.from_numpy(v.astype(np.int64)).to(dev)
                 for k, v in raw.items()}
        loss, _ = R.loss_fn(model, small, batch, dtype=torch.float32)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[dev] = (float(loss.detach()), [g.cpu() for g in grads])
    loss_diff = abs(out["cpu"][0] - out["cuda"][0])
    if loss_diff > 1e-4:
        raise AssertionError(f"loss differs by {loss_diff:.3g}")
    grad_rel = 0.0
    for (name, _), a, b in zip(cpu.named_parameters(), out["cpu"][1],
                               out["cuda"][1]):
        rel = float((a - b).abs().max() / a.abs().max().clamp(min=1e-30))
        if rel > 1e-3:
            raise AssertionError(f"grad of {name}: {rel:.3g} of its max")
        grad_rel = max(grad_rel, rel)
    params = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        opt = O.adamw()
        p = dict(model.named_parameters())
        grads = {n: g.to(dev) for n, g in zip(p, out["cpu"][1])}
        opt.update(grads, opt.init(p), p, torch.tensor(1e-3))
        params[dev] = [t.detach().cpu() for t in p.values()]
    upd = max(float((a - b).abs().max())
              for a, b in zip(params["cpu"], params["cuda"]))
    if upd > 1e-6:
        raise AssertionError(f"AdamW update differs by {upd:.3g}")
    return {"loss_cpu": out["cpu"][0], "loss_cuda": out["cuda"][0],
            "loss_abs_diff": loss_diff, "grad_max_rel_diff": grad_rel,
            "adamw_param_max_abs_diff": upd}


# --------------------------------------------------------------------- #
# phases 6 and 7: Mamba-2 training
# --------------------------------------------------------------------- #

def mamba2_counters(RN, FA, SSD):
    """The launch counters phase 6 reads: Mamba-2's kernels, and the flash
    kernels, which it must not launch."""
    return {"ssd_chunk": (SSD, "launches"),
            "rmsnorm_fwd": (RN, "launches"),
            "rmsnorm_bwd": (RN, "bwd_launches"),
            "flash_fwd": (FA, "launches"),
            "flash_bwd_dq": (FA, "dq_launches"),
            "flash_bwd_dkv": (FA, "dkv_launches")}


def phase6(cfg, RN, FA, SSD):
    from repro_torch.configs import (OptimizerConfig, RunConfig,
                                     ScheduleConfig)
    # base LR 8e-4: five times GPT-3's 2.7B rate, the Mamba recipe
    run = RunConfig(model=cfg,
                    schedule=ScheduleConfig(kind="seesaw", base_lr=8e-4,
                                            alpha=2.0, n_cuts=2),
                    optimizer=OptimizerConfig(kind="adamw", beta1=0.9,
                                              beta2=0.95, grad_clip=1.0),
                    seq_len=2048, global_batch_size=4,
                    total_tokens=11 * 4 * 2048, dtype="bfloat16")
    tr, out = run_ramp(run, mamba2_counters(RN, FA, SSD), fuse_steps=1,
                       max_device_batch=4,
                       want=([4, 8, 16], [7, 1, 1], [1, 2, 4]))
    if not out["loss_last"] < out["loss_first"]:
        raise AssertionError(f"last loss {out['loss_last']} not below the "
                             f"first {out['loss_first']}")
    L = cfg.n_layers
    check_launches(out, {"ssd_chunk": 2 * L, "rmsnorm_fwd": 4 * L + 1,
                         "rmsnorm_bwd": 2 * L + 1, "flash_fwd": 0,
                         "flash_bwd_dq": 0, "flash_bwd_dkv": 0})
    out["param_count"] = sum(p.numel() for p in tr.state.model.parameters())
    return tr, out


def phase7(R):
    """The reduced mamba2 (2 layers, d=256, 8 heads, d_state 16, chunk 32)
    in float32 on the card and on the CPU with the same weights: the loss
    and every grad, S=200 (a ragged last chunk)."""
    from repro_torch.configs import get_config
    from repro_torch.data import MarkovLM
    small = get_config("mamba2-2.7b").reduced()
    cpu = R.init_model(small, seed=4, dtype=torch.float32, device="cpu",
                       trainable=True)
    card = R.init_model(small, seed=4, dtype=torch.float32, device="cpu",
                        trainable=True).cuda()
    raw = MarkovLM(small.vocab_size, seed=3).sample(0, 2, 200)
    out = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        batch = {k: torch.from_numpy(v.astype(np.int64)).to(dev)
                 for k, v in raw.items()}
        loss, _ = R.loss_fn(model, small, batch, dtype=torch.float32)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[dev] = (float(loss.detach()), [g.cpu() for g in grads])
    loss_diff = abs(out["cpu"][0] - out["cuda"][0])
    if loss_diff > 1e-4:
        raise AssertionError(f"loss differs by {loss_diff:.3g}")
    grad_rel = 0.0
    for (name, _), a, b in zip(cpu.named_parameters(), out["cpu"][1],
                               out["cuda"][1]):
        rel = float((a - b).abs().max() / a.abs().max().clamp(min=1e-30))
        if rel > 1e-3:
            raise AssertionError(f"grad of {name}: {rel:.3g} of its max")
        grad_rel = max(grad_rel, rel)
    return {"loss_cpu": out["cpu"][0], "loss_cuda": out["cuda"][0],
            "loss_abs_diff": loss_diff, "grad_max_rel_diff": grad_rel}


# --------------------------------------------------------------------- #

def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; the port's kernels run only on "
            "an NVIDIA card")
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import overlap as OV
    from repro_torch.kernels import paged as PG
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import ssd as SSD
    from repro_torch.models import registry as R
    from repro_torch.models import transformer
    from repro_torch.optim import optimizers as O
    from repro_torch import serving

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(OUT_DIR, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    record = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda}

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    record["build_s"] = time.perf_counter() - t0
    record["ptxas"] = [ln for ln in lib.with_suffix(".ptxas.txt")
                       .read_text().splitlines()
                       if "registers" in ln or "spill" in ln]
    log(f"build: {record['build_s']:.1f} s")
    for ln in record["ptxas"]:
        log(f"  {ln.strip()}")
    record["compiled"] = compiled_report(_build, lib)
    log(f"compiled: {record['compiled']}")

    t = time.perf_counter()
    errors, inputs = phase1(RN, FA, PG, ref)
    times = measure(RN, FA, PG, ref, serving.cache, inputs)
    del inputs
    record["phase1"] = {"errors": errors, "times": times,
                        "s": time.perf_counter() - t}
    log(f"phase 1: {record['phase1']['s']:.1f} s")
    t = time.perf_counter()
    bwd_errors, inputs = phase1b(RN, FA, ref)
    bwd_times = measure_bwd(RN, FA, ref, inputs)
    del inputs
    torch.cuda.empty_cache()
    record["phase1b"] = {"errors": bwd_errors, "times": bwd_times,
                         "s": time.perf_counter() - t}
    log(f"phase 1b: {record['phase1b']['s']:.1f} s {bwd_times}")
    t = time.perf_counter()
    ssd_errors, ssd_f64, inputs = phase1c(SSD, RN, ref)
    ssd_times = measure_ssd(SSD, RN, ref, inputs)
    del inputs
    torch.cuda.empty_cache()
    record["phase1c"] = {"errors": ssd_errors, "vs_float64": ssd_f64,
                         "times": ssd_times, "s": time.perf_counter() - t}
    log(f"phase 1c: {record['phase1c']['s']:.1f} s {ssd_times}")
    t = time.perf_counter()
    ov_errors, ov_probes = phase1d(OV, ref)
    record["phase1d"] = {"errors": ov_errors, "probes": ov_probes,
                         "s": time.perf_counter() - t}
    log(f"phase 1d: {record['phase1d']['s']:.1f} s")
    OV.launches = 0         # phases 2-7 must not launch it

    cfg = get_config("seesaw-150m")
    t = time.perf_counter()
    eng, record["engine"] = phase2(cfg, R, serving, (RN, FA, PG))
    log(f"phase 2: {time.perf_counter() - t:.1f} s {record['engine']}")
    eng.reset()
    record["profile"] = profile_engine(cfg, eng, serving)
    del eng
    log(f"profile: {record['profile']}")
    t = time.perf_counter()
    record["card_vs_cpu"] = phase3(cfg, R, serving, transformer)
    log(f"phase 3: {time.perf_counter() - t:.1f} s {record['card_vs_cpu']}")
    t = time.perf_counter()
    tr, record["train"] = phase4(cfg, RN, FA)
    log(f"phase 4: {time.perf_counter() - t:.1f} s {record['train']}")
    record["train_profile"] = profile_train(
        tr, record["train"]["per_batch_size"]["8"]["wall_s_per_step"], 8,
        "profile_train.txt")
    log(f"train profile: {record['train_profile']}")
    del tr
    torch.cuda.empty_cache()
    t = time.perf_counter()
    record["train_card_vs_cpu"] = phase5(cfg, R, O)
    log(f"phase 5: {time.perf_counter() - t:.1f} s "
        f"{record['train_card_vs_cpu']}")
    torch.cuda.empty_cache()
    mcfg = get_config("mamba2-2.7b")
    t = time.perf_counter()
    tr, record["mamba2"] = phase6(mcfg, RN, FA, SSD)
    record["mamba2"]["s"] = time.perf_counter() - t
    log(f"phase 6: {record['mamba2']['s']:.1f} s {record['mamba2']}")
    record["mamba2_profile"] = profile_train(
        tr, record["mamba2"]["per_batch_size"]["4"]["wall_s_per_step"], 4,
        "profile_mamba2.txt")
    log(f"mamba2 profile: {record['mamba2_profile']}")
    del tr
    torch.cuda.empty_cache()
    t = time.perf_counter()
    record["mamba2_card_vs_cpu"] = phase7(R)
    log(f"phase 7: {time.perf_counter() - t:.1f} s "
        f"{record['mamba2_card_vs_cpu']}")
    if OV.launches:
        raise AssertionError(f"overlap_norm launched {OV.launches} times "
                             f"on the serving and training paths")
    t = time.perf_counter()
    bench_ctr = dict(counters(RN, FA), ssd_chunk=(SSD, "launches"),
                     overlap_norm=(OV, "launches"))
    record["bench_kernels"] = phase8(bench_ctr)
    record["bench_kernels"]["s"] = time.perf_counter() - t
    log(f"phase 8: {record['bench_kernels']['s']:.1f} s "
        f"{record['bench_kernels']['launches']} "
        f"{record['bench_kernels']['errors']}")

    launches = record["engine"]["launches"]
    train_launches = record["train"]["launches"]
    err_of = {(n, tag, dn): e
              for n, tag, dn, e in errors + bwd_errors + ssd_errors}
    kernels = []
    for name, mod, src, replaces, key, tag in (
            ("rmsnorm_fwd", "rmsnorm", "src/repro_torch/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm.py:30", "rmsnorm_fwd/prefill",
             "prefill"),
            ("flash_fwd", "flash_attention",
             "src/repro_torch/csrc/flash_fwd.cu",
             "src/repro/kernels/flash_attention.py:58", "flash_fwd",
             "seesaw"),
            ("ragged_decode", "paged", "src/repro_torch/csrc/paged_decode.cu",
             "src/repro/kernels/paged.py:32", "ragged_decode", "seesaw")):
        tm = times[key]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": launches[mod],
                 "max_abs_err": err_of[(name, tag, "bfloat16")],
                 "max_abs_err_f32": err_of[(name, tag, "float32")],
                 "ms": tm["ms"],
                 "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
                 "bound_by": tm["bound_by"], "library_ms": tm["library_ms"],
                 "host_us": tm["host_us"],
                 "library_host_us": tm["library_host_us"],
                 "shape": tm["shape"]}
        if name == "flash_fwd":
            tr = bwd_times["flash_fwd/train"]
            entry.update(train_shape_max_abs_err=err_of[
                             ("flash_fwd", "bwd-seesaw", "bfloat16")],
                         train_shape_max_abs_err_f32=err_of[
                             ("flash_fwd", "bwd-seesaw", "float32")],
                         train_shape_ms=tr["ms"],
                         train_shape_library_ms=tr["library_ms"],
                         train_shape_bound_ms=tr["bound_ms"],
                         train_shape=tr["shape"])
        if name == "ragged_decode":
            pg, ga = times["ragged_decode/paged"], times["gather_pages"]
            paged = [e for n, _, _, e in errors if n == "paged_decode"]
            entry.update(
                paged_ms=pg["ms"], paged_plain_ms=pg["plain_ms"],
                paged_bound_ms=pg["bound_ms"], paged_host_us=pg["host_us"],
                paged_max_abs_err=max(
                    e for n, _, dn, e in errors
                    if n == "paged_decode" and dn == "bfloat16"),
                paged_max_abs_err_f32=max(
                    e for n, _, dn, e in errors
                    if n == "paged_decode" and dn == "float32"),
                paged_cases=len(paged),
                paged_vs_gathered_max_abs_err=pg["max_abs_err_vs_gathered"],
                paged_shape=pg["shape"],
                **{f"{t}_{f}": times[f"ragged_decode/{t}"][f]
                   for t in ("one_split", "full_window")
                   for f in ("ms", "bound_ms", "library_ms")},
                gather_pages_ms=ga["ms"],
                gather_pages_bound_ms=ga["bound_ms"],
                gather_pages_shape=ga["shape"])
        if name == "rmsnorm_fwd":
            dec = times["rmsnorm_fwd/decode"]
            tr = bwd_times["rmsnorm_fwd/train"]
            entry.update(decode_rows_ms=dec["ms"],
                         decode_rows_bound_ms=dec["bound_ms"],
                         decode_rows_library_ms=dec["library_ms"],
                         train_shape_ms=tr["ms"],
                         train_shape_plain_ms=tr["plain_ms"],
                         train_shape_bound_ms=tr["bound_ms"],
                         train_shape_library_ms=tr["library_ms"],
                         train_shape=tr["shape"])
        if name in train_launches:
            entry["train_launches"] = train_launches[name]
        if name == "flash_fwd":
            entry["compiled"] = {k: v for k, v in record["compiled"].items()
                                 if k.startswith("flash_fwd")}
        kernels.append(entry)
    for name, src, replaces, tag in (
            ("rmsnorm_bwd", "src/repro_torch/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm.py:38", "train"),
            ("flash_bwd_dq", "src/repro_torch/csrc/flash_bwd.cu",
             "src/repro/kernels/flash_attention.py:161", "seesaw"),
            ("flash_bwd_dkv", "src/repro_torch/csrc/flash_bwd.cu",
             "src/repro/kernels/flash_attention.py:200", "seesaw")):
        tm = bwd_times[name]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": train_launches[name],
                 "max_abs_err": err_of[(name, tag, "bfloat16")],
                 "max_abs_err_f32": err_of[(name, tag, "float32")],
                 "ms": tm["ms"], "plain_ms": tm["plain_ms"],
                 "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
                 "library_ms": tm["library_ms"], "host_us": tm["host_us"],
                 "shape": tm["shape"]}
        if name == "rmsnorm_bwd":
            entry["dscale_rel_err"] = err_of[("rmsnorm_bwd/dscale_rel",
                                              tag, "bfloat16")]
            entry["dscale_rel_err_f32"] = err_of[("rmsnorm_bwd/dscale_rel",
                                                  tag, "float32")]
            entry["few_rows_max_abs_err"] = err_of[("rmsnorm_bwd",
                                                    "few-rows", "bfloat16")]
            entry["compiled"] = {k: v for k, v in record["compiled"].items()
                                 if k.startswith(name)}
        else:
            entry["plain_and_library_compute"] = "dq, dk and dv together"
            entry["flash_bwd_ms"] = bwd_times["flash_bwd"]["ms"]
            entry["compiled"] = {k: v for k, v in record["compiled"].items()
                                 if k.startswith(name)}
        kernels.append(entry)
    tm = ssd_times["ssd_chunk"]
    kernels.append({
        "name": "ssd_chunk", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd.py:28",
        "launches": record["mamba2"]["launches"]["ssd_chunk"],
        "max_abs_err": err_of[("ssd_chunk", "2.7b", "bfloat16")],
        "max_abs_err_f32": err_of[("ssd_chunk", "2.7b", "float32")],
        "max_abs_err_small_decay": err_of[("ssd_chunk", "ragged",
                                           "bfloat16")],
        "vs_float64": [r for r in ssd_f64 if r["shape"] == "2.7b"],
        "ms": tm["ms"], "plain_ms": tm["plain_ms"],
        "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
        "library_ms": None, "library_note": tm["library_note"],
        "tflops": tm["tflops"], "host_us": tm["host_us"],
        "shape": tm["shape"],
        "compiled": {k: v for k, v in record["compiled"].items()
                     if k.startswith("ssd_chunk")}})
    for k in kernels:
        if k["name"] in ("rmsnorm_fwd", "rmsnorm_bwd"):
            k["mamba2_launches"] = record["mamba2"]["launches"][k["name"]]
            for d in (2560, 5120):
                tm = ssd_times[f"{k['name']}/mamba2-d{d}"]
                k[f"mamba2_d{d}"] = {
                    "ms": tm["ms"], "plain_ms": tm["plain_ms"],
                    "library_ms": tm["library_ms"],
                    "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
                    "max_abs_err": err_of[(k["name"], f"mamba2-d{d}",
                                           "bfloat16")],
                    "max_abs_err_f32": err_of[(k["name"], f"mamba2-d{d}",
                                               "float32")]}
    ov = record["bench_kernels"]["overlap"]
    best = ov["best"]
    kernels.append({
        "name": "overlap_norm", "route": "cuda",
        "source": "src/repro_torch/csrc/overlap.cu",
        "replaces": "benchmarks/bench_kernels.py:187",
        "launches": record["bench_kernels"]["launches"]["overlap_norm"],
        "max_abs_err": max(c["max_err"] for c in ov["configs"]
                           if "ms" in c),
        "max_abs_err_f32": max(e for n, d, b, k, e in ov_errors
                               if e is not None and (n, d) == (8192, 512)),
        "ms": best["ms"], "depth1_ms": ov["depth1_ms"],
        "block_rows": best["block_rows"], "depth": best["buffer_depth"],
        "plain_ms": ov["plain_ms"], "bound_ms": ov["bound_ms"],
        "bound_by": ov["bound_by"], "library_ms": ov["library_ms"],
        **ov_probes,
        "skipped_over_budget": record["bench_kernels"]["skipped"],
        "serving_and_training_launches": 0,
        "shape": f"x ({ov['rows']}, {ov['d']}) float32, the kernel "
                 f"benchmark's path (phase 8)"})
    record["kernels"] = kernels
    record["total_s"] = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"engine": record["engine"],
                      "card_vs_cpu": record["card_vs_cpu"]}))
    long = ("losses", "lrs", "chunks", "grad_norms")
    train = {k: v for k, v in record["train"].items() if k not in long}
    print(json.dumps({"train": train, "profile": record["train_profile"],
                      "card_vs_cpu": record["train_card_vs_cpu"]}))
    mamba2 = {k: v for k, v in record["mamba2"].items() if k not in long}
    print(json.dumps({"mamba2": mamba2,
                      "profile": record["mamba2_profile"],
                      "card_vs_cpu": record["mamba2_card_vs_cpu"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
