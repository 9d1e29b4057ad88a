#!/usr/bin/env python3
"""Build the port's CUDA kernels, check them, serve seesaw-150m and train
it with a Seesaw batch ramp on one NVIDIA card.

    python3 chip_smoke.py

Imports nothing of JAX and nothing of the JAX package ``repro``; it runs
``src/repro_torch`` from this checkout.

- Build: nvcc compiles ``src/repro_torch/csrc`` for sm_90a (one process
  per source, in parallel) into ``build/kernels``.
- Phase 1, kernels against their plain versions: RMSNorm forward, the
  causal GQA flash forward and the ragged paged decode, each on the
  serving path's shapes (seesaw-150m prefill at S=1024, decode at 8 slots
  over a 1024-token window with ragged lengths) and on llama3.2-3b's GQA
  heads (H=24, Hkv=8, hd=128), in float32 (tolerance 2e-5) and bfloat16
  (2e-2), TF32 off.  Then each kernel (``ms``), its plain version
  (``plain_ms``) and one PyTorch call that computes the same function
  (``library_ms``, a yardstick the port never calls) are timed with CUDA
  events, L2 flushed before every launch and the host's enqueue hidden
  behind a device spin (``Timer``), at the serving path's shapes in
  bfloat16.
- Phase 2, the engine: ``get_config("seesaw-150m")`` unreduced, random
  weights from a seed, bfloat16, 8 decode slots, page 16, max_len 1024;
  16 seeded requests with prompts of 64-768 tokens and 32-128 new
  tokens, EOS off.  Every request must finish with exactly its
  max_new_tokens tokens in [0, vocab) and the pool must drain to 0 pages.
  The kernels' launch counts are set to 0 just before this run and read
  just after; each must be > 0.
- Phase 3, the card against the CPU: two of those requests, 8 new tokens
  each, in float32 through the same engine on the card (kernels) and on
  the CPU (plain versions), same weights.  First-token logits must agree
  within 1e-3 and the greedy tokens must be equal.
- Phase 1b, the backward kernels against their plain versions: RMSNorm
  backward at the training rows (8·1024 × 1024) and at (1000 × 3072);
  the flash backward (dq, dk/dv) at seesaw-150m's training shapes (B=8,
  S=1024, H=Hkv=16, hd=64) and at llama3.2-3b's GQA heads with a ragged
  S=1000; float32 (2e-5) and bfloat16 (2e-2), TF32 off.  RMSNorm's
  dscale, a float32 sum over all rows, is held to 2e-5 of the sum of its
  terms' magnitudes.  Then each is timed as in phase 1 at the training
  shapes in bfloat16; ``library_ms`` is ``torch.autograd.grad`` through
  ``F.rms_norm`` and through ``F.scaled_dot_product_attention``, the
  forward outside the timed call.
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

Prints the card's name and power limit, one ``kernels`` JSON line, one
``engine`` and one ``train`` JSON line, and last ``{"ok": true,
"device": {...}}``; the full record goes to
``chiprun_out/chip_smoke.json``.  Any failed check
raises, so the script exits non-zero before the last line.  Without a
CUDA device it exits with code 2 and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
DTYPES = (torch.float32, torch.bfloat16)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# --------------------------------------------------------------------- #
# timing and bounds
# --------------------------------------------------------------------- #

class Timer:
    """Device time of one call: CUDA events around each call, median of
    ``iters``.  Before each call the queue is drained, a 64 MB write
    leaves the 50 MB L2 cold,
    as the bound assumes, and a device spin keeps the card busy while the
    host enqueues the call, so the events bracket the call's kernels and
    not the host's time to launch them.  The spin is sized from the
    call's own host time (four times ``host_us`` plus 50 us), and each
    call's enqueue time is measured: a timing counts only if the host
    finished enqueuing within three quarters of the spin, and if fewer
    than half do, the spin doubles and the timing is made again.

    ``host_us`` is the mean wall time of one call with the queue never
    drained in between: what a decode step pays per call when the card
    waits for the host."""

    def __init__(self, iters: int = 30, warmup: int = 3):
        self.iters, self.warmup = iters, warmup
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        # clock cycles of torch.cuda._sleep per microsecond
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        torch.cuda._sleep(4_000_000)
        end.record()
        torch.cuda.synchronize()
        self.cycles_per_us = 4_000_000 / (start.elapsed_time(end) * 1e3)

    def __call__(self, fn) -> float:
        for _ in range(self.warmup):
            fn()
        spin_us = 4 * self.host_us(fn, calls=20) + 50
        for _ in range(6):
            ev = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(self.iters)]
            enqueue_us = []
            for start, end in ev:
                torch.cuda.synchronize()        # an empty queue each time
                self.flush.zero_()
                torch.cuda._sleep(int(spin_us * self.cycles_per_us))
                t = time.perf_counter()
                start.record()
                fn()
                end.record()
                enqueue_us.append((time.perf_counter() - t) * 1e6)
            torch.cuda.synchronize()
            on_time = [s.elapsed_time(e) for (s, e), u in zip(ev, enqueue_us)
                       if u < 0.75 * spin_us]
            if 2 * len(on_time) >= self.iters:
                return float(np.median(on_time))
            spin_us *= 2
        raise RuntimeError("timer: the host never got ahead of the device")

    def host_us(self, fn, calls: int = 200) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        t = time.perf_counter() - t
        torch.cuda.synchronize()
        return t / calls * 1e6


def bound(n_bytes: float, n_ops: float, dtype) -> dict:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": n_ops}


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
    return (q, k, v, lengths, lens), err


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
                                      (1, 1000, 24, 8, 128, "llama")):
            t, err = flash_case(FA, ref, B, S, H, Hkv, hd, dtype, g)
            errors.append(("flash_fwd", tag, dn, err))
            inputs[("flash_fwd", tag, dn)] = t
        for B, Skv, H, Hkv, hd, tag in ((8, 1024, 16, 16, 64, "seesaw"),
                                        (8, 1008, 24, 8, 128, "llama")):
            t, err = decode_case(PG, ref, B, Skv, H, Hkv, hd, dtype, g, rng)
            errors.append(("ragged_decode", tag, dn, err))
            inputs[("ragged_decode", tag, dn)] = t
    for name, tag, dn, err in errors:
        log(f"phase 1: {name} {tag} {dn}: max |err| {err:.3g}")
    return errors, inputs


def measure(RN, FA, PG, ref, inputs):
    """Kernel, plain and library times at the serving path's shapes in
    bfloat16, each with its bound."""
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

    q, k, v, lengths, lens = inputs[("ragged_decode", "seesaw", "bfloat16")]
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
                             (1000, 3072, "llama")):
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
                                      (1, 1000, 24, 8, 128, "llama")):
            q, k, v, do = (torch.randn(B, S, n, hd, generator=g,
                                       device="cuda").to(dtype)
                           for n in (H, Hkv, Hkv, H))
            qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
            out, lse = FA.flash_fwd(qt, kt, vt)
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
        shape=f"x, g ({n}, {d}) bf16; ms includes summing the per-block "
              f"dscale partials",
        **bound(3 * n * d * es + 8 * d, 12 * n * d, bf))
    del xr, w, y

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
    return rows


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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.drain()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
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
    return {"wall_us": wall_us, "device_busy_us": busy_us,
            "device_busy_share": busy_us / wall_us,
            "decode_steps": eng.steps, "top_kernels": [
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


def phase4(cfg, RN, FA):
    from repro_torch.configs import (OptimizerConfig, RunConfig,
                                     ScheduleConfig)
    from repro_torch.data import MarkovLM, PhaseDataLoader
    from repro_torch.train.trainer import Trainer
    run = RunConfig(model=cfg,
                    schedule=ScheduleConfig(kind="seesaw", alpha=2.0,
                                            n_cuts=2),
                    optimizer=OptimizerConfig(kind="adamw", beta1=0.9,
                                              beta2=0.95, grad_clip=1.0),
                    seq_len=1024, global_batch_size=8,
                    total_tokens=24 * 8 * 1024, dtype="bfloat16")
    tr = Trainer(run, device="cuda", fuse_steps=4, max_device_batch=8)
    plan, eng, seq = tr.plan, tr.engine, run.seq_len
    steps = plan.steps_per_phase(seq)
    micro = [eng.micro_batches(b) for b in plan.batch_sizes()]
    if plan.batch_sizes() != [8, 16, 32] or steps != [16, 2, 1] \
            or micro != [1, 2, 4]:
        raise AssertionError(f"plan: batches {plan.batch_sizes()}, steps "
                             f"{steps}, micro-batches {micro}")
    loader = PhaseDataLoader(MarkovLM(2048, seed=0), plan, seq,
                             device="cuda")
    ctr = counters(RN, FA)
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
    if len(hist) != sum(steps) or not all(np.isfinite(losses)):
        raise AssertionError(f"{len(hist)} steps, losses {losses}")
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
    drop = losses[0] - float(np.mean(losses[-3:]))
    if drop < 0.5:
        raise AssertionError(f"loss fell {drop:.3f} < 0.5 nats: {losses}")
    L, mb = cfg.n_layers, sum(n * m for n, m in zip(steps, micro))
    want = {"rmsnorm_fwd": (4 * L + 1) * mb, "rmsnorm_bwd": (2 * L + 1) * mb,
            "flash_fwd": 2 * L * mb, "flash_bwd_dq": L * mb,
            "flash_bwd_dkv": L * mb}
    if launches != want:
        raise AssertionError(f"launches {launches}, remat gives {want}")

    # wall per step at each batch size; the first chunk (cuBLAS set-up,
    # the allocator's first growth) is left out of B=8's
    stats = {}
    for b in plan.batch_sizes():
        timed_chunks = [(n, dt) for i, (bb, n, dt) in enumerate(chunks)
                        if bb == b and not (i == 0 and len(chunks) > 1)]
        n = sum(c[0] for c in timed_chunks)
        sec = sum(c[1] for c in timed_chunks)
        stats[str(b)] = {"wall_s_per_step": sec / n,
                         "tok_per_s": b * seq * n / sec,
                         "steps_timed": n}
    return tr, {"steps": len(hist), "plan_steps": steps,
                "batch_sizes": plan.batch_sizes(), "micro_batches": micro,
                "wall_s": wall, "tokens": hist[-1]["tokens"],
                "tok_per_s": hist[-1]["tokens"] / wall,
                "per_batch_size": stats, "peak_mem_gb": peak,
                "loss_first": losses[0], "loss_last3": float(
                    np.mean(losses[-3:])), "losses": losses,
                "lrs": [h["lr"] for h in hist], "launches": launches,
                "chunks": chunks,
                "launches_per_micro_batch": {k: v // mb for k, v in
                                             want.items()},
                "micro_batches_run": mb}


def profile_train(tr, step_s: float):
    """Where the time goes: torch.profiler over one more optimizer step at
    B=8 on the trained model.  Device time by kernel; the busy share is
    that sum over the window's wall time, which holds the profiler's own
    host cost, and ``busy_share_of_step`` the same sum over ``step_s``,
    phase 4's unprofiled wall time of a B=8 step."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import MarkovLM
    raw = MarkovLM(2048, seed=1).sample(0, 8, tr.cfg.seq_len)
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
    with open(os.path.join(OUT_DIR, "profile_train.txt"), "w") as f:
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

def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; the port's kernels run only on "
            "an NVIDIA card")
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged as PG
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as RN
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

    t = time.perf_counter()
    errors, inputs = phase1(RN, FA, PG, ref)
    times = measure(RN, FA, PG, ref, inputs)
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
        tr, record["train"]["per_batch_size"]["8"]["wall_s_per_step"])
    log(f"train profile: {record['train_profile']}")
    del tr
    torch.cuda.empty_cache()
    t = time.perf_counter()
    record["train_card_vs_cpu"] = phase5(cfg, R, O)
    log(f"phase 5: {time.perf_counter() - t:.1f} s "
        f"{record['train_card_vs_cpu']}")

    launches = record["engine"]["launches"]
    train_launches = record["train"]["launches"]
    err_of = {(n, tag, dn): e for n, tag, dn, e in errors + bwd_errors}
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
        if name == "rmsnorm_fwd":
            dec = times["rmsnorm_fwd/decode"]
            entry.update(decode_rows_ms=dec["ms"],
                         decode_rows_bound_ms=dec["bound_ms"],
                         decode_rows_library_ms=dec["library_ms"])
        if name in train_launches:
            entry["train_launches"] = train_launches[name]
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
        else:
            entry["plain_and_library_compute"] = "dq, dk and dv together"
            entry["flash_bwd_ms"] = bwd_times["flash_bwd"]["ms"]
        kernels.append(entry)
    record["kernels"] = kernels
    record["total_s"] = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"engine": record["engine"],
                      "card_vs_cpu": record["card_vs_cpu"]}))
    train = {k: v for k, v in record["train"].items()
             if k not in ("losses", "lrs", "chunks")}
    print(json.dumps({"train": train, "profile": record["train_profile"],
                      "card_vs_cpu": record["train_card_vs_cpu"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
