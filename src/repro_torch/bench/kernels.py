"""Per-kernel sweeps and a copy/compute-overlap profile, on the card.

The counterpart of ``benchmarks/bench_kernels.py``, with its function
names, shapes and analytic columns:

1. **Kernel sweeps**: forward, and forward plus backward (autograd
   through ``kernels.backend``, as the reference times ``jax.grad``), of
   flash attention, RMSNorm and the SSD across the reference's configs,
   float32, for the port's kernels (``kernel_*``) and their plain
   PyTorch versions (``plain_*``, where the reference has ``xla_*``),
   with FLOP and byte counts that place each row on a roofline.  Each
   row also holds the kernels' outputs and grads against the plain
   version's on the same inputs (``fwd_err``, ``grad_err``; see
   ``rel_err``).  The backward is the backward kernels for RMSNorm and
   attention, and the plain recompute for the SSD, as on the training
   path.  The port's kernels take no block size: configs that differ
   only in the reference's ``block``/``block_rows`` are timed once, and
   each row names the port's fixed tile (``port_tile``).
2. **Overlap profile**: the streaming normalize ``kernels.overlap``
   (a ring of shared-memory stages filled and drained by bulk
   asynchronous copies) swept over block rows × depth.  Depth 1
   serializes copies and compute; the depth where the curve flattens is
   the latency-hiding knee.  Block rows are sized for one SM's share of
   the rows; a config whose stages exceed the card's opt-in shared
   memory per block is recorded as skipped and not run.

    PYTHONPATH=src python -m repro_torch.bench.kernels [--ci] \\
        [--device cuda|cpu] [--out chiprun_out/bench_kernels.json]

On the card times are device times (``bench.timing.Timer``: CUDA
events, L2 flushed, the host's enqueue hidden).  ``--device cpu`` runs
the plain versions in both columns, timed by the host's clock, and
skips the overlap profile.  ``--ci`` shrinks every sweep.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch
import torch.nn.functional as F

from repro_torch.kernels import backend as KB
from repro_torch.kernels import ref

# The reference's configs; the block / block_rows / chunk column is last
ATTENTION = {True: [(1, 4, 2, 128, 64, 64)],
             False: [(1, 4, 2, 256, 64, 64), (1, 4, 2, 256, 64, 128),
                     (1, 8, 2, 512, 64, 128), (2, 4, 4, 256, 64, 64)]}
RMSNORM = {True: [(1024, 256, 256)],
           False: [(4096, 512, 128), (4096, 512, 256), (4096, 512, 512),
                   (16384, 1024, 256)]}
SSD = {True: [(1, 128, 2, 32, 16, 32)],
       False: [(1, 256, 4, 64, 32, 64), (1, 256, 4, 64, 32, 128),
               (2, 512, 4, 64, 32, 128)]}
CONFIG_KEYS = {"attention": ("B", "H", "Hkv", "S", "head_dim", "block"),
               "rmsnorm": ("rows", "d", "block_rows"),
               "ssd": ("B", "S", "H", "P", "N", "chunk")}
# (rows, d, block rows, depths); block rows sized for one SM's share
OVERLAP = {True: (2048, 256, [1, 4], [1, 2, 4, 8]),
           False: (8192, 512, [1, 2, 4, 8, 16, 32], [1, 2, 4, 8])}
EPS = 1e-5


# --------------------------------------------------------------------- #
# analytic columns (the reference's formulas)
# --------------------------------------------------------------------- #

def attention_analytics(B, H, Hkv, S, hd) -> dict:
    """Causal: ~half the S² pairs, 2 matmuls (qk, pv)."""
    flops = 2 * 2 * B * H * S * S * hd / 2
    bytes_moved = 4 * (B * S * hd * (H + 2 * Hkv) * 2)
    return {"gflops_fwd": round(flops / 1e9, 3),
            "flops_per_byte": round(flops / bytes_moved, 1),
            "flops": flops}


def rmsnorm_analytics(n, d) -> dict:
    """Memory-bound: 1 read + 1 write of (n, d) float32."""
    return {"gb": 2 * n * d * 4 / 1e9}


def ssd_analytics(B, S, H, P, N, chunk) -> dict:
    """The intra-chunk quadratic dominates: 2·(C·Bᵀ) + 2·(M·x) per chunk."""
    nc = S // chunk
    flops = B * H * nc * (2 * chunk * chunk * N + 2 * chunk * chunk * P)
    return {"gflops_fwd": round(flops / 1e9, 3)}


def attention_tile(hd: int) -> str:
    return (f"flash_fwd: 64 query rows a block, 32-key tiles; flash_bwd: "
            f"{256 // (hd // 16)} rows a block, 32-row tiles")


RMSNORM_TILE = ("rmsnorm_fwd: one 128-thread block a row; rmsnorm_bwd: "
                "at most one 512-thread block an SM, 1-16 warps a row")
SSD_TILE = "ssd_chunk: one block a (batch, chunk, head), 64-row tiles"


# --------------------------------------------------------------------- #
# timing
# --------------------------------------------------------------------- #

def _wall_ms(fn, warmup: int = 1, reps: int = 3) -> float:
    """Median host wall time of a call on the CPU (no device here)."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return sorted(ts)[len(ts) // 2]


def _timer(device: str):
    if device == "cpu":
        return _wall_ms
    from repro_torch.bench.timing import Timer
    return Timer(iters=20)


def _fwd(fn, args):
    def run():
        with torch.no_grad():
            return fn(*args)
    return run


def _fwd_bwd(fn, args):
    """Forward and backward: the sum of every output, differentiated
    with respect to every input (the reference's ``_grad_of``).  The
    call returns the outputs and the grads."""
    leaves = [a.detach().requires_grad_() for a in args]

    def run():
        out = fn(*leaves)
        out = out if isinstance(out, tuple) else (out,)
        loss = sum(o.float().sum() for o in out)
        return out, torch.autograd.grad(loss, leaves)
    return run


def rel_err(got, want, terms=None) -> float:
    """max |got - want| / (1 + |want|): at most t exactly when ``got`` is
    within t absolute and t relative of ``want``.  For a sum of many
    terms that cancel, float32 in any order is only as close as the
    terms' magnitude allows: with ``terms`` (the sum of the terms'
    absolute values) the error is max |got - want| / terms, as
    ``chip_smoke.py`` phase 1b holds RMSNorm's dscale."""
    got, want = got.detach().float(), want.detach().float()
    den = 1 + want.abs() if terms is None else terms
    return float(((got - want).abs() / den).max())


def _time_both(timer, kernel, plain, args, names, terms=None) -> dict:
    """The four times, and the kernel's outputs (``fwd_err``, the largest
    over them) and grads (``grad_err``, one for each of ``names``)
    against the plain version's on the same inputs, by ``rel_err``.  A
    grad named in ``terms`` is held to its terms' magnitude, and its
    abs/rel error is kept beside (``grad_err_abs_rel``)."""
    terms = terms or {}
    (k_out, k_grad), (p_out, p_grad) = (_fwd_bwd(fn, args)()
                                        for fn in (kernel, plain))
    row = {"fwd_err": max(rel_err(a, b) for a, b in zip(k_out, p_out)),
           "grad_err": {n: rel_err(a, b, terms.get(n))
                        for n, a, b in zip(names, k_grad, p_grad)}}
    if terms:
        row["grad_err_abs_rel"] = {n: rel_err(a, b) for n, a, b
                                   in zip(names, k_grad, p_grad)
                                   if n in terms}
    del k_out, k_grad, p_out, p_grad
    row.update({"kernel_fwd_ms": timer(_fwd(kernel, args)),
                "kernel_bwd_ms": timer(_fwd_bwd(kernel, args)),
                "plain_fwd_ms": timer(_fwd(plain, args)),
                "plain_bwd_ms": timer(_fwd_bwd(plain, args))})
    return row


def _randn(g, device, *shape):
    return torch.randn(*shape, generator=g, device=device)


# --------------------------------------------------------------------- #
# kernel sweeps
# --------------------------------------------------------------------- #

def _plain_attention(q, k, v):
    out, _ = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=True)
    return out.transpose(1, 2)


def _sweep(cfgs, keys, make_row, *, shared_last: bool = True):
    """One row per reference config.  With ``shared_last``, configs equal
    but for the last column (the reference's block size, which the
    port's kernels do not take) share one timing, and the later rows
    name the row it came from (``timings_from_<key>``)."""
    rows, done = [], {}
    for cfg in cfgs:
        row = dict(zip(keys, cfg))
        shape = cfg[:-1] if shared_last else cfg
        if shape in done:
            first = done[shape]
            row.update({k: v for k, v in first.items() if k not in row})
            row[f"timings_from_{keys[-1]}"] = first[keys[-1]]
        else:
            row.update(make_row(cfg))
            done[shape] = row
        rows.append(row)
    return rows


def _attention_sweep(device: str, ci: bool, timer):
    def make(cfg):
        B, H, Hkv, S, hd, _blk = cfg
        g = torch.Generator(device).manual_seed(0)
        q = _randn(g, device, B, S, H, hd)
        k = _randn(g, device, B, S, Hkv, hd)
        v = _randn(g, device, B, S, Hkv, hd)
        a = attention_analytics(B, H, Hkv, S, hd)
        row = {"gflops_fwd": a["gflops_fwd"],
               "flops_per_byte": a["flops_per_byte"],
               "port_tile": attention_tile(hd)}
        row.update(_time_both(timer, KB.attention, _plain_attention,
                              (q, k, v), ("q", "k", "v")))
        for tag in ("kernel", "plain"):
            row[f"{tag}_achieved_gflops"] = (a["flops"]
                                             / row[f"{tag}_fwd_ms"] / 1e6)
        return row
    return _sweep(ATTENTION[ci], CONFIG_KEYS["attention"], make)


def _rmsnorm_sweep(device: str, ci: bool, timer):
    def make(cfg):
        n, d, _br = cfg
        g = torch.Generator(device).manual_seed(1)
        x = _randn(g, device, n, d)
        s = 0.1 * _randn(g, device, d)
        # dscale sums x̂ (the loss's grad is 1) over every row
        xh = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS)
        row = {"port_tile": RMSNORM_TILE}
        row.update(_time_both(
            timer, lambda x, s: KB.rmsnorm(x, s, eps=EPS),
            lambda x, s: ref.rmsnorm_ref(x, s, EPS), (x, s),
            ("x", "scale"), terms={"scale": xh.abs().sum(0)}))
        del xh
        gb = rmsnorm_analytics(n, d)["gb"]
        for tag in ("kernel", "plain"):
            row[f"{tag}_gb_per_s"] = gb / (row[f"{tag}_fwd_ms"] / 1e3)
        return row
    return _sweep(RMSNORM[ci], CONFIG_KEYS["rmsnorm"], make)


def _ssd_sweep(device: str, ci: bool, timer):
    from repro_torch.models.mamba2 import ssd_chunked

    def make(cfg):
        B, S, H, P, N, chunk = cfg
        g = torch.Generator(device).manual_seed(2)
        args = (_randn(g, device, B, S, H, P),
                F.softplus(_randn(g, device, B, S, H)),
                -_randn(g, device, H).abs() * 0.5,
                _randn(g, device, B, S, N) * 0.3,
                _randn(g, device, B, S, N) * 0.3,
                _randn(g, device, H) * 0.1)
        row = ssd_analytics(B, S, H, P, N, chunk)
        row["port_tile"] = SSD_TILE
        row.update(_time_both(
            timer, lambda *a: KB.ssd(*a, chunk=chunk),
            lambda *a: ssd_chunked(*a, chunk=chunk), args,
            ("x", "dt", "A", "B", "C", "D")))
        return row
    # the chunk is the SSD's own parameter: every config is timed
    return _sweep(SSD[ci], CONFIG_KEYS["ssd"], make, shared_last=False)


# --------------------------------------------------------------------- #
# copy/compute-overlap profile
# --------------------------------------------------------------------- #

def overlap_plan(ci: bool, budget: int):
    """The profile's configs: (block_rows, depth) over the sweep, each
    with its shared memory, and marked skipped where that exceeds
    ``budget``, the card's opt-in shared memory per block."""
    from repro_torch.kernels.overlap import smem_bytes
    rows, d, blocks, depths = OVERLAP[ci]
    plan = []
    for block in blocks:
        if rows % block:
            continue
        for depth in depths:
            rec = {"block_rows": block, "buffer_depth": depth,
                   "smem_bytes": smem_bytes(block, d, depth)}
            if rec["smem_bytes"] > budget:
                rec["skipped"] = "exceeds the opt-in shared memory per block"
            plan.append(rec)
    return plan


def _overlap_profile(device: str, ci: bool, timer):
    """(block_rows × depth) sweep of ``kernels.overlap.overlap_norm``,
    aware of the card's shared memory."""
    if device == "cpu":
        return {"skipped": "the overlap profile needs the card"}
    from repro_torch.bench.timing import bound
    from repro_torch.kernels import overlap as OV
    rows, d = OVERLAP[ci][:2]
    g = torch.Generator(device).manual_seed(3)
    x = _randn(g, device, rows, d)
    want = ref.overlap_norm_ref(x, EPS)
    budget = OV.smem_budget(x.device)
    gb = 2 * rows * d * 4 / 1e9
    out = {"rows": rows, "d": d, "smem_budget_bytes": budget,
           "sms": torch.cuda.get_device_properties(x.device)
           .multi_processor_count, "configs": overlap_plan(ci, budget)}
    for rec in out["configs"]:
        if "skipped" in rec:
            continue
        block, depth = rec["block_rows"], rec["buffer_depth"]
        n_blocks = rows // block
        rec["grid"] = OV.grid_of(n_blocks, x.device)
        rec["blocks_per_sm"] = n_blocks / rec["grid"]

        def call(block=block, depth=depth):
            return OV.overlap_norm(x, block_rows=block, depth=depth)
        got = call()
        torch.cuda.synchronize()
        rec["max_err"] = float((got - want).abs().max())
        rec["ms"] = timer(call)
        rec["gb_per_s"] = gb / (rec["ms"] / 1e3)
    ran = [c for c in out["configs"] if "ms" in c]
    best = min(ran, key=lambda c: c["ms"])
    out["best"] = {k: best[k] for k in
                   ("block_rows", "buffer_depth", "ms", "gb_per_s")}
    out["depth1_ms"] = next(c["ms"] for c in ran
                            if c["block_rows"] == best["block_rows"]
                            and c["buffer_depth"] == 1)
    out["plain_ms"] = timer(lambda: ref.overlap_norm_ref(x, EPS))
    out["library_ms"] = timer(lambda: F.rms_norm(x, (d,), None, EPS))
    out["library"] = "F.rms_norm(x, (d,), None, 1e-5)"
    out.update(bound(2 * rows * d * 4, 3 * rows * d, torch.float32))
    return out


# --------------------------------------------------------------------- #
# entry points
# --------------------------------------------------------------------- #

def _measure(device: str, ci: bool):
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("repro_torch.bench.kernels: --device cuda "
                               "needs an NVIDIA card (--device cpu runs "
                               "the plain versions)")
        # the plain versions' float32 products in full float32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        name, how = torch.cuda.get_device_name(0), (
            "device ms: CUDA events, L2 flushed, median of 20 (Timer)")
    elif device == "cpu":
        name, how = "cpu", "host wall-clock ms, median of 3"
    else:
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    timer = _timer(device)
    return {"device": name, "platform": "gpu" if device == "cuda" else "cpu",
            "timer": how, "ci": ci,
            "attention": _attention_sweep(device, ci, timer),
            "rmsnorm": _rmsnorm_sweep(device, ci, timer),
            "ssd": _ssd_sweep(device, ci, timer),
            "overlap": _overlap_profile(device, ci, timer)}


def run(steps: int = 0, device: str = "cuda"):
    """Harness entry point: CSV rows from a CI-sized sweep."""
    result = _measure(device, ci=True)
    rows = []
    for section, keys in CONFIG_KEYS.items():
        for r in result[section]:
            name = f"kernels/{section}/" + "x".join(str(r[k]) for k in keys)
            rows.append((name, r["kernel_fwd_ms"] * 1e3,
                         f"bwd_ms={r['kernel_bwd_ms']}"))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="per-kernel sweeps and the overlap profile")
    ap.add_argument("--ci", action="store_true",
                    help="smoke-size sweeps")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the kernels, timed on the card; cpu: the "
                         "plain versions in both columns, no overlap")
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "bench_kernels.json"))
    args = ap.parse_args(argv)
    result = _measure(args.device, args.ci)
    for section in CONFIG_KEYS:
        for r in result[section]:
            print(f"{section}: {r}")
    ov = result["overlap"]
    for c in ov.get("configs", []):
        print(f"overlap: {c}")
    if "best" in ov:
        print(f"overlap best: {ov['best']}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"-> {args.out}")
    return result


if __name__ == "__main__":
    main()
