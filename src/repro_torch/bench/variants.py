"""Where a kernel's time goes: variants of one source, each with one
change, built and timed side by side on the card.

No profiler that reads the SMs' counters runs where the card is, so a
kernel's time is taken apart by difference instead: a variant leaves
out one piece of work (a role of the blocks, two of the three split
products, the exp, the x loads, the dscale merge), moves it (the RMSNorm
forward's scale loads behind the sum) or changes one constant or the
form a call takes, and its time beside the unchanged kernel's says what
that piece costs.  A variant that leaves work out computes
wrong outputs; only its time is read.

    PYTHONPATH=src python -m repro_torch.bench.variants [NAME ...] \\
        [--against OTHER/csrc/rmsnorm.cu] \\
        [--out chiprun_out/kernel_variants.json]

Each variant is the source in ``csrc/`` with text substitutions
(``VARIANTS``); a substitution that no longer matches the source raises,
so a stale variant cannot pass for the kernel.  Each builds with the
port's nvcc flags into its own library under ``build/variants/`` (in
parallel, seconds each) and is called through its C entry with the
shapes of the Mamba-2 training path: the SSD chunk at mamba2-2.7b's (B=4,
S=2048, H=80, P=64, N=128, Q=256, bf16, strided as in the mixer, its
init's decay) and the RMSNorm backward at 8192 rows of d = 1024, 2560 and
5120 in bf16, timed by ``bench.timing.Timer``.  The RMSNorm forward's
variants, and ``--against`` another tree's forward (the parent commit's,
unpacked by ``git archive``), are timed together at ``FWD_SHAPES`` (the
training shapes, a prefill, the prompt buckets, a decode step), each in
its own tree's layout, cold (``Timer``) and as a graph replays them
(``GraphTimer``, ``graph_us``), in rounds that move their buffers and
rotate their order; the medians are kept.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import rmsnorm as RN

OUT_DIR = _build.BUILD_DIR.parent / "variants"

# text of ssd_chunk.cu: the role of a block, the y path's and the state
# path's split products, the exp of the decay, the x tile loads
_IS_STATE = "  const bool is_state = role < nh;\n"
_SPLIT_CALL = "\n          mma_split(acc, hi, mid, lo, xt, kb, npb, lane);\n"
_Y_SPLIT_CALL = "\n        mma_split(acc, hi, mid, lo, xt, kb, npb, lane);\n"
_X_LOAD = ("      load_rows<kCprP>(ring + (k % kStages) * kXTile, "
           "xb + h * xs.h, xs.s,\n                       jt * kTile, "
           "kTile, valid, P);\n")
_EXP_A = "    m[0][e] = cbv[0][e] * ex2(ea) * dj[e];"
_EXP_B = "    m[1][e] = cbv[1][e] * ex2(eb) * dj[e];"
_ONE_TERM = "mma_split(acc, hi, hi, hi, xt, kb, npb, lane);\n"
_MERGE = "  const int q = blockIdx.x / merge, q0 = q * merge;"
# text of rmsnorm.cu's forward: the register form's early scale loads and
# its stores, the choice of form
_FWD_SCALE = ("#pragma unroll\n    for (int k = 0; k < KV; ++k) {\n"
              "      const int i = t + k * stride;\n"
              "      if (i < nvec) load_scale<V>(scale, i, s[k]);\n    }\n")
_FWD_STORE = "        store_y<T, V>(yr, i, v, rr, s[k]);\n"
_FWD_FORM = "  if (staged)\n"

# name -> (source, [(old, new), ...]); "ssd_only_y" etc. run one role
VARIANTS: Dict[str, Tuple[str, List[Tuple[str, str]]]] = {
    "ssd": ("ssd_chunk.cu", []),
    "ssd_only_y": ("ssd_chunk.cu",
                   [(_IS_STATE, _IS_STATE + "  if (is_state) return;\n")]),
    "ssd_only_state": ("ssd_chunk.cu",
                       [(_IS_STATE,
                         _IS_STATE + "  if (!is_state) return;\n")]),
    # the same three mma a block, all on the hi term: the products' cost
    # stays, the split's pack and unpack of mid and lo go
    "ssd_only_y_hi_terms": ("ssd_chunk.cu",
                            [(_IS_STATE,
                              _IS_STATE + "  if (is_state) return;\n"),
                             (_Y_SPLIT_CALL, "\n        " + _ONE_TERM)]),
    "ssd_only_y_no_exp": ("ssd_chunk.cu",
                          [(_IS_STATE,
                            _IS_STATE + "  if (is_state) return;\n"),
                           (_EXP_A, "    m[0][e] = cbv[0][e] * dj[e];"),
                           (_EXP_B, "    m[1][e] = cbv[1][e] * dj[e];")]),
    "ssd_only_y_no_x_loads": ("ssd_chunk.cu",
                              [(_IS_STATE,
                                _IS_STATE + "  if (is_state) return;\n"),
                               (_X_LOAD, "")]),
    "ssd_only_y_no_mma": ("ssd_chunk.cu",
                          [(_IS_STATE,
                            _IS_STATE + "  if (is_state) return;\n"),
                           (_Y_SPLIT_CALL, "\n        if (hi[0] == 0x12345u) "
                                           + _ONE_TERM)]),
    "ssd_only_state_no_mma": ("ssd_chunk.cu",
                              [(_IS_STATE,
                                _IS_STATE + "  if (!is_state) return;\n"),
                               (_SPLIT_CALL,
                                "\n          if (hi[0] == 0x12345u) "
                                + _ONE_TERM)]),
    "ssd_group4": ("ssd_chunk.cu",
                   [("constexpr int kGroup = 8;",
                     "constexpr int kGroup = 4;")]),
    "ssd_group16": ("ssd_chunk.cu",
                    [("constexpr int kGroup = 8;",
                      "constexpr int kGroup = 16;")]),
    "rmsnorm_bwd": ("rmsnorm.cu", []),
    "rmsnorm_bwd_no_merge": ("rmsnorm.cu",
                             [(_MERGE, "  return;\n" + _MERGE)]),
    "rmsnorm_bwd_stages3": ("rmsnorm.cu",
                            [("constexpr int kBwdStages = 2;",
                              "constexpr int kBwdStages = 3;")]),
    "rmsnorm_fwd": ("rmsnorm.cu", []),
    # every call of rows of one chunk in the staged form
    "rmsnorm_fwd_staged": ("rmsnorm.cu",
                           [(_FWD_FORM, "  if (d / rt::Vec<T>::N <= "
                                        "wpr * 32 * kVec)\n")]),
    # the register form reading scale after the sum, a second trip to
    # memory
    "rmsnorm_fwd_scale_late": ("rmsnorm.cu",
                               [(_FWD_SCALE, ""),
                                (_FWD_STORE,
                                 "        load_scale<V>(scale, i, s[k]);\n"
                                 + _FWD_STORE)]),
}


def variant_source(name: str) -> str:
    """The source text of variant ``name``; raises if a substitution does
    not match the source exactly once."""
    src, subs = VARIANTS[name]
    text = (_build.CSRC / src).read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} found "
                             f"{text.count(old)} times in {src}")
        text = text.replace(old, new)
    return text


def build_variant(name: str, text: str = None,
                  headers: Path = _build.CSRC) -> Tuple[Path, List[str]]:
    """Compile variant ``name`` (or ``text``, a source whose headers are in
    ``headers``) into its own shared library; returns its path and
    ptxas's register and spill lines."""
    d = OUT_DIR / name
    d.mkdir(parents=True, exist_ok=True)
    for h in headers.glob("*.cuh"):
        (d / h.name).write_text(h.read_text())
    cu = d / f"{name}.cu"
    cu.write_text(variant_source(name) if text is None else text)
    lib = d / f"lib{name}.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                        "-shared", str(cu), "-o", str(lib)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{r.stdout}{r.stderr}")
    return lib, [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
                 if "registers" in ln or "spill" in ln]


def _ssd_call(lib, g):
    """A call of the SSD chunk entry at mamba2-2.7b's training shape."""
    B, S, H, P, N, Q = 4, 2048, 80, 64, 128, 256
    di = H * P
    xbc = torch.randn(B, S, di + 2 * N, generator=g,
                      device="cuda").bfloat16()
    xh = xbc[..., :di].reshape(B, S, H, P)
    Bm, Cm = xbc[..., di:di + N], xbc[..., di + N:]
    dt0 = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1), H,
                                   device="cuda"))
    dt = torch.nn.functional.softplus(
        dt0 + torch.log(-torch.expm1(-dt0))
        + 0.5 * torch.randn(B, S, H, generator=g, device="cuda"))
    A = -torch.arange(1, H + 1, dtype=torch.float32, device="cuda")
    nc = S // Q
    y = torch.empty(B, S, H, P, device="cuda")
    st = torch.empty(B, nc, H, N, P, device="cuda")
    T = torch.empty(B, nc, H, device="cuda")
    fn = lib.ssd_chunk
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_int64] * 10 + [ctypes.c_int, ctypes.c_void_p])
    args = (xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), st.data_ptr(), T.data_ptr(), B, S,
            H, P, N, Q, *xh.stride()[:3], *dt.stride(), Bm.stride(0),
            Bm.stride(1), Cm.stride(0), Cm.stride(1), 1)
    keep = (xbc, dt, A, y, st, T)
    return {"x (4, 2048, 80, 64), N 128, Q 256": (
        lambda: fn(*args, torch.cuda.current_stream().cuda_stream), keep)}


def _rmsnorm_calls(lib, g):
    """Calls of the RMSNorm backward entry at 8192 rows of d = 1024, 2560
    and 5120."""
    sc = lib.rmsnorm_bwd_scratch
    sc.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
    fn = lib.rmsnorm_bwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p]
    ctr = torch.zeros(1024, dtype=torch.int32, device="cuda")
    calls = {}
    for d in (1024, 2560, 5120):
        x, gy = (torch.randn(8192, d, generator=g, device="cuda").bfloat16()
                 for _ in range(2))
        s = 0.1 * torch.randn(d, generator=g, device="cuda")
        rows, n = ctypes.c_int(), ctypes.c_int()
        sc(8192, d, 1, ctypes.byref(rows), ctypes.byref(n))
        part = torch.empty(rows.value, d, device="cuda")
        dx, ds = torch.empty_like(x), torch.empty_like(s)
        args = (x.data_ptr(), s.data_ptr(), gy.data_ptr(), dx.data_ptr(),
                ds.data_ptr(), part.data_ptr(), ctr.data_ptr(), 8192, d,
                1e-5, 1)
        calls[f"8192 x {d}"] = (
            lambda a=args: fn(*a, torch.cuda.current_stream().cuda_stream),
            (x, gy, s, part, dx, ds, ctr))
    return calls


# the RMSNorm forward's shapes (bf16): a training micro-batch at the dense
# model's and Mamba-2's widths, a prefill of 1024, phase 2's prompt
# buckets, a decode step
FWD_SHAPES = ((8192, 1024), (8192, 2560), (8192, 5120), (1024, 1024),
              (512, 1024), (256, 1024), (128, 1024), (64, 1024), (8, 1024))
FWD_ROUNDS = 7              # rounds the forwards are timed in


def _rmsnorm_fwd_entry(lib, text: str):
    """The forward entry of a built ``rmsnorm.cu`` and the layout it
    takes for n rows of d: ``fwd_layout``'s where the entry takes one,
    none where it lays itself out (an older source)."""
    fn = lib.rmsnorm_fwd
    if "int warps_per_row" in text:
        fn.argtypes = RN._ARGTYPES
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        return fn, lambda n, d: RN.fwd_layout(n, d, 1, sms)
    fn.argtypes = RN._ARGTYPES[:7] + [ctypes.c_void_p]
    return fn, lambda n, d: ()


def _time_forwards(entries: dict) -> dict:
    """``graph_us`` and cold ``ms`` of each forward entry at every shape
    of ``FWD_SHAPES``, the medians of ``FWD_ROUNDS`` rounds.  Each round
    copies x to a new address and gives each entry a new y, and the
    entries take turns in a rotated order, so no entry keeps the
    placement of its buffers or its place in the sequence."""
    from repro_torch.bench.timing import GraphTimer, Timer
    timer, graph_timer = Timer(iters=20), GraphTimer()
    g = torch.Generator(device="cuda").manual_seed(3)
    names = list(entries)
    out = {name: {"graph_us": {}, "ms": {}} for name in names}
    for n, d in FWD_SHAPES:
        x = torch.randn(n, d, generator=g, device="cuda").bfloat16()
        s = 0.1 * torch.randn(d, generator=g, device="cuda")
        runs = {name: ([], []) for name in names}
        for r in range(FWD_ROUNDS):
            pad = torch.empty(256 * (1 + r * 97 % 4093), device="cuda")
            xr = x.clone()
            for name in names[r % len(names):] + names[:r % len(names)]:
                fn, layout = entries[name]
                y = torch.empty_like(x)
                args = (xr.data_ptr(), s.data_ptr(), y.data_ptr(), n, d,
                        1e-5, 1, *layout(n, d))

                def call(fn=fn, args=args):
                    return fn(*args, torch.cuda.current_stream().cuda_stream)
                if call():
                    raise RuntimeError(f"{name} at {n} x {d}: CUDA error")
                runs[name][0].append(graph_timer(call))
                runs[name][1].append(timer(call))
            del pad
        for name, (gus, ms) in runs.items():
            out[name]["graph_us"][f"{n} x {d}"] = float(np.median(gus))
            out[name]["ms"][f"{n} x {d}"] = float(np.median(ms))
    return out


def measure(names=None, against: str = None) -> dict:
    """Build every variant (in parallel) and time each at its shapes; the
    RMSNorm forward's variants together, in rounds, beside ``against``
    (another tree's ``csrc/rmsnorm.cu``, such as the parent commit's)
    where one is given."""
    if not torch.cuda.is_available():
        raise RuntimeError("kernel variants are timed on an NVIDIA card")
    from repro_torch.bench.timing import Timer
    names = list(names or VARIANTS)
    jobs = [(name, None, _build.CSRC) for name in names]
    texts = {name: variant_source(name) for name in names}
    if against:
        texts["against"] = Path(against).read_text()
        jobs.append(("against", texts["against"], Path(against).parent))
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = dict(zip([j[0] for j in jobs],
                         ex.map(lambda j: build_variant(*j), jobs)))
    timer = Timer(iters=20)
    out = {"device": torch.cuda.get_device_name(0), "variants": {}}
    forwards = {}
    for name, (lib_path, ptxas) in built.items():
        lib = ctypes.CDLL(str(lib_path))
        out["variants"][name] = rec = {"ptxas": ptxas, "ms": {}}
        if name == "against" or name.startswith("rmsnorm_fwd"):
            forwards[name] = _rmsnorm_fwd_entry(lib, texts[name])
            continue
        g = torch.Generator(device="cuda").manual_seed(3)
        calls = (_ssd_call if name.startswith("ssd") else _rmsnorm_calls)(
            lib, g)
        for shape, (call, _keep) in calls.items():
            err = call()
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"{name} at {shape}: CUDA error {err}")
            rec["ms"][shape] = timer(call)
        print(f"{name}: {rec['ms']}", flush=True)
    if forwards:
        for name, rec in _time_forwards(forwards).items():
            out["variants"][name].update(rec)
            print(f"{name}: graph_us {rec['graph_us']}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*",
                    help="variants to build and time (default: all)")
    ap.add_argument("--against", default=None,
                    help="another tree's csrc/rmsnorm.cu, whose forward is "
                         "timed beside the forward variants")
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "kernel_variants.json"))
    args = ap.parse_args(argv)
    unknown = sorted(set(args.names) - set(VARIANTS))
    if unknown:
        ap.error(f"no such variant: {', '.join(unknown)}")
    result = measure(args.names, args.against)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"-> {args.out}")
    return result


if __name__ == "__main__":
    main()
