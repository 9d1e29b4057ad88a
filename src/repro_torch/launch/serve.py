"""Serving launcher: drive the port's continuous-batching engine from the
CLI (the counterpart of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        [--requests 16] [--decode-slots 4] [--page-size 16] \
        [--max-len 256] [--max-new 32] [--seed 0] [--device cuda|cpu]

Builds the reduced config of the named architecture with seeded random
weights, submits a seeded batch of ragged requests (prompts of 2 tokens
and more), streams tokens as the engine emits them, and reports the
drain throughput.  A dense architecture serves from the paged KV pool
(``--page-size`` tokens a page); ``--arch mamba2-2.7b`` serves from the
recurrent state pool, one page of state per request, with one prefill
entry per distinct prompt length.  ``--device``
(default ``cuda``) picks where it runs: the hand-written kernels on the
card, their plain versions on the CPU.  There is no kernel-backend flag:
the device decides.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import registry as R
from repro_torch.serving import GenerationRequest, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--decode-slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-request completion lines")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    if R.serving_mode(cfg) is None:
        raise SystemExit(
            f"arch {cfg.name} (arch_type={cfg.arch_type}, window="
            f"{cfg.sliding_window}) has no paged/state serving mode; use "
            f"repro_torch.train.serve.Server")
    dtype = torch.bfloat16
    model = R.init_model(cfg, seed=args.seed, dtype=dtype,
                         device=args.device)
    eng = ServingEngine(cfg, model, decode_slots=args.decode_slots,
                        page_size=args.page_size, max_len=args.max_len,
                        dtype=dtype)

    rng = np.random.default_rng(args.seed)
    max_prompt = max(args.max_len - args.max_new, 2)
    for _ in range(args.requests):
        s = int(rng.integers(2, max_prompt + 1))
        n = int(rng.integers(1, args.max_new + 1))
        eng.submit(GenerationRequest(
            prompt=rng.integers(0, cfg.vocab_size, (s,)).astype(np.int32),
            max_new_tokens=n))

    print(f"arch={cfg.name} device={args.device} mode={eng.mode} "
          f"slots={args.decode_slots} page_size={eng.page_size} "
          f"pool={eng.pool.capacity} pages")
    t0 = time.perf_counter()
    n_tok = 0
    while not eng.done:
        for rid, _tok, fin in eng.step():
            n_tok += 1
            if fin and not args.quiet:
                res = eng.result(rid)
                print(f"  rid={rid} {res.finish_reason} "
                      f"prompt={res.prompt_len} new={len(res.tokens)}")
    dt = time.perf_counter() - t0
    print(f"{args.requests} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / max(dt, 1e-9):.1f} tok/s); occupancy "
          f"{eng.mean_occupancy():.2f}; {eng.executables} executables "
          f"(budget {eng.executable_budget})")


if __name__ == "__main__":
    main()
