"""Serving benchmark: continuous batching against static batching, and a
Poisson load sweep through the paged engine (``benchmarks/bench_serve.py``
on the port).

The reference's workload, seeded as there: arrivals are Poisson in
engine steps (the trace is the same on every host, whatever its speed),
ragged prompts, and bimodal budgets (3/4 short replies of 4-10 tokens,
1/4 long ones of 40-64), the shape where a static batch blocks on its
longest member while its finished rows idle.

Rows, in the reference's order:

- ``serve/throughput/speedup``: the engine's requests/s over the
  static-batch ``Server``'s on one backlog of the same requests (the
  reference's acceptance floor is 1.5x).
- ``serve/rate{r}/request`` for r = 0.5 and 2.0 arrivals a step: µs a
  request, with requests/s, tokens/s, p50/p99 submit-to-finish latency
  and the mean decode-slot occupancy.
- ``serve/compiles``: the serving compile invariant, entries against
  the budget.

What the port measures where it cannot do as the reference does:

- **Compiles.**  The port compiles nothing; its compile cache is one
  entry per prompt bucket and one decode entry, and on the card each
  entry holds a captured CUDA graph (``ServingEngine``).  ``compiles``
  counts the entries as the reference counts executables, and
  ``graphs`` the graphs captured (0 on the CPU, where entries hold the
  eager functions).  ``check_compiles`` holds both to the budget:
  prefill entries (and graphs) at most the buckets, exactly one decode
  entry.
- **The static baseline's cache.**  The reference's ``Server`` has a
  cache of ``MAX_LEN`` positions, and a batch padded to its longest
  prompt and budget writes past it: the reference drops those writes
  and returns wrong tokens (ROADMAP Queue 3).  The port's ``Server``
  refuses to do that, so its baseline holds ``MAX_LEN +`` the longest
  budget (192 positions): the same batches, the same work, and one more
  prompt bucket (192) in its prefill ladder.

Warm-up runs every prompt bucket and a decode step twice (the first
call of a kind runs eagerly, the next captures its graph), then
``reset()`` keeps the entries (and graphs) and frees the pool, so the
timed runs are steady state; the static baseline is warmed by an untimed
pass.

    PYTHONPATH=src python -m repro_torch.bench.serve [--requests 48] \\
        [--ci] [--check-compiles] [--check-speedup 1.5] [--device cpu] \\
        [--out chiprun_out/bench_serve.json]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import warnings

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry as R
from repro_torch.serving import GenerationRequest, ServingEngine
from repro_torch.train.serve import Server

# the reference's reduced-scale LM: the serving path of the real presets
# at tiny dims (4 heads of 32, 2 kv heads)
SERVE_LM = ModelConfig(name="serve-lm", arch_type="dense", n_layers=2,
                       d_model=128, n_heads=4, n_kv_heads=2,
                       head_dim=32, d_ff=256, vocab_size=512,
                       max_seq_len=256, rope_theta=1e4)

DECODE_SLOTS = 4
PAGE_SIZE = 16
MAX_LEN = 128
LONG_BUDGET = 64            # the largest max_new_tokens of the mix
RATES = (0.5, 2.0)          # mean arrivals per engine step
DEFAULT_OUT = os.path.join("chiprun_out", "bench_serve.json")


def _model(device):
    return R.init_model(SERVE_LM, seed=0, dtype=torch.bfloat16,
                        device=device)


def _make_engine(model):
    return ServingEngine(SERVE_LM, model, decode_slots=DECODE_SLOTS,
                         page_size=PAGE_SIZE, max_len=MAX_LEN)


def _request(rng) -> GenerationRequest:
    """One request of the mix: ~3/4 short replies (4..10 tokens), ~1/4
    long generations (40..64)."""
    if rng.random() < 0.75:
        max_new = int(rng.integers(4, 11))
    else:
        max_new = int(rng.integers(40, LONG_BUDGET + 1))
    s = int(rng.integers(2, MAX_LEN - max_new))
    prompt = rng.integers(0, SERVE_LM.vocab_size, (s,)).astype(np.int32)
    return GenerationRequest(prompt=prompt, max_new_tokens=max_new)


def _trace(n_requests: int, rate: float, seed: int):
    """Deterministic Poisson trace: (arrival_step, request) sorted by
    arrival."""
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    for _ in range(n_requests):
        t += rng.exponential(1.0 / rate)
        out.append((t, _request(rng)))
    return out


def _warmup(engine: ServingEngine):
    """Run every prompt bucket's prefill and the decode step twice (on
    the card the first call of each kind runs eagerly and the next one
    captures its entry's graph), then drop the requests, keeping the
    entries."""
    rng = np.random.default_rng(1)
    for _ in range(2):
        for i, b in enumerate(engine.buckets):
            s = b if i == 0 else engine.buckets[i - 1] + 1
            if s + 2 > engine.max_len:
                s = engine.max_len - 2
            engine.submit(GenerationRequest(
                max_new_tokens=2,
                prompt=rng.integers(0, SERVE_LM.vocab_size, (s,)).astype(
                    np.int32)))
        engine.drain(max_steps=200)
    engine.reset()


def _drive(engine: ServingEngine, trace) -> dict:
    """Submit the trace against engine-step time and drain; returns the
    per-rate metrics block."""
    t_submit, t_finish, n_tokens = {}, {}, {}
    step, q = 0, 0
    t0 = time.perf_counter()
    while q < len(trace) or not engine.done:
        while q < len(trace) and trace[q][0] <= step:
            rid = engine.submit(trace[q][1])
            t_submit[rid] = time.perf_counter()
            q += 1
        for rid, _tok, fin in engine.step():
            n_tokens[rid] = n_tokens.get(rid, 0) + 1
            if fin:
                t_finish[rid] = time.perf_counter()
        step += 1
        if step >= 100_000:
            raise RuntimeError("engine failed to drain the trace")
    elapsed = time.perf_counter() - t0
    lat = np.asarray([1e3 * (t_finish[r] - t_submit[r])
                      for r in t_finish])
    total_tokens = sum(n_tokens.values())
    return {
        "n_requests": len(trace),
        "steps": step,
        "requests_per_s": round(len(trace) / elapsed, 2),
        "tokens_per_s": round(total_tokens / elapsed, 1),
        "generated_tokens": total_tokens,
        "latency_ms": {
            "p50": round(float(np.percentile(lat, 50)), 1),
            "p99": round(float(np.percentile(lat, 99)), 1),
            "mean": round(float(lat.mean()), 1)},
        "mean_occupancy": round(engine.mean_occupancy(), 3),
    }


def _static_baseline(srv: Server, requests, *, timed: bool) -> dict:
    """The blocking API on the same workload: requests grouped in
    arrival order into batches of DECODE_SLOTS, prompts padded to the
    batch's longest, each batch generating its largest budget."""
    t0 = time.perf_counter()
    useful = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for i in range(0, len(requests), DECODE_SLOTS):
            batch = requests[i:i + DECODE_SLOTS]
            s_max = max(len(r.prompt) for r in batch)
            toks = np.zeros((len(batch), s_max), np.int32)
            for j, r in enumerate(batch):
                # right-aligned: the last column is each prompt's final
                # token (the static API's shared-length contract)
                toks[j, s_max - len(r.prompt):] = r.prompt
            n_new = max(r.max_new_tokens for r in batch)
            srv.generate(toks, n_new)
            useful += sum(min(n_new, r.max_new_tokens) for r in batch)
    elapsed = time.perf_counter() - t0
    if not timed:
        return {}
    return {
        "n_requests": len(requests),
        "requests_per_s": round(len(requests) / elapsed, 2),
        "useful_tokens_per_s": round(useful / elapsed, 1),
        "batch_size": DECODE_SLOTS,
        "max_len": srv.max_len,
    }


def _measure(n_requests: int = 48, seed: int = 0, device: str = "cuda"):
    rows, result = [], {}
    model = _model(device)
    engine = _make_engine(model)
    _warmup(engine)
    result.update({
        "model": SERVE_LM.name,
        "device": str(engine.device),
        "decode_slots": DECODE_SLOTS,
        "page_size": PAGE_SIZE,
        "max_len": MAX_LEN,
        "buckets": list(engine.buckets),
        "pool_pages": engine.pool.capacity,
        "rates": {},
    })

    # the throughput comparison on one backlog (everything queued up
    # front): continuous batching against the static-batch Server
    backlog = [r for _, r in _trace(n_requests, 1e9, seed)]
    engine.reset()
    eng_rec = _drive(engine, [(0.0, r) for r in backlog])
    srv = Server(SERVE_LM, model, max_len=MAX_LEN + LONG_BUDGET)
    _static_baseline(srv, backlog, timed=False)          # warm
    sta_rec = _static_baseline(srv, backlog, timed=True)
    speedup = round(eng_rec["requests_per_s"]
                    / max(sta_rec["requests_per_s"], 1e-9), 2)
    result["throughput"] = {
        "engine": eng_rec, "static": sta_rec, "speedup": speedup}
    rows.append(("serve/throughput/speedup", float(speedup),
                 f"engine_rps={eng_rec['requests_per_s']} "
                 f"static_rps={sta_rec['requests_per_s']} floor=1.5"))

    for rate in RATES:
        engine.reset()
        rec = _drive(engine, _trace(n_requests, rate, seed))
        result["rates"][str(rate)] = rec
        rows.append((
            f"serve/rate{rate}/request",
            1e6 / max(rec["requests_per_s"], 1e-9),
            f"req_per_s={rec['requests_per_s']} "
            f"tok_per_s={rec['tokens_per_s']} "
            f"p50_ms={rec['latency_ms']['p50']} "
            f"p99_ms={rec['latency_ms']['p99']} "
            f"occupancy={rec['mean_occupancy']}"))
    result["compiles"] = {
        "prefill_executables": engine.n_prefill_executables,
        "decode_executables": engine.n_decode_executables,
        "executables": engine.executables,
        "graphs": engine.captures,
        "on_card": engine.device.type == "cuda",
        "prompt_buckets": len(engine.buckets),
        "decode_batch_sizes": 1,
        "budget": engine.executable_budget,
    }
    rows.append(("serve/compiles", float(engine.executables),
                 f"budget={engine.executable_budget} "
                 f"buckets={len(engine.buckets)} decode_batches=1 "
                 f"graphs={engine.captures}"))
    return rows, result


def run(steps: int = 144, device: str = "cuda", n_requests: int = 16):
    """Harness entry point (``python -m repro_torch.bench.run --only
    serve``): CSV rows only."""
    rows, _ = _measure(n_requests=n_requests, device=device)
    return rows


def check_compiles(result) -> list:
    """The serving compile invariant as a gate: after the backlog and
    both arrival rates, at most one prefill entry per prompt bucket and
    exactly one decode entry; on the card every entry captured once, so
    as many graphs as entries."""
    errors = []
    c = result["compiles"]
    if c["executables"] > c["budget"]:
        errors.append(
            f"{c['executables']} entries exceed the budget {c['budget']} "
            f"(= {c['prompt_buckets']} prompt buckets + "
            f"{c['decode_batch_sizes']} decode batch sizes)")
    if c["prefill_executables"] > c["prompt_buckets"]:
        errors.append(
            f"{c['prefill_executables']} prefill entries for "
            f"{c['prompt_buckets']} prompt buckets — per-prompt-length "
            f"entries are back")
    if c["decode_executables"] != c["decode_batch_sizes"]:
        errors.append(
            f"{c['decode_executables']} decode entries for "
            f"{c['decode_batch_sizes']} decode batch sizes")
    if c.get("on_card") and c["graphs"] != c["executables"]:
        errors.append(f"{c['graphs']} graphs captured for "
                      f"{c['executables']} entries")
    return errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=48,
                    help="requests per workload (the throughput "
                         "comparison and each arrival rate)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ci", action="store_true",
                    help="16 requests, the reference's CI smoke")
    ap.add_argument("--check-compiles", action="store_true",
                    help="exit non-zero unless prefill entries <= "
                         "#prompt-buckets and decode entries == 1")
    ap.add_argument("--check-speedup", type=float, default=None,
                    help="exit non-zero unless engine/static requests/s "
                         ">= this floor (wall clock: not a CI gate)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    n = 16 if args.ci else args.requests
    rows, result = _measure(n_requests=n, seed=args.seed,
                            device=args.device)
    print("name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"-> {args.out}")
    ok = True
    if args.check_compiles:
        errors = check_compiles(result)
        for e in errors:
            print(f"serving compile invariant VIOLATED: {e}")
        ok = ok and not errors
        if not errors:
            print("serving compile invariant OK: one decode entry, "
                  "prefill entries <= #prompt-buckets")
    if args.check_speedup is not None:
        sp = result["throughput"]["speedup"]
        if sp < args.check_speedup:
            print(f"continuous-batching speedup {sp}x below the "
                  f"{args.check_speedup}x floor")
            ok = False
        else:
            print(f"continuous-batching speedup OK: {sp}x >= "
                  f"{args.check_speedup}x")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
