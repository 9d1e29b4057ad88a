"""Engine dispatch benchmark: a step at a time with the host in the loop
against K-step chunks, K in {1, 4, 16} (``benchmarks/bench_engine.py``
on the port).

Rows, in the reference's order, for each of two regimes:

- ``engine/{regime}/eager_per_step_sync``: µs a step when each step is
  its own ``run_chunk`` call with the LR evaluated on the host
  beforehand and every metric read back (a blocking transfer) after.
- ``engine/{regime}/fused_k{K}``: µs a step when the loader hands the
  engine chunks of K steps and the metrics are read once, after the run.
- ``engine/{regime}/host_overhead_us_per_step``: eager minus fused K=16.

The regimes are the reference's: ``dispatch``, a reduced LM (2 layers,
4 heads of 32) whose step is a few ms, so the host's share is large;
``smoke150m``, ``SEESAW_150M.reduced()``, a heavier step.  Then
``engine/compiles/{seesaw,step}``: entries of the step cache after a
ramp of three batch sizes (Seesaw) and after three phases of one batch
size (``step``), 52 steps at K = 16.

What the port measures where it cannot do as the reference does:

- **"eager" and "fused".**  The reference's eager row dispatches one
  jitted step per call and its fused rows one jitted K-step scan per
  call.  The port's engine replays one captured CUDA graph per step on
  the card (``train.engine.PhaseEngine``), whatever K: a chunk of K is
  K replays queued by one call, with no host read between them.  So
  here "eager" is a replay per call plus the host's LR and a blocking
  read of every metric, "fused K" K replays per call and one read at
  the end; the difference is the host's round trips, the overhead the
  reference's fusion removes.  On the CPU every step runs eagerly.
- **Compiles.**  The port compiles nothing; its compile cache is the
  step cache, one entry per (batch size, micro) (on the card one
  captured graph each).  ``executables`` counts the entries as the
  reference counts executables; K is a loop on the host, not part of
  the key, so ``chunk_ks`` records the chunk lengths the engine was
  handed (the loader pads tails to K: [16]).  The adaptive record's
  ``prewarms_in_flight`` is 0: nothing is compiled in the background.

    PYTHONPATH=src python -m repro_torch.bench.engine [--steps 144] \\
        [--check-compiles] [--schedule adaptive-seesaw] [--device cpu] \\
        [--out chiprun_out/bench_engine.json]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.configs import (ModelConfig, OptimizerConfig, RunConfig,
                                 ScheduleConfig)
from repro_torch.configs.seesaw_paper import SEESAW_150M
from repro_torch.data import MarkovLM, PhaseDataLoader
from repro_torch.train.trainer import Trainer

# the reference's reduced-scale LM: dispatch-bound (a few ms a step)
DISPATCH_LM = ModelConfig(name="engine-lm", arch_type="dense",
                          n_layers=2, d_model=128, n_heads=4,
                          n_kv_heads=4, head_dim=32, d_ff=256,
                          vocab_size=512, max_seq_len=64,
                          rope_theta=1e4)
KS = (1, 4, 16)
# untimed steps first: the eager step, then the capture of the graph
WARM_STEPS = 2
DEFAULT_OUT = os.path.join("chiprun_out", "bench_engine.json")


def _cfg(model: ModelConfig, seq: int, b0: int, steps: int) -> RunConfig:
    # cosine: one phase (one chunk shape), and a host LR that is real
    # work in the eager loop
    return RunConfig(
        model=model,
        schedule=ScheduleConfig(kind="cosine", base_lr=1e-3),
        optimizer=OptimizerConfig(kind="adamw"),
        seq_len=seq, global_batch_size=b0,
        total_tokens=seq * b0 * steps, remat=False)


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _bench_eager(model, seq, b0, steps, device) -> float:
    """A step a call: the LR on the host first, every metric read back
    after."""
    tr = Trainer(_cfg(model, seq, b0, steps + WARM_STEPS), device=device,
                 fuse_steps=1)
    loader = PhaseDataLoader(MarkovLM(512, seed=0), tr.plan, seq,
                             device=device, prefetch=0)
    it = iter(loader)
    st = tr.state
    n, tokens, t0 = 0, 0, None
    for i, (_, _, batch) in enumerate(it):
        if i == WARM_STEPS:
            t0, n = time.perf_counter(), 0
        tr.engine.host_lr(tokens, i)                       # host LR
        _, _, m = tr.engine.run_chunk(
            st.model, st.opt_state, tokens,
            {k: v[None] for k, v in batch.items()}, step=i)
        {k: float(v[0]) for k, v in m.items()}             # blocking
        tokens += seq * b0
        n += 1
    return n / (time.perf_counter() - t0)


def _bench_fused(model, seq, b0, steps, k, device):
    warm = -(-WARM_STEPS // k) * k
    tr = Trainer(_cfg(model, seq, b0, steps + warm), device=device,
                 fuse_steps=k)
    loader = PhaseDataLoader(MarkovLM(512, seed=0), tr.plan, seq,
                             device=device)
    st = tr.state
    done, tokens, pending, t0 = 0, 0, [], None
    for _, stacked, mk in loader.iter_chunks(k):
        if t0 is None and done >= WARM_STEPS:
            _sync(device)
            t0, n, pending = time.perf_counter(), 0, []
        _, _, m = tr.engine.run_chunk(st.model, st.opt_state, tokens,
                                      stacked, n_valid=mk, step=done)
        pending.append(m)                     # read after the run
        tokens += mk * seq * b0
        done += mk
        if t0 is not None:
            n += mk
    _sync(device)
    [{k: v.cpu() for k, v in m.items()} for m in pending]
    return n / (time.perf_counter() - t0), len(tr.engine._cache)


def _regime(name, model, seq, b0, steps, rows, result, device):
    sps_eager = _bench_eager(model, seq, b0, steps, device)
    rows.append((f"engine/{name}/eager_per_step_sync", 1e6 / sps_eager,
                 f"steps_per_s={sps_eager:.1f}"))
    reg = {"model": model.name, "seq_len": seq, "batch_size": b0,
           "steps": steps, "eager_steps_per_s": round(sps_eager, 2),
           "fused": {}}
    for k in KS:
        sps, n_exec = _bench_fused(model, seq, b0, steps, k, device)
        rows.append((f"engine/{name}/fused_k{k}", 1e6 / sps,
                     f"steps_per_s={sps:.1f} "
                     f"speedup_vs_eager={sps / sps_eager:.2f}x "
                     f"executables={n_exec}"))
        reg["fused"][str(k)] = {
            "steps_per_s": round(sps, 2),
            "speedup_vs_eager": round(sps / sps_eager, 3),
            "executables": n_exec}
    sps16 = reg["fused"]["16"]["steps_per_s"]
    reg["host_overhead_ms_per_step"] = round(
        1e3 * (1.0 / sps_eager - 1.0 / sps16), 2)
    rows.append((f"engine/{name}/host_overhead_us_per_step",
                 1e6 * (1.0 / sps_eager - 1.0 / sps16),
                 "eager_minus_fused16"))
    result[name] = reg


def _counted_run(tr: Trainer, device: str):
    """Run ``tr`` to the end of its plan, recording the chunk length K
    of every call the engine was handed."""
    ks = set()
    run_chunk = tr.engine.run_chunk

    def recording(model, opt_state, tokens_seen, stacked, *a, **kw):
        ks.add(next(iter(stacked.values())).shape[0])
        return run_chunk(model, opt_state, tokens_seen, stacked, *a, **kw)

    tr.engine.run_chunk = recording
    tr.run(PhaseDataLoader(MarkovLM(512, seed=0), tr.plan, 16,
                           device=device))
    return sorted(ks)


def _compile_counts(rows, result, device):
    """One entry per distinct batch size on multi-phase ramps at K = 16
    with step counts that are not multiples of 16 (tail padding in
    play): Seesaw ramps through 3 batch sizes, ``step`` (β = 1) has 3
    phases of one batch size."""
    out = {}
    for kind in ("seesaw", "step"):
        cfg = RunConfig(
            model=DISPATCH_LM,
            schedule=ScheduleConfig(kind=kind, base_lr=1e-3, alpha=2.0,
                                    n_cuts=2),
            optimizer=OptimizerConfig(kind="adamw"),
            seq_len=16, global_batch_size=2,
            total_tokens=16 * 2 * 52, remat=False)
        tr = Trainer(cfg, device=device, fuse_steps=16)
        ks = _counted_run(tr, device)
        out[kind] = {
            "phases": len(tr.plan.phases),
            "distinct_batch_sizes": len(set(tr.plan.batch_sizes())),
            "executables": len(tr.engine._cache),
            "graphs": tr.engine.captures,
            "chunk_ks": ks,
            "steps": len(tr.history)}
        rows.append((f"engine/compiles/{kind}",
                     float(out[kind]["executables"]),
                     f"distinct_b={out[kind]['distinct_batch_sizes']} "
                     f"steps={out[kind]['steps']} k16_only="
                     f"{out[kind]['chunk_ks'] == [16]}"))
    result["compiles"] = out


def _adaptive_compiles(rows, result, device):
    """The step cache under phases made at run time: an adaptive-seesaw
    run whose plateau controller fires keeps one entry per distinct
    batch size (a cut changes values on the host, not the graphs)."""
    cfg = RunConfig(
        model=DISPATCH_LM,
        schedule=ScheduleConfig(kind="adaptive-seesaw", base_lr=1e-2,
                                warmup_frac=0.02, alpha=2.0, n_cuts=4,
                                plateau_window=16,
                                plateau_threshold=2e-2, ema_decay=0.9),
        optimizer=OptimizerConfig(kind="adamw"),
        seq_len=16, global_batch_size=2,
        total_tokens=16 * 2 * 360, remat=False)
    tr = Trainer(cfg, device=device, fuse_steps=16)
    ks = _counted_run(tr, device)
    rec = {
        "phases": len(tr.plan.phases),
        "cuts": len(tr.cut_tokens),
        "distinct_batch_sizes": len(set(tr.plan.batch_sizes())),
        "executables": len(tr.engine._cache),
        "graphs": tr.engine.captures,
        "prewarms_in_flight": 0,
        "chunk_ks": ks,
        "steps": len(tr.history)}
    rows.append(("engine/compiles/adaptive",
                 float(rec["executables"]),
                 f"cuts={rec['cuts']} "
                 f"distinct_b={rec['distinct_batch_sizes']} "
                 f"steps={rec['steps']} k16_only="
                 f"{rec['chunk_ks'] == [16]}"))
    result["compiles"]["adaptive"] = rec


def _measure(steps: int = 144, compiles_only: bool = False,
             schedule: str = None, device: str = "cuda"):
    steps -= steps % 48          # divisible by every K in KS
    steps = max(steps, 48)
    rows, result = [], {"device": device}
    if not compiles_only:
        _regime("dispatch", DISPATCH_LM, 16, 1, steps, rows, result,
                device)
        _regime("smoke150m", SEESAW_150M.reduced(), 16, 1,
                min(steps, 48), rows, result, device)
    _compile_counts(rows, result, device)
    if schedule == "adaptive-seesaw":
        _adaptive_compiles(rows, result, device)
    return rows, result


def run(steps: int = 144, device: str = "cuda"):
    """Harness entry point (``python -m repro_torch.bench.run --only
    engine``): CSV rows only."""
    rows, _ = _measure(steps, device=device)
    return rows


def check_compiles(result) -> list:
    """The reference's gate: every ramp of the ``compiles`` section holds
    exactly one step-cache entry per distinct batch size (the adaptive
    run at most one more), every chunk it ran had K = 16, and on the
    card each entry was captured once."""
    errors = []
    for kind, rec in result["compiles"].items():
        if kind == "adaptive":
            if rec["executables"] > rec["distinct_batch_sizes"] + 1:
                errors.append(
                    f"adaptive: {rec['executables']} entries for "
                    f"{rec['distinct_batch_sizes']} distinct batch sizes")
            if rec["cuts"] < 1:
                errors.append(
                    "adaptive: the plateau controller never fired — "
                    "the run did not exercise phases made at run time")
        elif rec["executables"] != rec["distinct_batch_sizes"]:
            errors.append(
                f"{kind}: {rec['executables']} entries for "
                f"{rec['distinct_batch_sizes']} distinct batch sizes")
        if rec["chunk_ks"] != [16]:
            errors.append(f"{kind}: chunks of {rec['chunk_ks']} != [16]")
        if result.get("device", "cuda") != "cpu" and \
                rec["graphs"] != rec["executables"]:
            errors.append(f"{kind}: {rec['graphs']} graphs captured for "
                          f"{rec['executables']} entries")
    return errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=144)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--compiles-only", action="store_true",
                    help="skip the timing regimes, run only the "
                         "compiles section")
    ap.add_argument("--check-compiles", action="store_true",
                    help="exit non-zero unless the compiles section "
                         "shows one step-cache entry per distinct batch "
                         "size")
    ap.add_argument("--schedule", default=None,
                    choices=["adaptive-seesaw"],
                    help="add the adaptive-seesaw compiles record")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    rows, result = _measure(args.steps, compiles_only=args.compiles_only,
                            schedule=args.schedule, device=args.device)
    print("name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"-> {args.out}")
    if args.check_compiles:
        errors = check_compiles(result)
        for e in errors:
            print(f"compiles invariant VIOLATED: {e}")
        if errors:
            return 1
        print("compiles invariant OK: one step-cache entry per distinct "
              "batch size")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
