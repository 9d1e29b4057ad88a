"""Checkpoint stall benchmark: a synchronous save's wall time against
the step loop's stall on an asynchronous ``CheckpointManager.
request_save`` (``benchmarks/bench_checkpoint.py`` on the port).

A synchronous save blocks the loop for the whole device -> host ->
disk -> commit round trip.  The asynchronous one blocks it only for the
snapshot of the state on its device (one copy a tensor, queued on the
caller's stream) and the hand-off to the writer thread, which streams
and commits while the next steps run.  Both are measured on the
reference's workload, ``SEESAW_150M.reduced()`` after 8 steps at B = 2
of 64 tokens, as the median of ``--saves`` saves each.

Rows, in the reference's order: ``checkpoint/stall_sync`` and
``checkpoint/stall_async`` (µs).  ``check_stall`` requires the async
stall to be at least 5x smaller; ``check_schema`` round-trips one
checkpoint of the port's writer and checks the on-disk contract (format
version, generation, the meta fields a resume reads, each block's file,
bounds, crc32 and writer, the crc of every block on disk) and a bitwise
restore.

    PYTHONPATH=src python -m repro_torch.bench.checkpoint [--saves 5] \\
        [--check-stall] [--check-schema] [--device cpu] [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import tempfile
import time

import torch

from repro_torch.configs import OptimizerConfig, RunConfig, ScheduleConfig
from repro_torch.configs.seesaw_paper import SEESAW_150M
from repro_torch.data import MarkovLM, PhaseDataLoader
from repro_torch.train import checkpoint as CKPT
from repro_torch.train.trainer import Trainer

SEQ = 64
B0 = 2
STEPS = 8


def _trainer(device: str) -> Trainer:
    model = SEESAW_150M.reduced()
    cfg = RunConfig(
        model=model,
        schedule=ScheduleConfig(kind="cosine", base_lr=1e-3),
        optimizer=OptimizerConfig(kind="adamw"),
        seq_len=SEQ, global_batch_size=B0,
        total_tokens=SEQ * B0 * STEPS, remat=False)
    tr = Trainer(cfg, device=device, fuse_steps=4)
    # a few real steps, so the saves write a mid-run state (moments
    # filled, tokens_seen past 0)
    tr.run(PhaseDataLoader(MarkovLM(min(model.vocab_size, 2048), seed=0),
                           tr.plan, SEQ, device=device))
    return tr


def _state_tensors(tr: Trainer):
    st = tr.state
    out = list(st.model.parameters())
    for v in st.opt_state.values():
        out.extend(v.values() if isinstance(v, dict) else [v])
    return out


def _bench_stalls(tr: Trainer, workdir: str, saves: int):
    st = tr.state
    params, opt_state = tr._trees()
    sync_s, async_s = [], []
    sync_dir = os.path.join(workdir, "sync")
    for _ in range(saves):
        shutil.rmtree(sync_dir, ignore_errors=True)
        t0 = time.perf_counter()
        CKPT.save_phase_checkpoint(sync_dir, params, opt_state, st.step,
                                   st.tokens_seen, plan=tr.plan,
                                   seq_len=tr.cfg.seq_len)
        sync_s.append(time.perf_counter() - t0)

    mgr = tr.engine.make_checkpoint_manager()
    async_dir = os.path.join(workdir, "async")
    for i in range(saves):
        t0 = time.perf_counter()
        mgr.request_save(async_dir, params, opt_state, st.step + i,
                         st.tokens_seen)
        async_s.append(time.perf_counter() - t0)
        mgr.wait()               # not timed: drain before the next one
    mgr.finalize()
    if mgr.saves_committed < 1:
        raise RuntimeError("no async save committed")
    return statistics.median(sync_s), statistics.median(async_s)


def _measure(saves: int = 5, device: str = "cuda"):
    tr = _trainer(device)
    workdir = tempfile.mkdtemp(prefix="bench_ckpt_")
    try:
        stall_sync, stall_async = _bench_stalls(tr, workdir, saves)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    ratio = stall_sync / max(stall_async, 1e-9)
    n_bytes = sum(t.numel() * t.element_size() for t in _state_tensors(tr))
    result = {"model": tr.cfg.model.name, "device": device,
              "state_bytes": n_bytes, "saves": saves,
              "stall_sync_s": round(stall_sync, 4),
              "stall_async_s": round(stall_async, 4),
              "ratio": round(ratio, 2)}
    rows = [("checkpoint/stall_sync", 1e6 * stall_sync,
             f"state_mb={n_bytes / 1e6:.1f}"),
            ("checkpoint/stall_async", 1e6 * stall_async,
             f"ratio_vs_sync={ratio:.1f}x")]
    return rows, result


def run(saves: int = 5, device: str = "cuda"):
    """Harness entry point: CSV rows."""
    rows, _ = _measure(saves, device=device)
    return rows


def check_stall(result) -> list:
    """The async request must stall the step loop at least 5x less than
    a blocking save of the same state."""
    if result["ratio"] < 5.0:
        return [f"async stall ratio {result['ratio']}x < 5x "
                f"(sync {result['stall_sync_s']}s, "
                f"async {result['stall_async_s']}s)"]
    return []


def check_schema(device: str = "cuda") -> list:
    """Round-trip one checkpoint of the trained state and check the
    on-disk contract: the manifest's format and generation, the meta
    fields a resume depends on, each leaf's shape/dtype/shards and each
    shard's file/bounds/crc32/writer, the crc of every block on disk,
    and a bitwise restore into zeroed tensors."""
    errors = []
    tr = _trainer(device)
    st = tr.state
    params, opt_state = tr._trees()
    workdir = tempfile.mkdtemp(prefix="bench_ckpt_schema_")
    base = os.path.join(workdir, "ck")
    try:
        CKPT.save_phase_checkpoint(base, params, opt_state, st.step,
                                   st.tokens_seen, plan=tr.plan,
                                   seq_len=tr.cfg.seq_len)
        with open(os.path.join(base, "manifest.json")) as f:
            man = json.load(f)
        if man.get("format") != CKPT.FORMAT_VERSION:
            errors.append(f"format {man.get('format')} != "
                          f"{CKPT.FORMAT_VERSION}")
        if man.get("generation") != 0:
            errors.append(f"first generation {man.get('generation')}")
        meta = man.get("meta", {})
        for key in ("step", "tokens_seen", "phase", "batch_size",
                    "save_process_count"):
            if key not in meta:
                errors.append(f"meta missing {key!r}")
        n_leaves = len(CKPT._flat_state(params, opt_state))
        if len(man.get("arrays", {})) != n_leaves:
            errors.append(f"{len(man.get('arrays', {}))} manifest "
                          f"leaves != {n_leaves} state leaves")
        for name, entry in man.get("arrays", {}).items():
            for field in ("shape", "dtype", "shards"):
                if field not in entry:
                    errors.append(f"{name}: missing {field!r}")
            for shard in entry.get("shards", []):
                for field in ("file", "start", "stop", "crc32",
                              "writer"):
                    if field not in shard:
                        errors.append(f"{name}: shard missing "
                                      f"{field!r}")
                path = os.path.join(base, shard.get("file", ""))
                if not os.path.isfile(path):
                    errors.append(f"{name}: {shard.get('file')} "
                                  f"missing on disk")
                elif CKPT._crc_of_file(path) != shard.get("crc32"):
                    errors.append(f"{name}: crc mismatch on "
                                  f"{shard.get('file')}")
        want = [t.detach().clone() for t in _state_tensors(tr)]
        with torch.no_grad():
            for t in _state_tensors(tr):
                t.zero_()
        try:
            _, _, meta2 = CKPT.restore(base, params, opt_state,
                                       verify=True)
        except CKPT.CheckpointError as e:
            errors.append(f"restore: {e}")
        else:
            if not all(torch.equal(a, b)
                       for a, b in zip(_state_tensors(tr), want)):
                errors.append("restored state not bitwise")
            if CKPT.exact_tokens(meta2["tokens_seen"]) != st.tokens_seen:
                errors.append("tokens_seen did not round-trip")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--saves", type=int, default=5)
    ap.add_argument("--out", default=None)
    ap.add_argument("--check-stall", action="store_true")
    ap.add_argument("--check-schema", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    def write(result):
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(result, f, indent=2, sort_keys=True)
            print(f"wrote {args.out}")

    if args.check_schema:
        errors = check_schema(args.device)
        write({"schema_ok": not errors, "errors": errors})
        if errors:
            print("schema check failed:\n  " + "\n  ".join(errors))
            return 1
        print("schema check passed")
        return 0

    rows, result = _measure(args.saves, device=args.device)
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    write(result)
    if args.check_stall:
        errors = check_stall(result)
        if errors:
            print("stall check failed:\n  " + "\n  ".join(errors))
            return 1
        print(f"stall check passed: {result['ratio']}x")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
