"""The dry-run (``repro.launch.dryrun`` in PyTorch): every (architecture
× input shape) as one shape-only step of one rank on the reference's
production meshes (16x16 and 2x16x16), and one JSON record each.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
        --shape train_4k [--multipod] [--out artifacts/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The reference lowers and compiles the step on 512 forced host devices
and reads XLA's analyses.  The port has no compiler to ask, so it runs
the step itself, on one rank and on the meta device:

- A fake process group (``torch.testing._internal.distributed.fake_pg``)
  whose world is the mesh's size, this process its rank 0, holds the
  mesh's groups; its collectives move nothing.  A process holds one such
  group, so ``--all`` runs one subprocess a mesh.
- ``launch.steps.build_workload``'s meta model and input stand-ins are
  cut to rank 0's blocks (``parallel.shard``, ``launch.mesh.shard_box``,
  ``parallel.cache_layout``); rank 0 holds the largest blocks, also
  where the model axis does not divide the query heads
  (``parallel.head_block``).  Training turns the parameters' grads on,
  as ``registry.init_model(trainable=True)`` does, and AdamW's state is
  made over the rank's blocks.
- The step runs once under ``torch.utils.flop_counter.FlopCounterMode``,
  ``torch.distributed._tools.mem_tracker.MemTracker`` and a fresh
  ``parallel.Comms``.  The kernel wrappers take the card's path on meta
  tensors: they allocate what they allocate on the card and count their
  operations (``kernels._build.shape_only``) without launching.

The record has the reference's keys (``src/repro/launch/dryrun.py``):

- ``memory_analysis``: ``argument_size_in_bytes`` the rank's parameters,
  optimizer state and inputs; ``output_size_in_bytes`` the step's
  outputs; ``alias_size_in_bytes`` the outputs the step updates in place
  (the parameters and AdamW's state in training, the cache in decode:
  the reference's donation); ``temp_size_in_bytes`` the tracked peak
  less the arguments.  The ``generated_code`` and ``host_*`` sizes are
  ``None``: no compiled program holds them.
- ``cost_analysis``: ``flops``, ``FlopCounterMode``'s count (the
  products) plus the kernels' counts; ``bytes accessed`` is ``None``
  (nothing reads the step's traffic).
- ``collective_bytes`` and ``collective_counts`` by the reference's five
  kinds, from ``parallel.KINDS``: ``fsdp_gather``, ``model_all_gather``
  and ``slot_gather`` are all-gathers; ``grad_reduce`` and
  ``model_all_reduce`` all-reduces; ``model_all_to_all`` all-to-alls;
  ``model_reduce_scatter`` reduce-scatters; no collective-permute.  A
  byte count is that of the tensor handed to the collective (a rank's
  block for an all-gather, as ``Comms`` counts), where the reference
  counts the result's.  ``port_collectives`` keeps them by the port's
  own kinds.
- ``collective_bytes_in_loop`` is all zeros: the port unrolls its layers
  (a ``ModuleList``), so its counts are already whole, where the
  reference scans them and counts a loop body once.
- ``lower_s``, ``compile_s`` and ``hlo_lines`` are ``None`` (nothing is
  lowered or compiled); ``run_s`` is the step's wall time here.

Every number is of one rank, rank 0, and shape-only: nothing is
measured on a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch import parallel
from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES,
                                 OptimizerConfig, get_config)
from repro_torch.kernels import _build
from repro_torch.launch import mesh as MESH
from repro_torch.launch import steps as ST
from repro_torch.optim import optimizers as O

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
KIND_MAP = {"fsdp_gather": "all-gather", "grad_reduce": "all-reduce",
            "model_all_reduce": "all-reduce",
            "model_all_gather": "all-gather",
            "model_all_to_all": "all-to-all",
            "model_reduce_scatter": "reduce-scatter",
            "slot_gather": "all-gather"}
MEMORY_KEYS = ("alias_size_in_bytes", "argument_size_in_bytes",
               "generated_code_size_in_bytes", "host_alias_size_in_bytes",
               "host_argument_size_in_bytes",
               "host_generated_code_size_in_bytes",
               "host_output_size_in_bytes", "host_temp_size_in_bytes",
               "output_size_in_bytes", "temp_size_in_bytes")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
OUT = "artifacts/dryrun_torch"


def fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks, this process rank 0 (a
    group of another size is replaced)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_rank() == 0:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _tensors(tree):
    """Every tensor in a tree of dicts, lists, tuples and dataclasses (a
    ``DenseKVCache``)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _block(t: torch.Tensor, spec, mesh, rank: int, name: str):
    """A meta stand-in of ``rank``'s block of ``t`` under ``spec``."""
    box = MESH.shard_box(tuple(t.shape), spec, mesh, rank, name=name)
    return torch.empty(tuple(b - a for a, b in box), dtype=t.dtype,
                       device="meta")


def _cache_blocks(cfg, cache, tp, shape, cache_seq_shard: bool, dtype):
    """The decode cache stand-in cut to the rank's boxes of its layout,
    the leaves held in the compute dtype (``decode_struct``'s bfloat16)
    in the step's ``dtype``, the float32 states as they are; ``lengths``
    whole, as ``registry.prefill`` keeps them."""
    from repro_torch.serving.cache import DenseKVCache
    layout = parallel.cache_layout(cfg, tp, shape.global_batch,
                                   shape.seq_len, cache_seq_shard)

    def cut(name, t):
        box = layout.boxes[name]
        dt = dtype if t.dtype == torch.bfloat16 else t.dtype
        return torch.empty(tuple(b - a for a, b in box), dtype=dt,
                           device="meta")

    data = cache.data
    if isinstance(data, list):
        data = [{n: cut(n, t) for n, t in layer.items()} for layer in data]
    else:
        data = {n: cut(n, t) for n, t in data.items()}
    return DenseKVCache(data=data, lengths=cache.lengths, layout=layout)


def rank_step(cfg, shape, mesh, *, rank: int = 0, multi_pod: bool = False,
              opt_kind: str = "adamw", seq_shard: bool = True,
              remat_policy: str = "", serve_resident: bool = False,
              cache_seq_shard: bool = False, block_skip: bool = False,
              dtype=torch.bfloat16, slot_rows: bool = False):
    """(call, args by part, the aliased parts, the model) of ``rank``'s
    shape-only step: ``build_workload``'s stand-ins cut to the rank's
    blocks on the meta device.  ``slot_rows`` cuts a training batch by
    data slot, as the trainer feeds a mesh (``train.engine.slot_rows``),
    where the reference's input spec replicates a batch that 16 does not
    divide.  Needs a process group of the mesh's size (the groups are
    made at the first collective)."""
    fn, args, in_specs, _ = ST.build_workload(
        cfg, shape, multi_pod=multi_pod, opt_kind=opt_kind,
        block_skip=block_skip, seq_shard=seq_shard,
        remat_policy=remat_policy, serve_resident=serve_resident,
        cache_seq_shard=cache_seq_shard, dtype=dtype)
    model = parallel.shard(args[0], cfg, mesh, rank,
                           serve_resident=(serve_resident
                                           and shape.mode != "train"))
    params = dict(model.named_parameters())
    if shape.mode == "train":
        model.requires_grad_(True)
        opt = O.from_config(OptimizerConfig(kind=opt_kind))
        state = opt.init(params)
        if slot_rows:
            from repro_torch.train.engine import slot_rows as rows_of
            batch = rows_of(args[2], mesh, rank)
        else:
            batch = {k: _block(v, in_specs[2][k], mesh, rank, k)
                     for k, v in args[2].items()}
        lr = args[3]
        parts = {"params": params, "opt_state": state,
                 "inputs": (batch, lr)}
        return (lambda: fn(model, state, batch, lr), parts,
                ("params", "opt_state"), model)
    if shape.mode == "prefill":
        batch = {k: _block(v, in_specs[1][k], mesh, rank, k)
                 for k, v in args[1].items()}
        return (lambda: fn(model, batch),
                {"params": params, "inputs": batch}, (), model)
    cache = _cache_blocks(cfg, args[1], model.tp, shape, cache_seq_shard,
                          dtype)
    token = _block(args[2], in_specs[2], mesh, rank, "token")
    return (lambda: fn(model, cache, token),
            {"params": params, "cache": cache, "inputs": token},
            ("cache",), model)


def measure(cfg, shape, mesh, *, multi_pod: bool = False,
            **kw) -> Dict:
    """Rank 0's shape-only step on ``mesh`` (a fake group of its size
    made first): the record's analyses (the module's docstring)."""
    fake_group(mesh.size)
    call, parts, aliased, model = rank_step(cfg, shape, mesh,
                                            multi_pod=multi_pod, **kw)
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode
    tp = model.tp
    tp.comms.reset()
    _build.meta_ops = 0.0
    args = {k: _nbytes(v) for k, v in parts.items()}
    mt = MemTracker()
    mt.track_external(*(t for v in parts.values() for t in _tensors(v)))
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc, mt:
        out = call()
    run_s = time.perf_counter() - t0
    peak = mt.get_tracker_snapshot("peak").get(torch.device("meta"), {})
    argument = sum(args.values())
    output = _nbytes(out)
    mem = {k: None for k in MEMORY_KEYS}
    mem.update(argument_size_in_bytes=argument, output_size_in_bytes=output,
               alias_size_in_bytes=sum(args[k] for k in aliased),
               temp_size_in_bytes=max(int(peak.get("Total", 0)) - argument,
                                      0))
    cb = {k: 0 for k in COLLECTIVES}
    cc = {k: 0 for k in COLLECTIVES}
    for kind in parallel.KINDS:
        cb[KIND_MAP[kind]] += tp.comms.bytes[kind]
        cc[KIND_MAP[kind]] += tp.comms.calls[kind]
    return {
        "memory_analysis": mem,
        "argument_parts": args,
        "cost_analysis": {"flops": float(fc.get_total_flops())
                          + _build.meta_ops,
                          "kernel_flops": _build.meta_ops,
                          "bytes accessed": None},
        "collective_bytes": cb,
        "collective_bytes_in_loop": {k: 0 for k in COLLECTIVES},
        "collective_counts": cc,
        "port_collectives": {k: [tp.comms.calls[k], tp.comms.bytes[k]]
                             for k in parallel.KINDS},
        "held_params": sum(p.numel() for p in model.parameters()),
        "model_params": sum(
            int(torch.Size(s).numel()) for s in model.full_shapes.values()),
        "run_s": run_s,
    }


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_one(arch: str, shape_name: str, *, multi_pod: bool,
            out_dir: Optional[str] = OUT, block_skip: bool = False,
            seq_shard: bool = True, remat_policy: str = "",
            serve_resident: bool = False, capacity_factor: float = 0.0,
            cache_seq_shard: bool = False, mesh_shape: str = "",
            tag: str = "", cfg=None, shape=None,
            dtype=torch.bfloat16) -> dict:
    """One record, written to ``out_dir`` (None: not written).  ``cfg``
    and ``shape`` default to the arch's config and the named shape;
    ``mesh_shape`` ("DxM" or "PxDxM") replaces the production mesh, and
    a mesh with a pod axis cuts by the multi-pod specs.  The record's
    ``mesh`` is the production mesh's name, as the reference's is, and
    ``mesh_shape`` the mesh run."""
    cfg = cfg or get_config(arch)
    if capacity_factor and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    shape = shape or INPUT_SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name(multi_pod),
           "mode": shape.mode, "tag": tag or "baseline"}
    ok, why = ST.shape_supported(cfg, shape)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        _save(rec, out_dir)
        return rec
    t0 = time.time()
    try:
        if mesh_shape:
            mesh = MESH.Mesh(MESH.parse_mesh(mesh_shape))
            multi_pod = "pod" in mesh.shape
        else:
            mesh = MESH.make_production_mesh(multi_pod=multi_pod)
        rec["mesh_shape"] = "x".join(str(n) for n in mesh.shape.values())
        rec.update(measure(
            cfg, shape, mesh, multi_pod=multi_pod, block_skip=block_skip,
            seq_shard=seq_shard, remat_policy=remat_policy,
            serve_resident=serve_resident, cache_seq_shard=cache_seq_shard,
            dtype=dtype))
        rec["status"] = "ok"
        rec.update(lower_s=None, compile_s=None, hlo_lines=None)
        print(f"OK   {arch:26s} {shape_name:12s} {rec['mesh']:8s} "
              f"run={rec['run_s']:.1f}s", flush=True)
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = traceback.format_exc()[-2000:]
        print(f"FAIL {arch:26s} {shape_name:12s} {rec['mesh']}: "
              f"{str(e)[:200]}", flush=True)
    rec["wall_s"] = time.time() - t0
    _save(rec, out_dir)
    return rec


def _path(out_dir: str, arch: str, shape: str, mesh: str, tag: str) -> str:
    suffix = "" if not tag or tag == "baseline" else f".{tag}"
    return os.path.join(out_dir, f"{arch}.{shape}.{mesh}{suffix}.json")


def _save(rec: dict, out_dir: Optional[str]) -> None:
    if out_dir is None:
        return
    os.makedirs(out_dir, exist_ok=True)
    with open(_path(out_dir, rec["arch"], rec["shape"], rec["mesh"],
                    rec.get("tag", "baseline")), "w") as f:
        json.dump(rec, f, indent=1)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None,
                    help="an arch, or several joined by commas")
    ap.add_argument("--shape", default=None,
                    help="a shape, or several joined by commas")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--block-skip", action="store_true",
                    help="the reference's triangular blocking: the port "
                         "has no such path (build_workload raises)")
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--remat-policy", default="")
    ap.add_argument("--serve-resident", action="store_true")
    ap.add_argument("--capacity-factor", type=float, default=0.0)
    ap.add_argument("--cache-seq-shard", action="store_true")
    ap.add_argument("--mesh-shape", default="",
                    help="override mesh, e.g. 32x8 (data x model)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--skip-existing", action="store_true")
    return ap


def _records(args, multi_pod: bool):
    archs = ASSIGNED_ARCHS if args.all else args.arch.split(",")
    shapes = SHAPES if args.all else args.shape.split(",")
    for arch in archs:
        for shp in shapes:
            yield arch, shp, _path(args.out, arch, shp,
                                   mesh_name(multi_pod), args.tag)


def _worker_argv(args, todo, multi_pod: bool):
    """The argv of one mesh's subprocess: its records and every knob."""
    out = ["--out", args.out,
           "--arch", ",".join(dict.fromkeys(a for a, _, _ in todo)),
           "--shape", ",".join(dict.fromkeys(s for _, s, _ in todo))]
    flags = {"--multipod": multi_pod, "--no-seq-shard": args.no_seq_shard,
             "--serve-resident": args.serve_resident,
             "--cache-seq-shard": args.cache_seq_shard}
    out += [f for f, on in flags.items() if on]
    for flag, v in (("--remat-policy", args.remat_policy),
                    ("--capacity-factor", args.capacity_factor),
                    ("--mesh-shape", args.mesh_shape), ("--tag", args.tag)):
        if v:
            out += [flag, str(v)]
    return out


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    ST._refuse(args.block_skip)
    if not args.all and not (args.arch and args.shape):
        raise SystemExit("give --arch and --shape, or --all")
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multipod]
    results = []
    for mp in meshes:
        todo = []
        for arch, shp, path in _records(args, mp):
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    prev = json.load(f)
                if prev.get("status") in ("ok", "skipped"):
                    print(f"SKIP {arch} {shp} {mesh_name(mp)} (cached)")
                    results.append(prev)
                    continue
            todo.append((arch, shp, path))
        if not todo:
            continue
        if len(meshes) > 1:
            # a process holds one fake group: a subprocess a mesh
            subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                            *_worker_argv(args, todo, mp)], check=False)
            for _, _, path in todo:
                if os.path.exists(path):
                    with open(path) as f:
                        results.append(json.load(f))
            continue
        for arch, shp, _ in todo:
            results.append(run_one(
                arch, shp, multi_pod=mp, out_dir=args.out,
                seq_shard=not args.no_seq_shard,
                remat_policy=args.remat_policy,
                serve_resident=args.serve_resident,
                capacity_factor=args.capacity_factor,
                cache_seq_shard=args.cache_seq_shard,
                mesh_shape=args.mesh_shape, tag=args.tag))
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\ndone: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"/ {len(results)} total")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
