"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``) and against real ranks, on the CPU.

- The 80 (arch, shape, mesh) records of ``--all``: each has the
  reference's skip decision and reason (``launch.steps.
  shape_supported``); the skipped ones are written as the reference
  writes them, under its file names.  ``ASSIGNED_ARCHS`` is the
  reference's list.
- ``parallel.check_model`` and ``check_batch`` take all 10 archs at
  train_4k, prefill_32k and decode_32k on both production meshes
  (16x16, 2x16x16): llama3.2-3b's, starcoder2-3b's and yi-34b's query
  heads that 16 does not divide, and the MoE's decode group of 128
  tokens over 16 or 32 data slots.
- Records of reduced configs, one a family × train / prefill / decode on
  2x2 and 2x2x2 (B 8 × S 64, the reference's own small dry-run shapes),
  all made in one subprocess (a process holds one fake group): status
  ``ok`` and the reference's keys (its memory analysis's, from a
  compiled jitted function here; its five collective kinds).  In the
  same subprocess, the dry-run's memory tracker counts none of the whole
  decode cache's meta stand-ins that ``parallel.cache_layout`` reads
  inside a prefill (``registry.decode_struct`` makes them outside any
  dispatch mode).
- Against real ranks (two ``mesh_cases`` runs of gloo processes, each
  running ``build_workload``'s ``fn`` on a rank-only init): granite's
  training step on 2x2 (its routing group spanning the two data slots)
  and its prefill and decode steps on 2x2, float32.  The dry-run's
  collective calls and bytes, by the port's kinds, equal rank 0's
  measured ones, and its argument bytes equal the bytes of the
  parameters, optimizer state, inputs and cache rank 0 holds.
"""
import ast
import json
import os
import subprocess
import sys

import pytest

import mesh_cases as MC
from repro_torch import parallel
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as MESH
from repro_torch.launch import steps as ST

ROOT = MC.ROOT


def _ref_constant(name):
    """A constant of ``repro.launch.dryrun``, read from its source (the
    module sets a 512-device XLA flag when imported)."""
    path = os.path.join(ROOT, "src", "repro", "launch", "dryrun.py")
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == name:
            return ast.literal_eval(node.value)
    raise KeyError(name)


def test_assigned_archs_are_the_references():
    from repro.configs import ASSIGNED_ARCHS as J
    assert ASSIGNED_ARCHS == J


def test_skip_decisions_match_the_reference(tmp_path):
    from repro.configs import INPUT_SHAPES as JS
    from repro.configs import get_config as jget
    from repro.launch import steps as JST
    skipped = 0
    for arch in ASSIGNED_ARCHS:
        for shape in D.SHAPES:
            want = JST.shape_supported(jget(arch), JS[shape])
            assert ST.shape_supported(get_config(arch),
                                      INPUT_SHAPES[shape]) == want
            if want[0]:
                continue
            for mp in (False, True):
                rec = D.run_one(arch, shape, multi_pod=mp,
                                out_dir=str(tmp_path))
                assert (rec["status"], rec["reason"]) == ("skipped", want[1])
                name = f"{arch}.{shape}.{'2x16x16' if mp else '16x16'}.json"
                with open(tmp_path / name) as f:
                    assert json.load(f) == rec
                skipped += 1
    assert skipped == 14 and len(ASSIGNED_ARCHS) * len(D.SHAPES) * 2 == 80


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_meshes_take_every_arch(multi_pod):
    mesh = MESH.make_production_mesh(multi_pod=multi_pod)
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        parallel.check_model(cfg, mesh)
        parallel.check_model(cfg, mesh, serve_resident=True)
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            s = INPUT_SHAPES[shape]
            parallel.check_batch(cfg, mesh, s.global_batch,
                                 1 if s.mode == "decode" else s.seq_len)


FAMILIES = {"dense": "llama3.2-3b", "moe": "granite-moe-1b-a400m",
            "vlm": "internvl2-76b", "ssm": "mamba2-2.7b",
            "hybrid": "recurrentgemma-9b", "audio": "seamless-m4t-medium"}
SHAPE_OF = {"train": (64, 8), "prefill": (64, 8), "decode": (64, 8)}

# granite reduced, 2x2, float32: a training step whose routing group of
# 256 tokens (the whole batch) spans the two data slots (8 rows of 16
# each), and the serving steps (a decode step's group of 16 tokens spans
# them too)
GRANITE = "granite-moe-1b-a400m"
TRAIN = ("t", 16, 16, "train")
PREFILL = ("p", 32, 16, "prefill")
DECODE = ("d", 48, 16, "decode")

# one subprocess: every record of this file (one fake group a process)
RECORDS = r"""
import dataclasses, json, sys
import torch
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun as D
out_path, families, shape_of, extra = sys.argv[1:5]
out = {}
for fam, arch in json.loads(families).items():
    cfg = get_config(arch).reduced()
    if cfg.arch_type == "audio":
        cfg = dataclasses.replace(cfg, n_encoder_layers=2)
    for mode, (S, B) in json.loads(shape_of).items():
        for mesh in ("2x2", "2x2x2"):
            out[f"{fam}/{mode}/{mesh}"] = D.run_one(
                arch, mode, multi_pod=False, out_dir=None, cfg=cfg,
                shape=InputShape(mode, S, B, mode), mesh_shape=mesh)
for key, (arch, shape) in json.loads(extra).items():
    out[key] = D.run_one(arch, key, multi_pod=False, out_dir=None,
                         cfg=get_config(arch).reduced(),
                         shape=InputShape(*shape), mesh_shape="2x2",
                         dtype=torch.float32)
# the whole decode cache's meta stand-ins under the dry-run's tracker,
# beside one meta tensor of 128 bytes that it must count
from torch.distributed._tools.mem_tracker import MemTracker
from repro_torch.models import registry as R
mt = MemTracker()
with mt:
    R.decode_struct(get_config("llama3.2-3b"), 128, 32768)
    kept = torch.empty(4, 8, device="meta")
out["stand_ins"] = mt.get_tracker_snapshot("peak").get(
    torch.device("meta"), {}).get("Total", 0)
with open(out_path, "w") as f:
    json.dump(out, f)
"""

# one gloo rank of 2x2: granite's training, prefill and decode steps from
# build_workload on a rank-only init, float32; its collectives by kind and
# the bytes it holds
RANK = r"""
import json, os, sys
import torch
torch.set_num_threads(1)
rank, world, port, d, spec = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4], sys.argv[5])
from repro_torch import parallel
from repro_torch.configs import OptimizerConfig, get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import mesh as M
from repro_torch.launch import steps as ST
from repro_torch.launch.train import maybe_init_distributed
from repro_torch.models import registry as R
from repro_torch.optim import optimizers as O

assert maybe_init_distributed(f"127.0.0.1:{port}", world, rank,
                              device="cpu")
mesh = M.make_launch_mesh(spec, distributed=True)
cfg = get_config(%r).reduced()
TRAIN, PREFILL, DECODE = %r, %r, %r


def nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts)


def tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors(v)]
    return []


def comms(tp):
    return {k: [tp.comms.calls[k], tp.comms.bytes[k]]
            for k in parallel.KINDS}


def rows(t, spec):
    box = M.shard_box(tuple(t.shape), spec, mesh, rank)
    return t[tuple(slice(a, b) for a, b in box)].contiguous()


out = {}
g = torch.Generator().manual_seed(0)
model = R.init_model(cfg, dtype=torch.float32, device="cpu",
                     trainable=True, mesh=mesh, rank=rank)
shape = InputShape(*TRAIN)
fn, _, ins, _ = ST.build_workload(cfg, shape, dtype=torch.float32)
opt = O.from_config(OptimizerConfig())
state = opt.init(dict(model.named_parameters()))
toks = torch.randint(0, cfg.vocab_size, (shape.global_batch, shape.seq_len),
                     generator=g)
batch = {"tokens": rows(toks, ins[2]["tokens"]),
         "labels": rows(toks.roll(-1, 1), ins[2]["labels"])}
lr = torch.tensor(1e-3)
args = nbytes(list(model.parameters()) + tensors(state) + tensors(batch)
              + [lr])
model.tp.comms.reset()
fn(model, state, batch, lr)
out["train"] = {"comms": comms(model.tp), "args": args}

model = R.init_model(cfg, dtype=torch.float32, device="cpu", mesh=mesh,
                     rank=rank)
tp = model.tp
shape = InputShape(*PREFILL)
fn, _, ins, _ = ST.build_workload(cfg, shape, dtype=torch.float32)
toks = torch.randint(0, cfg.vocab_size, (shape.global_batch, shape.seq_len),
                     generator=g)
batch = {"tokens": rows(toks, ins[1]["tokens"])}
tp.comms.reset()
with torch.no_grad():
    fn(model, batch)
out["prefill"] = {"comms": comms(tp),
                  "args": nbytes(list(model.parameters()) + [batch["tokens"]])}
dshape = InputShape(*DECODE)
fn, _, ins, _ = ST.build_workload(cfg, dshape, dtype=torch.float32)
with torch.no_grad():
    logits, cache = R.prefill(model, cfg, batch["tokens"],
                              cache_len_cap=dshape.seq_len,
                              global_batch=shape.global_batch)
    tok = tp.greedy(logits)[:, -1:]
    args = nbytes(list(model.parameters()) + tensors(cache.data)
                  + [cache.lengths, tok])
    tp.comms.reset()
    fn(model, cache, tok)
out["decode"] = {"comms": comms(tp), "args": args}
if rank == 0:
    with open(os.path.join(d, "ranks.json"), "w") as f:
        json.dump(out, f)
torch.distributed.destroy_process_group()
""" % (GRANITE, TRAIN, PREFILL, DECODE)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    extra = {"train": (GRANITE, TRAIN), "prefill": (GRANITE, PREFILL),
             "decode": (GRANITE, DECODE)}
    recs = subprocess.Popen(
        [sys.executable, "-c", RECORDS, str(d / "records.json"),
         json.dumps(FAMILIES), json.dumps(SHAPE_OF), json.dumps(extra)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    ranks = MC.spawn(d, "2x2", RANK)
    MC.wait(ranks)
    o, e = recs.communicate(timeout=400)
    assert recs.returncode == 0, (o[-2000:], e[-4000:])
    with open(d / "records.json") as f:
        records = json.load(f)
    with open(d / "ranks.json") as f:
        measured = json.load(f)
    return records, measured


def _reference_memory_keys():
    import jax
    import jax.numpy as jnp
    ma = jax.jit(lambda x: x * 2).lower(jnp.ones(4)).compile() \
        .memory_analysis()
    return {k for k in dir(ma)
            if k.endswith("_size_in_bytes") and not k.startswith("_")}


def test_family_records_have_the_reference_keys(runs):
    records, _ = runs
    top = {"arch", "shape", "mesh", "mode", "tag", "status", "lower_s",
           "compile_s", "memory_analysis", "cost_analysis",
           "collective_bytes", "collective_bytes_in_loop",
           "collective_counts", "hlo_lines"}
    kinds = set(_ref_constant("_COLLECTIVES"))
    mem = _reference_memory_keys()
    for fam in FAMILIES:
        for mode in SHAPE_OF:
            for mesh in ("2x2", "2x2x2"):
                rec = records[f"{fam}/{mode}/{mesh}"]
                assert rec["status"] == "ok", rec.get("error")
                assert top <= set(rec), (fam, mode, set(top) - set(rec))
                assert rec["mesh_shape"] == mesh
                assert set(rec["memory_analysis"]) == mem
                assert {"flops", "bytes accessed"} <= set(
                    rec["cost_analysis"])
                assert rec["cost_analysis"]["flops"] > 0
                for k in ("collective_bytes", "collective_bytes_in_loop",
                          "collective_counts"):
                    assert set(rec[k]) == kinds
                assert not any(rec["collective_bytes_in_loop"].values())
                m = rec["memory_analysis"]
                assert m["argument_size_in_bytes"] > 0
                assert m["temp_size_in_bytes"] >= 0


def test_cache_stand_ins_are_not_tracked(runs):
    """The whole decode cache's meta stand-ins, which
    ``parallel.cache_layout`` reads inside a prefill, are made outside any
    dispatch mode: the dry-run's memory tracker counts none of their
    bytes (llama3.2-3b's decode_32k cache, B 128: 498 GB it would
    otherwise count in a prefill's peak), only the 128-byte tensor made
    beside them."""
    records, _ = runs
    assert records["stand_ins"] == 128


@pytest.mark.parametrize("step", ["train", "prefill", "decode"])
def test_collectives_and_arguments_equal_real_ranks(runs, step):
    records, measured = runs
    rec, got = records[step], measured[step]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["port_collectives"] == got["comms"]
    assert rec["memory_analysis"]["argument_size_in_bytes"] == got["args"]
    by_kind = {k: 0 for k in D.COLLECTIVES}
    for kind, (calls, nbytes) in got["comms"].items():
        by_kind[D.KIND_MAP[kind]] += nbytes
    assert rec["collective_bytes"] == by_kind
    if step in ("train", "decode"):         # the group spans 2 slots
        assert got["comms"]["slot_gather"][0] > 0
