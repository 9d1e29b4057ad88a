"""The port's sharded step on data × model meshes of gloo processes,
against the reference's single-device step, on the CPU.

- Loss and grads: the reduced llama3.2-3b (GQA 4/2, tied head) and the
  reduced seesaw-150m (untied), float32, remat on, on meshes 2x2, 1x2
  and 2x1x2: the sharded loss within 1e-5 of the reference's
  single-device ``value_and_grad``, every gathered grad within 1e-4 of
  its leaf's max, ``grad_norm`` within 1e-5 relative of one process's
  ``optimizers.global_norm``.  That is tighter than the reference's own
  sharded test (1e-4 and 5e-3 absolute).
- The reference's own sharded step cannot run: under JAX 0.9.0 its
  ``loss_fn`` on a (2, 2) mesh raises ``DuplicateSpecError`` at the
  embedding gather (``x = emb[tokens]``, ``tok`` sharded ("model",
  "data"), the tokens over "data"); the port's vocab-parallel embedding
  runs there, and its 2x2 loss is the reference's single-device loss.
- A Seesaw run: ``launch.train --mesh 2x2 --reduced --device cpu
  --dtype float32`` as four ranks, from the reference ``Trainer``'s
  initial weights (its step-0 checkpoint, resumed), across one cut: step
  for step the JAX ``Trainer`` on one device (loss within 5e-4; step,
  tokens, LR, batch size and phase equal).
- Checkpoints: a 2x2 save's manifest (files, start, stop, writer) is
  what the reference's ``_plan_writes`` gives for the same leaves and
  specs on a forced 4-device (2, 2) mesh, each device standing for a
  process; leaves have several blocks and the writers rotate over the 4
  ranks.  The resumes 2x2 → one process and one process → 2x2 are
  bitwise, a reference single-device checkpoint restores onto the mesh
  bitwise, and the reference's ``CKPT.restore`` reads the 2x2 save
  bitwise.

The ranks are ``python -c`` processes (no JAX imported) on free ports,
as ``tests/test_torch_distributed.py`` starts them.
"""
import json
import os
import shutil
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data import MarkovLM as JMarkovLM
from repro.data import PhaseDataLoader as JLoader
from repro.models import registry as JR
from repro.train import checkpoint as JCKPT
from repro.train.trainer import Trainer as JTrainer
from repro_torch import weights as W
from repro_torch.optim import optimizers as O
from repro_torch.train import checkpoint as CKPT
from repro_torch.train.trainer import Trainer

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
ARCHS = ("llama3.2-3b", "seesaw-150m")
MESHES = ("2x2", "1x2", "2x1x2")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the ranks and the workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the runs' configs, exec'd here and in the ranks
CONFIGS = r'''
SEQ, B0, STEPS, CKPT_STEPS = 32, 4, 12, 3


def run_cfg(pkg, steps=STEPS):
    """What ``launch.train --reduced --batch-size 4 --seq-len 32 --steps
    12 --max-cuts 1 --dtype float32`` builds: the reduced seesaw-150m,
    a Seesaw ramp B 4 -> 8 (10 steps)."""
    return pkg.RunConfig(
        model=pkg.get_config("seesaw-150m").reduced(),
        schedule=pkg.ScheduleConfig(kind="seesaw", base_lr=3e-3, alpha=2.0,
                                    beta=2.0, n_cuts=1, ema_decay=0.98,
                                    plateau_window=50,
                                    plateau_threshold=2e-3),
        optimizer=pkg.OptimizerConfig(kind="adamw"), seq_len=SEQ,
        global_batch_size=B0, total_tokens=steps * B0 * SEQ,
        dtype="float32")


def launch_args(ck):
    return ["--device", "cpu", "--reduced", "--batch-size", str(B0),
            "--seq-len", str(SEQ), "--steps", str(STEPS), "--max-cuts", "1",
            "--dtype", "float32", "--checkpoint", ck, "--resume"]
'''
exec(CONFIGS)

RANK = CONFIGS + r'''
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
rank, world, port, d, spec, job = (int(sys.argv[1]), int(sys.argv[2]),
                                   sys.argv[3], sys.argv[4], sys.argv[5],
                                   sys.argv[6])
from repro_torch import parallel
from repro_torch.launch import mesh as M
from repro_torch.launch.train import maybe_init_distributed
import repro_torch.configs as C
from repro_torch.configs import get_config
from repro_torch.train import engine as E
from repro_torch.train.trainer import Trainer
from repro_torch.weights import from_jax_params, to_jax_opt_state, \
    to_jax_params

if job == "launch":
    from repro_torch.launch import train as launch_train
    hist = launch_train.main(launch_args(os.path.join(d, "jck0_launch")) + [
        "--mesh", spec, "--coordinator", f"127.0.0.1:{port}",
        "--num-processes", str(world), "--process-id", str(rank)])
    with open(os.path.join(d, f"launch{rank}.json"), "w") as f:
        json.dump(hist, f)
    sys.exit(0)

assert maybe_init_distributed(f"127.0.0.1:{port}", world, rank,
                              device="cpu")
mesh = M.make_launch_mesh(spec, distributed=True)


def unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, last = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def full(model, name, local):
    shape, spec_ = model.full_shapes[name], model.specs[name]
    boxes = [M.shard_box(shape, spec_, mesh, r) for r in range(mesh.size)]
    return parallel.gather_full(local, shape, boxes)


def save(obj, name):
    if rank == 0:
        torch.save(obj, os.path.join(d, name))


if job == "grads":
    out = {}
    for arch in ("llama3.2-3b", "seesaw-150m"):
        cfg = get_config(arch).reduced()
        ref = np.load(os.path.join(d, f"{arch}.npz"))
        tree = unflatten({k: ref[k] for k in ref.files
                          if k not in ("tokens", "labels")})
        model = from_jax_params(tree, cfg, dtype=torch.float32,
                                device="cpu", trainable=True, mesh=mesh)
        tp = model.tp
        b = ref["tokens"].shape[0] // mesh.n_fsdp
        rows = slice(tp.fsdp_index * b, (tp.fsdp_index + 1) * b)
        batch = {k: torch.from_numpy(ref[k][rows]).long()
                 for k in ("tokens", "labels")}
        params = dict(model.named_parameters())
        names, plist = list(params), list(params.values())
        grads, metrics = E._local_grads(model, cfg, batch, names, params, 1,
                                        0.0, torch.float32, True)
        grads, metrics = parallel.reduce_grads(tp, plist, grads, metrics)
        norm = parallel.global_norm(tp, plist, grads)
        out[arch] = {"loss": float(metrics["loss"]),
                     "grad_norm": float(norm),
                     "grads": {n: full(model, n, g)
                               for n, g in zip(names, grads)},
                     "comms": tp.comms.summary()}
    save(out, f"grads_{spec}.pt")

if job == "ckpt":
    tr = Trainer(run_cfg(C, CKPT_STEPS + 2), device="cpu", mesh=mesh)
    tr.restore_checkpoint(os.path.join(d, "jck0"), verify=True)
    save(to_jax_params(tr.state.model), "mesh_init.pt")
    from repro_torch.data import MarkovLM, PhaseDataLoader
    loader = PhaseDataLoader(MarkovLM(512, seed=0), tr.plan, SEQ,
                             device="cpu", per_host=True,
                             process_index=mesh.fsdp_index(rank),
                             process_count=mesh.n_fsdp)
    tr.run(loader, max_steps=CKPT_STEPS)
    tr.save_checkpoint(os.path.join(d, "ck22"))
    state = (to_jax_params(tr.state.model),
             to_jax_opt_state(tr.state.model, tr.state.opt_state))
    save(state, "state22.pt")
    tr.save_checkpoint(os.path.join(d, "ck22_async"), block=False)
    tr.close()
    one = Trainer(run_cfg(C, CKPT_STEPS + 2), device="cpu", mesh=mesh)
    one.restore_checkpoint(os.path.join(d, "ck1"), verify=True)
    save((to_jax_params(one.state.model),
          to_jax_opt_state(one.state.model, one.state.opt_state),
          one.state.step), "state1_on_22.pt")
torch.distributed.destroy_process_group()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(d, spec, job):
    world = int(np.prod([int(x) for x in spec.split("x")]))
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(world), port, str(d), spec,
         job], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]


def _wait(procs, timeout=300):
    for p in procs:
        o, e = p.communicate(timeout=timeout)
        assert p.returncode == 0, (o[-2000:], e[-4000:])


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): np.asarray(tree)}


def _reference(arch):
    """The reference's float32 single-device loss and grads (remat on)
    of the reduced arch at its init, on ``concrete_inputs`` (8 x 64)."""
    cfg = j_get_config(arch).reduced()
    params = JR.init_params(jax.random.PRNGKey(0), cfg)
    batch = JR.concrete_inputs(cfg, "train", 8, 64)

    def loss_of(p, b):
        return JR.loss_fn(p, cfg, b, remat=True, dtype=jnp.float32)

    (loss, _), grads = jax.value_and_grad(loss_of, has_aux=True)(params,
                                                                 batch)
    return (jax.tree.map(np.asarray, params), float(loss),
            jax.tree.map(np.asarray, grads), jax.tree.map(np.asarray, batch))


DUPLICATE = r'''
import json
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.launch.mesh import make_test_mesh
from repro.models import registry as R

cfg = get_config("llama3.2-3b").reduced()
params = R.init_params(jax.random.PRNGKey(0), cfg)
batch = R.concrete_inputs(cfg, "train", 8, 64)
mesh = make_test_mesh(2, 2)
err = None
try:
    with mesh:
        p = jax.device_put(params, jax.tree.map(
            lambda s: NamedSharding(mesh, s), R.param_specs(cfg),
            is_leaf=lambda x: isinstance(x, P)))
        b = jax.device_put(batch, NamedSharding(mesh, P("data")))
        loss, _ = jax.jit(lambda p, b: R.loss_fn(
            p, cfg, b, remat=True, dtype=jnp.float32))(p, b)
except Exception as e:
    err = [type(e).__name__, str(e)]
print(json.dumps({"error": err, "jax": jax.__version__}))
'''

PLAN = r'''
import json, sys
from collections import namedtuple
import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.train import checkpoint as JCKPT

leaves = json.load(open(sys.argv[1]))
mesh = jax.make_mesh((2, 2), ("data", "model"))
pos = {d: i for i, d in enumerate(mesh.devices.flat)}
Dev = namedtuple("Dev", "process_index")
Shard = namedtuple("Shard", "index data")


class Sharding:
    """A real NamedSharding's devices_indices_map, each of the 4 devices
    standing for the process at its mesh position."""
    is_fully_addressable = False

    def __init__(self, spec):
        self.real = NamedSharding(mesh, spec)

    def devices_indices_map(self, shape):
        return {Dev(pos[d]): i for d, i in
                self.real.devices_indices_map(shape).items()}


class Array:
    def __init__(self, shape, dtype, spec):
        self.shape, self.dtype = tuple(shape), np.dtype(dtype)
        self.sharding = Sharding(spec)

    @property
    def addressable_shards(self):
        imap = self.sharding.devices_indices_map(self.shape)
        return [Shard(i, None) for d, i in imap.items()
                if d.process_index == 0]


class Shim:
    Array = Array

    @staticmethod
    def process_count():
        return 4

    @staticmethod
    def process_index():
        return 0


JCKPT.jax = Shim
flat = {k: Array(shape, dtype, P(*[tuple(e) if isinstance(e, list) else e
                                   for e in spec]))
        for k, (shape, dtype, spec) in leaves.items()}
arrays, _ = JCKPT._plan_writes(flat, int(sys.argv[2]))
print(json.dumps(arrays))
'''


def _subprocess(script, *argv, devices=4):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    p = subprocess.run([sys.executable, "-c", script, *map(str, argv)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's single-device grads (written for the ranks), the
    grad ranks on the three meshes; the JAX ``Trainer``'s step-0
    checkpoint and run; a one-process port save (``ck1``); the launcher's
    2x2 ranks and the checkpoint ranks; the reference's sharded loss."""
    import repro.configs as JC
    import repro_torch.configs as C
    d = tmp_path_factory.mktemp("mesh")
    refs = {}
    for arch in ARCHS:
        params, loss, grads, batch = _reference(arch)
        refs[arch] = dict(params=params, loss=loss, grads=grads)
        np.savez(d / f"{arch}.npz", tokens=batch["tokens"],
                 labels=batch["labels"], **_flat(params))
    procs = {spec: _spawn(d, spec, "grads") for spec in MESHES}
    jtr = JTrainer(run_cfg(JC))
    jtr.save_checkpoint(str(d / "jck0"))
    shutil.copytree(d / "jck0", d / "jck0_launch")   # the launcher saves
    one = Trainer(run_cfg(C, CKPT_STEPS + 2), device="cpu")
    one.restore_checkpoint(str(d / "jck0"))
    from repro_torch.data import MarkovLM, PhaseDataLoader
    one.run(PhaseDataLoader(MarkovLM(512, seed=0), one.plan, SEQ,
                            device="cpu"), max_steps=2)
    one.save_checkpoint(str(d / "ck1"))
    for p in procs.values():
        _wait(p)
    late = _spawn(d, "2x2", "launch") + _spawn(d, "2x2", "ckpt")
    jinit = jax.tree.map(np.asarray, jtr.state.params)
    jtr.run(JLoader(JMarkovLM(512, seed=0), jtr.plan, SEQ))
    dup = _subprocess(DUPLICATE)
    _wait(late)
    return dict(d=d, refs=refs, jtr=jtr, jinit=jinit, one=one, dup=dup,
                grads={s: torch.load(d / f"grads_{s}.pt") for s in MESHES})


def _ref_grad(grads, name, cfg):
    return torch.from_numpy(np.array(W._ref_leaf(grads, name, cfg)))


@pytest.mark.parametrize("spec", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_and_grads_match_single_device(runs, arch, spec):
    ref, got = runs["refs"][arch], runs["grads"][spec][arch]
    cfg = j_get_config(arch).reduced()
    assert abs(got["loss"] - ref["loss"]) <= 1e-5
    names = list(got["grads"])
    for n in names:
        want = _ref_grad(ref["grads"], n, cfg)
        g = got["grads"][n]
        assert g.shape == want.shape, n
        err = float((g - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), (n, err)
    one = float(O.global_norm([_ref_grad(ref["grads"], n, cfg)
                               for n in names]))
    assert abs(got["grad_norm"] - one) <= 1e-5 * one


@pytest.mark.parametrize("spec", MESHES)
def test_collectives_of_a_step(runs, spec):
    """The kinds each mesh issues: gathers only with a data axis, model
    all-reduces only with a model axis; the same count on every arch's
    2-layer step (remat gathers each layer's 7 weights twice, plus the
    embedding and the head)."""
    for arch in ARCHS:
        c = runs["grads"][spec][arch]["comms"]
        n_fsdp = 1 if spec == "1x2" else 2
        assert c["fsdp_gather"]["calls"] == (0 if n_fsdp == 1 else 30)
        assert c["model_all_reduce"]["calls"] > 0
        assert c["grad_reduce"]["calls"] == (1 if n_fsdp == 1 else 18)


def test_reference_sharded_step_raises_where_the_port_runs(runs):
    """ROADMAP Queue 3's reference fault: the reference's sharded
    ``loss_fn`` raises ``DuplicateSpecError`` at the embedding gather
    (JAX 0.9.0); the port's 2x2 loss on the same weights is the
    reference's single-device loss."""
    err = runs["dup"]["error"]
    assert err is not None and err[0] == "DuplicateSpecError", runs["dup"]
    assert "PartitionSpec('data', None, 'data')" in err[1]
    got = runs["grads"]["2x2"]["llama3.2-3b"]["loss"]
    assert abs(got - runs["refs"]["llama3.2-3b"]["loss"]) <= 1e-5


def test_launcher_on_a_2x2_mesh_matches_the_jax_trainer(runs):
    d, jtr = runs["d"], runs["jtr"]
    hists = []
    for r in range(4):
        with open(d / f"launch{r}.json") as f:
            hists.append(json.load(f))
    want = jtr.history
    assert len(want) == 10 and {h["batch_size"] for h in want} == {4, 8}
    for hist in hists:
        assert len(hist) == len(want)
        for a, b in zip(hist, want):
            assert [a[k] for k in ("step", "tokens", "batch_size",
                                   "phase")] == \
                [b[k] for k in ("step", "tokens", "batch_size", "phase")]
            assert np.float32(a["lr"]) == np.float32(b["lr"])
            assert abs(a["loss"] - b["loss"]) < 5e-4, (a, b)
        assert [h["loss"] for h in hist] == [h["loss"] for h in hists[0]]


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _leaf_specs(keys):
    """Each checkpoint leaf's spec from the reference's param specs."""
    from repro.models import registry as JRR
    specs = _flat_specs(JRR.param_specs(j_get_config("seesaw-150m")
                                        .reduced()))
    out = {}
    for k in keys:
        kind, path = k.split(":", 1)
        if kind == "p":
            out[k] = specs[path]
        elif path == "count":
            out[k] = []
        else:
            out[k] = specs[path.split("/", 1)[1]]
    return out


def _flat_specs(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_specs(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): [list(e) if isinstance(e, tuple) else e
                                 for e in tree]}


def test_2x2_manifest_is_the_reference_plan(runs, tmp_path):
    d = runs["d"]
    for ck in ("ck22", "ck22_async"):
        m = _manifest(str(d / ck))
        specs = _leaf_specs(m["arrays"])
        leaves = {k: [e["shape"], e["dtype"], specs[k]]
                  for k, e in m["arrays"].items()}
        with open(tmp_path / "leaves.json", "w") as f:
            json.dump(leaves, f)
        want = _subprocess(PLAN, tmp_path / "leaves.json", m["generation"])
        got = {k: {"shape": e["shape"], "dtype": e["dtype"],
                   "shards": [{x: s[x] for x in ("file", "start", "stop",
                                                 "writer")}
                              for s in e["shards"]]}
               for k, e in m["arrays"].items()}
        assert got == want
        assert m["meta"]["save_process_count"] == 4
        assert max(len(e["shards"]) for e in m["arrays"].values()) == 4
        assert {s["writer"] for e in m["arrays"].values()
                for s in e["shards"]} == {0, 1, 2, 3}


def _equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_checkpoint_resumes_are_bitwise(runs):
    import repro.configs as JC
    import repro_torch.configs as C
    d = runs["d"]
    # a reference single-device checkpoint onto the 2x2 mesh
    _equal(torch.load(d / "mesh_init.pt", weights_only=False), runs["jinit"])
    # 2x2 -> one process
    params22, opt22 = torch.load(d / "state22.pt", weights_only=False)
    one = Trainer(run_cfg(C, CKPT_STEPS + 2), device="cpu")
    meta = one.restore_checkpoint(str(d / "ck22"), verify=True)
    assert meta["step"] == CKPT_STEPS
    _equal(W.to_jax_params(one.state.model), params22)
    _equal(W.to_jax_opt_state(one.state.model, one.state.opt_state), opt22)
    # one process -> 2x2
    p1, o1, step = torch.load(d / "state1_on_22.pt", weights_only=False)
    assert step == 2
    _equal(p1, W.to_jax_params(runs["one"].state.model))
    _equal(o1, W.to_jax_opt_state(runs["one"].state.model,
                                  runs["one"].state.opt_state))
    # the reference reads the 2x2 save
    jres = JTrainer(run_cfg(JC, CKPT_STEPS + 2))
    meta = jres.restore_checkpoint(str(d / "ck22"), verify=True)
    assert meta["save_process_count"] == 4
    _equal(jax.tree.map(np.asarray, jres.state.params), params22)
    _equal(jax.tree.map(np.asarray, jres.state.opt_state), opt22)
    # the async save holds the same blocks
    m, a = _manifest(str(d / "ck22")), _manifest(str(d / "ck22_async"))
    for k, e in m["arrays"].items():
        assert [s["crc32"] for s in e["shards"]] == \
            [s["crc32"] for s in a["arrays"][k]["shards"]], k
    assert CKPT.read_meta(str(d / "ck22"))["step"] == CKPT_STEPS
