"""Shared by ``tests/test_torch_mesh_*.py`` (not collected): a family's
sharded loss and grads on data × model meshes of gloo processes, held to
the reference's single-device ``value_and_grad`` on the same numpy
weights and rows.

A case is a config (an arch's ``reduced()`` with fields replaced, or a
config of its own), a batch made from a seed with numpy, and the JAX
init seed.  :func:`run_cases` computes each case's reference loss and
grads (float32, remat on) in this process, writes the weights and the
batch for the ranks, runs every mesh's ranks side by side (``python -c``
processes that import no JAX, on free ports) and returns what rank 0
saved: the loss, ``grad_norm``, every grad gathered whole and the
collectives' summary.  :func:`check_case` holds them at the mesh tests'
tolerances: loss 1e-5, every grad within 1e-4 of its leaf's max,
``grad_norm`` 1e-5 relative.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

# one rank: every case of the job on this mesh
RANK = r'''
import dataclasses, json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
rank, world, port, d, spec = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4], sys.argv[5])
from repro_torch import parallel
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as M
from repro_torch.launch.train import maybe_init_distributed
from repro_torch.train import engine as E
from repro_torch.weights import from_jax_params

assert maybe_init_distributed(f"127.0.0.1:{port}", world, rank,
                              device="cpu")
mesh = M.make_launch_mesh(spec, distributed=True)
with open(os.path.join(d, "cases.json")) as f:
    cases = json.load(f)


def config(c):
    if c.get("fields"):
        return ModelConfig(**c["fields"])
    cfg = get_config(c["arch"]).reduced()
    return dataclasses.replace(cfg, **c.get("replace", {}))


def unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, last = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


out = {}
for name, c in cases.items():
    cfg = config(c)
    ref = np.load(os.path.join(d, f"{name}.npz"))
    inputs = [k for k in ref.files if k.startswith("batch:")]
    tree = unflatten({k: ref[k] for k in ref.files if k not in inputs})
    model = from_jax_params(tree, cfg, dtype=torch.float32, device="cpu",
                            trainable=True, mesh=mesh)
    tp = model.tp
    batch = {k[6:]: torch.from_numpy(ref[k]) for k in inputs}
    batch = E.slot_rows(batch, mesh, rank)
    params = dict(model.named_parameters())
    names, plist = list(params), list(params.values())
    grads, metrics = E._local_grads(model, cfg, batch, names, params, 1,
                                    0.0, torch.float32, True)
    grads, metrics = parallel.reduce_grads(tp, plist, grads, metrics)
    norm = parallel.global_norm(tp, plist, grads)
    full = {}
    for n, g in zip(names, grads):
        shape, sp = model.full_shapes[n], model.specs[n]
        full[n] = parallel.gather_full(g, shape, [
            M.shard_box(shape, sp, mesh, r) for r in range(mesh.size)])
    out[name] = {"metrics": {k: float(v) for k, v in metrics.items()},
                 "grad_norm": float(norm), "grads": full,
                 "comms": tp.comms.summary()}
if rank == 0:
    torch.save(out, os.path.join(d, f"grads_{spec}.pt"))
torch.distributed.destroy_process_group()
'''


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(d, spec, script=RANK, *extra):
    """One ``python -c script rank world port d spec *extra`` a slot of
    ``spec``, on a free port."""
    world = int(np.prod([int(x) for x in spec.split("x")]))
    port = str(free_port())
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(world), port, str(d),
         spec, *map(str, extra)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def wait(procs, timeout=400):
    for p in procs:
        o, e = p.communicate(timeout=timeout)
        assert p.returncode == 0, (o[-2000:], e[-4000:])


def configs(case):
    """(the reference's config, the port's) of a case."""
    from repro.configs import get_config as j_get_config
    from repro.configs.base import ModelConfig as JModelConfig
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ModelConfig
    if case.get("fields"):
        return JModelConfig(**case["fields"]), ModelConfig(**case["fields"])
    kw = case.get("replace", {})
    return (dataclasses.replace(j_get_config(case["arch"]).reduced(), **kw),
            dataclasses.replace(get_config(case["arch"]).reduced(), **kw))


def batch_of(cfg, B: int, S: int, seed: int):
    """Tokens, labels, a mask and the frontend's frames of the family
    (``src_emb`` for the enc-dec, ``prefix_emb`` for the VLM), float32,
    from ``seed``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    out = {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
           "mask": (rng.random((B, S)) > 0.1).astype(np.float32)}
    if cfg.arch_type in ("audio", "encdec", "vlm"):
        key = "prefix_emb" if cfg.arch_type == "vlm" else "src_emb"
        out[key] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): np.asarray(tree)}


def reference(jcfg, batch, seed: int):
    """The reference's float32 single-device (params, loss, metrics,
    grads), remat on."""
    import jax
    import jax.numpy as jnp
    from repro.models import registry as JR
    params = JR.init_params(jax.random.PRNGKey(seed), jcfg)
    jb = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
          for k, v in batch.items()}

    def loss_of(p):
        return JR.loss_fn(p, jcfg, jb, remat=True, dtype=jnp.float32)

    (loss, metrics), grads = jax.value_and_grad(loss_of, has_aux=True)(
        params)
    return (jax.tree.map(np.asarray, params), float(loss),
            {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, grads))


def run_cases(d, cases, meshes):
    """cases: {name: {"arch" and "replace", or "fields"; "B", "S",
    "seed"}}.  Returns ({name: (reference loss, metrics, grads, port
    config)}, {mesh: rank 0's record})."""
    refs = {}
    with open(os.path.join(d, "cases.json"), "w") as f:
        json.dump(cases, f)
    for name, c in cases.items():
        jcfg, cfg = configs(c)
        batch = batch_of(cfg, c["B"], c["S"], c["seed"])
        params, loss, metrics, grads = reference(jcfg, batch, c["seed"])
        np.savez(os.path.join(d, f"{name}.npz"), **_flat(params),
                 **{f"batch:{k}": v for k, v in batch.items()})
        refs[name] = (loss, metrics, grads, cfg)
    procs = {spec: spawn(d, spec) for spec in meshes}
    for p in procs.values():
        wait(p)
    return refs, {spec: torch.load(os.path.join(d, f"grads_{spec}.pt"))
                  for spec in meshes}


def check_case(ref, got, metrics=("loss",), metric_tol=1e-5):
    """The sharded loss within 1e-5 (and each name of ``metrics`` within
    ``metric_tol``), every gathered grad within 1e-4 of its leaf's max,
    ``grad_norm`` within 1e-5 relative of one process's
    ``optimizers.global_norm``."""
    from repro_torch.optim import optimizers as O
    from repro_torch.weights import _ref_leaf
    loss, jm, jgrads, cfg = ref
    assert abs(got["metrics"]["loss"] - loss) <= 1e-5, (got["metrics"],
                                                         loss)
    for k in metrics:
        if k != "loss":
            assert abs(got["metrics"][k] - jm[k]) <= metric_tol, \
                (k, got["metrics"][k], jm[k])
    want = {}
    for n, g in got["grads"].items():
        w = torch.from_numpy(np.array(_ref_leaf(jgrads, n, cfg)))
        assert g.shape == w.shape, n
        err = float((g - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), (n, err,
                                                    float(w.abs().max()))
        want[n] = w
    one = float(O.global_norm(list(want.values())))
    assert abs(got["grad_norm"] - one) <= 1e-5 * one, (got["grad_norm"],
                                                       one)
