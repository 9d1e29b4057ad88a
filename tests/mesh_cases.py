"""Shared by ``tests/test_torch_mesh_*.py`` (not collected): a family's
sharded loss and grads, or its sharded prefill and decode, on data ×
model meshes of gloo processes, held to the reference's single-device
run on the same numpy weights and rows.

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

Serving (``test_torch_mesh_serve*.py``): :func:`serve_runs` computes
each case's reference float32 prefill and ``SERVE_STEPS`` greedy decode
steps in this process (:func:`serve_reference`), runs every mesh's
``SERVE_RANK`` processes side by side (each builds ``launch.steps.
build_workload``'s prefill and decode ``fn``s and runs every case under
both cache cuts and ``serve_resident`` off and on, recording each
rank's logits error, greedy tokens, cache blocks against the reference's
cut to its box, each leaf's cut and a decode step's collectives) and,
for the cases marked ``"jit"``, the reference's own sharded jitted
decode step on a forced 4-device host mesh (``SERVE_JIT``).  Every such
script starts with ``SERVE_PARAMS``, the source of :func:`serve_config`
and :func:`params_of`.
"""
import dataclasses
import inspect
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
from repro_torch.models import registry as R
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
    # the family's loss with the residual whole on every model rank (the
    # registry's would cut it: tests/test_torch_seq_shard.py holds that)
    loss, metrics = R.family(cfg).loss_fn(model, cfg, batch,
                                          dtype=torch.float32, remat=True,
                                          seq_shard=False)
    grads = torch.autograd.grad(loss, plist)
    metrics = {k: v.detach().float() for k, v in metrics.items()}
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


# --------------------------------------------------------------------- #
# sharded serving
# --------------------------------------------------------------------- #

SERVE_B, SERVE_STEPS = 16, 4

def serve_config(get, c, model_config):
    """A serving case's config from ``get`` and ``model_config`` (either
    package's ``get_config`` and ``ModelConfig``): its ``fields``, or the
    arch's ``reduced()`` with its fields and its SSD block's replaced."""
    if c.get("fields"):
        return model_config(**c["fields"])
    cfg = get(c["arch"]).reduced()
    if "ssm" in c:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                               **c["ssm"]))
    return dataclasses.replace(cfg, **c.get("replace", {}))


def params_of(ref, leaf=lambda a: a):
    """The parameter tree of a case's npz ``ref`` (its "p:<path>"
    entries), each leaf through ``leaf``."""
    tree = {}
    for k in ref.files:
        if k.startswith("p:"):
            node = tree
            *path, last = k[2:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[last] = leaf(ref[k])
    return tree


# the two helpers above, for the scripts the serving tests run in
# processes of their own (either package's; a script imports its own
# get_config and ModelConfig)
SERVE_PARAMS = "import dataclasses\n\n\n" + "\n\n".join(
    inspect.getsource(f) for f in (serve_config, params_of)) + "\n\n"

# one rank: every serving case on this mesh; a case holds "fields" (a
# config of its own) or "arch" (its reduced() with "replace" and "ssm"
# fields); "cap" the cache length, "layouts" the cache cuts to run,
# "refuse" the meshes on which the case must raise
SERVE_RANK = SERVE_PARAMS + r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
rank, world, port, d, spec = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4], sys.argv[5])
from repro_torch import parallel
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch import mesh as M
from repro_torch.launch import steps as ST
from repro_torch.launch.train import maybe_init_distributed
from repro_torch.models import registry as R
from repro_torch.weights import from_jax_params

assert maybe_init_distributed(f"127.0.0.1:{port}", world, rank,
                              device="cpu")
mesh = M.make_launch_mesh(spec, distributed=True)
with open(os.path.join(d, "cases.json")) as f:
    cases = json.load(f)
B, STEPS = %d, %d


def leaves(data):
    # (key, leaf name, tensor): a dict of stacked leaves, or the
    # hybrid's list of per-layer dicts
    layers = data if isinstance(data, list) else [data]
    pre = (lambda i: f"{i}/") if isinstance(data, list) else (lambda i: "")
    for i, layer in enumerate(layers):
        for n, t in layer.items():
            yield pre(i) + n, n, t


def leaf_err(got, want):
    return float((got.float() - want.float()).abs().max())


out, keep = {}, {}
for name, c in cases.items():
    cfg = serve_config(get_config, c, ModelConfig)
    ref = np.load(os.path.join(d, f"{name}.npz"))
    tree = params_of(ref)
    toks = torch.from_numpy(ref["tokens"])
    prefix = (torch.from_numpy(ref["prefix"]) if "prefix" in ref.files
              else None)
    cap = c.get("cap", 1)
    for resident in (False, True):
        for seq_cut in c.get("layouts", [False, True]):
            key = f"{name}/{int(resident)}/{int(seq_cut)}"
            model = from_jax_params(tree, cfg, dtype=torch.float32,
                                    device="cpu", mesh=mesh,
                                    serve_resident=resident)
            tp = model.tp
            kw = dict(serve_resident=resident, cache_seq_shard=seq_cut,
                      dtype=torch.float32)
            pf = ST.build_workload(cfg, InputShape("p", cap, B, "prefill"),
                                   **kw)[0]
            df = ST.build_workload(cfg, InputShape("d", cap, B, "decode"),
                                   **kw)[0]
            lay = parallel.cache_layout(cfg, tp, B, cap, seq_cut)
            lo, hi = lay.rows
            batch = {"tokens": toks[lo:hi]}
            if prefix is not None:
                batch["prefix_emb"] = prefix[lo:hi]
            rec = {"rows": [lo, hi], "logits": [], "tokens": [],
                   "cache": {}, "shapes_are_boxes": True}
            if spec in c.get("refuse", []):
                try:
                    with torch.no_grad():
                        pf(model, batch)
                        _, cache = R.prefill(
                            model, cfg, batch["tokens"], cache_len_cap=cap,
                            global_batch=B, cache_seq_shard=seq_cut)
                        df(model, cache, toks[lo:hi, -1:])
                    rec["refused"] = None
                except ValueError as e:
                    rec["refused"] = str(e)
                out[key] = rec
                continue
            with torch.no_grad():
                tp.comms.reset()
                logits = pf(model, batch)
                rec["prefill_comms"] = tp.comms.summary()
                # the whole residual, where the family honours it (the
                # prefill fn above runs the reference's cut)
                _, cache = R.prefill(model, cfg, batch["tokens"],
                                     prefix_emb=batch.get("prefix_emb"),
                                     cache_len_cap=cap, global_batch=B,
                                     cache_seq_shard=seq_cut,
                                     seq_shard=False)
                V = logits.shape[-1]
                v0 = tp.vocab_start(V)

                def check_cache(tag):
                    for k, n, t in leaves(cache.data):
                        box = lay.boxes[n]
                        if tuple(t.shape) != tuple(b - a for a, b in box):
                            rec["shapes_are_boxes"] = False
                        want = torch.from_numpy(ref[f"{tag}:{k}"])
                        if n in ("ek", "ev"):   # the reference's order
                            want = want.transpose(2, 3)
                        rec["cache"][f"{tag}:{k}"] = leaf_err(
                            t, lay.block(n, want))

                def check_logits(i):
                    want = torch.from_numpy(ref[f"logits{i}"])
                    rec["logits"].append(leaf_err(
                        logits, want[lo:hi, :, v0:v0 + V]))
                    tok = tp.greedy(logits)[:, -1:]
                    rec["tokens"].append(bool(torch.equal(
                        tok, torch.from_numpy(ref[f"tokens{i}"])[lo:hi])))
                    return tok

                check_cache("prefill")
                tok = check_logits(0)
                for i in range(1, STEPS + 1):
                    tp.comms.reset()
                    logits, cache = df(model, cache, tok)
                    rec["comms"] = tp.comms.summary()
                    if (c.get("jit") and spec == "2x2" and resident
                            and not seq_cut and i == 1):
                        keep[name] = (logits.clone(), (lo, hi, v0, V))
                    tok = check_logits(i)
                check_cache("decode")
            rec["cut"] = {n: lay.model_cut(n) for n in lay.specs}
            out[key] = rec
with open(os.path.join(d, f"serve_{spec}_{rank}.json"), "w") as f:
    json.dump(out, f)
if keep:
    torch.save(keep, os.path.join(d, f"keep_{spec}_{rank}.pt"))
torch.distributed.destroy_process_group()
""" % (SERVE_B, SERVE_STEPS)

# the reference's own sharded jitted decode step of a case on a forced
# 4-device host mesh (2x2, serve_resident, the head_dim cut): the step-1
# logits after its single-device prefill and greedy pick
SERVE_JIT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
""" + SERVE_PARAMS + r"""
import json, sys
import jax
import jax.numpy as jnp
import numpy as np
from repro.configs import get_config
from repro.configs.base import InputShape, ModelConfig
from repro.launch import steps as ST
from repro.launch.mesh import make_test_mesh
from repro.models import registry as R

d, name = sys.argv[1], sys.argv[2]
with open(os.path.join(d, "cases.json")) as f:
    c = json.load(f)[name]
cfg = serve_config(get_config, c, ModelConfig)
ref = np.load(os.path.join(d, f"{name}.npz"))
params = params_of(ref, jnp.asarray)
B, cap = ref["tokens"].shape[0], int(ref["cap"])
toks = jnp.asarray(ref["tokens"].astype(np.int32))
kw = {}
if "prefix" in ref.files:
    kw["prefix_emb"] = jnp.asarray(ref["prefix"])
logits, cache = R.prefill(params, cfg, toks, cache_len_cap=cap,
                          dtype=jnp.float32, **kw)
tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
fn, args, ins, outs = ST.build_workload(
    cfg, InputShape("d", cap, B, "decode"), serve_resident=True,
    dtype=jnp.float32)
mesh = make_test_mesh(2, 2)
with mesh:
    step = jax.jit(fn, in_shardings=ST._named(mesh, ins),
                   out_shardings=ST._named(mesh, outs))
    got, _ = step(params, cache, tok)
np.save(os.path.join(d, f"jit_{name}.npy"), np.asarray(got))
"""


def _cache_leaves(data):
    """{key: leaf} of a reference cache: stacked leaves by name, the
    hybrid's per-layer leaves as "<layer>/<name>"."""
    if isinstance(data, list):
        return {f"{i}/{n}": t for i, layer in enumerate(data)
                for n, t in layer.items()}
    return dict(data)


def serve_reference(c, d):
    """The reference's float32 prefill and ``SERVE_STEPS`` greedy decode
    steps of case ``c`` on one device: weights, prompts, the frontend's
    frames (the VLM's patches, the enc-dec's source frames), logits,
    tokens and caches to ``<d>/<name>.npz``; returns them."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.models import registry as JR
    jcfg = serve_config(j_get_config, c, JModelConfig)
    params = JR.init_params(jax.random.PRNGKey(c["seed"]), jcfg)
    rng = np.random.default_rng(c["seed"])
    toks = rng.integers(0, jcfg.vocab_size, (SERVE_B, c["S"]))
    out = {f"p:{k}": v for k, v in _flat(
        jax.tree.map(np.asarray, params)).items()}
    out["tokens"] = toks
    kw = {"dtype": jnp.float32}
    if jcfg.arch_type in ("vlm", "audio", "encdec"):
        out["prefix"] = rng.standard_normal(
            (SERVE_B, jcfg.frontend_tokens, jcfg.d_model)).astype(
                np.float32)
        kw["prefix_emb"] = jnp.asarray(out["prefix"])
    if "cap" in c:
        kw["cache_len_cap"] = c["cap"]
        out["cap"] = np.asarray(c["cap"])
    logits, cache = JR.prefill(params, jcfg,
                               jnp.asarray(toks.astype(np.int32)), **kw)
    for n, t in _cache_leaves(cache.data).items():
        out[f"prefill:{n}"] = np.asarray(t)
    for i in range(SERVE_STEPS + 1):
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        out[f"logits{i}"] = np.asarray(logits)
        out[f"tokens{i}"] = np.asarray(tok).astype(np.int64)
        if i < SERVE_STEPS:
            logits, cache = JR.decode_step(params, jcfg, cache, tok,
                                           dtype=jnp.float32)
    for n, t in _cache_leaves(cache.data).items():
        out[f"decode:{n}"] = np.asarray(t)
    np.savez(os.path.join(d, f"{c['name']}.npz"), **out)
    return out


def serve_runs(d, cases, meshes):
    """Every case's reference (this process), every mesh's ranks and each
    ``"jit"`` case's reference sharded step (subprocesses, side by side).
    Returns {"refs": {name: npz dict}, "got": {mesh: [rank's record]},
    "d": d, "jit": {name: the subprocess's CompletedProcess}}."""
    cases = {n: dict(c, name=n) for n, c in cases.items()}
    with open(os.path.join(d, "cases.json"), "w") as f:
        json.dump(cases, f)
    refs = {n: serve_reference(c, d) for n, c in cases.items()}
    procs = {spec: spawn(d, spec, SERVE_RANK) for spec in meshes}
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    jit = {n: subprocess.Popen([sys.executable, "-c", SERVE_JIT, str(d), n],
                               env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
           for n, c in cases.items() if c.get("jit")}
    for p in procs.values():
        wait(p)
    for n, p in jit.items():
        o, e = p.communicate(timeout=420)
        jit[n] = subprocess.CompletedProcess(p.args, p.returncode, o, e)
    got = {}
    for spec, ps in procs.items():
        got[spec] = []
        for r in range(len(ps)):
            with open(os.path.join(d, f"serve_{spec}_{r}.json")) as f:
                got[spec].append(json.load(f))
    return dict(refs=refs, got=got, d=d, jit=jit)


def serve_combos(c):
    """(serve_resident, cache_seq_shard) of every run of a case."""
    return [(r, s) for r in (False, True)
            for s in c.get("layouts", [False, True])]


def check_serving(runs, cases, name, spec):
    """Every run of case ``name`` on ``spec``, every rank: logits within
    2e-5 of the reference's at the prefill and each step, greedy tokens
    equal, each cache leaf exactly its box's shape and within 2e-5 of the
    reference's cut to it."""
    for resident, seq_cut in serve_combos(cases[name]):
        key = f"{name}/{int(resident)}/{int(seq_cut)}"
        for rank, ranks in enumerate(runs["got"][spec]):
            rec = ranks[key]
            where = (spec, key, rank)
            assert len(rec["logits"]) == SERVE_STEPS + 1, where
            assert max(rec["logits"]) <= 2e-5, (where, rec["logits"])
            assert all(rec["tokens"]), (where, rec["tokens"])
            assert rec["shapes_are_boxes"], where
            assert max(rec["cache"].values()) <= 2e-5, (where, rec["cache"])


def check_jit(runs, name):
    """The reference's sharded jitted step of case ``name`` within 2e-5
    of its single-device step, and every 2x2 rank's block within 2e-5 of
    it."""
    jit = runs["jit"][name]
    assert jit.returncode == 0, jit.stderr[-3000:]
    want = np.load(os.path.join(runs["d"], f"jit_{name}.npy"))
    single = runs["refs"][name]["logits1"]
    assert np.abs(want - single).max() <= 2e-5
    for r in range(4):
        got, (lo, hi, v0, V) = torch.load(os.path.join(
            runs["d"], f"keep_2x2_{r}.pt"))[name]
        assert np.abs(got.numpy() - want[lo:hi, :, v0:v0 + V]).max() \
            <= 2e-5, r
