"""Sharded prefill and decode on data × model meshes of gloo processes,
against the reference's single-device ``prefill`` / ``decode_step`` on
the same numpy weights and prompts, on the CPU.

- Configs (``reduced()``): llama3.2-3b (GQA 4/2), starcoder2-3b (its
  window of 64: a 64-slot ring, the prompt of 72 wrapping it),
  granite-moe-1b-a400m (4 experts, top 2), internvl2-76b (a 16-row
  prefix) and mamba2-2.7b (8 SSD heads, d_state 16), and mamba2 at d 512
  (16 heads: ``cache_seq_shard`` cuts its state by heads, as at
  mamba2-2.7b's 80) and at d_state 4 (neither its state nor its conv
  divides into 16: both whole on every model rank).  B 16, float32.
- Meshes: 1x2, 2x2 (the batch cut over data: 8 rows a slot) and 1x4 (the
  KV heads 2 < 4: each rank's one query head attends to a KV head shared
  with a neighbour); ``serve_resident`` off and on, the head_dim cut and
  the sequence cut of the cache.  On 2x2 the MoE's decode is refused: its
  routing group of the 16 tokens would straddle the two data slots.
- Each rank runs ``launch.steps.build_workload``'s prefill and decode
  ``fn``s (and ``registry.prefill`` for the cache): its vocab block of
  the logits within 2e-5 of the reference's at the prefill and each of 4
  greedy steps, the greedy tokens (``TensorParallel.greedy``) equal to
  the reference's, each cache leaf exactly the shape of its box and
  within 2e-5 of the reference's cache cut to it, after the prefill and
  after the steps.  A decode step's collectives are counted by kind and
  size: the new token's q, k and v, the scores or the softmax states, the
  attention output's re-cut and the rows' partial sums; no cache byte.
- One case, llama3.2-3b decode with ``serve_resident`` on 2x2, is also
  held to the reference's own sharded jitted step (``build_workload``
  jitted with its in/out shardings on a forced 4-device host mesh, in a
  subprocess), within 2e-5.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mesh_cases as MC

B, STEPS = 16, 4
MESHES = ("1x2", "2x2", "1x4")
CASES = {
    "llama": {"arch": "llama3.2-3b", "S": 20, "cap": 48, "seed": 0},
    "starcoder2": {"arch": "starcoder2-3b", "S": 72, "cap": 96, "seed": 1},
    "granite": {"arch": "granite-moe-1b-a400m", "S": 16, "cap": 32,
                "seed": 2, "refuse": ["2x2"]},
    "internvl": {"arch": "internvl2-76b", "S": 12, "cap": 48, "seed": 3},
    "mamba2": {"arch": "mamba2-2.7b", "S": 40, "seed": 4},
    "mamba2_h16": {"arch": "mamba2-2.7b", "replace": {"d_model": 512},
                   "S": 40, "seed": 5, "layouts": [True]},
    "mamba2_n4": {"arch": "mamba2-2.7b", "ssm": {"d_state": 4}, "S": 40,
                  "seed": 6, "layouts": [False]},
}
RANK = r'''
import dataclasses, json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
rank, world, port, d, spec = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4], sys.argv[5])
from repro_torch import parallel
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
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
B, STEPS = 16, 4


def unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, last = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def leaf_err(got, want):
    return float((got.float() - want.float()).abs().max())


out, keep = {}, {}
for name, c in cases.items():
    cfg = get_config(c["arch"]).reduced()
    cfg = dataclasses.replace(cfg, **c.get("replace", {}), **(
        {"ssm": dataclasses.replace(cfg.ssm, **c["ssm"])} if "ssm" in c
        else {}))
    ref = np.load(os.path.join(d, f"{name}.npz"))
    tree = unflatten({k[2:]: ref[k] for k in ref.files
                      if k.startswith("p:")})
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
                logits = pf(model, batch)
                _, cache = R.prefill(model, cfg, batch["tokens"],
                                     prefix_emb=batch.get("prefix_emb"),
                                     cache_len_cap=cap, global_batch=B,
                                     cache_seq_shard=seq_cut)
                V = logits.shape[-1]
                v0 = tp.vocab_start(V)

                def check_cache(tag):
                    for n, t in cache.data.items():
                        box = lay.boxes[n]
                        if tuple(t.shape) != tuple(b - a for a, b in box):
                            rec["shapes_are_boxes"] = False
                        want = torch.from_numpy(ref[f"{tag}:{n}"])
                        rec["cache"][f"{tag}:{n}"] = leaf_err(
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
                    if (name, spec, resident, seq_cut) == (
                            "llama", "2x2", True, False) and i == 1:
                        keep["jit_logits1"] = logits.clone()
                        keep["jit_rows"] = (lo, hi, v0, V)
                    tok = check_logits(i)
                check_cache("decode")
            rec["cut"] = {n: lay.model_cut(n) for n in lay.specs}
            out[key] = rec
with open(os.path.join(d, f"serve_{spec}_{rank}.json"), "w") as f:
    json.dump(out, f)
if keep:
    torch.save(keep, os.path.join(d, f"keep_{spec}_{rank}.pt"))
torch.distributed.destroy_process_group()
'''

JIT = r'''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
import jax
import jax.numpy as jnp
import numpy as np
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.launch import steps as ST
from repro.launch.mesh import make_test_mesh
from repro.models import registry as R

d = sys.argv[1]
ref = np.load(os.path.join(d, "llama.npz"))
params = {}
for k in ref.files:
    if k.startswith("p:"):
        node = params
        *path, last = k[2:].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = jnp.asarray(ref[k])
cfg = get_config("llama3.2-3b").reduced()
B, cap = ref["tokens"].shape[0], int(ref["cap"])
toks = jnp.asarray(ref["tokens"].astype(np.int32))
logits, cache = R.prefill(params, cfg, toks, cache_len_cap=cap,
                          dtype=jnp.float32)
tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
fn, args, ins, outs = ST.build_workload(
    cfg, InputShape("d", cap, B, "decode"), serve_resident=True,
    dtype=jnp.float32)
mesh = make_test_mesh(2, 2)
with mesh:
    step = jax.jit(fn, in_shardings=ST._named(mesh, ins),
                   out_shardings=ST._named(mesh, outs))
    got, _ = step(params, cache, tok)
np.save(os.path.join(d, "jit_logits1.npy"), np.asarray(got))
'''


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the ranks and the workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(get, c):
    """A case's config from ``get`` (either package's ``get_config``):
    the arch's ``reduced()``, its fields and its SSD block's replaced."""
    cfg = get(c["arch"]).reduced()
    if "ssm" in c:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                               **c["ssm"]))
    return dataclasses.replace(cfg, **c.get("replace", {}))


def _reference(c, d):
    """The reference's float32 prefill and STEPS greedy decode steps on one
    device; weights, prompts, logits, tokens and caches to an npz."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.models import registry as JR
    jcfg = _config(j_get_config, c)
    params = JR.init_params(jax.random.PRNGKey(c["seed"]), jcfg)
    rng = np.random.default_rng(c["seed"])
    toks = rng.integers(0, jcfg.vocab_size, (B, c["S"]))
    out = {f"p:{k}": v for k, v in MC._flat(
        jax.tree.map(np.asarray, params)).items()}
    out["tokens"] = toks
    kw = {"dtype": jnp.float32}
    if jcfg.arch_type == "vlm":
        out["prefix"] = rng.standard_normal(
            (B, jcfg.frontend_tokens, jcfg.d_model)).astype(np.float32)
        kw["prefix_emb"] = jnp.asarray(out["prefix"])
    if "cap" in c:
        kw["cache_len_cap"] = c["cap"]
        out["cap"] = np.asarray(c["cap"])
    logits, cache = JR.prefill(params, jcfg,
                               jnp.asarray(toks.astype(np.int32)), **kw)
    for n, t in cache.data.items():
        out[f"prefill:{n}"] = np.asarray(t)
    for i in range(STEPS + 1):
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        out[f"logits{i}"] = np.asarray(logits)
        out[f"tokens{i}"] = np.asarray(tok).astype(np.int64)
        if i < STEPS:
            logits, cache = JR.decode_step(params, jcfg, cache, tok,
                                           dtype=jnp.float32)
    for n, t in cache.data.items():
        out[f"decode:{n}"] = np.asarray(t)
    np.savez(os.path.join(d, f"{c['name']}.npz"), **out)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_serve")
    cases = {n: dict(c, name=n) for n, c in CASES.items()}
    with open(os.path.join(d, "cases.json"), "w") as f:
        json.dump(cases, f)
    refs = {n: _reference(c, d) for n, c in cases.items()}
    procs = {spec: MC.spawn(d, spec, RANK) for spec in MESHES}
    env = dict(os.environ, PYTHONPATH=os.path.join(MC.ROOT, "src"),
               JAX_PLATFORMS="cpu")
    jit = subprocess.run([sys.executable, "-c", JIT, str(d)], env=env,
                         capture_output=True, text=True, timeout=420)
    for p in procs.values():
        MC.wait(p)
    got = {}
    for spec, ps in procs.items():
        got[spec] = []
        for r in range(len(ps)):
            with open(os.path.join(d, f"serve_{spec}_{r}.json")) as f:
                got[spec].append(json.load(f))
    return dict(refs=refs, got=got, d=d, jit=jit)


def _combos(name):
    c = CASES[name]
    return [(r, s) for r in (False, True)
            for s in c.get("layouts", [False, True])]


@pytest.mark.parametrize("name,spec", [
    (n, s) for n in CASES for s in MESHES
    if s not in CASES[n].get("refuse", [])])
def test_sharded_serving_matches_single_device(runs, name, spec):
    for resident, seq_cut in _combos(name):
        key = f"{name}/{int(resident)}/{int(seq_cut)}"
        for rank, ranks in enumerate(runs["got"][spec]):
            rec = ranks[key]
            where = (spec, key, rank)
            assert len(rec["logits"]) == STEPS + 1, where
            assert max(rec["logits"]) <= 2e-5, (where, rec["logits"])
            assert all(rec["tokens"]), (where, rec["tokens"])
            assert rec["shapes_are_boxes"], where
            assert max(rec["cache"].values()) <= 2e-5, (where, rec["cache"])


def test_moe_decode_refused_where_its_group_straddles_two_slots(runs):
    for resident, seq_cut in _combos("granite"):
        for ranks in runs["got"]["2x2"]:
            msg = ranks[f"granite/{int(resident)}/{int(seq_cut)}"]["refused"]
            assert msg is not None and "straddle two data slots" in msg


def _cut_dim(name, seq_cut):
    """Each leaf's dim the reference's specs cut over 'model': Mamba-2's
    state by N, or by heads (16 of them) with the sequence cut; its conv
    by channels; K/V by head_dim, or by the sequence."""
    if name == "mamba2_h16":
        return {"h": 2, "conv": 3}
    if name == "mamba2":
        return {"h": 4, "conv": 3}
    if name == "mamba2_n4":
        return {"h": None, "conv": None}
    return {"k": 2 if seq_cut else 4, "v": 2 if seq_cut else 4}


@pytest.mark.parametrize("spec", MESHES)
def test_caches_are_cut_as_the_specs_say(runs, spec):
    for name in CASES:
        if spec in CASES[name].get("refuse", []):
            continue
        for resident, seq_cut in _combos(name):
            rec = runs["got"][spec][0][f"{name}/{int(resident)}/"
                                       f"{int(seq_cut)}"]
            for leaf, dim in _cut_dim(name, seq_cut).items():
                got = rec["cut"][leaf]
                assert (got and got[0]) == dim, (name, leaf, rec["cut"])


def _decode_bytes(name, spec, resident, seq_cut):
    """A decode step's bytes by collective kind, from the shapes alone:
    no term scales with the cache but the head_dim cut's scores (H·Skv
    floats a row and layer)."""
    from repro_torch.configs import get_config
    from repro_torch.models.mamba2 import _dims
    c = CASES[name]
    cfg = _config(get_config, c)
    D, Mm = (int(x) for x in spec.split("x"))
    b = B // D if B % 16 == 0 else B          # the rank's rows
    L, d, f4 = cfg.n_layers, cfg.d_model, 4
    want = {"model_all_reduce": b * d * f4, "model_all_gather": 0,
            "model_all_to_all": 0}            # the embedding's sum
    if cfg.arch_type == "ssm":
        s, di, H, P, N = _dims(cfg)
        C = di + 2 * N
        want["model_all_gather"] = L * b * di // Mm * f4
        if C % 16:                           # the conv whole: its weights
            want["model_all_gather"] += L * (s.d_conv + 1) * C // Mm * f4
        else:                                # its channels: the output
            want["model_all_gather"] += L * b * C // Mm * f4
        want["model_all_reduce"] += L * (b * d * f4 + b * f4)
        if not (seq_cut and H % 16 == 0) and N % 16 == 0:   # the N cut
            want["model_all_reduce"] += L * b * H * P * f4
        return want
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    skv = min(c["cap"], cfg.sliding_window or c["cap"])
    want["model_all_gather"] = L * b * (H + 2 * Hkv) * hd // Mm * f4
    want["model_all_reduce"] += L * 2 * b * d * f4
    if seq_cut:
        want["model_all_gather"] += L * b * H * (hd + 2) * f4
    else:
        want["model_all_reduce"] += L * b * H * skv * f4
        want["model_all_to_all"] = L * b * H * hd // Mm * f4
    return want


@pytest.mark.parametrize("spec", MESHES)
def test_a_decode_step_moves_no_cache_bytes(runs, spec):
    for name in CASES:
        if spec in CASES[name].get("refuse", []):
            continue
        for resident, seq_cut in _combos(name):
            c = runs["got"][spec][0][f"{name}/{int(resident)}/"
                                     f"{int(seq_cut)}"]["comms"]
            want = _decode_bytes(name, spec, resident, seq_cut)
            got = {k: round(c[k]["MB"] * 1e6) for k in want}
            assert got == want, (name, resident, seq_cut, got, want)
            assert (c["fsdp_gather"]["calls"] > 0) == (
                not resident and spec == "2x2"), (name, resident)
            assert c["grad_reduce"]["calls"] == 0


def test_reference_sharded_jitted_step_agrees(runs):
    jit = runs["jit"]
    assert jit.returncode == 0, jit.stderr[-3000:]
    want = np.load(os.path.join(runs["d"], "jit_logits1.npy"))
    single = runs["refs"]["llama"]["logits1"]
    assert np.abs(want - single).max() <= 2e-5
    for r in range(4):
        keep = torch.load(os.path.join(runs["d"], f"keep_2x2_{r}.pt"))
        lo, hi, v0, V = keep["jit_rows"]
        got = keep["jit_logits1"].numpy()
        assert np.abs(got - want[lo:hi, :, v0:v0 + V]).max() <= 2e-5, r
