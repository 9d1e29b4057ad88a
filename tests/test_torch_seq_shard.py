"""The reference's sequence-parallel residual (``seq_shard``, its
``layers.residual_spec``) on data × model meshes of gloo processes,
against the reference's single-device functions, on the CPU.

Each case runs, on every rank, the registry's step at the reference's
defaults (the residual cut along S wherever 16 and the model axis divide
it, ``parallel.seq_cut``) and, on a fresh copy of the same weights, the
family's step with ``seq_shard=False`` (the whole residual on every
model rank); with ``"prefill"`` also the cut prefill (the registry's, at
its default) beside the whole one.  Gates:

- the cut step's loss within 1e-5 of the reference's single-device
  ``value_and_grad``, every gathered grad within 1e-4 of its leaf's max,
  ``grad_norm`` within 1e-5 relative (``mesh_cases.check_case``);
- the norm scales the forward applied to the cut rows are exactly the
  family's (the blocks' norms; the final norm too where the reference
  norms the cut residual, not the enc-dec's ``enc_norm`` and
  ``final_norm``), and each one's grad is whole and equal on every rank;
- every collective of the step and of the prefill, calls and bytes by
  kind, is the whole layout's plus what the cut changes, predicted from
  the shapes (:func:`step_delta`, :func:`prefill_delta`);
- the residual checkpoints a rank holds between forward and backward
  (the tensor inputs each layer's remat region saves, read off the
  ``torch.utils.checkpoint`` calls) are L tensors of (B/slots, S/M, d),
  the whole layout's (…, S, d): 1/M of the bytes;
- the cut prefill's logits within 2e-5 of the reference's largest, its
  cache blocks within 2e-5 of the whole prefill's.

Cases: the reduced llama3.2-3b (GQA 4/2) on 1x2 and 2x2, granite-moe on
2x2 (each data slot routes one whole group of 2,048), the VLM prefix
(internvl, its 16 patches counted in S) on 1x2, mamba2 on 1x2, the hybrid
at 5 layers on 1x2 (S past its 64-slot window), seamless (12 encoder
layers, 16 frames) and the tiny ``"encdec"`` config (24 frames: its
encoder stays whole while its decoder is cut) on 1x2, and llama at S 24,
where 16 does not divide S and the residual stays whole.

The reference's knob-swallowing is shown in both packages: its
``mamba2``, ``rglru`` and ``encdec`` ``loss_fn`` take ``seq_shard`` into
``**_``, so its jitted loss on a forced 2-device host mesh lowers to the
same program (the model-cut residual constraints in it) with
``seq_shard=False`` as with True, where the transformer's drops them;
the port's registry cuts those families whatever it is asked.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mesh_cases as MC

TINY = dict(name="torch-tiny-encdec", arch_type="encdec", n_layers=2,
            n_encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=128, vocab_size=256, max_seq_len=128,
            rope_theta=1e4, act="gelu", frontend_tokens=24,
            frontend_dim=64)
CASES = {
    "llama": {"arch": "llama3.2-3b", "B": 8, "S": 32, "seed": 5,
              "meshes": ["1x2", "2x2"], "prefill": True},
    "llama_s24": {"arch": "llama3.2-3b", "B": 4, "S": 24, "seed": 6,
                  "meshes": ["1x2"]},
    "granite": {"arch": "granite-moe-1b-a400m", "B": 4, "S": 1024,
                "seed": 7, "meshes": ["2x2"]},
    "vlm": {"arch": "internvl2-76b", "B": 4, "S": 16, "seed": 8,
            "meshes": ["1x2"], "prefill": True},
    "mamba2": {"arch": "mamba2-2.7b", "B": 4, "S": 64, "seed": 9,
               "meshes": ["1x2"], "prefill": True},
    "hybrid": {"arch": "recurrentgemma-9b", "replace": {"n_layers": 5},
               "B": 4, "S": 80, "seed": 10, "meshes": ["1x2"],
               "prefill": True},
    "seamless": {"arch": "seamless-m4t-medium", "B": 4, "S": 32,
                 "seed": 11, "meshes": ["1x2"], "prefill": True},
    "encdec": {"fields": TINY, "B": 4, "S": 32, "seed": 12,
               "meshes": ["1x2"], "prefill": True},
}
MESHES = ("1x2", "2x2")
RUNS = [(n, m) for n, c in CASES.items() for m in c["meshes"]]

# one rank: every case of the job on this mesh
SEQ_RANK = r'''
import dataclasses, json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
rank, world, port, d, spec = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4], sys.argv[5])
import torch.distributed as dist
from repro_torch import parallel
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as M
from repro_torch.launch.train import maybe_init_distributed
from repro_torch.models import layers as Ly
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


def saved_inputs(fn):
    """fn()'s result and the shapes of the tensors each outermost remat
    region saves until its backward (a non-reentrant checkpoint saves its
    tensor inputs and recomputes the rest), a list a region."""
    real, calls, depth = Ly.checkpoint, [], [0]

    def counting(f, *args, **kw):
        # a region inside another, or one that a backward's recompute
        # opens, holds nothing from the forward to the backward
        if depth[0] or torch._C._current_graph_task_id() != -1:
            return real(f, *args, **kw)
        calls.append([list(a.shape) for a in args
                      if isinstance(a, torch.Tensor)])
        depth[0] += 1
        try:
            return real(f, *args, **kw)
        finally:
            depth[0] -= 1

    Ly.checkpoint = counting
    try:
        return fn(), calls
    finally:
        Ly.checkpoint = real


def comms(tp):
    return {k: [tp.comms.calls[k], tp.comms.bytes[k]]
            for k in parallel.KINDS}


def fresh():
    return from_jax_params(tree, cfg, dtype=torch.float32, device="cpu",
                           trainable=True, mesh=mesh)


def full_grads(model, names, grads):
    out = {}
    for n, g in zip(names, grads):
        shape, sp = model.full_shapes[n], model.specs[n]
        out[n] = parallel.gather_full(g, shape, [
            M.shard_box(shape, sp, mesh, r) for r in range(mesh.size)])
    return out


def prefill(model, seq_shard):
    """The rank's prefill logits and cache of the case's prompts, and its
    collectives: the registry's at its default (the reference's cut), or
    the family's with ``seq_shard=False``."""
    tp = model.tp
    lay = parallel.cache_layout(cfg, tp, B, cap)
    lo, hi = lay.rows
    kw = {} if prefix is None else {"prefix_emb": prefix[lo:hi]}
    if cfg.arch_type != "ssm":
        kw["cache_len_cap"] = cap
    tp.comms.reset()
    with torch.no_grad():
        if seq_shard:
            logits, cache = R.prefill(model, cfg, toks[lo:hi],
                                      global_batch=B, **kw)
            data = cache.data
        else:
            logits, data = R.family(cfg).prefill(
                model, cfg, toks[lo:hi], layout=lay, seq_shard=False, **kw)
    return logits, data, comms(tp), (lo, hi)


def leaves(data):
    layers = data if isinstance(data, list) else [data]
    return {f"{i}/{n}": t for i, layer in enumerate(layers)
            for n, t in layer.items()}


out = {}
for name, c in cases.items():
    if spec not in c["meshes"]:
        continue
    cfg = config(c)
    ref = np.load(os.path.join(d, f"{name}.npz"))
    inputs = [k for k in ref.files if k.startswith("batch:")]
    tree = unflatten({k: ref[k] for k in ref.files if k not in inputs
                      and not k.startswith("ref:")})
    whole_batch = {k[6:]: torch.from_numpy(ref[k]) for k in inputs}
    batch = E.slot_rows(whole_batch, mesh, rank)
    rec = {}
    # the reference's layout: the registry's step at its defaults
    model = fresh()
    tp = model.tp
    params = dict(model.named_parameters())
    names, plist = list(params), list(params.values())
    (grads, metrics), saved = saved_inputs(lambda: E._local_grads(
        model, cfg, batch, names, params, 1, 0.0, torch.float32, True))
    partial = sorted(n for n, p in params.items()
                     if id(p) in tp.model_partial)
    grads, metrics = parallel.reduce_grads(tp, plist, grads, metrics)
    norm = parallel.global_norm(tp, plist, grads)
    spread = {}
    for n in partial:
        g = grads[names.index(n)].contiguous()
        every = [torch.empty_like(g) for _ in range(world)]
        dist.all_gather(every, g)
        spread[n] = max(float((e - every[0]).abs().max()) for e in every)
    rec["cut"] = {"metrics": {k: float(v) for k, v in metrics.items()},
                  "grad_norm": float(norm),
                  "grads": full_grads(model, names, grads),
                  "comms": comms(tp), "partial": partial, "spread": spread,
                  "saved": saved}
    # the whole residual: the family's step with seq_shard=False
    model2 = fresh()
    tp2 = model2.tp
    p2 = list(model2.parameters())

    def whole_step():
        loss, m = R.family(cfg).loss_fn(model2, cfg, batch,
                                        dtype=torch.float32, remat=True,
                                        seq_shard=False)
        return (torch.autograd.grad(loss, p2),
                {k: v.detach().float() for k, v in m.items()})

    (g2, m2), saved2 = saved_inputs(whole_step)
    assert not tp2.model_partial
    g2, m2 = parallel.reduce_grads(tp2, p2, g2, m2)
    parallel.global_norm(tp2, p2, g2)
    rec["whole"] = {"loss": float(m2["loss"]), "comms": comms(tp2),
                    "saved": saved2}
    if c.get("prefill"):
        toks = torch.from_numpy(ref["batch:tokens"])
        B, cap = toks.shape
        pk = [k for k in ("batch:prefix_emb", "batch:src_emb")
              if k in ref.files]
        prefix = torch.from_numpy(ref[pk[0]]) if pk else None
        if cfg.arch_type == "vlm":          # the cache holds the prefix
            cap += prefix.shape[1]
        lw, cw, comms_w, rows = prefill(model2, False)
        lc, cc, comms_c, _ = prefill(model2, True)
        lo, hi = rows
        V = lc.shape[-1]
        v0 = tp2.vocab_start(V)
        want = torch.from_numpy(ref["ref:prefill_logits"])[lo:hi, :,
                                                           v0:v0 + V]
        cw, cc = leaves(cw), leaves(cc)
        rec["prefill"] = {
            "logits_err": float((lc - want).abs().max()),
            "whole_logits_err": float((lw - want).abs().max()),
            "largest": float(torch.from_numpy(
                ref["ref:prefill_logits"]).abs().max()),
            "cache_err": max(float((cc[k].float() - cw[k].float()).abs()
                                   .max()) for k in cw),
            "same_leaves": sorted(cw) == sorted(cc),
            "comms": comms_c, "whole_comms": comms_w}
    out[name] = rec
if rank == 0:
    torch.save(out, os.path.join(d, f"seq_{spec}.pt"))
torch.distributed.destroy_process_group()
'''

# the reference's loss on a forced 2-device host mesh (data 1 x model 2,
# Auto axes, weights and rows replicated): the lowered program with
# seq_shard=False and with True, and how many model-cut residual
# constraints each holds
SWALLOW = r'''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import json, re
import jax
import jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_config
from repro.models import registry as R

mesh = jax.make_mesh((1, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}
for arch in ("llama3.2-3b", "mamba2-2.7b", "recurrentgemma-9b",
             "seamless-m4t-medium"):
    cfg = get_config(arch).reduced()
    params = R.init_params(jax.random.PRNGKey(0), cfg)
    batch = R.concrete_inputs(cfg, "train", 2, 32)
    texts, losses = {}, {}
    for seq in (False, True):
        fn = jax.jit(lambda p, b: R.loss_fn(p, cfg, b, remat=True,
                                            dtype=jnp.float32,
                                            seq_shard=seq)[0])
        with jax.set_mesh(mesh):
            texts[seq] = fn.lower(params, batch).as_text()
            losses[seq] = float(fn(params, batch))
    cut = r'\{"data"\}, \{"model"\}, \{\}'
    out[arch] = {"same": texts[False] == texts[True],
                 "cuts": [len(re.findall(cut, texts[s]))
                          for s in (False, True)],
                 "losses": [losses[False], losses[True]]}
print(json.dumps(out))
'''


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the ranks and the workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prefill_reference(jcfg, params, batch, cap):
    import jax.numpy as jnp
    from repro.models import registry as JR
    kw = {"dtype": jnp.float32, "cache_len_cap": cap}
    for k in ("prefix_emb", "src_emb"):
        if k in batch:
            kw["prefix_emb"] = jnp.asarray(batch[k])
    logits, _ = JR.prefill(params, jcfg,
                           jnp.asarray(batch["tokens"].astype(np.int32)),
                           **kw)
    return np.asarray(logits)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case's reference step (and prefill), every mesh's ranks side
    by side, the reference's lowered losses."""
    import jax
    from repro.models import registry as JR
    d = tmp_path_factory.mktemp("seq_shard")
    env = dict(os.environ, PYTHONPATH=os.path.join(MC.ROOT, "src"),
               JAX_PLATFORMS="cpu")
    swallow = subprocess.Popen([sys.executable, "-c", SWALLOW], env=env,
                               stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
    with open(os.path.join(d, "cases.json"), "w") as f:
        json.dump(CASES, f)
    refs = {}
    for name, c in CASES.items():
        jcfg, cfg = MC.configs(c)
        batch = MC.batch_of(cfg, c["B"], c["S"], c["seed"])
        params, loss, metrics, grads = MC.reference(jcfg, batch, c["seed"])
        extra = {}
        if c.get("prefill"):
            jparams = JR.init_params(jax.random.PRNGKey(c["seed"]), jcfg)
            cap = c["S"] + (cfg.frontend_tokens if cfg.arch_type == "vlm"
                            else 0)
            extra["ref:prefill_logits"] = _prefill_reference(
                jcfg, jparams, batch, cap)
        np.savez(os.path.join(d, f"{name}.npz"), **MC._flat(params),
                 **{f"batch:{k}": v for k, v in batch.items()}, **extra)
        refs[name] = (loss, metrics, grads, cfg)
    procs = {spec: MC.spawn(d, spec, SEQ_RANK) for spec in MESHES}
    for p in procs.values():
        MC.wait(p)
    o, e = swallow.communicate(timeout=420)
    assert swallow.returncode == 0, e[-3000:]
    return dict(refs=refs, swallow=json.loads(o.strip().splitlines()[-1]),
                got={s: torch.load(os.path.join(d, f"seq_{s}.pt"))
                     for s in MESHES})


def _dims(name, spec):
    """(rows a slot, S of the decoder's residual, frames, M, cut, enc_cut,
    the config)."""
    from repro_torch import parallel
    c = CASES[name]
    _, cfg = MC.configs(c)
    D, M = (int(x) for x in spec.split("x"))
    S = c["S"] + (cfg.frontend_tokens if cfg.arch_type == "vlm" else 0)
    Se = cfg.frontend_tokens if cfg.arch_type in ("audio", "encdec") else 0
    return (c["B"] // D, S, Se, M, parallel.seq_cut(S, M),
            bool(Se) and parallel.seq_cut(Se, M), cfg)


def _blocks(cfg):
    """The training layers' blocks in order: (entry, exit recomputed) of
    each, ``entry`` "sum" where the gathered rows' grads are partial (the
    gather's backward sums them), "whole" where every consumer already
    sums its own (the MoE, Mamba-2's mixer); an exit is recomputed when
    the layer's remat region saves something after it (the attention's,
    before the second norm; the MoE's, before its aux losses), not when
    it ends the region (the MLP's, Mamba-2's)."""
    from repro_torch.models import rglru
    if cfg.arch_type == "ssm":
        return [("whole", 0)] * cfg.n_layers
    if cfg.arch_type == "moe":
        return [("sum", 1), ("whole", 1)] * cfg.n_layers
    if cfg.arch_type == "hybrid":
        return [("sum", 1), ("sum", 0)] * len(rglru.kinds(cfg))
    if cfg.arch_type in ("audio", "encdec"):
        return [("sum", 1), ("sum", 1), ("sum", 0)] * cfg.n_layers
    return [("sum", 1), ("sum", 0)] * cfg.n_layers


def _zero():
    from repro_torch import parallel
    return {k: [0, 0] for k in parallel.KINDS}


def _add(t, kind, calls, nbytes):
    t[kind][0] += calls
    t[kind][1] += calls * nbytes


def step_delta(name, spec):
    """What the cut changes in a training step's collectives (float32,
    remat on), from the shapes: each block enters by an all-gather of its
    rank's S/M rows (the forward and remat's recompute) where the whole
    residual passed ``to_model`` (whose backward all-reduce the "sum"
    gather's backward replaces one for one), and leaves by a float32
    reduce-scatter (the forward, and the recompute where the exit is
    recomputed) whose backward all-gathers the grad, where the whole
    residual all-reduced; the embedding likewise; the final hiddens are
    gathered whole before the head, whose ``to_model`` backward becomes
    the gather's (the enc-dec's gathers before ``enc_norm`` and
    ``final_norm`` keep the rank's rows in their backward and its head's
    ``to_model`` stays); with one data slot the partial norm grads take
    one all-reduce of their own."""
    b, S, Se, M, cut, enc_cut, cfg = _dims(name, spec)
    d, f4 = cfg.d_model, 4
    t = _zero()
    if not cut:
        return t
    F, G = b * S * d * f4, b * S // M * d * f4
    enc = cfg.arch_type in ("audio", "encdec")
    blocks = _blocks(cfg)
    if enc:
        dec = blocks
        blocks = [("sum", 1), ("sum", 0)] * cfg.n_encoder_layers
        if enc_cut:
            Fe, Ge = b * Se * d * f4, b * Se // M * d * f4
            for entry, r in blocks:
                _add(t, "model_all_gather", 2, Ge)
                _add(t, "model_all_gather", 1, Ge)
                _add(t, "model_reduce_scatter", 1 + r, Fe)
                _add(t, "model_all_reduce", -(1 + r), Fe)
            _add(t, "model_all_gather", 1, Ge)          # before enc_norm
        blocks = dec
    for entry, r in blocks:
        _add(t, "model_all_gather", 2, G)                # entry
        _add(t, "model_all_gather", 1, G)                # exit's backward
        _add(t, "model_reduce_scatter", 1 + r, F)
        _add(t, "model_all_reduce", -(1 + r), F)
    # the embedding (the VLM's prefix inside the reduce-scatter)
    text = b * CASES[name]["S"] * d * f4
    _add(t, "model_reduce_scatter", 1, F)
    _add(t, "model_all_reduce", -1, text)
    _add(t, "model_all_gather", 1, G)
    # the final hiddens
    _add(t, "model_all_gather", 1, G)
    if not enc:
        _add(t, "model_all_reduce", 1, F)
        _add(t, "model_all_reduce", -1, text)
    if spec.startswith("1x"):
        _add(t, "grad_reduce", 1, f4 * d * len(expected_partial(cfg)))
    return t


def prefill_delta(name, spec):
    """What the cut changes in a prefill's collectives (no grad, no
    remat): each block's all-gather of the rank's rows and float32
    reduce-scatter where the whole residual all-reduced its exit, the
    embedding's reduce-scatter for its all-reduce, one all-gather of the
    last rows; the enc-dec's encoder cut over frames and gathered before
    ``enc_norm``."""
    b, S, Se, M, cut, enc_cut, cfg = _dims(name, spec)
    b = CASES[name]["B"]              # the prefill's rows: every slot's
    d, f4 = cfg.d_model, 4
    t = _zero()
    enc = cfg.arch_type in ("audio", "encdec")
    if enc and enc_cut:
        Fe, Ge = b * Se * d * f4, b * Se // M * d * f4
        n = 2 * cfg.n_encoder_layers
        _add(t, "model_all_gather", n + 1, Ge)
        _add(t, "model_reduce_scatter", n, Fe)
        _add(t, "model_all_reduce", -n, Fe)
    if not cut:
        return t
    F, G = b * S * d * f4, b * S // M * d * f4
    n = len(_blocks(cfg))
    _add(t, "model_all_gather", n, G)
    _add(t, "model_reduce_scatter", n + 1, F)
    _add(t, "model_all_reduce", -n, F)
    _add(t, "model_all_reduce", -1, b * CASES[name]["S"] * d * f4)
    _add(t, "model_all_gather", 1, b * d * f4)
    return t


def expected_partial(cfg):
    """The parameters the forward applies to the cut residual's rows: the
    blocks' norms, and the final norm where the reference norms the cut
    residual (``transformer.py:142``, ``mamba2.py:280``,
    ``rglru.py:291``); the enc-dec gathers before ``enc_norm`` and
    ``final_norm`` (``encdec.py:115``, ``:146``).  Its encoder's norms
    only where its frames are cut."""
    from repro_torch import parallel
    from repro_torch.models import rglru
    if cfg.arch_type == "ssm":
        return ["final_norm"] + [f"layers.{i}.norm"
                                 for i in range(cfg.n_layers)]
    if cfg.arch_type in ("audio", "encdec"):
        out = [f"decoder.{i}.norm{k}" for i in range(cfg.n_layers)
               for k in (1, 2, 3)]
        if parallel.seq_cut(cfg.frontend_tokens, 2):
            out += [f"encoder.{i}.norm{k}"
                    for i in range(cfg.n_encoder_layers) for k in (1, 2)]
        return out
    n = (len(rglru.kinds(cfg)) if cfg.arch_type == "hybrid"
         else cfg.n_layers)
    return ["final_norm"] + [f"layers.{i}.norm{k}" for i in range(n)
                             for k in (1, 2)]


def _comms_sum(a, b):
    return {k: [a[k][0] + b[k][0], a[k][1] + b[k][1]] for k in a}


@pytest.mark.parametrize("name,spec", RUNS)
def test_cut_step_matches_single_device(runs, name, spec):
    got = runs["got"][spec][name]["cut"]
    MC.check_case(runs["refs"][name], got)


@pytest.mark.parametrize("name,spec", RUNS)
def test_partial_norms_are_summed_whole_on_every_rank(runs, name, spec):
    got = runs["got"][spec][name]["cut"]
    b, S, Se, M, cut, enc_cut, cfg = _dims(name, spec)
    want = sorted(expected_partial(cfg)) if cut else []
    assert got["partial"] == want
    assert sorted(got["spread"]) == want
    assert all(v == 0.0 for v in got["spread"].values()), got["spread"]


@pytest.mark.parametrize("name,spec", RUNS)
def test_step_collectives_as_predicted(runs, name, spec):
    rec = runs["got"][spec][name]
    want = _comms_sum(rec["whole"]["comms"], step_delta(name, spec))
    assert rec["cut"]["comms"] == want, (rec["cut"]["comms"], want)


@pytest.mark.parametrize("name,spec", RUNS)
def test_residual_checkpoints_fall_to_one_in_m(runs, name, spec):
    rec = runs["got"][spec][name]
    b, S, Se, M, cut, enc_cut, cfg = _dims(name, spec)
    d = cfg.d_model
    enc = cfg.arch_type in ("audio", "encdec")
    n_enc = cfg.n_encoder_layers if enc else 0
    L = cfg.n_layers
    layer_inputs = {}
    for tag in ("cut", "whole"):
        saved = rec[tag]["saved"]
        assert len(saved) >= n_enc + L
        layer_inputs[tag] = [s[0] for s in saved[:n_enc + L]]
    rows = S // M if cut else S
    frames = Se // M if enc_cut else Se
    assert layer_inputs["cut"] == [[b, frames, d]] * n_enc + \
        [[b, rows, d]] * L
    assert layer_inputs["whole"] == [[b, Se, d]] * n_enc + [[b, S, d]] * L
    nbytes = {t: sum(np.prod(s) for s in v) for t, v in
              layer_inputs.items()}
    if cut and (enc_cut or not enc):
        assert nbytes["cut"] * M == nbytes["whole"]
    # what else a region holds (the enc-dec's encoder output, the loss's
    # chunks) is the same in both layouts
    assert [s[1:] for s in rec["cut"]["saved"][:n_enc + L]] == \
        [s[1:] for s in rec["whole"]["saved"][:n_enc + L]]
    assert rec["cut"]["saved"][n_enc + L:] == \
        rec["whole"]["saved"][n_enc + L:]


PREFILLS = [(n, m) for n, m in RUNS if CASES[n].get("prefill")]


@pytest.mark.parametrize("name,spec", PREFILLS)
def test_cut_prefill_matches_single_device(runs, name, spec):
    p = runs["got"][spec][name]["prefill"]
    assert p["logits_err"] <= 2e-5 * p["largest"], p
    assert p["whole_logits_err"] <= 2e-5 * p["largest"], p
    assert p["same_leaves"] and p["cache_err"] <= 2e-5, p


@pytest.mark.parametrize("name,spec", PREFILLS)
def test_prefill_collectives_as_predicted(runs, name, spec):
    p = runs["got"][spec][name]["prefill"]
    want = _comms_sum(p["whole_comms"], prefill_delta(name, spec))
    assert p["comms"] == want, (p["comms"], want)


def test_s_not_a_multiple_of_16_keeps_the_residual_whole(runs):
    rec = runs["got"]["1x2"]["llama_s24"]
    assert rec["cut"]["comms"] == rec["whole"]["comms"]
    assert rec["cut"]["partial"] == []
    assert rec["cut"]["comms"]["model_reduce_scatter"] == [0, 0]


def test_seq_cut_rule():
    from repro_torch import parallel
    assert parallel.seq_cut(32, 2) and parallel.seq_cut(64, 4)
    assert not parallel.seq_cut(24, 2)        # 16 does not divide S
    assert not parallel.seq_cut(32, 3)        # the axis does not divide S
    assert parallel.seq_cut(48, 3)
    assert not parallel.seq_cut(32, 1)        # no model axis


def test_reference_swallows_the_knob_where_the_port_reproduces_it(runs):
    """The reference's ``mamba2``, ``rglru`` and ``encdec`` losses lower
    to the same program with ``seq_shard=False`` as with True, the
    model-cut residual constraints in both; the transformer's drops
    them.  The port's registry passes the knob to the transformer family
    only: ``registry.loss_fn(seq_shard=False)`` of Mamba-2 cuts (the
    partial norms of its 1x2 record above came through the registry's
    default, and the family's ``seq_shard=False`` run recorded none)."""
    sw = runs["swallow"]
    assert not sw["llama3.2-3b"]["same"]
    assert sw["llama3.2-3b"]["cuts"][0] == 0 < sw["llama3.2-3b"]["cuts"][1]
    for arch in ("mamba2-2.7b", "recurrentgemma-9b", "seamless-m4t-medium"):
        assert sw[arch]["same"] and sw[arch]["cuts"][0] > 0, (arch,
                                                              sw[arch])
    for arch, rec in sw.items():
        assert abs(rec["losses"][0] - rec["losses"][1]) <= 1e-5, arch
    import inspect
    from repro_torch.models import registry as R
    src = inspect.getsource(R.loss_fn)
    assert "_TRANSFORMER_FAMILIES" in src


def test_registry_loss_cuts_mamba2_whatever_it_is_asked(monkeypatch):
    """``registry.loss_fn(seq_shard=False)`` hands Mamba-2's forward no
    knob (so it runs at its default, the cut) and the dense family's
    ``seq_shard=False``."""
    from repro_torch.models import mamba2, transformer
    from repro_torch.models import registry as R
    seen = {}

    def spy(mod, name):
        def fh(*a, **kw):
            seen[name] = kw.get("seq_shard", True)
            raise StopIteration
        monkeypatch.setattr(mod, "forward_hidden", fh)

    spy(mamba2, "ssm")
    spy(transformer, "dense")
    from repro_torch.configs import get_config
    for arch, key in (("mamba2-2.7b", "ssm"), ("llama3.2-3b", "dense")):
        cfg = get_config(arch).reduced()
        toks = torch.zeros(1, 16, dtype=torch.long)
        with pytest.raises(StopIteration):
            R.loss_fn(None, cfg, {"tokens": toks, "labels": toks},
                      seq_shard=False)
    assert seen == {"ssm": True, "dense": False}
