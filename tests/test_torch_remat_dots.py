"""``remat_policy="dots"`` (the reference's ``transformer.py:134``:
``jax.checkpoint`` with ``dots_with_no_batch_dims_saveable``) against the
reference, on the CPU, float32.

- What the forward keeps: the reduced seesaw-150m at ``head_dim=48,
  d_ff=384`` (every width differs), B 2, S 32.  The reference's
  ``print_saved_residuals`` lists, per layer, under "dots" the layer's
  input and six products (q (…, 192), k and v (…, 96), the o-projection's
  output (…, 256), up and gate (…, 384)), not the down projection's
  output; under "" the layer's input alone.  The port's layer inputs
  (the tensors each remat region saves) and the products its "dots"
  contexts keep (each context's ``storage``, recorded by a wrapper of
  ``create_selective_checkpoint_contexts``) are those, shape for shape
  (rows flattened to B·S, as ``aten.mm`` returns them), and under "" it
  keeps no product.
- Loss and grads under "dots" equal the port's "" run within 1e-6 and
  the reference's "dots" run within the mesh tests' gates (loss 1e-5,
  every grad 1e-4 of its leaf's max); the same for the MoE (reduced
  granite) and the VLM prefix (reduced internvl).
- Mamba-2 runs "dots" as "": the reference's ``mamba2.loss_fn`` swallows
  the knob in ``**_``, and ``registry.loss_fn`` passes it to the
  transformer family only.
- The card's path (``_FakeCard``: the kernels' autograd Functions over
  their plain versions): under "dots" the backward recomputes four
  products a layer fewer (q, k, v and o) and the flash forward and the
  RMSNorms as often as under "".
- An engine made with ``remat_policy="dots"`` steps under it (and one
  made without, under full remat), each keyed as the reference's
  (batch, micro); a "dots" grad step equals the "" one within 1e-6.
"""
import contextlib
import dataclasses
import io
import re

import jax
import jax.ad_checkpoint
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as j_get_config
from repro.models import registry as JR
from repro.models import transformer as JT
from repro_torch.configs import (OptimizerConfig, RunConfig, ScheduleConfig,
                                 get_config)
from repro_torch.models import layers as Ly
from repro_torch.models import registry as R
from repro_torch.optim import optimizers as O
from repro_torch.train import engine as E
from repro_torch.train.trainer import Trainer
from repro_torch.weights import _ref_leaf, from_jax_params
from test_torch_train import _FakeCard

B, S = 2, 32
WIDE = dict(head_dim=48, d_ff=384)
MM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(arch, seed=0, **kw):
    """(reference config, params, port config, port model, numpy batch)
    of the reduced arch with ``kw`` replaced."""
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), **kw)
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    params = JR.init_params(jax.random.PRNGKey(seed), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            dtype=torch.float32, device="cpu",
                            trainable=True)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.arch_type == "vlm":
        batch["prefix_emb"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return jcfg, params, cfg, model, batch


def _torch(batch):
    return {k: torch.from_numpy(v) if v.dtype == np.float32
            else torch.from_numpy(v).long() for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64
                           else v) for k, v in batch.items()}


def _reference_saved(jcfg, params, tokens, policy):
    """The reference's per-layer residuals (the layer-stacked outputs of
    its scan in ``print_saved_residuals``), each as (B·S, width)."""
    def f(p):
        return JT.forward_hidden(p, jcfg, tokens, dtype=jnp.float32,
                                 remat=True, remat_policy=policy)[0].sum()

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax.ad_checkpoint.print_saved_residuals(f, params)
    out = []
    for line in buf.getvalue().splitlines():
        m = re.match(r"f32\[([\d,]+)\] output of scan", line)
        dims = [int(x) for x in m.group(1).split(",")] if m else []
        if len(dims) == 4 and dims[0] == jcfg.n_layers:
            out.append((dims[1] * dims[2], dims[3]))
    return sorted(out)


@contextlib.contextmanager
def _recording_contexts():
    """A list that gets the ``storage`` (the kept products) of every
    "dots" forward context made inside."""
    real, caches = Ly.create_selective_checkpoint_contexts, []

    def recording(*args, **kw):
        fwd, rec = real(*args, **kw)
        caches.append(fwd.storage)
        return fwd, rec

    Ly.create_selective_checkpoint_contexts = recording
    try:
        yield caches
    finally:
        Ly.create_selective_checkpoint_contexts = real


def _port_saved(model, cfg, tokens, policy):
    """(the port's layer inputs, the products its "dots" contexts keep),
    each as (rows, width), from one forward."""
    real, inputs, depth = Ly.checkpoint, [], [0]

    def counting(f, *args, **kw):
        if depth[0]:
            return real(f, *args, **kw)
        inputs.extend(tuple(a.shape) for a in args
                      if isinstance(a, torch.Tensor))
        depth[0] += 1
        try:
            return real(f, *args, **kw)
        finally:
            depth[0] -= 1

    Ly.checkpoint = counting
    try:
        with _recording_contexts() as caches:
            R.family(cfg).forward_hidden(model, cfg, tokens,
                                         dtype=torch.float32, remat=True,
                                         remat_policy=policy)
    finally:
        Ly.checkpoint = real
    kept = []
    for c in caches:
        for entries in c.values():
            for v in (entries.values() if isinstance(entries, dict)
                      else entries):
                if hasattr(v, "val"):
                    kept.append(tuple(v.val.shape))
    layers = [(s[0] * s[1], s[2]) for s in inputs]
    return layers, kept


@pytest.mark.parametrize("policy", ["", "dots"])
def test_saved_tensors_equal_the_reference(policy):
    jcfg, params, cfg, model, batch = _case("seesaw-150m", **WIDE)
    want = _reference_saved(jcfg, params, jnp.asarray(
        batch["tokens"].astype(np.int32)), policy)
    layers, kept = _port_saved(model, cfg, torch.from_numpy(
        batch["tokens"]).long(), policy)
    L, d = cfg.n_layers, cfg.d_model
    assert layers == [(B * S, d)] * L
    one = []
    if policy == "dots":
        q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
        one = [(B * S, w) for w in (q, kv, kv, d, cfg.d_ff, cfg.d_ff)]
    assert kept == one * L                      # in the layer's order
    # the reference stacks each residual over its L layers
    assert sorted([(B * S, d)] + one) == want


def _grads(model, cfg, batch, policy):
    params = list(model.parameters())
    loss, _ = R.loss_fn(model, cfg, _torch(batch), dtype=torch.float32,
                        remat=True, remat_policy=policy)
    return float(loss.detach()), torch.autograd.grad(loss, params)


def _reference_grads(jcfg, params, batch, policy):
    def loss_of(p):
        return JR.loss_fn(p, jcfg, _jax(batch), remat=True,
                          dtype=jnp.float32, remat_policy=policy)

    (loss, _), grads = jax.value_and_grad(loss_of, has_aux=True)(params)
    return float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("arch,kw", [("seesaw-150m", WIDE),
                                     ("granite-moe-1b-a400m", {}),
                                     ("internvl2-76b", {})])
def test_dots_loss_and_grads(arch, kw):
    jcfg, params, cfg, model, batch = _case(arch, seed=1, **kw)
    loss, grads = _grads(model, cfg, batch, "dots")
    loss0, grads0 = _grads(model, cfg, batch, "")
    assert abs(loss - loss0) <= 1e-6
    for a, b in zip(grads, grads0):
        assert float((a - b).abs().max()) <= 1e-6
    jloss, jgrads = _reference_grads(jcfg, params, batch, "dots")
    assert abs(loss - jloss) <= 1e-5
    for (n, _), g in zip(model.named_parameters(), grads):
        w = torch.from_numpy(np.array(_ref_leaf(jgrads, n, cfg)))
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()), n


def test_mamba2_runs_dots_as_full_remat():
    _, _, cfg, model, batch = _case("mamba2-2.7b", seed=2)
    with _recording_contexts() as caches:
        loss, grads = _grads(model, cfg, batch, "dots")
    assert caches == []                      # no policy was applied
    loss0, grads0 = _grads(model, cfg, batch, "")
    assert loss == loss0
    assert all(torch.equal(a, b) for a, b in zip(grads, grads0))


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in MM:
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_card_path_under_dots(monkeypatch):
    """The autograd Functions of the card's kernels (over their plain
    versions): "dots" recomputes q, k, v and o no more (four products a
    layer fewer in the backward); the flash forward and the RMSNorms run
    as often as under full remat, and the grads are the same."""
    _, _, cfg, model, batch = _case("seesaw-150m", seed=3, **WIDE)
    params = list(model.parameters())
    fake = _FakeCard(monkeypatch)
    got = {}
    for policy in ("", "dots"):
        fake.n = dict.fromkeys(fake.n, 0)
        loss, _ = R.loss_fn(model, cfg, _torch(batch), dtype=torch.float32,
                            remat=True, remat_policy=policy)
        with _CountMM() as mm:
            g = torch.autograd.grad(loss, params)
        got[policy] = (dict(fake.n), mm.n, g)
    L = cfg.n_layers
    assert got["dots"][0] == got[""][0] == dict(
        rmsnorm_fwd=4 * L + 1, rmsnorm_bwd=2 * L + 1, flash_fwd=2 * L,
        flash_bwd_dq=L, flash_bwd_dkv=L)
    assert got["dots"][1] == got[""][1] - 4 * L
    for a, b in zip(got["dots"][2], got[""][2]):
        assert float((a - b).abs().max()) <= 1e-6


def test_engine_keys_and_steps_dots():
    cfg = dataclasses.replace(get_config("seesaw-150m").reduced(), **WIDE)
    run = RunConfig(model=cfg, schedule=ScheduleConfig(kind="constant",
                                                       base_lr=1e-3),
                    optimizer=OptimizerConfig(kind="adamw"), seq_len=S,
                    global_batch_size=B, total_tokens=B * S * 4,
                    dtype="float32")
    tr = Trainer(run, device="cpu")
    assert tr.engine.remat_policy == ""
    dots = E.PhaseEngine(run, tr.optimizer, tr.plan, remat_policy="dots")
    zeros = torch.zeros(1, B, S, dtype=torch.long)
    for eng, kept in ((tr.engine, False), (dots, True)):
        with _recording_contexts() as caches:
            eng.run_chunk(tr.state.model, tr.state.opt_state, 0,
                          {"tokens": zeros, "labels": zeros}, step=0)
        assert list(eng._cache) == [(B, 1)]      # the reference's key
        assert bool(caches) == kept, eng.remat_policy
    _, _, _, model, batch = _case("seesaw-150m", seed=4, **WIDE)
    opt = O.from_config(OptimizerConfig(kind="adamw"))
    out = {}
    for policy in ("", "dots"):
        m = model
        state = opt.init(dict(m.named_parameters()))
        before = [p.detach().clone() for p in m.parameters()]
        step = E.make_grad_step(cfg, opt, dtype=torch.float32,
                                remat_policy=policy)
        _, _, metrics = step(m, state, _torch(batch),
                             torch.tensor(1e-3))
        out[policy] = ({k: float(v) for k, v in metrics.items()},
                       [p.detach().clone() for p in m.parameters()])
        with torch.no_grad():
            for p, b in zip(m.parameters(), before):
                p.copy_(b)
    for k, v in out[""][0].items():
        assert abs(out["dots"][0][k] - v) <= 1e-6 * max(1.0, abs(v)), k
    for a, b in zip(out["dots"][1], out[""][1]):
        assert float((a - b).abs().max()) <= 1e-6
