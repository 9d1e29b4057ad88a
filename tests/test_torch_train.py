"""The port's training slice against the JAX package, on the CPU.

The same numpy inputs and weights go through the reference and through
its port: the Seesaw plans and their per-step LR, the data stream, the
backward of RMSNorm and of flash attention (the reference's Pallas VJPs
under ``interpret=True``), the loss and its grads, the optimizers, the
grad step, and whole short training runs.  Float32 throughout.

Tolerances: plan tables and data bitwise; a piecewise LR bitwise, the
quarter-cosine LR within 2 float32 ulp (XLA's float32 cos and torch's
round 1 ulp apart at some points, and the product with base_lr can round
that to 2); kernel grads 2e-5 (the
``docs/kernels.md`` bound); loss 1e-5 and grads 1e-4; optimizer updates
1e-6; training histories 5e-4 per step, as the reference's own ramp
parity test (``tests/test_backend.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import OptimizerConfig as JOptimizerConfig
from repro.configs import RunConfig as JRunConfig
from repro.configs import ScheduleConfig as JScheduleConfig
from repro.configs.base import ModelConfig as JModelConfig
from repro.core import schedules as JS
from repro.core import seesaw as JSS
from repro.data import MarkovLM as JMarkovLM
from repro.data import PhaseDataLoader as JLoader
from repro.kernels import backend as JKB
from repro.kernels.flash_attention import _flash_bwd, _flash_fwd
from repro.kernels.rmsnorm import _pallas_bwd
from repro.kernels.rmsnorm import rmsnorm as j_rmsnorm
from repro.models import registry as JR
from repro.optim import optimizers as JO
from repro.train import engine as JE
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs import (ModelConfig, OptimizerConfig, RunConfig,
                                 ScheduleConfig)
from repro_torch.core import schedules as S
from repro_torch.core import seesaw as SS
from repro_torch.data import MarkovLM, PhaseDataLoader
from repro_torch.kernels import backend as KB
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as RN
from repro_torch.launch import train as launch_train
from repro_torch.models import registry as R
from repro_torch.optim import optimizers as O
from repro_torch.train import engine as E
from repro_torch.train.trainer import Trainer
from repro_torch.weights import from_jax_params

KERNEL = dict(atol=2e-5, rtol=2e-5)

TINY = dict(name="train-tiny", arch_type="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=200,
            max_seq_len=64, rope_theta=1e4)

KINDS = ["cosine", "step", "seesaw", "seesaw-general", "naive-ramp",
         "constant"]


def _normal(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _jax_name(tree, name):
    """The reference's array for a port parameter name
    (``layers.1.attn.w_q`` -> ``tree['layers']['attn']['w_q'][1]``)."""
    parts = name.split(".")
    if parts[0] == "tok":
        return tree["embed"]["tok"]
    if parts[0] == "lm_head":
        return tree["embed"]["lm_head"]
    if parts[0] == "final_norm":
        return tree["final_norm"]
    node = tree["layers"]
    for p in parts[2:]:
        node = node[p]
    return node[int(parts[1])]


# --------------------------------------------------------------------- #
# configs, plans and the LR
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("ours,theirs", [
    (ScheduleConfig, JScheduleConfig), (OptimizerConfig, JOptimizerConfig),
    (RunConfig, JRunConfig)])
def test_run_configs_match_reference(ours, theirs):
    """Same fields and defaults, the adaptive controller's knobs
    included, less the reference's kernel_backend."""
    want = {f.name: f.default for f in dataclasses.fields(theirs)
            if f.name != "kernel_backend"}
    got = {f.name: f.default for f in dataclasses.fields(ours)}
    assert got == want


def _plans(kind, **kw):
    args = dict(kind=kind, base_lr=3e-3, total_tokens=64 * 8 * 120,
                warmup_frac=0.1, b0=8, alpha=2.0, n_cuts=4,
                beta=2.0 if kind in ("seesaw-general", "naive-ramp")
                else None)
    args.update(kw)
    return SS.build_plan(**args), JSS.build_plan(**args)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("max_b", [None, 32])
def test_plan_tables_and_per_step_lr_match(kind, max_b):
    ours, theirs = _plans(kind, max_batch_size=max_b)
    seq = 64
    assert [dataclasses.astuple(p) for p in ours.phases] == \
        [dataclasses.astuple(p) for p in theirs.phases]
    assert (ours.alpha, ours.beta, ours.warmup_tokens) == \
        (theirs.alpha, theirs.beta, theirs.warmup_tokens)
    assert ours.steps_per_phase(seq) == theirs.steps_per_phase(seq)
    assert ours.batch_sizes() == theirs.batch_sizes()
    assert [(b, [(p.index, n) for p, n in e])
            for b, e in ours.merged_segments(seq)] == \
        [(b, [(p.index, n) for p, n in e])
         for b, e in theirs.merged_segments(seq)]
    # every step of the run: its phase and its LR, by tokens and by the
    # exact step index
    lr, jlr = E.plan_lr_fn(ours, seq), JE.plan_lr_fn(theirs, seq)
    tok, got, want = 0, [], []
    for step in range(ours.total_steps(seq)):
        p = ours.realized_phase_at(tok, seq)
        assert p.index == theirs.realized_phase_at(tok, seq).index
        for st in (step, -1, None):
            got.append(float(lr(float(tok), st)))
            want.append(float(jlr(float(tok), st)))
        tok += p.batch_size * seq
    np.testing.assert_array_max_ulp(np.float32(got), np.float32(want),
                                    2 if kind == "cosine" else 0)


def test_schedule_curves_match():
    toks = np.linspace(0, 2e5, 97)
    pairs = [(S.quarter_cosine_lr(3e-3, 2e5, 2e4),
              JS.quarter_cosine_lr(3e-3, 2e5, 2e4)),
             (S.constant_lr(1e-3, 5e3), JS.constant_lr(1e-3, 5e3)),
             (S.piecewise_lr(1e-3, 1e4, [5e4, 1.2e5, 2e5], [1, .5, .25]),
              JS.piecewise_lr(1e-3, 1e4, [5e4, 1.2e5, 2e5], [1, .5, .25]))]
    for ulp, (ours, theirs) in zip((2, 0, 0), pairs):
        got = np.float32([float(ours(t)) for t in toks])
        want = np.float32([float(theirs(t)) for t in toks])
        np.testing.assert_array_max_ulp(got, want, ulp)
    assert S.cosine_cut_points(1e6, 1e5, 2.0, 6) == \
        JS.cosine_cut_points(1e6, 1e5, 2.0, 6)
    assert S.cosine_cut_points(1e6, 1e5, 2.0, 6, quarter=False) == \
        JS.cosine_cut_points(1e6, 1e5, 2.0, 6, quarter=False)


def test_piecewise_step_tier_is_exact_past_2_24_tokens():
    """The int32 step compare places the cut on its step where the
    float32 token compare cannot (tokens past 2^24)."""
    ends = [2 ** 25 + 1, 2 ** 26]
    lr = S.piecewise_lr(1.0, 0.0, ends, [1.0, 0.5], phase_end_steps=[7, 9])
    assert float(lr(2 ** 25, 6)) == 1.0 and float(lr(2 ** 25, 7)) == 0.5
    assert float(lr(2 ** 25, -1)) == 0.5        # token tier: 1 ulp early


def test_plan_validation_matches_reference():
    for kw in (dict(cut_tokens=[3e4, 2e4]), dict(cut_tokens=[1.0]),
               dict(kind="seesaw-general", alpha=1.2, beta=4.0)):
        args = dict(kind="step", base_lr=1.0, total_tokens=1e5,
                    warmup_frac=0.1, b0=8)
        args.update(kw)
        for build in (SS.build_plan, JSS.build_plan):
            with pytest.raises(ValueError):
                build(**args)
    # the adaptive plan builds, as the reference's: one phase at B0 and
    # the per-cut factors (√α, α)
    kw = dict(kind="adaptive-seesaw", base_lr=1.0, total_tokens=1e5,
              warmup_frac=0.1, b0=8, cut_tokens=[3e4, 2e4])
    ours, theirs = SS.build_plan(**kw), JSS.build_plan(**kw)
    assert [dataclasses.astuple(p) for p in ours.phases] == \
        [dataclasses.astuple(p) for p in theirs.phases] == \
        [(0, 0.0, 1e5, 1.0, 8)]
    assert (ours.alpha, ours.beta, ours.kind) == \
        (theirs.alpha, theirs.beta, theirs.kind)


def test_speedup_accounting_matches_reference():
    kw = dict(base_lr=1.0, total_tokens=2 ** 26, warmup_frac=0.1, b0=32,
              alpha=2.0, n_cuts=6)
    see, ref_ = SS.build_plan(kind="seesaw", **kw), \
        SS.build_plan(kind="cosine", **kw)
    jsee, jref = JSS.build_plan(kind="seesaw", **kw), \
        JSS.build_plan(kind="cosine", **kw)
    assert SS.measured_speedup(see, ref_, 1024) == \
        JSS.measured_speedup(jsee, jref, 1024)
    assert SS.continuous_step_fraction(6) == JSS.continuous_step_fraction(6)
    # test_system.py's TestSpeedupAccounting, on the port
    pred = 1 - SS.continuous_step_fraction(6, 2.0)
    assert SS.measured_speedup(see, ref_, 1024) == \
        pytest.approx(pred * 0.9, abs=0.06)


# --------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------- #

def test_markov_samples_match_reference():
    ours, theirs = MarkovLM(300, seed=3), JMarkovLM(300, seed=3)
    for start, b in ((0, 4), (1234567, 3)):
        a, w = ours.sample(start, b, 40), theirs.sample(start, b, 40)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], w[k])
    assert ours.conditional_entropy() == theirs.conditional_entropy()


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("resume_steps", [0, 5])
def test_loader_chunks_match_reference(k, resume_steps):
    ours, theirs = _plans("seesaw", total_tokens=16 * 4 * 40, b0=4,
                          n_cuts=3)
    seq = 16
    src, jsrc = MarkovLM(128, seed=1), JMarkovLM(128, seed=1)
    lo = PhaseDataLoader(src, ours, seq, device="cpu")
    jlo = JLoader(jsrc, theirs, seq)
    tok = 0
    for _ in range(resume_steps):
        tok += ours.realized_phase_at(tok, seq).batch_size * seq
    if resume_steps:
        lo.resume(tok)
        jlo.resume(tok)
        assert lo.position_at(tok) == jlo.position_at(tok)
    got, want = list(lo.iter_chunks(k)), list(jlo.iter_chunks(k))
    assert len(got) == len(want) > 0
    for (p, c, m), (jp, jc, jm) in zip(got, want):
        assert (p.index, m) == (jp.index, jm)
        for name in ("tokens", "labels"):
            assert c[name].dtype == torch.int64
            assert c[name].shape[0] == k
            np.testing.assert_array_equal(c[name].numpy(),
                                          np.asarray(jc[name]))
    steps = [(p.index, s, b["tokens"].numpy()) for p, s, b in lo]
    jsteps = [(p.index, s, np.asarray(b["tokens"])) for p, s, b in jlo]
    assert [x[:2] for x in steps] == [x[:2] for x in jsteps]
    for a, b in zip(steps, jsteps):
        np.testing.assert_array_equal(a[2], b[2])


def test_loader_rejects_an_off_boundary_resume():
    plan, _ = _plans("seesaw", total_tokens=16 * 4 * 40, b0=4)
    lo = PhaseDataLoader(MarkovLM(64), plan, 16, device="cpu")
    with pytest.raises(ValueError, match="step boundary"):
        lo.resume(17)


# --------------------------------------------------------------------- #
# backward kernels' plain versions and the autograd path
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("shape", [(4, 7, 64), (33, 256)])
def test_rmsnorm_grads_match_jax_kernel(shape):
    rng = np.random.default_rng(0)
    x, s = _normal(rng, shape), _normal(rng, shape[-1:], 0.1)
    g = _normal(rng, shape)

    def jloss(x_, s_):
        return jnp.sum(j_rmsnorm(x_, s_, eps=1e-5, block_rows=8,
                                 interpret=True) * g)

    jdx, jds = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                                 jnp.asarray(s))
    # the plain backward, and autograd through the plain forward
    dx, ds = ref.rmsnorm_bwd_ref(_t(x), _t(s), _t(g), 1e-5)
    xt, st = _t(x).requires_grad_(), _t(s).requires_grad_()
    adx, ads = torch.autograd.grad(KB.rmsnorm(xt, st, eps=1e-5), (xt, st),
                                   _t(g))
    # and the reference's backward kernel called directly
    kdx, kds = _pallas_bwd(jnp.asarray(x), jnp.asarray(s), jnp.asarray(g),
                           eps=1e-5, block_rows=8, interpret=True)
    for got in ((dx, ds), (adx, ads)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(jdx), **KERNEL)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(jds), **KERNEL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(kdx), **KERNEL)
    np.testing.assert_allclose(ds.numpy(), np.asarray(kds), **KERNEL)


@pytest.mark.parametrize("B,H,Hkv,S,hd,blk", [
    (2, 4, 2, 32, 16, 16),      # GQA
    (1, 4, 1, 32, 32, 16),      # MQA
    (1, 2, 2, 21, 8, 8),        # MHA, ragged causal S
    (1, 6, 2, 37, 16, 16),      # GQA, ragged causal S
])
def test_flash_grads_match_jax_kernels(B, H, Hkv, S, hd, blk):
    rng = np.random.default_rng(1)
    q, do = _normal(rng, (B, H, S, hd)), _normal(rng, (B, H, S, hd))
    k, v = _normal(rng, (B, Hkv, S, hd)), _normal(rng, (B, Hkv, S, hd))
    # the reference's kernels need S a block multiple: zero-pad (padded
    # keys sit above every real query's causal reach) and slice
    Sp = -(-S // blk) * blk
    pad = ((0, 0), (0, 0), (0, Sp - S), (0, 0))
    jq, jk, jv, jdo = (jnp.asarray(np.pad(a, pad)) for a in (q, k, v, do))
    jo, jlse = _flash_fwd(jq, jk, jv, causal=True, block_q=blk,
                          block_k=blk, interpret=True)
    jdq, jdk, jdv = _flash_bwd(jq, jk, jv, jo, jlse, jdo, causal=True,
                               block_q=blk, block_k=blk, interpret=True)
    want = [np.asarray(a)[:, :, :S] for a in (jdq, jdk, jdv)]

    out, lse = ref.attention_ref(_t(q), _t(k), _t(v))
    got = ref.flash_bwd_ref(_t(q), _t(k), _t(v), out, lse, _t(do))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, **KERNEL)

    # autograd through the backend's plain path, in the models' layout,
    # against the reference's differentiable padded Pallas route
    qm, km, vm = (_t(np.swapaxes(a, 1, 2)).requires_grad_()
                  for a in (q, k, v))
    dom = _t(np.swapaxes(do, 1, 2))
    agrads = torch.autograd.grad(KB.attention(qm, km, vm), (qm, km, vm),
                                 dom)

    def jloss(q_, k_, v_):
        o = JKB.attention(q_, k_, v_, causal=True,
                          backend="pallas_interpret", block_q=blk,
                          block_k=blk)
        return jnp.sum(o * jnp.asarray(np.swapaxes(do, 1, 2)))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(np.swapaxes(a, 1, 2)) for a in (q, k, v)))
    for a, b in zip(agrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **KERNEL)


def test_backward_wrappers_refuse_cpu_tensors():
    """The backward wrappers raise on a tensor that is not on a CUDA
    device, and count nothing."""
    before = (RN.bwd_launches, FA.dq_launches, FA.dkv_launches)
    x = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        RN.rmsnorm_bwd(x, torch.zeros(64), x)
    q, lse = torch.zeros(1, 2, 8, 64), torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_bwd(q, q, q, q, lse, q)
    for fn in (FA.flash_bwd_dq, FA.flash_bwd_dkv):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, q, q, q, lse, lse)
    assert (RN.bwd_launches, FA.dq_launches, FA.dkv_launches) == before


class _FakeCard:
    """The card's autograd path on the CPU: ``_on_card`` says yes and
    each kernel wrapper becomes its plain version, counting its launches
    as the wrapper does.  Holds the ``torch.autograd.Function`` wiring
    (saved tensors, transposes, which kernel runs when) to the plain
    path; the kernels themselves are held to their plain versions on the
    card (``tests/test_torch_card.py``)."""

    def __init__(self, monkeypatch):
        self.n = dict(rmsnorm_fwd=0, rmsnorm_bwd=0, flash_fwd=0,
                      flash_bwd_dq=0, flash_bwd_dkv=0)

        def count(name, fn):
            def wrapped(*a):
                self.n[name] += 1
                return fn(*a)
            return wrapped

        def flash_bwd(*a):
            self.n["flash_bwd_dq"] += 1
            self.n["flash_bwd_dkv"] += 1
            return ref.flash_bwd_ref(*a)

        monkeypatch.setattr(KB, "_on_card", lambda t, op: True)
        monkeypatch.setattr(RN, "rmsnorm_fwd",
                            count("rmsnorm_fwd", ref.rmsnorm_ref))
        monkeypatch.setattr(RN, "rmsnorm_bwd",
                            count("rmsnorm_bwd", ref.rmsnorm_bwd_ref))
        monkeypatch.setattr(FA, "flash_fwd",
                            count("flash_fwd", ref.attention_ref))
        monkeypatch.setattr(FA, "flash_bwd", flash_bwd)


def _tiny_batch(rng, cfg, B=2, S=12):
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


@pytest.fixture(scope="module")
def tiny():
    jcfg = JModelConfig(**TINY)
    params = JR.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, params, ModelConfig(**TINY)


def _model(tiny):
    _, params, cfg = tiny
    return from_jax_params(_np_tree(params), cfg, dtype=torch.float32,
                           device="cpu", trainable=True)


@pytest.mark.parametrize("remat", [True, False])
def test_autograd_functions_match_plain_path(tiny, monkeypatch, remat):
    """The loss's grads through the autograd Functions (kernels faked by
    their plain versions) equal autograd through the plain path; under
    remat each layer's forward kernels run twice per micro-batch."""
    cfg = tiny[2]
    batch = _torch_batch(_tiny_batch(np.random.default_rng(2), cfg))
    model = _model(tiny)
    params = list(model.parameters())
    loss, _ = R.loss_fn(model, cfg, batch, z_loss=1e-3,
                        dtype=torch.float32, remat=remat)
    want = torch.autograd.grad(loss, params)
    fake = _FakeCard(monkeypatch)
    loss2, _ = R.loss_fn(model, cfg, batch, z_loss=1e-3,
                         dtype=torch.float32, remat=remat)
    got = torch.autograd.grad(loss2, params)
    assert loss2.item() == pytest.approx(loss.item(), abs=1e-6)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    L, r = cfg.n_layers, 2 if remat else 1
    assert fake.n == dict(rmsnorm_fwd=2 * L * r + 1, rmsnorm_bwd=2 * L + 1,
                          flash_fwd=L * r, flash_bwd_dq=L, flash_bwd_dkv=L)


# --------------------------------------------------------------------- #
# the loss, the optimizers and the grad step
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_jax(tiny, remat):
    """z-loss on and a padded vocab (200 -> 256 rows of the head)."""
    jcfg, params, cfg = tiny
    batch = _tiny_batch(np.random.default_rng(3), cfg, B=3, S=20)
    (jloss, jm), jgrads = jax.value_and_grad(JR.loss_fn, has_aux=True)(
        params, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
        z_loss=1e-3, dtype=jnp.float32, remat=remat)
    model = _model(tiny)
    assert model.lm_head.shape[1] == 256
    loss, m = R.loss_fn(model, cfg, _torch_batch(batch), z_loss=1e-3,
                        dtype=torch.float32, remat=remat)
    assert abs(loss.item() - float(jloss)) < 1e-5
    assert abs(m["z_sq"].item() - float(jm["z_sq"])) < 1e-4
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    jg = _np_tree(jgrads)
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), _jax_name(jg, n), atol=1e-4,
                                   rtol=1e-4, err_msg=n)


def test_loss_sums_chunks_and_remainder(tiny):
    """S = 1100 takes two 512-token chunks and a 76-token remainder, as
    the reference's scan and tail do."""
    jcfg, params, cfg = tiny
    batch = _tiny_batch(np.random.default_rng(4), cfg, B=1, S=1100)
    jloss, _ = JR.loss_fn(params, jcfg,
                          {k: jnp.asarray(v) for k, v in batch.items()},
                          dtype=jnp.float32, remat=False)
    loss, _ = R.loss_fn(_model(tiny), cfg, _torch_batch(batch),
                        dtype=torch.float32, remat=False)
    assert abs(loss.item() - float(jloss)) < 1e-5


OPTIMIZERS = [
    (lambda m: m.adamw(weight_decay=0.1), "adamw"),
    (lambda m: m.adam(), "adam"),
    (lambda m: m.sgd(momentum=0.9, grad_clip=0.5), "sgd-momentum"),
    (lambda m: m.sgd(), "sgd"),
    (lambda m: m.nsgd(), "nsgd"),
]


@pytest.mark.parametrize("make,name", OPTIMIZERS, ids=[n for _, n in
                                                         OPTIMIZERS])
def test_optimizers_match_reference(make, name):
    rng = np.random.default_rng(5)
    shapes = {"a": (7, 5), "b": (11,), "c": (3, 2, 4)}
    p0 = {n: _normal(rng, s) for n, s in shapes.items()}
    gs = [{n: _normal(rng, s, 0.4) for n, s in shapes.items()}
          for _ in range(2)]
    opt, jopt = make(O), make(JO)
    params = {n: _t(a) for n, a in p0.items()}
    state = opt.init(params)
    jparams = {n: jnp.asarray(a) for n, a in p0.items()}
    jstate = jopt.init(jparams)
    for lr, g in zip((1e-2, 3e-3), gs):
        params, state = opt.update({n: _t(a) for n, a in g.items()}, state,
                                   params, torch.tensor(lr,
                                                        dtype=torch.float32))
        jparams, jstate = jopt.update({n: jnp.asarray(a)
                                       for n, a in g.items()}, jstate,
                                      jparams, jnp.float32(lr))
    for n in shapes:
        np.testing.assert_allclose(params[n].numpy(), np.asarray(jparams[n]),
                                   atol=1e-6, rtol=0)
        for slot in ("m", "v", "mu"):
            if slot in jstate:
                np.testing.assert_allclose(state[slot][n].numpy(),
                                           np.asarray(jstate[slot][n]),
                                           atol=1e-6, rtol=0)
    assert state["count"].dtype == torch.int32
    assert int(state["count"]) == int(jstate["count"]) == 2


def test_grad_step_with_micro_batches_matches_reference(tiny):
    jcfg, params, cfg = tiny
    batch = _tiny_batch(np.random.default_rng(6), cfg, B=4, S=16)
    # SGD with momentum: the update is linear in the averaged grads (an
    # Adam step nearly takes their sign, which flips where a grad is ~0)
    jopt, opt = JO.sgd(momentum=0.9), O.sgd(momentum=0.9)
    jstep = JE.make_grad_step(jcfg, jopt, micro_batches=2, z_loss=1e-3,
                              dtype=jnp.float32, remat=False)
    jp, _, jm = jstep(params, jopt.init(params),
                      {k: jnp.asarray(v) for k, v in batch.items()},
                      jnp.float32(0.1))
    model = _model(tiny)
    step = E.make_grad_step(cfg, opt, micro_batches=2, z_loss=1e-3,
                            dtype=torch.float32, remat=False)
    state = opt.init(dict(model.named_parameters()))
    model, state, m = step(model, state, _torch_batch(batch),
                           torch.tensor(0.1))
    for k in ("loss", "ce_loss", "z_sq", "grad_norm"):
        assert abs(float(m[k]) - float(jm[k])) < 1e-4 * max(
            1.0, abs(float(jm[k]))), k
    jp = _np_tree(jp)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), _jax_name(jp, n),
                                   atol=1e-6, rtol=0, err_msg=n)


def test_micro_batches_count():
    cfg = RunConfig(model=ModelConfig(**TINY), schedule=ScheduleConfig(),
                    optimizer=OptimizerConfig())
    plan = SS.build_plan(kind="constant", base_lr=1.0, total_tokens=1e4,
                         warmup_frac=0.0, b0=8)
    eng = E.PhaseEngine(cfg, O.adamw(), plan, max_device_batch=8)
    assert [eng.micro_batches(b) for b in (8, 16, 32, 12, 5)] == \
        [1, 2, 4, 2, 1]
    assert E.PhaseEngine(cfg, O.adamw(), plan).micro_batches(64) == 1


# --------------------------------------------------------------------- #
# whole runs
# --------------------------------------------------------------------- #

def _ramp_cfg(ours: bool):
    C, Sch, Opt, Run = ((ModelConfig, ScheduleConfig, OptimizerConfig,
                         RunConfig) if ours else
                        (JModelConfig, JScheduleConfig, JOptimizerConfig,
                         JRunConfig))
    b0, steps, seq = 4, 12, 32
    return Run(model=C(**dict(TINY, vocab_size=128)),
               schedule=Sch(kind="seesaw", base_lr=1e-3, alpha=2.0,
                            n_cuts=2),
               optimizer=Opt(), seq_len=seq, global_batch_size=b0,
               total_tokens=seq * b0 * steps, dtype="float32", remat=False)


def _port_trainer(jtr, fuse_steps):
    tr = Trainer(_ramp_cfg(True), device="cpu", fuse_steps=fuse_steps)
    model = from_jax_params(_np_tree(jtr.state.params), tr.cfg.model,
                            dtype=torch.float32, device="cpu")
    tr.state.model.load_state_dict(model.state_dict())
    return tr


@pytest.fixture(scope="module")
def ramp_runs():
    jtr = JTrainer(_ramp_cfg(False), fuse_steps=4)
    ports = {k: _port_trainer(jtr, k) for k in (1, 4)}
    jtr.run(JLoader(JMarkovLM(128, seed=0), jtr.plan, 32))
    for tr in ports.values():
        tr.run(PhaseDataLoader(MarkovLM(128, seed=0), tr.plan, 32,
                               device="cpu"))
    return jtr, ports


def test_ramp_run_matches_jax_trainer(ramp_runs):
    jtr, ports = ramp_runs
    tr = ports[4]
    assert len(set(tr.plan.batch_sizes())) >= 2
    assert len(tr.history) == len(jtr.history) == tr.plan.total_steps(32)
    for a, b in zip(tr.history, jtr.history):
        assert (a["step"], a["tokens"], a["batch_size"], a["phase"]) == \
            (b["step"], b["tokens"], b["batch_size"], b["phase"])
        assert np.float32(a["lr"]) == np.float32(b["lr"])
        assert abs(a["loss"] - b["loss"]) < 5e-4
    assert tr.state.tokens_seen == jtr.state.tokens_seen
    assert isinstance(tr.state.tokens_seen, int)


def test_fuse_steps_do_not_change_the_run(ramp_runs):
    _, ports = ramp_runs
    h1, h4 = ports[1].history, ports[4].history
    keys = ("step", "tokens", "lr", "batch_size", "phase", "loss",
            "grad_norm", "z_sq")
    assert [[r[k] for k in keys] for r in h1] == \
        [[r[k] for k in keys] for r in h4]
    for a, b in zip(ports[1].state.model.parameters(),
                    ports[4].state.model.parameters()):
        assert torch.equal(a, b)


def test_max_steps_and_log_every():
    cfg = dataclasses.replace(_ramp_cfg(True), log_every=3)
    tr = Trainer(cfg, device="cpu", fuse_steps=4)
    seen = []
    hist = tr.run(PhaseDataLoader(MarkovLM(128), tr.plan, 32, device="cpu"),
                  max_steps=7, log_cb=seen.append)
    assert [h["step"] for h in hist] == list(range(1, 8))
    assert [r["step"] for r in seen] == [3, 6]
    assert tr.state.step == 7


def test_trainer_raises_for_later_slices(tmp_path):
    """Checkpoints, the preemption hook and the adaptive plan work: a run
    with periodic saves and ``stop_fn`` stops on its chunk boundary with
    the save committed, ``save_checkpoint`` writes the reference's
    format, and an adaptive trainer starts from a one-phase plan."""
    tr = Trainer(_ramp_cfg(True), device="cpu", fuse_steps=2)
    lo = PhaseDataLoader(MarkovLM(128), tr.plan, 32, device="cpu")
    path = str(tmp_path / "ck")
    hist = tr.run(lo, checkpoint_path=path, save_every=2,
                  stop_fn=lambda: tr.state.step >= 4)
    tr.close()
    assert [h["step"] for h in hist] == [1, 2, 3, 4]
    from repro_torch.train import checkpoint as CKPT
    assert CKPT.read_meta(path)["step"] == 4
    tr.save_checkpoint(str(tmp_path / "sync"))
    meta = CKPT.read_meta(str(tmp_path / "sync"))
    assert (meta["step"], meta["tokens_seen"], meta["schedule_kind"]) == \
        (4, 4 * 4 * 32, "seesaw")
    cfg = dataclasses.replace(
        _ramp_cfg(True), schedule=ScheduleConfig(kind="adaptive-seesaw"))
    ad = Trainer(cfg, device="cpu")
    assert len(ad.plan.phases) == 1 and ad.controller is not None


def test_trainer_and_launcher_need_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(_ramp_cfg(True))                   # device defaults to cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--reduced", "--steps", "2"])


def test_launcher_trains_on_the_cpu(capsys):
    hist = launch_train.main(["--device", "cpu", "--reduced", "--seq-len",
                              "16", "--batch-size", "2", "--total-tokens",
                              "2048", "--steps", "10", "--fuse-steps", "2",
                              "--max-device-batch", "4"])
    out = capsys.readouterr().out
    assert out.startswith("arch=seesaw-150m-smoke ")
    assert "steps=" in out and "batches=[2, 4," in out
    assert "step    10 phase" in out and "done:" in out
    assert all(np.isfinite(h["loss"]) for h in hist)


# test_system.py's TestSeesawVsCosine, on the port's trainer

SYS_MODEL = dict(name="sys-tiny", arch_type="dense", n_layers=2,
                 d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
                 d_ff=256, vocab_size=256, max_seq_len=64, rope_theta=1e4)


def _sys_run(kind, steps=120, seed=0, alpha=2.0, n_cuts=4):
    cfg = RunConfig(model=ModelConfig(**SYS_MODEL),
                    schedule=ScheduleConfig(kind=kind, base_lr=3e-3,
                                            alpha=alpha, n_cuts=n_cuts,
                                            beta=alpha),
                    optimizer=OptimizerConfig(kind="adamw"),
                    seq_len=64, global_batch_size=8,
                    total_tokens=64 * 8 * steps, remat=False, seed=seed)
    tr = Trainer(cfg, device="cpu")
    hist = tr.run(PhaseDataLoader(MarkovLM(256, branching=8, seed=seed),
                                  tr.plan, 64, device="cpu"))
    return tr, hist


@pytest.fixture(scope="module")
def sys_runs():
    torch.manual_seed(0)
    tr_c, h_c = _sys_run("cosine")
    tr_s, h_s = _sys_run("seesaw")
    return tr_c, h_c, tr_s, h_s


class TestSeesawVsCosine:
    def test_equal_token_budget(self, sys_runs):
        _, h_c, _, h_s = sys_runs
        slack = 64 * 128  # half of one late-phase step
        assert abs(h_c[-1]["tokens"] - h_s[-1]["tokens"]) <= 2 * slack

    def test_fewer_serial_steps(self, sys_runs):
        _, h_c, _, h_s = sys_runs
        assert len(h_s) < len(h_c)

    def test_final_loss_matches(self, sys_runs):
        _, h_c, _, h_s = sys_runs
        lc = np.mean([h["loss"] for h in h_c[-5:]])
        ls = np.mean([h["loss"] for h in h_s[-5:]])
        assert abs(lc - ls) < 0.12, (lc, ls)

    def test_loss_approaches_entropy_floor(self, sys_runs):
        _, h_c, _, _ = sys_runs
        floor = MarkovLM(256, branching=8, seed=0).conditional_entropy()
        final = np.mean([h["loss"] for h in h_c[-5:]])
        assert final < floor + 1.5

    def test_batch_ramp_happened(self, sys_runs):
        _, _, tr_s, h_s = sys_runs
        assert max(h["batch_size"] for h in h_s) >= 8 * 2 ** 3
