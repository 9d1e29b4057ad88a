"""The port's MoE family against the JAX package, on the CPU.

The same numpy weights and inputs go through the reference's
``repro.models.moe`` / ``transformer`` and the port's: the MoE layer at
capacities that drop most choices (0.25), the configs' own (1.25) and
none (16), at two group sizes; the reduced granite-moe-1b model's loss
and grads; a Seesaw ramp against the JAX ``Trainer``; the serving
engine and the ``Server``; the reduced phi3.5-moe forward.  Float32
throughout.

Tolerances: the layer's output 1e-5 and its aux losses 1e-6, the
dropped share and the kept set exact; the model's loss 1e-5 and grads
1e-4 (``docs/kernels.md``, "model loss/grads"); training histories 5e-4
per step; greedy tokens equal.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import OptimizerConfig as JOptimizerConfig
from repro.configs import RunConfig as JRunConfig
from repro.configs import ScheduleConfig as JScheduleConfig
from repro.configs import get_config as jget_config
from repro.data import MarkovLM as JMarkovLM
from repro.data import PhaseDataLoader as JLoader
from repro.models import moe as JM
from repro.models import registry as JR
from repro.serving import GenerationRequest as JRequest
from repro.serving import ServingEngine as JEngine
from repro.train.serve import Server as JServer
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs import (OptimizerConfig, RunConfig, ScheduleConfig,
                                 get_config)
from repro_torch.data import MarkovLM, PhaseDataLoader
from repro_torch.kernels import backend as KB
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as RN
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import moe as M
from repro_torch.models import registry as R
from repro_torch.serving import GenerationRequest, ServingEngine
from repro_torch.train.serve import Server
from repro_torch.train.trainer import Trainer
from repro_torch.weights import _ref_leaf, from_jax_params

ARCH = "granite-moe-1b-a400m"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these small models run many small ops, which
    the thread pools of several test workers on a shared CPU slow down
    many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def granite():
    """The reduced granite-moe-1b (2 layers, d 256, 4 experts, top-2)
    in both packages, the reference's weights and the port's model
    loaded from them (float32, CPU)."""
    jcfg = jget_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    params = JR.init_params(jax.random.PRNGKey(0), jcfg)
    model = from_jax_params(_np(params), cfg, dtype=torch.float32,
                            device="cpu")
    return jcfg, params, cfg, model


# --------------------------------------------------------------------- #
# the MoE layer
# --------------------------------------------------------------------- #

def _j_kept(p, x, jcfg, group_size):
    """The reference's kept set, (G, g, k) bool, by its own routing
    lines (``repro/models/moe.py``: top-k, queue places, capacity)."""
    m = jcfg.moe
    B, S, d = x.shape
    g = min(group_size, B * S)
    cap = min(max(int(np.ceil(g * m.top_k * m.capacity_factor
                              / m.num_experts)), m.top_k), g)
    xt = jnp.asarray(x).reshape(-1, g, d)
    probs = jax.nn.softmax(xt @ p["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, m.top_k)
    onehot = jax.nn.one_hot(idx, m.num_experts)
    flat = onehot.reshape(xt.shape[0], g * m.top_k, m.num_experts)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(onehot.shape)
    return np.asarray(jnp.any((pos < cap) & (onehot > 0), axis=-1))


@pytest.mark.parametrize("group_size", [2048, 16])
@pytest.mark.parametrize("capacity", [0.25, 1.25, 16.0])
def test_moe_forward_matches_jax(granite, capacity, group_size):
    """y within 1e-5, the aux losses within 1e-6, the dropped share and
    the kept set exact; the plain one-hot version equals the main one
    to 1e-6."""
    jcfg, params, cfg, model = granite
    jc = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=capacity))
    c = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity))
    p = jax.tree.map(lambda a: a[1], params["layers"]["moe"])
    x = np.random.default_rng(0).standard_normal(
        (2, 48, cfg.d_model)).astype(np.float32)
    jy, jaux = JM.moe_forward(p, jnp.asarray(x), jc, group_size=group_size)
    moe = model.layers[1].moe
    y, aux = M.moe_forward(moe, torch.from_numpy(x), c,
                           group_size=group_size)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    for k in ("lb_loss", "rz_loss"):
        assert abs(aux[k].item() - float(jaux[k])) < 1e-6, k
    assert aux["frac_dropped"].item() == pytest.approx(
        float(jaux["frac_dropped"]), abs=1e-7)
    probs = torch.softmax(torch.from_numpy(x).reshape(
        -1, min(group_size, 96), cfg.d_model) @ moe.router, dim=-1)
    G, g, cap = M.groups(c, 96, group_size)
    _, _, _, keep = M._route(probs, c.moe.top_k, cap)
    np.testing.assert_array_equal(keep.numpy(),
                                  _j_kept(p, x, jc, group_size))
    if capacity == 0.25:
        assert aux["frac_dropped"].item() > 0.3
    yr, auxr = M.moe_forward_ref(moe, torch.from_numpy(x), c,
                                 group_size=group_size)
    torch.testing.assert_close(y, yr, atol=1e-6, rtol=1e-6)
    for k in aux:
        torch.testing.assert_close(aux[k], auxr[k], atol=1e-7, rtol=1e-6)


def test_moe_grads_match_jax_where_tokens_drop(granite):
    """The gather Functions' backward (dispatch, combine and the gates)
    against JAX's grads of the one-hot einsums, at a capacity that drops
    choices: router, experts and x within 1e-6 of their scale."""
    jcfg, params, cfg, model = granite
    jc = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=0.5))
    c = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    p = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
    x = np.random.default_rng(1).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32)
    dy = np.random.default_rng(2).standard_normal(x.shape).astype(
        np.float32)

    def jloss(p, x):
        y, aux = JM.moe_forward(p, x, jc, group_size=16)
        return jnp.sum(y * dy) + JM.moe_aux_total(aux, jc)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    moe = M.MoE(c, dtype=torch.float32, device="cpu")
    for n, w in moe.named_parameters():
        w.data.copy_(torch.from_numpy(np.array(p[n])))
    moe.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = M.moe_forward(moe, xt, c, group_size=16)
    assert aux["frac_dropped"].item() > 0
    loss = (y * torch.from_numpy(dy)).sum() + M.moe_aux_total(aux, c)
    names = [n for n, _ in moe.named_parameters()]
    grads = torch.autograd.grad(loss, list(moe.parameters()) + [xt])
    for n, g in zip(names + ["x"], grads):
        want = np.asarray(jgx if n == "x" else jg[n])
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=n)


def test_uneven_groups_raise_before_any_work(granite):
    """3 prompts at bucket 1024 are 3,072 tokens: more than a group of
    2,048 and not a whole number of them.  The reference asserts inside
    its forward; the port raises ``ValueError`` from the MoE, from the
    ragged prefill and from the ``Server``, before any layer runs."""
    jcfg, params, cfg, model = granite
    toks = np.zeros((3, 1024), np.int32)
    with pytest.raises(AssertionError):
        JR.prefill_ragged(params, jcfg, jnp.asarray(toks),
                          jnp.full((3,), 1000, jnp.int32),
                          dtype=jnp.float32)
    with pytest.raises(ValueError, match="3072 tokens"):
        M.check_tokens(cfg, 3072)
    calls = []
    orig = M.moe_forward
    try:
        M.moe_forward = lambda *a, **k: calls.append(1) or orig(*a, **k)
        with pytest.raises(ValueError, match="groups of 2048"):
            R.prefill_ragged(model, cfg, torch.zeros(3, 1024).long(),
                             torch.full((3,), 1000, dtype=torch.int32))
        srv = Server(cfg, model, max_len=1100, dtype=torch.float32)
        with pytest.raises(ValueError, match="groups of 2048"):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                srv.generate(np.zeros((3, 1000), np.int32), 2)
    finally:
        M.moe_forward = orig
    assert calls == []
    M.check_tokens(cfg, 4096)          # whole groups pass
    M.check_tokens(cfg, 2000)          # one group of 2000


# --------------------------------------------------------------------- #
# the model: loss, grads, the card's autograd path
# --------------------------------------------------------------------- #

def _batch(rng, cfg, B=2, S=40):
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


@pytest.fixture(scope="module")
def jax_loss_and_grads(granite):
    """The reference's loss, metrics and grads on one batch (its remat
    changes memory, not the numbers)."""
    jcfg, params, cfg, _ = granite
    batch = _batch(np.random.default_rng(3), cfg)
    (jloss, jm), jg = jax.value_and_grad(JR.loss_fn, has_aux=True)(
        params, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
        z_loss=1e-3, dtype=jnp.float32, remat=False)
    return batch, jloss, jm, jg


@pytest.mark.parametrize("remat", [True, False])
def test_granite_loss_and_grads_match_jax(granite, jax_loss_and_grads,
                                          remat):
    """Loss within 1e-5, each metric (ce_loss, z_sq, lb_loss, rz_loss,
    frac_dropped) with it, grads within 1e-4, with and without the
    port's remat."""
    _, params, cfg, _ = granite
    batch, jloss, jm, jg = jax_loss_and_grads
    model = from_jax_params(_np(params), cfg, dtype=torch.float32,
                            device="cpu", trainable=True)
    loss, m = R.loss_fn(model, cfg, {k: torch.from_numpy(v).long()
                                     for k, v in batch.items()},
                        z_loss=1e-3, dtype=torch.float32, remat=remat)
    assert abs(loss.item() - float(jloss)) < 1e-5
    assert set(m) == set(jm)
    for k in ("ce_loss", "lb_loss", "rz_loss", "frac_dropped"):
        assert abs(m[k].item() - float(jm[k])) < 1e-5, k
    assert abs(m["z_sq"].item() - float(jm["z_sq"])) < 1e-4
    grads = torch.autograd.grad(loss, list(model.parameters()))
    jg = _np(jg)
    for (n, _), g in zip(model.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), _ref_leaf(jg, n), atol=1e-4,
                                   rtol=1e-4, err_msg=n)


@pytest.mark.parametrize("remat", [True, False])
def test_card_autograd_path_matches_plain_path(granite, monkeypatch, remat):
    """The card's autograd Functions, their kernels faked by the plain
    versions, give the plain path's loss and grads; the launches per
    micro-batch are the dense family's (the MoE runs no kernel of its
    own): RMSNorm forward (4L+1 under remat, 2L+1 without), backward
    2L+1, flash forward 2L (L), dq and dk/dv L."""
    _, params, cfg, _ = granite
    model = from_jax_params(_np(params), cfg, dtype=torch.float32,
                            device="cpu", trainable=True)
    batch = {k: torch.from_numpy(v).long()
             for k, v in _batch(np.random.default_rng(4), cfg).items()}
    loss, _ = R.loss_fn(model, cfg, batch, dtype=torch.float32, remat=remat)
    want = torch.autograd.grad(loss, list(model.parameters()))
    n = dict(rmsnorm_fwd=0, rmsnorm_bwd=0, flash_fwd=0, flash_bwd=0)

    def count(name, fn):
        def wrapped(*a):
            n[name] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(KB, "_on_card", lambda t, op: True)
    monkeypatch.setattr(RN, "rmsnorm_fwd",
                        count("rmsnorm_fwd", ref.rmsnorm_ref))
    monkeypatch.setattr(RN, "rmsnorm_bwd",
                        count("rmsnorm_bwd", ref.rmsnorm_bwd_ref))
    monkeypatch.setattr(FA, "flash_fwd", count("flash_fwd",
                                               ref.attention_ref))
    monkeypatch.setattr(FA, "flash_bwd", count("flash_bwd",
                                               ref.flash_bwd_ref))
    loss2, _ = R.loss_fn(model, cfg, batch, dtype=torch.float32,
                         remat=remat)
    got = torch.autograd.grad(loss2, list(model.parameters()))
    assert loss2.item() == pytest.approx(loss.item(), abs=1e-6)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    L, r = cfg.n_layers, 2 if remat else 1
    assert n == dict(rmsnorm_fwd=2 * L * r + 1, rmsnorm_bwd=2 * L + 1,
                     flash_fwd=L * r, flash_bwd=L)


def test_phi35_reduced_forward_matches_jax():
    """The reduced phi3.5-moe (16 experts cut to 4, top-2, untied head):
    loss and metrics within 1e-5."""
    jcfg = jget_config("phi3.5-moe-42b-a6.6b").reduced()
    cfg = get_config("phi3.5-moe-42b-a6.6b").reduced()
    assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(jcfg.moe)
    assert not cfg.tie_embeddings
    params = JR.init_params(jax.random.PRNGKey(1), jcfg)
    model = from_jax_params(_np(params), cfg, dtype=torch.float32,
                            device="cpu")
    batch = _batch(np.random.default_rng(5), cfg, B=2, S=24)
    jloss, jm = JR.loss_fn(params, jcfg, {k: jnp.asarray(v)
                                          for k, v in batch.items()},
                           dtype=jnp.float32, remat=False)
    loss, m = R.loss_fn(model, cfg, {k: torch.from_numpy(v).long()
                                     for k, v in batch.items()},
                        dtype=torch.float32, remat=False)
    for k in jm:
        assert abs(m[k].item() - float(jm[k])) < 1e-5, k
    assert get_config("phi3.5-moe-42b-a6.6b").param_count() == \
        jget_config("phi3.5-moe-42b-a6.6b").param_count()


# --------------------------------------------------------------------- #
# a Seesaw ramp against the JAX Trainer
# --------------------------------------------------------------------- #

def _ramp_cfg(ours: bool):
    Sch, Opt, Run = ((ScheduleConfig, OptimizerConfig, RunConfig) if ours
                     else (JScheduleConfig, JOptimizerConfig, JRunConfig))
    model = (get_config if ours else jget_config)(ARCH).reduced()
    b0, steps, seq = 4, 12, 32
    return Run(model=model,
               schedule=Sch(kind="seesaw", base_lr=1e-3, alpha=2.0,
                            n_cuts=2),
               optimizer=Opt(), seq_len=seq, global_batch_size=b0,
               total_tokens=seq * b0 * steps, dtype="float32", remat=False)


@pytest.fixture(scope="module")
def ramp():
    jtr = JTrainer(_ramp_cfg(False), fuse_steps=4)
    tr = Trainer(_ramp_cfg(True), device="cpu", fuse_steps=4)
    model = from_jax_params(_np(jtr.state.params), tr.cfg.model,
                            dtype=torch.float32, device="cpu")
    tr.state.model.load_state_dict(model.state_dict())
    jtr.run(JLoader(JMarkovLM(512, seed=0), jtr.plan, 32))
    tr.run(PhaseDataLoader(MarkovLM(512, seed=0), tr.plan, 32,
                           device="cpu"))
    return jtr, tr


def test_ramp_matches_jax_trainer(ramp):
    """12 steps over B = 4 / 8 / 16: step, tokens, batch and phase
    equal, LR bitwise, loss within 5e-4; every step records the MoE's
    metrics."""
    jtr, tr = ramp
    assert len(set(tr.plan.batch_sizes())) == 3
    assert len(tr.history) == len(jtr.history) == tr.plan.total_steps(32)
    for a, b in zip(tr.history, jtr.history):
        assert (a["step"], a["tokens"], a["batch_size"], a["phase"]) == \
            (b["step"], b["tokens"], b["batch_size"], b["phase"])
        assert np.float32(a["lr"]) == np.float32(b["lr"])
        assert abs(a["loss"] - b["loss"]) < 5e-4
        for k in ("lb_loss", "rz_loss", "frac_dropped"):
            assert np.isfinite(a[k]) and k in b
            assert abs(a[k] - b[k]) < 5e-3, k
    assert tr.history[-1]["loss"] < tr.history[0]["loss"]


# --------------------------------------------------------------------- #
# serving: the engine and the Server
# --------------------------------------------------------------------- #

ENGINE = dict(decode_slots=3, page_size=8, max_len=64)
PROMPTS = (5, 13, 30, 9)
MAX_NEW = (6, 4, 8, 5)


def test_engine_matches_jax_engine(granite):
    """The paged engine, event for event and token for token, and the
    pools within 1e-5 outside the null page."""
    jcfg, params, cfg, model = granite
    j_eng = JEngine(jcfg, params, dtype=jnp.float32, **ENGINE)
    eng = ServingEngine(cfg, model, dtype=torch.float32, **ENGINE)
    rng = np.random.default_rng(6)
    for rid, (s, n) in enumerate(zip(PROMPTS, MAX_NEW)):
        p = rng.integers(0, cfg.vocab_size, (s,)).astype(np.int32)
        eng.submit(GenerationRequest(prompt=p, max_new_tokens=n, rid=rid))
        j_eng.submit(JRequest(prompt=p, max_new_tokens=n, rid=rid))
    steps = 0
    while not (eng.done and j_eng.done):
        assert eng.step() == j_eng.step(), f"step {steps}"
        steps += 1
        assert steps < 100
    for rid, n in enumerate(MAX_NEW):
        got, want = eng.result(rid), j_eng.result(rid)
        np.testing.assert_array_equal(got.tokens, want.tokens)
        assert len(got.tokens) == n
    np.testing.assert_allclose(eng.pool.kv.numpy()[:, 1:],
                               np.asarray(j_eng.pool.kv)[:, 1:],
                               atol=1e-5, rtol=1e-5)


def test_server_matches_jax_server(granite):
    """The blocking ``Server`` (bucketed prefill, full cache): the same
    greedy tokens as the reference's, and the same as each prompt alone
    through the engine."""
    jcfg, params, cfg, model = granite
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 11)).astype(np.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = JServer(jcfg, params, max_len=32, dtype=jnp.float32) \
            .generate(toks, 6)
        got = Server(cfg, model, max_len=32, dtype=torch.float32) \
            .generate(toks, 6)
    np.testing.assert_array_equal(got, np.asarray(want))


# --------------------------------------------------------------------- #
# the launchers
# --------------------------------------------------------------------- #

def test_launchers_take_granite(capsys):
    launch_train.main(["--arch", ARCH, "--device", "cpu", "--reduced",
                       "--seq-len", "16", "--batch-size", "2", "--steps",
                       "4", "--fuse-steps", "2"])
    out = capsys.readouterr().out
    assert "arch=granite-moe-1b-a400m-smoke" in out
    launch_serve.main(["--arch", ARCH, "--device", "cpu", "--requests",
                       "3", "--max-len", "32", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "mode=paged" in out
