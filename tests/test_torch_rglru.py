"""The port's RG-LRU hybrid (training side) against the JAX package, on
the CPU.

The same numpy inputs and weights go through the reference and through
its port: the RG-LRU scan (the plain chunked scan and the model's
``rglru_scan``) and its grads, the O(1) step, the scan kernels'
backward written out (``rglru_scan_bwd_ref``), the card's autograd path
(kernels faked by their plain versions), the weights' name map, the
hybrid's loss and grads at the reduced recurrentgemma cut to 5 layers
(one (recurrent, recurrent, attention) group and a remainder of two, so
both of the reference's layouts are read), a 10-step Seesaw ramp
against the reference's ``Trainer`` and the launcher; and a windowed
dense arch (the reduced starcoder2) trained through
``chunked_attention``'s autograd.  Float32 throughout.

Tolerances: the scan's values within 1e-5 of max |h| and its grads
within 1e-4 of each tensor's max |grad|; the card's path against the
plain path 1e-6; loss 1e-5 and grads 1e-4 (``docs/kernels.md``'s model
row); training histories 5e-4 per step, as the reference's own ramp
parity test.
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
from repro.configs import get_config as j_get_config
from repro.data import MarkovLM as JMarkovLM
from repro.data import PhaseDataLoader as JLoader
from repro.models import registry as JR
from repro.models import rglru as JH
from repro.models import transformer as JT
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs import (OptimizerConfig, RunConfig, ScheduleConfig,
                                 get_config)
from repro_torch.data import MarkovLM, PhaseDataLoader
from repro_torch.kernels import backend as KB
from repro_torch.kernels import ref
from repro_torch.kernels import rglru as RG
from repro_torch.kernels import rmsnorm as RN
from repro_torch.launch import train as launch_train
from repro_torch.models import registry as R
from repro_torch.models import rglru as H
from repro_torch.train.trainer import Trainer
from repro_torch.weights import _ref_leaf, from_jax_params, to_jax_params


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these small models run many small ops, which
    the thread pools of several test workers on a shared CPU slow down
    many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "recurrentgemma-9b"


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _close_to_max(got, want, rel, what=""):
    """|got − want| within ``rel`` of max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    tol = rel * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: {err:.3g} > {tol:.3g}"


def _scan_inputs(seed, B, S, W, lam_scale=0.2):
    """The reference tests' inputs (tests/test_recurrent_cores.py), from
    numpy: y normal, r and i sigmoids of normals, lam normal·scale."""
    rng = np.random.default_rng(seed)
    f = np.float32
    sig = lambda a: 1 / (1 + np.exp(-a))                    # noqa: E731
    y = rng.standard_normal((B, S, W)).astype(f)
    r = sig(rng.standard_normal((B, S, W))).astype(f)
    i = sig(rng.standard_normal((B, S, W))).astype(f)
    lam = (lam_scale * rng.standard_normal(W)).astype(f)
    h0 = rng.standard_normal((B, W)).astype(f)
    return y, r, i, lam, h0


def _port_scan(y, r, i, lam, h0=None, chunk=512):
    """The gates of ``models.rglru`` around the plain chunked scan."""
    a = H._gates(r, lam)
    return ref.rglru_scan_ref(a, H._input(a, i, y), h0, chunk=chunk)


# --------------------------------------------------------------------- #
# the scan and the step
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("S,chunk,with_h0", [
    (16, 16, False), (64, 16, False), (77, 16, True), (33, 512, False),
    (600, 512, True),                     # a ragged S, the carry at 512
    (1030, 512, False)])                  # three chunks, the last of 6
def test_scan_matches_jax(S, chunk, with_h0):
    """``rglru_scan_ref`` (at the reference's chunk) and the model's
    ``rglru_scan`` (the backend's CPU path, chunk 512) against the
    reference's ``rglru_scan``: hs and h_last within 1e-5 of max |h|."""
    y, r, i, lam, h0 = _scan_inputs(S, 2, S, 8)
    h0 = h0 if with_h0 else None
    jhs, jhl = JH.rglru_scan(*(jnp.asarray(a) for a in (y, r, i, lam)),
                             h0=None if h0 is None else jnp.asarray(h0),
                             chunk=chunk)
    hs, hl = _port_scan(*(_t(a) for a in (y, r, i, lam)),
                        None if h0 is None else _t(h0), chunk=chunk)
    mhs, mhl = H.rglru_scan(*(_t(a) for a in (y, r, i, lam)),
                            None if h0 is None else _t(h0))
    assert hs.dtype == hl.dtype == mhl.dtype == torch.float32
    scale = float(np.abs(np.asarray(jhs)).max())
    for got in (hs, mhs):
        np.testing.assert_allclose(got.numpy(), np.asarray(jhs),
                                   atol=1e-5 * scale, rtol=0)
    for got in (hl, mhl):
        np.testing.assert_allclose(got.numpy(), np.asarray(jhl),
                                   atol=1e-5 * scale, rtol=0)


@pytest.mark.parametrize("S,chunk", [(16, 16), (64, 16), (77, 16),
                                     (33, 512)])
def test_scan_matches_sequential_steps(S, chunk):
    """tests/test_recurrent_cores.py's ``test_matches_sequential`` on the
    port: the chunked scan against a chain of ``rglru_step``s, and the
    port's steps against the reference's."""
    y, r, i, lam, _ = _scan_inputs(100 + S, 2, S, 8)
    hs, hl = _port_scan(*(_t(a) for a in (y, r, i, lam)), chunk=chunk)
    h, jh = torch.zeros(2, 8), jnp.zeros((2, 8))
    outs = []
    for t in range(S):
        _, h = H.rglru_step(h, _t(y[:, t]), _t(r[:, t]), _t(i[:, t]),
                            _t(lam))
        _, jh = JH.rglru_step(jh, y[:, t], r[:, t], i[:, t], lam)
        outs.append(h)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-6,
                                   rtol=1e-6)
    want = torch.stack(outs, 1)
    torch.testing.assert_close(hs, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(hl, want[:, -1], atol=1e-5, rtol=1e-5)


def test_scan_carries_its_initial_state():
    """``test_initial_state_carried``: two halves, the second from the
    first's h_last, equal one scan from h0; and the forgetting bound."""
    y, r, i, lam, h0 = (_t(a) for a in _scan_inputs(7, 1, 20, 4))
    hs_a, hl_a = _port_scan(y[:, :10], r[:, :10], i[:, :10], lam, h0, 4)
    hs_b, _ = _port_scan(y[:, 10:], r[:, 10:], i[:, 10:], lam, hl_a, 4)
    hs, _ = _port_scan(y, r, i, lam, h0, 8)
    torch.testing.assert_close(torch.cat([hs_a, hs_b], 1), hs, atol=1e-5,
                               rtol=1e-5)
    y, r, i, _, _ = (_t(a) for a in _scan_inputs(8, 1, 200, 4))
    big, _ = H.rglru_scan(10 * y, r, i, torch.ones(4))
    assert torch.isfinite(big).all() and float(big.abs().max()) < 100.0


def _jax_scan_grads(args, cts, chunk):
    y, r, i, lam, h0 = (jnp.asarray(a) for a in args)

    def f(y, r, i, lam, h0):
        hs, hl = JH.rglru_scan(y, r, i, lam, h0=h0, chunk=chunk)
        return jnp.sum(hs * cts[0]) + jnp.sum(hl * cts[1])
    return jax.grad(f, argnums=(0, 1, 2, 3, 4))(y, r, i, lam, h0)


@pytest.mark.parametrize("S,chunk", [(77, 16), (600, 512)])
def test_scan_grads_match_jax(S, chunk):
    """Grads of y, r, i, lam and h0 through the port's scan (autograd of
    the plain chunked scan) against the reference's, each within 1e-4 of
    its max."""
    args = _scan_inputs(S + 1, 2, S, 8)
    rng = np.random.default_rng(S)
    cts = (rng.standard_normal((2, S, 8)).astype(np.float32),
           rng.standard_normal((2, 8)).astype(np.float32))
    want = _jax_scan_grads(args, cts, chunk)
    leaves = [_t(a).requires_grad_() for a in args]
    hs, hl = _port_scan(*leaves, chunk=chunk)
    got = torch.autograd.grad((hs * _t(cts[0])).sum()
                              + (hl * _t(cts[1])).sum(), leaves)
    for name, g, w in zip(("y", "r", "i", "lam", "h0"), got, want):
        _close_to_max(g.numpy(), w, 1e-4, name)


@pytest.mark.parametrize("S", [1, 50, 515])
def test_bwd_ref_equals_autograd_of_the_scan(S):
    """``rglru_scan_bwd_ref``, the backward kernel's arithmetic written
    out (the reverse sweep as a chunked scan), against autograd through
    ``rglru_scan_ref``, with and without h0, dhs and dh_last."""
    rng = np.random.default_rng(S)
    a = _t(rng.uniform(0.05, 0.999, (2, S, 6)).astype(np.float32))
    b = _t(rng.standard_normal((2, S, 6)).astype(np.float32))
    h0 = _t(rng.standard_normal((2, 6)).astype(np.float32))
    dhs = _t(rng.standard_normal((2, S, 6)).astype(np.float32))
    dhl = _t(rng.standard_normal((2, 6)).astype(np.float32))
    for use_h0, use_dhs, use_dhl in ((True, True, True), (False, True, False),
                                     (True, False, True)):
        la, lb = a.clone().requires_grad_(), b.clone().requires_grad_()
        lh = h0.clone().requires_grad_() if use_h0 else None
        hs, hl = ref.rglru_scan_ref(la, lb, lh)
        out = (hs * dhs).sum() * use_dhs + (hl * dhl).sum() * use_dhl
        want = torch.autograd.grad(out, [t for t in (la, lb, lh)
                                         if t is not None])
        da, db, dh0 = ref.rglru_scan_bwd_ref(
            a, hs.detach(), h0 if use_h0 else None,
            dhs if use_dhs else None, dhl if use_dhl else None)
        got = (da, db, dh0) if use_h0 else (da, db)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------- #
# the card's autograd path, kernels faked by their plain versions
# --------------------------------------------------------------------- #

class _FakeCard:
    """The card's path on the CPU: ``_on_card`` says yes and each kernel
    wrapper becomes its plain version, counting its launches as the
    wrapper does (the pattern of ``tests/test_torch_mamba2.py``).  Holds
    ``_RGLRUScan`` (the scan kernel's forward, the reverse-sweep
    backward) and the RMSNorm Functions to the plain path; the kernels
    themselves are held to their plain versions on the card
    (``tests/test_torch_card.py``, ``chip_smoke.py`` phase 15a)."""

    def __init__(self, monkeypatch):
        self.n = dict(rglru_scan_fwd=0, rglru_scan_bwd=0, rmsnorm_fwd=0,
                      rmsnorm_bwd=0)

        def count(name, fn):
            def wrapped(*a, **k):
                self.n[name] += 1
                return fn(*a, **k)
            return wrapped

        def bwd(a, hs, h0, dhs, dh_last, want_dh0=True):
            da, db, dh0 = ref.rglru_scan_bwd_ref(a, hs, h0, dhs, dh_last)
            return da, db, dh0 if want_dh0 else None

        monkeypatch.setattr(KB, "_on_card", lambda t, op: True)
        monkeypatch.setattr(RG, "rglru_scan_fwd",
                            count("rglru_scan_fwd", ref.rglru_scan_ref))
        monkeypatch.setattr(RG, "rglru_scan_bwd",
                            count("rglru_scan_bwd", bwd))
        monkeypatch.setattr(RN, "rmsnorm_fwd",
                            count("rmsnorm_fwd", ref.rmsnorm_ref))
        monkeypatch.setattr(RN, "rmsnorm_bwd",
                            count("rmsnorm_bwd", ref.rmsnorm_bwd_ref))


def test_scan_function_matches_plain_scan(monkeypatch):
    """``_RGLRUScan`` alone (the kernels faked): outputs of the plain
    scan, grads of a, b and h0 equal autograd through it; a cotangent of
    h_last alone and one of hs alone each take one backward launch."""
    rng = np.random.default_rng(9)
    a = _t(rng.uniform(0.05, 0.99, (2, 70, 6)).astype(np.float32))
    b = _t(rng.standard_normal((2, 70, 6)).astype(np.float32))
    h0 = _t(rng.standard_normal((2, 6)).astype(np.float32))
    dhs = _t(rng.standard_normal((2, 70, 6)).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (a, b, h0)]
    hs, hl = ref.rglru_scan_ref(*leaves)
    want = torch.autograd.grad((hs * dhs).sum() + hl.sum(), leaves)
    fake = _FakeCard(monkeypatch)
    leaves = [t.clone().requires_grad_() for t in (a, b, h0)]
    hs2, hl2 = RG.rglru_scan(*leaves)
    torch.testing.assert_close(hs2, hs.detach())
    got = torch.autograd.grad((hs2 * dhs).sum() + hl2.sum(), leaves)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-5)
    for out in (lambda: RG.rglru_scan(*leaves)[1].sum(),
                lambda: RG.rglru_scan(*leaves)[0].sum()):
        torch.autograd.grad(out(), leaves)
    assert (fake.n["rglru_scan_fwd"], fake.n["rglru_scan_bwd"]) == (3, 3)


# --------------------------------------------------------------------- #
# the model: weights, loss and grads
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def reduced():
    """The reduced recurrentgemma at 5 layers (d 256, 4 heads of 64 on one
    kv head, LRU width 256, window 64) and the reference's weights."""
    jcfg = dataclasses.replace(j_get_config(ARCH).reduced(), n_layers=5)
    params = JR.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, params, dataclasses.replace(get_config(ARCH).reduced(),
                                             n_layers=5)


def _model(reduced, trainable=True):
    _, params, cfg = reduced
    return from_jax_params(_np_tree(params), cfg, dtype=torch.float32,
                           device="cpu", trainable=trainable)


def _batch(cfg, B=2, S=80, seed=5):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (B, S + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def test_from_jax_params_loads_the_hybrid_tree(reduced):
    """Every parameter from its reference leaf: layers 0-2 from
    ``groups/slot{0,1,2}`` at group 0, layers 3-4 from ``rem0``/``rem1``;
    ``to_jax_params`` gives the tree back."""
    jcfg, params, cfg = reduced
    model = _model(reduced, trainable=False)
    assert isinstance(model, H.Hybrid) and model.lm_head is not None
    assert [layer.kind for layer in model.layers] == \
        ["recurrent", "recurrent", "attention", "recurrent", "recurrent"]
    assert H.groups(cfg) == (("recurrent", "recurrent", "attention"), 1,
                             ["recurrent", "recurrent"])
    tree = _np_tree(params)
    assert set(tree) == {"embed", "final_norm", "groups", "rem0", "rem1"}
    for n, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      _ref_leaf(tree, n, cfg), err_msg=n)
        assert not p.requires_grad
    np.testing.assert_array_equal(
        model.layers[4].temporal.w_r.numpy(),
        tree["rem1"]["temporal"]["w_r"])
    np.testing.assert_array_equal(
        model.layers[2].temporal.w_q.numpy(),
        tree["groups"]["slot2"]["temporal"]["w_q"][0])
    assert model.layers[0].temporal.lam.dtype == torch.float32
    back = to_jax_params(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_jax(reduced, remat):
    """The reduced 5-layer hybrid with z-loss at S = 80 (past the window
    of 64) and a padded vocab: loss within 1e-5, every grad within 1e-4
    of its tensor's max."""
    jcfg, params, cfg = reduced
    batch = _batch(cfg)
    (jloss, jm), jgrads = jax.value_and_grad(JH.loss_fn, has_aux=True)(
        params, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
        z_loss=1e-3, dtype=jnp.float32, remat=remat)
    model = _model(reduced)
    loss, m = R.loss_fn(model, cfg, _torch_batch(batch), z_loss=1e-3,
                        dtype=torch.float32, remat=remat)
    assert abs(loss.item() - float(jloss)) < 1e-5
    assert abs(m["z_sq"].item() - float(jm["z_sq"])) < 1e-4
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    jg = _np_tree(jgrads)
    for n, g in zip(names, grads):
        _close_to_max(g.numpy(), _ref_leaf(jg, n, cfg), 1e-4, n)


@pytest.mark.parametrize("remat", [True, False])
def test_card_path_matches_plain_path(reduced, monkeypatch, remat):
    """The loss and its grads through ``_RGLRUScan`` and the RMSNorm
    Functions (kernels faked) equal autograd through the plain path; per
    micro-batch the scan kernel runs once per recurrent layer (twice
    under remat) and its backward once, RMSNorm's forward 4L+1 (2L+1
    without remat) and its backward 2L+1."""
    cfg = reduced[2]
    batch = _torch_batch(_batch(cfg, S=70))
    model = _model(reduced)
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
    L, n_rec, r = cfg.n_layers, 4, 2 if remat else 1
    assert fake.n == dict(rglru_scan_fwd=n_rec * r, rglru_scan_bwd=n_rec,
                          rmsnorm_fwd=2 * L * r + 1, rmsnorm_bwd=2 * L + 1)


def test_init_model_follows_reference_rules(reduced):
    jcfg, params, cfg = reduced
    m = R.init_model(cfg, seed=0, dtype=torch.float32, device="cpu")
    again = R.init_model(cfg, seed=0, dtype=torch.float32, device="cpu")
    assert isinstance(m, H.Hybrid) and torch.equal(m.tok, again.tok)
    tree = _np_tree(params)
    rec = m.layers[3].temporal
    np.testing.assert_allclose(rec.lam.numpy(),
                               tree["rem0"]["temporal"]["lam"], rtol=1e-6)
    assert float(rec.conv_b.abs().max()) == 0.0
    assert float(m.final_norm.abs().max()) == 0.0
    assert float(m.layers[0].norm1.abs().max()) == 0.0
    assert abs(float(rec.w_out.std()) - 0.02 / np.sqrt(10)) < 2e-3
    assert abs(float(rec.conv_w.std()) - 0.2 * 0.9866) < 0.03
    assert float(rec.conv_w.abs().max()) <= 3 * 0.2 + 1e-6
    assert abs(float(m.layers[2].temporal.w_q.std()) - 0.02) < 2e-3


# --------------------------------------------------------------------- #
# a Seesaw ramp against the reference's Trainer, and the launcher
# --------------------------------------------------------------------- #

def _ramp_cfg(ours: bool):
    get, Sch, Opt, Run = ((get_config, ScheduleConfig, OptimizerConfig,
                           RunConfig) if ours else
                          (j_get_config, JScheduleConfig, JOptimizerConfig,
                           JRunConfig))
    b0, steps, seq = 2, 12, 40
    return Run(model=dataclasses.replace(get(ARCH).reduced(), n_layers=5),
               schedule=Sch(kind="seesaw", base_lr=1e-3, alpha=2.0,
                            n_cuts=2),
               optimizer=Opt(), seq_len=seq, global_batch_size=b0,
               total_tokens=seq * b0 * steps, dtype="float32", remat=False)


def test_ramp_run_matches_jax_trainer():
    """Ten steps of Seesaw (B = 2 → 4 → 8) on the 5-layer hybrid: every
    step's loss within 5e-4 of the reference Trainer's, LR, batch and
    phase equal."""
    jtr = JTrainer(_ramp_cfg(False), fuse_steps=4)
    tr = Trainer(_ramp_cfg(True), device="cpu", fuse_steps=4,
                 max_device_batch=4)
    model = from_jax_params(_np_tree(jtr.state.params), tr.cfg.model,
                            dtype=torch.float32, device="cpu")
    tr.state.model.load_state_dict(model.state_dict())
    jtr.run(JLoader(JMarkovLM(512, seed=0), jtr.plan, 40))
    tr.run(PhaseDataLoader(MarkovLM(512, seed=0), tr.plan, 40,
                           device="cpu"))
    assert len({h["batch_size"] for h in tr.history}) >= 3
    assert 10 <= len(tr.history) == len(jtr.history) <= 12
    for a, b in zip(tr.history, jtr.history):
        assert (a["step"], a["tokens"], a["batch_size"], a["phase"]) == \
            (b["step"], b["tokens"], b["batch_size"], b["phase"])
        assert np.float32(a["lr"]) == np.float32(b["lr"])
        assert abs(a["loss"] - b["loss"]) < 5e-4
    assert tr.state.tokens_seen == jtr.state.tokens_seen


def test_launcher_trains_the_hybrid_on_the_cpu(capsys):
    hist = launch_train.main(["--arch", ARCH, "--reduced", "--device",
                              "cpu", "--seq-len", "32", "--batch-size", "2",
                              "--max-cuts", "2", "--total-tokens",
                              str(12 * 2 * 32), "--fuse-steps", "2",
                              "--max-device-batch", "4"])
    out = capsys.readouterr().out
    assert out.startswith("arch=recurrentgemma-9b-smoke ")
    assert "batches=[2, 4, 8]" in out and "done: 10 steps" in out
    assert all(np.isfinite(h["loss"]) for h in hist)


# --------------------------------------------------------------------- #
# a windowed dense arch trains through chunked_attention's autograd
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("remat", [True, False])
def test_windowed_dense_arch_trains_like_jax(remat):
    """The reduced starcoder2 (a window of 64) at S = 100: the window
    binds, and the port's loss and grads (the windowed layers through
    ``chunked_attention``, differentiated by autograd) match the
    reference's ``loss_fn`` (XLA): loss within 1e-5, each grad within
    1e-4 of its max."""
    jcfg = j_get_config("starcoder2-3b").reduced()
    cfg = get_config("starcoder2-3b").reduced()
    assert cfg.sliding_window == 64
    params = JR.init_params(jax.random.PRNGKey(1), jcfg)
    batch = _batch(cfg, S=100, seed=6)
    (jloss, _), jgrads = jax.value_and_grad(JT.loss_fn, has_aux=True)(
        params, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
        dtype=jnp.float32, remat=remat)
    model = from_jax_params(_np_tree(params), cfg, dtype=torch.float32,
                            device="cpu", trainable=True)
    loss, _ = R.loss_fn(model, cfg, _torch_batch(batch),
                        dtype=torch.float32, remat=remat)
    assert abs(loss.item() - float(jloss)) < 1e-5
    grads = torch.autograd.grad(loss, list(model.parameters()))
    jg = _np_tree(jgrads)
    for (n, _), g in zip(model.named_parameters(), grads):
        _close_to_max(g.numpy(), _ref_leaf(jg, n), 1e-4, n)


def test_registry_serves_the_hybrid_and_names_the_later_slices():
    """recurrentgemma-9b is registered and its family is ``models.rglru``;
    no family is left for a later slice: the enc-dec and the VLM
    resolve, the enc-dec served through the ``Server`` only (as the
    hybrid), the VLM from pages."""
    from repro_torch.models import encdec, transformer
    cfg = get_config(ARCH)
    assert cfg.arch_type == "hybrid" and R.family(cfg) is H
    assert R.serving_mode(cfg) is None
    for arch, fam, mode in (("seamless-m4t-medium", encdec, None),
                            ("internvl2-76b", transformer, "paged")):
        c = get_config(arch)
        assert R.family(c) is fam and R.serving_mode(c) == mode
    for arch in ("seamless-m4t-medium", "internvl2-76b", "mistral-nemo-12b",
                 "yi-34b"):
        assert get_config(arch).name == arch
        assert R.family(get_config(arch)) is not None
