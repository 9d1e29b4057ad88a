"""The port's Mamba-2 training slice against the JAX package, on the CPU.

The same numpy inputs and weights go through the reference and through
its port: the SSD chunk kernel's plain version against the reference's
Pallas kernel (``interpret=True``), the whole SSD scan and its grads,
the card's autograd path (kernels faked by their plain versions), the
weights, the loss and its grads at the reduced mamba2 config with both
of the reference's CPU backends, and a short Seesaw ramp against the
reference's ``Trainer``.  Float32 throughout.

Tolerances: the chunk kernel's outputs 2e-5 (``docs/kernels.md``); the
whole scan 1e-4 against the reference's chunked scan and its Pallas
route and 5e-4 against the sequential definition, as
``tests/test_kernels.py::TestSSD``; grads 2e-5; the card's path against
the plain path 1e-6; loss 1e-5 and grads 1e-4; training histories 5e-4
per step, as the reference's own ramp parity test.
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
from repro.kernels import ref as JREF
from repro.kernels.ssd import ssd_chunk as j_ssd_chunk
from repro.kernels.ssd import ssd_full as j_ssd_full
from repro.models import mamba2 as JM
from repro.models import registry as JR
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs import (OptimizerConfig, RunConfig, ScheduleConfig,
                                 get_config)
from repro_torch.data import MarkovLM, PhaseDataLoader
from repro_torch.kernels import backend as KB
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels import ssd as SSD
from repro_torch.launch import train as launch_train
from repro_torch.models import mamba2 as M
from repro_torch.models import registry as R
from repro_torch.serving import ServingEngine
from repro_torch.train.trainer import Trainer
from repro_torch.weights import from_jax_params


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these small models run many small ops, which
    the thread pools of several test workers on a shared CPU slow down
    many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KERNEL = dict(atol=2e-5, rtol=2e-5)
SSD_SHAPES = [(2, 96, 4, 32, 16, 32), (1, 128, 2, 64, 32, 64),
              (2, 100, 3, 16, 8, 32)]       # tests/test_kernels.py::TestSSD


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _ssd_inputs(seed, B, S, H, P, N, bc_scale=1.0, d=0.5):
    rng = np.random.default_rng(seed)
    f = np.float32
    xh = rng.standard_normal((B, S, H, P)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(f)
    A = (-np.exp(0.3 * rng.standard_normal(H))).astype(f)
    Bm = (bc_scale * rng.standard_normal((B, S, N))).astype(f)
    Cm = (bc_scale * rng.standard_normal((B, S, N))).astype(f)
    D = np.full(H, d, f)
    return xh, dt, A, Bm, Cm, D


# --------------------------------------------------------------------- #
# the chunk kernel's plain version and the whole scan
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("B,S,H,P,N,Q", SSD_SHAPES)
def test_ssd_chunk_ref_matches_jax_kernel(B, S, H, P, N, Q):
    """y_intra, the chunk states and T against the reference's Pallas
    kernel.  The reference's kernel takes S a multiple of the chunk, so
    it gets the zero-padded inputs (dt = 0 steps); the port's plain
    version takes the ragged S as it is."""
    xh, dt, A, Bm, Cm, _ = _ssd_inputs(0, B, S, H, P, N)
    Sp = -(-S // Q) * Q
    pad = lambda a: np.pad(a, [(0, 0), (0, Sp - S)]         # noqa: E731
                           + [(0, 0)] * (a.ndim - 2))
    jy, js, jT = j_ssd_chunk(*(jnp.asarray(pad(a)) for a in (xh, dt)),
                             jnp.asarray(A),
                             *(jnp.asarray(pad(a)) for a in (Bm, Cm)),
                             chunk=Q, interpret=True)
    y, s, T = ref.ssd_chunk_ref(_t(xh), _t(dt), _t(A), _t(Bm), _t(Cm), Q)
    assert y.shape == (B, S, H, P) and s.shape == (B, Sp // Q, H, N, P)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy)[:, :S], **KERNEL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **KERNEL)
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), **KERNEL)


@pytest.mark.parametrize("B,S,H,P,N,Q", SSD_SHAPES)
def test_ssd_matches_jax(B, S, H, P, N, Q):
    """The port's SSD (the CPU path: the plain chunked scan) against the
    reference's chunked scan, its Pallas route and the sequential
    definition; the port's sequential definition against the
    reference's."""
    args = _ssd_inputs(1, B, S, H, P, N)
    jargs = [jnp.asarray(a) for a in args]
    y, h = KB.ssd(*(_t(a) for a in args), chunk=Q)
    assert y.shape == (B, S, H, P) and h.shape == (B, H, P, N)
    oracle = dict(atol=1e-4, rtol=1e-4)
    for (wy, wh), tol in ((JM.ssd_chunked(*jargs, chunk=Q), oracle),
                          (j_ssd_full(*jargs, chunk=Q, interpret=True),
                           oracle),
                          (JREF.ssd_ref(*jargs), dict(atol=5e-4,
                                                      rtol=5e-4))):
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), **tol)
        np.testing.assert_allclose(h.numpy(), np.asarray(wh), **tol)
    ry, rh = ref.ssd_ref(*(_t(a) for a in args))
    jy, jh = JREF.ssd_ref(*jargs)
    np.testing.assert_allclose(ry.numpy(), np.asarray(jy), **KERNEL)
    np.testing.assert_allclose(rh.numpy(), np.asarray(jh), **KERNEL)


def _jax_grads(fn, args, cts):
    def loss(*a):
        y, h = fn(*a)
        return jnp.sum(y * cts[0]) + jnp.sum(h * cts[1])
    return jax.grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in args))


def _port_grads(fn, args, cts):
    leaves = [_t(a).requires_grad_() for a in args]
    y, h = fn(*leaves)
    return torch.autograd.grad((y * _t(cts[0])).sum()
                               + (h * _t(cts[1])).sum(), leaves)


@pytest.mark.parametrize("S,Q", [(96, 32), (100, 32)])
def test_ssd_grads_match_jax(S, Q):
    """Grads of all six inputs through the port's SSD against the
    reference's through its Pallas route (a recompute through its
    chunked scan), at tests/test_kernels.py::TestSSDGrads' shape and a
    ragged S."""
    B, H, P, N = 1, 2, 16, 8
    args = _ssd_inputs(2, B, S, H, P, N, bc_scale=0.3)
    rng = np.random.default_rng(3)
    cts = (rng.standard_normal((B, S, H, P)).astype(np.float32),
           rng.standard_normal((B, H, P, N)).astype(np.float32))
    want = _jax_grads(lambda *a: j_ssd_full(*a, chunk=Q, interpret=True),
                      args, cts)
    got = _port_grads(lambda *a: KB.ssd(*a, chunk=Q), args, cts)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **KERNEL)


def test_reference_nan_grad_is_fixed_in_the_port():
    """With |dt·A|·Q far past 88 (A down to -80, dt = 0.1, Q = 32: cum
    reaches -256 within a chunk) the reference's chunked scan has a NaN
    dt grad: it evaluates exp above the diagonal, where it overflows to
    inf, and masks afterwards (0·inf in the backward).  The port masks
    before the exp: its grads are finite and agree with float64 grads
    through its sequential definition."""
    B, S, H, P, N, Q = 1, 64, 4, 8, 8, 32
    rng = np.random.default_rng(4)
    f = np.float32
    args = (rng.standard_normal((B, S, H, P)).astype(f),
            np.full((B, S, H), 0.1, f),
            -np.linspace(1.0, 80.0, H).astype(f),
            (0.3 * rng.standard_normal((B, S, N))).astype(f),
            (0.3 * rng.standard_normal((B, S, N))).astype(f),
            np.full(H, 0.5, f))
    cts = (rng.standard_normal((B, S, H, P)).astype(f),
           rng.standard_normal((B, H, P, N)).astype(f))
    jg = _jax_grads(lambda *a: JM.ssd_chunked(*a, chunk=Q), args, cts)
    assert np.isnan(np.asarray(jg[1])).any()
    got = _port_grads(lambda *a: M.ssd_chunked(*a, chunk=Q), args, cts)

    def ref64(*a):
        return ref.ssd_ref(*(t.double() for t in a))

    leaves = [_t(a).double().requires_grad_() for a in args]
    y, h = ref64(*leaves)
    want = torch.autograd.grad((y * _t(cts[0]).double()).sum()
                               + (h * _t(cts[1]).double()).sum(), leaves)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g.double(), w, rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()))


# --------------------------------------------------------------------- #
# the card's autograd path, kernels faked by their plain versions
# --------------------------------------------------------------------- #

class _FakeCard:
    """The card's path on the CPU: ``_on_card`` says yes and each kernel
    wrapper becomes its plain version, counting its launches as the
    wrapper does (the pattern of ``tests/test_torch_train.py``).  Holds
    the ``_SSD`` Function (forward through the chunk kernel's outputs,
    backward recomputed through the plain scan) and the RMSNorm
    Functions to the plain path; the kernels themselves are held to
    their plain versions on the card (``tests/test_torch_card.py``)."""

    def __init__(self, monkeypatch):
        self.n = dict(ssd_chunk=0, rmsnorm_fwd=0, rmsnorm_bwd=0)

        def count(name, fn):
            def wrapped(*a):
                self.n[name] += 1
                return fn(*a)
            return wrapped

        monkeypatch.setattr(KB, "_on_card", lambda t, op: True)
        monkeypatch.setattr(SSD, "ssd_chunk",
                            count("ssd_chunk", ref.ssd_chunk_ref))
        monkeypatch.setattr(RN, "rmsnorm_fwd",
                            count("rmsnorm_fwd", ref.rmsnorm_ref))
        monkeypatch.setattr(RN, "rmsnorm_bwd",
                            count("rmsnorm_bwd", ref.rmsnorm_bwd_ref))


REDUCED = "mamba2-2.7b"


@pytest.fixture(scope="module")
def reduced():
    jcfg = j_get_config(REDUCED).reduced()
    params = JR.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, params, get_config(REDUCED).reduced()


def _model(reduced, trainable=True):
    _, params, cfg = reduced
    return from_jax_params(_np_tree(params), cfg, dtype=torch.float32,
                           device="cpu", trainable=trainable)


def _batch(cfg, B=2, S=40, seed=5):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (B, S + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


@pytest.mark.parametrize("remat", [True, False])
def test_card_path_matches_plain_path(reduced, monkeypatch, remat):
    """The loss and its grads through ``_SSD`` and the RMSNorm Functions
    (kernels faked) equal autograd through the plain path; per
    micro-batch under remat the chunk kernel runs 2L times (each layer's
    forward twice), RMSNorm's forward 4L+1 and its backward 2L+1."""
    cfg = reduced[2]
    batch = _torch_batch(_batch(cfg, S=48))     # a ragged last chunk
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
    L, r = cfg.n_layers, 2 if remat else 1
    assert fake.n == dict(ssd_chunk=L * r, rmsnorm_fwd=2 * L * r + 1,
                          rmsnorm_bwd=2 * L + 1)


def test_ssd_function_matches_plain_scan(monkeypatch):
    """``_SSD`` alone (the chunk kernel faked): outputs within the
    forward's float32 sums of the plain scan, grads of all six inputs
    equal to the plain scan's (the backward is its recompute)."""
    B, S, H, P, N, Q = 2, 100, 3, 16, 8, 32
    args = _ssd_inputs(6, B, S, H, P, N, bc_scale=0.3)
    rng = np.random.default_rng(7)
    cts = (rng.standard_normal((B, S, H, P)).astype(np.float32),
           rng.standard_normal((B, H, P, N)).astype(np.float32))
    want = _port_grads(lambda *a: M.ssd_chunked(*a, chunk=Q), args, cts)
    wy, wh = M.ssd_chunked(*(_t(a) for a in args), chunk=Q)
    _FakeCard(monkeypatch)
    y, h = SSD.ssd(*(_t(a) for a in args), chunk=Q)
    torch.testing.assert_close(y, wy, **KERNEL)
    torch.testing.assert_close(h, wh, **KERNEL)
    got = _port_grads(lambda *a: SSD.ssd(*a, chunk=Q), args, cts)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


# --------------------------------------------------------------------- #
# weights, the loss and its grads
# --------------------------------------------------------------------- #

def _jax_name(tree, name):
    """The reference's array for a port parameter name
    (``layers.1.mixer.w_z`` -> ``tree['layers']['mixer']['w_z'][1]``)."""
    parts = name.split(".")
    if parts[0] == "tok":
        return tree["embed"]["tok"]
    if parts[0] == "final_norm":
        return tree["final_norm"]
    node = tree["layers"]
    for p in parts[2:]:
        node = node[p]
    return node[int(parts[1])]


def test_from_jax_params_loads_the_ssm_tree(reduced):
    jcfg, params, cfg = reduced
    model = _model(reduced, trainable=False)
    assert isinstance(model, M.Mamba2) and model.lm_head is None
    tree = _np_tree(params)
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == 2 + cfg.n_layers * 13
    for n, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      _jax_name(tree, n), err_msg=n)
        assert not p.requires_grad
    assert model.layers[0].mixer.A_log.dtype == torch.float32


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_jax(reduced, backend, remat):
    """The reduced mamba2 (2 layers, d=256, 8 heads, d_state 16, chunk
    32) with z-loss, S = 40 (a ragged last chunk) and a padded vocab."""
    jcfg, params, cfg = reduced
    jcfg = dataclasses.replace(jcfg, kernel_backend=backend)
    batch = _batch(cfg)
    (jloss, jm), jgrads = jax.value_and_grad(JM.loss_fn, has_aux=True)(
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
        np.testing.assert_allclose(g.numpy(), _jax_name(jg, n), atol=1e-4,
                                   rtol=1e-4, err_msg=n)


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    got = M.causal_conv1d(_t(x), _t(w), _t(b))
    want = JM.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_init_model_follows_reference_rules(reduced):
    jcfg, params, cfg = reduced
    m = R.init_model(cfg, seed=0, dtype=torch.float32, device="cpu")
    again = R.init_model(cfg, seed=0, dtype=torch.float32, device="cpu")
    assert isinstance(m, M.Mamba2) and torch.equal(m.tok, again.tok)
    tree = _np_tree(params)
    mix = m.layers[0].mixer
    # the deterministic rules equal the reference's init exactly
    for n in ("A_log", "D", "conv_b", "norm"):
        np.testing.assert_allclose(getattr(mix, n).numpy(),
                                   tree["layers"]["mixer"][n][0], rtol=1e-6)
    np.testing.assert_allclose(mix.dt_bias.numpy(),
                               tree["layers"]["mixer"]["dt_bias"][0],
                               rtol=1e-5)
    assert float(m.final_norm.abs().max()) == 0.0
    assert abs(float(mix.w_out.std()) - 0.02 / np.sqrt(4)) < 2e-3
    assert abs(float(mix.conv_w.std()) - 0.2 * 0.9866) < 0.02
    assert float(mix.conv_w.abs().max()) <= 3 * 0.2 + 1e-6


def test_ssm_family_serves_from_the_state_pool(reduced):
    """Mamba-2 serves in the engine's ``"state"`` mode (the serving slice
    is held to the reference in ``tests/test_torch_mamba2_serving.py``);
    the bucketed ragged prefill stays closed to it, as in the
    reference."""
    cfg = reduced[2]
    model = R.init_model(cfg, dtype=torch.float32, device="cpu")
    assert R.serving_mode(cfg) == "state"
    eng = ServingEngine(cfg, model, dtype=torch.float32, decode_slots=2,
                        max_len=16)
    assert (eng.mode, eng.pool.kind, eng.page_size) == ("state", "state", 1)
    out = eng.generate(np.arange(8, dtype=np.int32)[None], 3)
    assert out.shape == (1, 3) and eng.pool.n_used == 0
    toks = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(NotImplementedError,
                       match="ragged prefill needs full attention"):
        R.prefill_ragged(model, cfg, toks, torch.tensor([4]))


# --------------------------------------------------------------------- #
# a Seesaw ramp against the reference's Trainer, and the launcher
# --------------------------------------------------------------------- #

def _ramp_cfg(ours: bool):
    get, Sch, Opt, Run = ((get_config, ScheduleConfig, OptimizerConfig,
                           RunConfig) if ours else
                          (j_get_config, JScheduleConfig, JOptimizerConfig,
                           JRunConfig))
    b0, steps, seq = 2, 12, 40
    return Run(model=get(REDUCED).reduced(),
               schedule=Sch(kind="seesaw", base_lr=1e-3, alpha=2.0,
                            n_cuts=2),
               optimizer=Opt(), seq_len=seq, global_batch_size=b0,
               total_tokens=seq * b0 * steps, dtype="float32", remat=False)


def test_ramp_run_matches_jax_trainer():
    jtr = JTrainer(_ramp_cfg(False), fuse_steps=4)
    tr = Trainer(_ramp_cfg(True), device="cpu", fuse_steps=4,
                 max_device_batch=4)
    model = from_jax_params(_np_tree(jtr.state.params), tr.cfg.model,
                            dtype=torch.float32, device="cpu")
    tr.state.model.load_state_dict(model.state_dict())
    jtr.run(JLoader(JMarkovLM(512, seed=0), jtr.plan, 40))
    tr.run(PhaseDataLoader(MarkovLM(512, seed=0), tr.plan, 40,
                           device="cpu"))
    batches = [h["batch_size"] for h in tr.history]
    assert len(set(batches)) >= 3                  # at least two cuts
    assert 10 <= len(tr.history) == len(jtr.history) <= 12
    for a, b in zip(tr.history, jtr.history):
        assert (a["step"], a["tokens"], a["batch_size"], a["phase"]) == \
            (b["step"], b["tokens"], b["batch_size"], b["phase"])
        assert np.float32(a["lr"]) == np.float32(b["lr"])
        assert abs(a["loss"] - b["loss"]) < 5e-4
    assert tr.state.tokens_seen == jtr.state.tokens_seen


def test_launcher_trains_mamba2_on_the_cpu(capsys):
    hist = launch_train.main(["--arch", "mamba2-2.7b", "--reduced",
                              "--device", "cpu", "--seq-len", "32",
                              "--batch-size", "2", "--max-cuts", "2",
                              "--total-tokens", str(12 * 2 * 32),
                              "--fuse-steps", "2", "--max-device-batch",
                              "4"])
    out = capsys.readouterr().out
    assert out.startswith("arch=mamba2-2.7b-smoke ")
    assert "batches=[2, 4, 8]" in out and "done: 10 steps" in out
    assert all(np.isfinite(h["loss"]) for h in hist)
