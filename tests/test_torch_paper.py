"""The paper's runs in the port against the JAX package, on the CPU.

The §4 presets and ``paper_run``, the Section-5 theory
(``core.theory``), the noise-scale estimator (``core.cbs``), the linear-
regression sampler, the Seesaw helpers, the theory benchmarks' rows, the
Trainer-driven figure LMs and the linear-regression example — each
against its reference on the same inputs.

Tolerances: configs, plans, the theory recursions, the sampler's stream
and the theory benchmarks' rows bitwise (the same numpy float64
arithmetic in the same order); the noise-scale estimator 1e-12 relative
(float64 sums of the same squares in another order); the figure LMs,
float32, 5e-4 in loss per step with LR, batch and phase equal (as the
port's other training runs against the JAX ``Trainer``); the sampled
SGD of the example 1e-9 relative (float64 products in another order,
over 10,000 steps).
"""
import dataclasses
import functools
import importlib.util
import math
import os
import sys

import jax
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:                # the reference's benchmarks/
    sys.path.insert(0, ROOT)

from benchmarks import bench_figure1 as jf1  # noqa: E402
from benchmarks import bench_figure2 as jf2  # noqa: E402
from benchmarks import bench_figure3 as jf3  # noqa: E402
from benchmarks import bench_figure5 as jf5  # noqa: E402
from benchmarks import bench_figure6_zloss as jf6  # noqa: E402
from benchmarks import bench_lemma1 as jl1  # noqa: E402
from benchmarks import bench_table1 as jt1  # noqa: E402
from repro.configs import seesaw_paper as JP  # noqa: E402
from repro.core import cbs as JC  # noqa: E402
from repro.core import seesaw as JSS  # noqa: E402
from repro.core import theory as JT  # noqa: E402
from repro.data import LinearRegressionSampler as JSampler  # noqa: E402
from repro.train import engine as JE  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro_torch.bench import figure1 as pf1  # noqa: E402
from repro_torch.bench import figure2 as pf2  # noqa: E402
from repro_torch.bench import figure3 as pf3  # noqa: E402
from repro_torch.bench import figure5 as pf5  # noqa: E402
from repro_torch.bench import figure6_zloss as pf6  # noqa: E402
from repro_torch.bench import lemma1 as pl1  # noqa: E402
from repro_torch.bench import run as bench_run  # noqa: E402
from repro_torch.bench import table1 as pt1  # noqa: E402
from repro_torch.configs import seesaw_paper as PP  # noqa: E402
from repro_torch.core import cbs as PC  # noqa: E402
from repro_torch.core import seesaw as PSS  # noqa: E402
from repro_torch.core import theory as PT  # noqa: E402
from repro_torch.data import LinearRegressionSampler  # noqa: E402
from repro_torch.examples import adaptive_seesaw as pad  # noqa: E402
from repro_torch.examples import \
    linear_regression_equivalence as plr  # noqa: E402
from repro_torch.examples import quickstart as pqs  # noqa: E402
from repro_torch.examples import seesaw_vs_cosine_lm as psc  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these small models run many small ops, which
    the thread pools of several test workers on a shared CPU slow down
    many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PRESETS = ["seesaw-150m", "seesaw-300m", "seesaw-600m"]
LAM = PT.power_law_spectrum(80, a=1.0)
ETA0 = PT.stability_eta(LAM)
SAMPLES = [4096] * 6


def _fields(cfg) -> dict:
    """A config as a dict, less the reference's kernel_backend."""
    d = dataclasses.asdict(cfg)
    d.pop("kernel_backend", None)
    if isinstance(d.get("model"), dict):
        d["model"].pop("kernel_backend", None)
    return d


# --------------------------------------------------------------------- #
# §4 presets and paper_run
# --------------------------------------------------------------------- #

def test_presets_and_cbs_match_reference():
    assert PP.CBS == JP.CBS == {"seesaw-150m": 256, "seesaw-300m": 512,
                                "seesaw-600m": 1024}
    for ours, theirs in ((PP.SEESAW_150M, JP.SEESAW_150M),
                         (PP.SEESAW_300M, JP.SEESAW_300M),
                         (PP.SEESAW_600M, JP.SEESAW_600M)):
        assert _fields(ours) == _fields(theirs)
    assert PP.CONFIG == PP.SEESAW_150M


@pytest.mark.parametrize("kind", ["cosine", "seesaw"])
@pytest.mark.parametrize("name", PRESETS)
def test_paper_run_matches_reference(name, kind):
    """Field for field, at the defaults (B0 = the CBS) and with every
    argument given."""
    ours = {"seesaw-150m": PP.SEESAW_150M, "seesaw-300m": PP.SEESAW_300M,
            "seesaw-600m": PP.SEESAW_600M}[name]
    theirs = {"seesaw-150m": JP.SEESAW_150M, "seesaw-300m": JP.SEESAW_300M,
              "seesaw-600m": JP.SEESAW_600M}[name]
    got = PP.paper_run(ours, kind=kind)
    assert _fields(got) == _fields(JP.paper_run(theirs, kind=kind))
    assert got.global_batch_size == PP.CBS[name]
    kw = dict(kind=kind, batch_size=64, lr=1e-3, alpha=1.1)
    assert _fields(PP.paper_run(ours, **kw)) == \
        _fields(JP.paper_run(theirs, **kw))


# --------------------------------------------------------------------- #
# Section-5 theory, bit for bit
# --------------------------------------------------------------------- #

def _both(fn_name, *args, **kw):
    return getattr(PT, fn_name)(*args, **kw), getattr(JT, fn_name)(*args,
                                                                     **kw)


def test_theory_primitives_match_reference():
    for d, a, tr in ((80, 1.0, 1.0), (100, 1.5, 3.0), (7, 0.5, 0.2)):
        got, want = _both("power_law_spectrum", d, a=a, trace=tr)
        assert np.array_equal(got, want)
    assert PT.stability_eta(LAM) == JT.stability_eta(LAM)
    rng = np.random.default_rng(0)
    m, e = rng.random(80), rng.normal(size=80)
    for B, s2 in ((8, 1.0), (64, 0.05)):
        (pm, pe), (jm, je) = _both("_step", m, e, LAM, 3 * ETA0, B, s2)
        assert np.array_equal(pm, jm) and np.array_equal(pe, je)
        assert PT.effective_grad_norm_sq(m, e, LAM, B, s2) == \
            JT.effective_grad_norm_sq(m, e, LAM, B, s2)
    assert PT.excess_risk(LAM, m) == JT.excess_risk(LAM, m)
    ph = PT.phase_schedule(0.3, 8, math.sqrt(2.0), 2.0, [4096, 1000, 77])
    jph = JT.phase_schedule(0.3, 8, math.sqrt(2.0), 2.0, [4096, 1000, 77])
    assert [dataclasses.astuple(p) for p in ph] == \
        [dataclasses.astuple(p) for p in jph]
    assert [p.samples for p in ph] == [p.samples for p in jph]


@pytest.fixture(scope="module")
def warm_m():
    got, want = _both("warm_start", LAM, 1.0, ETA0, 8, 2000)
    assert np.array_equal(got, want)
    return want


@pytest.mark.parametrize("case", [
    "theorem1", "theorem1-three-way", "theorem1-mismatched",
    "corollary1", "corollary1-exact", "corollary1-sgd-rule"])
def test_risk_ratios_match_reference(warm_m, case):
    """``tests/test_theory.py``'s Theorem 1 and Corollary 1 cases."""
    eta_n = ETA0 * math.sqrt(np.sum(LAM) / 8)
    kw = dict(b0=8, samples_per_phase=SAMPLES, m_start=warm_m)
    fn, args = {
        "theorem1": ("theorem1_risk_ratio", dict(
            eta0=ETA0, alpha1=4.0, beta1=1.0, alpha2=2.0, beta2=2.0)),
        "theorem1-three-way": ("theorem1_risk_ratio", dict(
            eta0=ETA0, alpha1=8.0, beta1=1.0, alpha2=2.0, beta2=4.0)),
        "theorem1-mismatched": ("theorem1_risk_ratio", dict(
            eta0=ETA0, alpha1=4.0, beta1=1.0, alpha2=1.2, beta2=1.0)),
        "corollary1": ("corollary1_risk_ratio", dict(
            eta0=eta_n, alpha1=2.0, beta1=1.0, alpha2=math.sqrt(2.0),
            beta2=2.0)),
        "corollary1-exact": ("corollary1_risk_ratio", dict(
            eta0=eta_n, alpha1=2.0, beta1=1.0, alpha2=math.sqrt(2.0),
            beta2=2.0, variance_dominated=False)),
        "corollary1-sgd-rule": ("corollary1_risk_ratio", dict(
            eta0=eta_n, alpha1=2.0, beta1=1.0, alpha2=1.0, beta2=2.0)),
    }[case]
    got, want = _both(fn, LAM, 1.0, **args, **kw)
    assert got == want and np.isfinite(got)


@pytest.mark.parametrize("normalized,variance_dominated,record", [
    (False, False, 0), (True, True, 100), (True, False, 37)])
def test_run_schedule_matches_reference(warm_m, normalized,
                                        variance_dominated, record):
    ph = PT.phase_schedule(0.5 * ETA0 * math.sqrt(np.sum(LAM) / 8)
                           if normalized else ETA0, 8, math.sqrt(2.0),
                           2.0, [2048] * 4)
    kw = dict(m0=warm_m, normalized=normalized,
              assume_variance_dominated=variance_dominated,
              record_every=record)
    got, want = PT.run_schedule(LAM, 1.0, ph, **kw), \
        JT.run_schedule(LAM, 1.0, ph, **kw)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert got[1].shape == want[1].shape


def test_lemma4_divergence_stop_matches_reference(warm_m):
    """α < √β under NSGD: the recursion records inf and stops at the same
    step in both packages (``tests/test_theory.py``'s Lemma 4 case)."""
    eta_n = 20 * ETA0 * math.sqrt(np.sum(LAM) / 8)
    ph = PT.phase_schedule(eta_n, 8, alpha=1.0, beta=4.0,
                           samples_per_phase=[2048] * 14)
    kw = dict(m0=warm_m, normalized=True, assume_variance_dominated=True,
              record_every=1)
    (r, traj, m), (jr, jtraj, jm) = PT.run_schedule(LAM, 1.0, ph, **kw), \
        JT.run_schedule(LAM, 1.0, ph, **kw)
    assert np.array_equal(r, jr) and np.array_equal(traj, jtraj)
    assert np.array_equal(m, jm, equal_nan=True)
    assert not np.isfinite(r[-1]) and len(r) < 14


# --------------------------------------------------------------------- #
# the noise scale (core.cbs)
# --------------------------------------------------------------------- #

def _grads(rng, G, sigma, b):
    """One noisy gradient as the reference's numpy pytree and the port's
    float64 tensors, nested the same way."""
    g = G + sigma * rng.normal(size=G.shape) / math.sqrt(b)
    tree = {"w": g[:300].reshape(20, 15), "layers": [g[300:420],
                                                    (g[420:500],)]}
    ours = {"w": torch.from_numpy(tree["w"]),
            "layers": [torch.from_numpy(tree["layers"][0]),
                       (torch.from_numpy(tree["layers"][1][0]),)]}
    return tree, ours


def test_noise_scale_two_point_matches_reference():
    rng = np.random.default_rng(0)
    G = rng.normal(size=500) * 0.1
    for b, B in ((8, 64), (4, 5), (16, 1024)):
        js, ps = _grads(rng, G, 1.0, b)
        jb, pb = _grads(rng, G, 1.0, B)
        want = JC.noise_scale_two_point(js, jb, b, B)
        got = PC.noise_scale_two_point(ps, pb, b, B)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
        # a bare tensor, a list and a tuple of float32 tensors: any tree,
        # summed in float64 (the reference's numpy vdot would sum float32
        # leaves in float32)
        flat = np.concatenate([js["w"].ravel(), js["layers"][0]])
        assert PC._sq_norm(torch.from_numpy(flat)) == \
            pytest.approx(JC._sq_norm(flat), rel=1e-12)
        f32 = [js["w"].astype(np.float32),
               (js["layers"][0].astype(np.float32),)]
        assert PC._sq_norm([torch.from_numpy(f32[0]),
                            (torch.from_numpy(f32[1][0]),)]) == \
            pytest.approx(JC._sq_norm([f32[0].astype(np.float64),
                                       (f32[1][0].astype(np.float64),)]),
                          rel=1e-12)
    with pytest.raises(AssertionError):
        PC.noise_scale_two_point(ps, pb, 8, 8)


def test_noise_scale_monitor_ema_matches_reference():
    rng = np.random.default_rng(1)
    G = rng.normal(size=500)
    mon = PC.NoiseScaleMonitor(micro_batch=8, full_batch=64, ema=0.5)
    jmon = JC.NoiseScaleMonitor(micro_batch=8, full_batch=64, ema=0.5)
    got, want = [], []
    for _ in range(50):
        js, ps = _grads(rng, G, 1.0, 8)
        jb, pb = _grads(rng, G, 1.0, 64)
        got.append(mon.update(ps, pb))
        want.append(jmon.update(js, jb))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert mon.value == pytest.approx(jmon.value, rel=1e-12)


def test_exact_noise_scale_matches_reference(warm_m):
    lam = PT.power_law_spectrum(60, a=1.0)
    eta = PT.stability_eta(lam)
    got = PC.noise_scale_trajectory(lam, 1.0, eta, batch=8, steps=3000,
                                    every=100)
    want = JC.noise_scale_trajectory(lam, 1.0, eta, batch=8, steps=3000,
                                     every=100)
    assert np.array_equal(got, want) and got[-1] > got[0] * 3
    e = np.sqrt(warm_m)
    for ee in (None, e):
        assert PC.exact_noise_scale(LAM, 1.0, warm_m, ee) == \
            JC.exact_noise_scale(LAM, 1.0, warm_m, ee)


# --------------------------------------------------------------------- #
# the linear-regression sampler
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("seed,sigma2,w_star", [(0, 1.0, False),
                                                (7, 0.25, True)])
def test_linear_regression_sampler_matches_reference(seed, sigma2, w_star):
    lam = PT.power_law_spectrum(50, a=1.0)
    w = np.random.default_rng(3).normal(size=50) if w_star else None
    ours = LinearRegressionSampler(lam, sigma2=sigma2, seed=seed, w_star=w)
    theirs = JSampler(lam, sigma2=sigma2, seed=seed, w_star=w)
    for step, batch in ((0, 10), (1, 10), (12345, 3), (7, 640)):
        (x, y), (jx, jy) = ours.sample(step, batch), theirs.sample(step,
                                                                   batch)
        assert x.dtype == jx.dtype == np.float32
        assert np.array_equal(x, jx) and np.array_equal(y, jy)
    for v in (np.zeros(50), np.random.default_rng(4).normal(size=50)):
        assert ours.risk(v) == theirs.risk(v)


# --------------------------------------------------------------------- #
# the Seesaw helpers and the planner's token count
# --------------------------------------------------------------------- #

def test_seesaw_helpers_match_reference():
    assert PSS.theoretical_speedup() == JSS.theoretical_speedup()
    for a in (1.0, 1.1, 2 ** 0.25, math.sqrt(2.0), 2.0, 4.0):
        for b in (1.0, 2.0, 2 ** 1.5, 4.0):
            assert PSS.divergence_risk(a, b) == JSS.divergence_risk(a, b)
            for k in (0, 1, 5):
                assert PSS.effective_lr_ratio(a, b, k) == \
                    JSS.effective_lr_ratio(a, b, k)
    assert PSS.divergence_risk(1.0, 4.0) and \
        not PSS.divergence_risk(math.sqrt(2.0), 2.0)


# (steps, n_cuts) of the figure LMs' plans (B0 8, seq 64), and paper_run's
PLANS = [("figure1", 150, 4), ("figure4", 120, 4), ("figure6", 100, 3),
         ("figure1-short", 24, 4), ("figure6-short", 20, 3)]


@pytest.mark.parametrize("kind", ["cosine", "seesaw"])
@pytest.mark.parametrize("tag,steps,n_cuts", PLANS)
def test_figure_plans_match_reference(tag, steps, n_cuts, kind):
    kw = dict(kind=kind, base_lr=3e-3, total_tokens=64 * 8 * steps,
              warmup_frac=0.1, b0=8, alpha=2.0, n_cuts=n_cuts)
    ours, theirs = PSS.build_plan(**kw), JSS.build_plan(**kw)
    assert ours.steps_per_phase(64) == theirs.steps_per_phase(64)
    assert ours.total_tokens_scheduled(64) == \
        theirs.total_tokens_scheduled(64)


@pytest.mark.parametrize("horizon,n_cuts,steps,tokens", [
    # the pinned fault: 16 cosine steps at B0 = 256, n_cuts 8 — the last
    # phase's batch (65,536 sequences) rounds its carry to 0 steps
    (16, 8, [11, 1, 0, 0, 0, 0, 0, 0, 0], 3_407_872),
    # chip_smoke phase 13c: 20 cosine steps, n_cuts 2 keeps every token
    (20, 2, [14, 1, 1], 5_242_880),
    (24, 2, None, 6_291_456),
])
def test_paper_run_plans_and_dropped_tokens(horizon, n_cuts, steps, tokens):
    """``paper_run``'s Seesaw plan at a short horizon, in both packages:
    steps per phase and the tokens the plan trains, which the last
    phase's rounding can cut short of ``total_tokens``."""
    plans = []
    for P, SS in ((PP, PSS), (JP, JSS)):
        cfg = P.paper_run(P.SEESAW_150M, kind="seesaw")
        total = horizon * cfg.global_batch_size * cfg.seq_len
        sch = cfg.schedule
        plans.append(SS.build_plan(
            kind=sch.kind, base_lr=sch.base_lr, total_tokens=total,
            warmup_frac=sch.warmup_frac, b0=cfg.global_batch_size,
            alpha=sch.alpha, n_cuts=n_cuts))
    ours, theirs = plans
    assert ours.steps_per_phase(1024) == theirs.steps_per_phase(1024)
    if steps is not None:
        assert ours.steps_per_phase(1024) == steps
    assert ours.total_tokens_scheduled(1024) == \
        theirs.total_tokens_scheduled(1024) == tokens
    assert ours.total_tokens == horizon * 256 * 1024


# --------------------------------------------------------------------- #
# the benchmarks
# --------------------------------------------------------------------- #

def _rows(rows):
    return [(n, d) for n, _, d in rows]


@pytest.mark.parametrize("ours,theirs", [
    (pl1, jl1), (pt1, jt1), (pf2, jf2), (pf3, jf3), (pf5, jf5)],
    ids=["lemma1", "table1", "figure2", "figure3", "figure5"])
def test_theory_bench_rows_match_reference(ours, theirs):
    got, want = ours.run(), theirs.run()
    assert _rows(got) == _rows(want)
    assert all(isinstance(us, float) and us >= 0 for _, us, _ in got)


def _paired_runs(jmod, pmod, steps):
    """The reference's ``run()`` and the port's, each over plans of
    ``steps`` cosine steps, float32, every port run starting from its
    reference run's initial weights.  Returns the two sets of rows and of
    trainers."""
    inits, jruns, pruns = [], [], []

    class JSeeded(JTrainer):
        def __init__(self, cfg, *a, **kw):
            super().__init__(dataclasses.replace(cfg, dtype="float32"), *a,
                             **kw)
            inits.append(jax.tree.map(np.asarray, self.state.params))
            jruns.append(self)

    class PSeeded(Trainer):
        def __init__(self, cfg, **kw):
            super().__init__(cfg, **kw)
            m = from_jax_params(inits[len(pruns)], cfg.model,
                                dtype=torch.float32, device="cpu")
            self.state.model.load_state_dict(m.state_dict())
            pruns.append(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmod, "Trainer", JSeeded)
        mp.setattr(jmod, "_train", functools.partial(jmod._train,
                                                     steps=steps))
        mp.setattr(pmod, "Trainer", PSeeded)
        want = jmod.run()
        got = pmod.run(device="cpu", steps=steps, dtype="float32")
    return got, want, pruns, jruns


@pytest.fixture(scope="module")
def figure1_runs():
    return _paired_runs(jf1, pf1, 24)


@pytest.fixture(scope="module")
def figure6_runs():
    return _paired_runs(jf6, pf6, 20)


def _same_histories(pruns, jruns, keys=("loss",)):
    """Step for step: the same step, tokens, batch and phase; the loss
    (and ``keys``) within 5e-4; the LR within 2 float32 ulp of the
    reference's plan LR (``test_torch_train``'s cosine bound) and within
    2e-6 of the JAX trainer's record, whose jitted quarter-cosine XLA
    rounds up to 12 ulp off its own eager value near the curve's end."""
    assert len(pruns) == len(jruns)
    for ptr, jtr in zip(pruns, jruns):
        assert ptr.cfg.dtype == jtr.cfg.dtype == "float32"
        assert len(ptr.history) == len(jtr.history) > 0
        jlr = JE.plan_lr_fn(jtr.plan, jtr.cfg.seq_len)
        got, want = [], []
        for i, (a, b) in enumerate(zip(ptr.history, jtr.history)):
            assert (a["step"], a["tokens"], a["batch_size"], a["phase"]) \
                == (b["step"], b["tokens"], b["batch_size"], b["phase"])
            tok = a["tokens"] - a["batch_size"] * jtr.cfg.seq_len
            got.append(a["lr"])
            want.append(float(jlr(float(tok), i)))
            assert a["lr"] == pytest.approx(b["lr"], rel=2e-6, abs=0)
            for k in keys:
                assert abs(a[k] - b[k]) < 5e-4, (a["step"], k, a[k], b[k])
        np.testing.assert_array_max_ulp(np.float32(got), np.float32(want),
                                        2)


def test_figure1_lm_matches_jax_trainer(figure1_runs):
    got, want, pruns, jruns = figure1_runs
    _same_histories(pruns, jruns)
    # the plans ramp the batch: Seesaw takes fewer serial steps
    assert len({h["batch_size"] for h in pruns[1].history}) == 2
    g, w = dict(_rows(got)), dict(_rows(want))
    assert [n for n, _, _ in got] == [n for n, _, _ in want]
    for name in ("figure1/lm_step_reduction", "figure1/theory_risk_ratio",
                 "figure1/theory_step_reduction"):
        assert g[name] == w[name]
    assert float(g["figure1/lm_step_reduction"]) > 0


def test_figure6_lm_matches_jax_trainer(figure6_runs):
    """z-loss off and on under cosine, on under Seesaw: the loss and the
    ``ce_loss`` the figure reads, per step."""
    got, want, pruns, jruns = figure6_runs
    _same_histories(pruns, jruns, keys=("loss", "ce_loss"))
    assert [r.cfg.z_loss for r in pruns] == [0.0, 1e-4, 1e-4]
    assert all(np.isfinite(h["z_sq"]) for r in pruns for h in r.history)
    assert [n for n, _, _ in got] == [n for n, _, _ in want]
    assert len({h["batch_size"] for h in pruns[2].history}) == 3


def test_bench_harness(capsys, monkeypatch):
    """``python -m repro_torch.bench.run``: the reference's CSV and its
    suites in its order (``benchmarks/run.py``), an unknown suite
    refused, an ERROR row and exit code 1 for a suite that raises."""
    assert list(bench_run.SUITES) == ["figure1", "table1", "figure2",
                                      "figure3", "figure4", "figure5",
                                      "figure6", "lemma1", "engine",
                                      "serve"]
    assert bench_run.main(["--only", "lemma1", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert [ln.split(",")[0] for ln in lines[1:]] == \
        [n for n, _, _ in jl1.run()]
    with pytest.raises(KeyError):
        bench_run.main(["--only", "figure9"])

    def boom():
        raise RuntimeError("no")
    monkeypatch.setattr(pl1, "run", boom)
    monkeypatch.setattr(bench_run, "SUITES", {"lemma1": ("lemma1", False)})
    assert bench_run.main([]) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[1:] == ["lemma1/ERROR,0,RuntimeError:no"]


# --------------------------------------------------------------------- #
# the examples
# --------------------------------------------------------------------- #

def _reference_example(name):
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_linear_regression_equivalence_matches_reference(monkeypatch,
                                                         capsys):
    """The exact ratios bit for bit; the sampled SGD (the port's in torch
    float64) within 1e-9 relative, at the same serial steps."""
    ref = _reference_example("linear_regression_equivalence")
    ratios, risks = [], []

    class Recorder:
        def __getattr__(self, name):
            fn = getattr(JT, name)
            if not name.endswith("_risk_ratio"):
                return fn

            def wrapped(*a, **kw):
                ratios.append(fn(*a, **kw))
                return ratios[-1]
            return wrapped

    class Sampler(JSampler):
        def risk(self, w):
            risks.append(super().risk(w))
            return risks[-1]

    monkeypatch.setattr(ref, "T", Recorder())
    monkeypatch.setattr(ref, "LinearRegressionSampler", Sampler)
    ref.exact_recursions()
    ref.sampled_sgd()
    want_out = capsys.readouterr().out
    got_ratios = plr.exact_recursions()
    (r1, s1), (r2, s2) = plr.sampled_sgd(device="cpu")
    assert list(got_ratios) == ratios
    np.testing.assert_allclose([r1, r2], risks, rtol=1e-9, atol=0)
    assert (s1, s2) == (10000, 3875)
    got_out = capsys.readouterr().out
    assert got_out.splitlines()[:4] == want_out.splitlines()[:4]
    with pytest.raises(RuntimeError, match="CUDA"):
        if not torch.cuda.is_available():
            plr.main([])
        else:
            raise RuntimeError("CUDA present")


def test_lm_examples_run_on_the_cpu(monkeypatch, capsys):
    """quickstart, seesaw_vs_cosine_lm (reduced, and the 150M preset's
    run configs through ``paper_run`` and ``CBS``) and adaptive_seesaw,
    shortened, on the CPU."""
    h_cos, h_see = pqs.main(["--device", "cpu", "--steps", "12"])
    assert len(h_see) < len(h_cos) == 12
    res = psc.main(["--device", "cpu", "--steps", "6"])
    assert len(res["seesaw"]) <= len(res["cosine"]) == 6
    for kind in ("cosine", "seesaw"):
        cfg = psc.run_config("150m", kind, 20, 2.0, n_cuts=2)
        assert cfg.global_batch_size == PP.CBS["seesaw-150m"] == 256
        assert cfg.total_tokens == 5_242_880 and cfg.schedule.n_cuts == 2
        assert _fields(dataclasses.replace(
            cfg, total_tokens=0, schedule=dataclasses.replace(
                cfg.schedule, n_cuts=8))) == \
            _fields(PP.paper_run(PP.SEESAW_150M, kind=kind))
    monkeypatch.setattr(pad, "STEPS", 16)
    h_cos, h_see, h_ada, ctl = pad.main(["--device", "cpu"])
    assert len(h_ada) == 16 and ctl is not None
    out = capsys.readouterr().out
    assert "serial-step reduction" in out and "seesaw (adaptive)" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pqs.main(["--steps", "2"])
