"""The port's adaptive Seesaw against the JAX package, on the CPU.

The plan's live extension (``SeesawPlan.extend_at``) and the adaptive
``build_plan``, case for case against the reference's
``TestPlanExtension``; the plateau controller fed the same loss and EMA
streams as the reference's (the same cuts, an equal ``state_dict`` at
every step); the adaptive plan's host LR against the reference's LR over
its runtime table at every token and step; then the reference's adaptive
run of ``tests/test_adaptive_engine.py`` (TINY, ``KNOBS``, float32)
through both trainers from the same weights:
the same cut steps, LR ÷√α and batch ×α at each cut, the loss within
5e-4, one step-cache entry per ``(batch_size, micro)``, the EMA the
host's float32 recursion, and resumes between two cuts — the port's own
bit for bit, the reference's checkpoint in the port with the same
remaining cuts.
"""
import dataclasses
import importlib.util
import math
import os
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import OptimizerConfig as JOptimizerConfig
from repro.configs import RunConfig as JRunConfig
from repro.configs import ScheduleConfig as JScheduleConfig
from repro.configs.base import ModelConfig as JModelConfig
from repro.core import schedules as JS
from repro.core import seesaw as JSS
from repro.core.adaptive import AdaptiveSeesaw as JAdaptiveSeesaw
from repro.data import MarkovLM as JMarkovLM
from repro.data import PhaseDataLoader as JLoader
from repro.optim import optimizers as JO
from repro.train import engine as JE
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs import (ModelConfig, OptimizerConfig, RunConfig,
                                 ScheduleConfig)
from repro_torch.core import seesaw as SS
from repro_torch.core.adaptive import AdaptiveSeesaw
from repro_torch.data import MarkovLM, PhaseDataLoader
from repro_torch.launch import train as launch_train
from repro_torch.optim import optimizers as O
from repro_torch.train import engine as E
from repro_torch.train.trainer import Trainer
from repro_torch.weights import from_jax_params

TINY = dict(name="tiny", arch_type="dense", n_layers=2, d_model=64,
            n_heads=2, n_kv_heads=2, head_dim=32, d_ff=128, vocab_size=128,
            max_seq_len=64, rope_theta=1e4)
SEQ, B0, STEPS = 32, 4, 360
KNOBS = dict(plateau_window=8, plateau_threshold=2e-2, ema_decay=0.9)
KEYS = ("step", "tokens", "lr", "batch_size", "phase", "loss", "grad_norm")



@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tiny models run thousands of small ops,
    which several test workers' thread pools on a shared CPU slow down
    many times over (and bit-for-bit comparisons need one thread count
    throughout)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _phases(plan):
    return [dataclasses.astuple(p) for p in plan.phases]


# --------------------------------------------------------------------- #
# the plan: extend_at and the adaptive build_plan
# --------------------------------------------------------------------- #

def _adaptive(pkg, b0=4, total=SEQ * B0 * STEPS):
    return pkg.build_plan(kind="adaptive-seesaw", base_lr=1e-2,
                          total_tokens=float(total), warmup_frac=0.02,
                          b0=b0, alpha=2.0)


CUT = 80 * B0 * SEQ
EXTENSIONS = {
    "single": [],
    "extend": [(CUT, None)],
    "chain": [(CUT, None), (CUT + 40 * 8 * SEQ, None)],
    "clamp": [(CUT, 6)],
    "clamp-chain": [(CUT, 6), (CUT + 40 * 6 * SEQ, 6)],
}


@pytest.mark.parametrize("cuts", EXTENSIONS.values(), ids=EXTENSIONS)
def test_extend_at_matches_reference(cuts):
    ours, theirs = _adaptive(SS), _adaptive(JSS)
    for cut, max_b in cuts:
        ours = ours.extend_at(cut, seq_len=SEQ, max_batch_size=max_b)
        theirs = theirs.extend_at(cut, seq_len=SEQ, max_batch_size=max_b)
    assert _phases(ours) == _phases(theirs)
    assert (ours.alpha, ours.beta, ours.kind, ours.total_tokens) == \
        (theirs.alpha, theirs.beta, theirs.kind, theirs.total_tokens)
    assert ours.steps_per_phase(SEQ) == theirs.steps_per_phase(SEQ)
    assert ours.alpha == pytest.approx(math.sqrt(2.0)) and ours.beta == 2.0
    if cuts:
        assert ours.phases[1].lr_scale == pytest.approx(1 / math.sqrt(2))
    for tok in range(0, int(ours.total_tokens), 7 * SEQ):
        assert ours.realized_phase_at(tok, SEQ).index == \
            theirs.realized_phase_at(tok, SEQ).index
        assert ours.phase_at_tokens(tok).index == \
            theirs.phase_at_tokens(tok).index


BAD_CUTS = {
    "off-step": ([], CUT + 7, "step boundary"),
    "past-end": ([], STEPS * B0 * SEQ + B0 * SEQ, "outside"),
    "closed-phase": ([CUT], 40 * B0 * SEQ, "outside"),
}


@pytest.mark.parametrize("before,cut,match", BAD_CUTS.values(),
                         ids=BAD_CUTS)
def test_bad_extension_raises_as_reference(before, cut, match):
    for pkg in (SS, JSS):
        plan = _adaptive(pkg)
        for c in before:
            plan = plan.extend_at(c, seq_len=SEQ)
        with pytest.raises(ValueError, match=match):
            plan.extend_at(cut, seq_len=SEQ)
        assert len(plan.phases) == len(before) + 1    # plans are values


@pytest.mark.parametrize("kind", ["step", "constant", "naive-ramp"])
def test_malformed_cuts_raise_for_every_kind(kind):
    kw = dict(kind=kind, base_lr=1.0, total_tokens=1e6, warmup_frac=0.1,
              b0=8, alpha=2.0, beta=2.0)
    for build in (SS.build_plan, JSS.build_plan):
        with pytest.raises(ValueError, match="increasing"):
            build(cut_tokens=[5e5, 3e5], **kw)
        with pytest.raises(ValueError, match="outside"):
            build(cut_tokens=[3e5, 2e6], **kw)
        with pytest.raises(ValueError, match="outside"):
            build(cut_tokens=[5e4], **kw)
    kw.update(kind="step", cut_tokens=[3e5, 6e5])
    assert _phases(SS.build_plan(**kw)) == _phases(JSS.build_plan(**kw))


def test_steps_per_phase_is_authoritative():
    kw = dict(kind="seesaw", base_lr=1.0, total_tokens=1e6,
              warmup_frac=0.1, b0=8, alpha=2.0, n_cuts=3)
    ours, theirs = SS.build_plan(**kw), JSS.build_plan(**kw)
    alloc = ours.steps_per_phase(128)
    assert alloc == theirs.steps_per_phase(128)
    # the reference's standalone per-phase estimate is within one step
    for ph, n in zip(theirs.phases, alloc):
        assert abs(ph.n_steps(128) - n) <= 1
    assert sum(alloc) == ours.total_steps(128) == theirs.total_steps(128)


# --------------------------------------------------------------------- #
# the controller on identical streams
# --------------------------------------------------------------------- #

def _loss_stream(n, floors):
    out, lvl = [], 1.0
    for f in floors:
        for _ in range(n):
            lvl = f + (lvl - f) * 0.97
            out.append(lvl)
    return out


# (knobs, loss stream, cuts ``observe`` fires: tests/test_cbs_adaptive.py)
STREAMS = {
    "one-plateau": (dict(window=20, min_steps_between=40),
                    _loss_stream(300, [0.5]), 1),
    "three-floors": (dict(window=10, min_steps_between=20),
                     _loss_stream(100, [0.5, 0.3, 0.25]), None),
    "flat-then-second": (dict(window=20, min_steps_between=20),
                         _loss_stream(400, [0.5])
                         + _loss_stream(400, [0.25]), 2),
    "improving": (dict(window=20, rel_threshold=1e-4),
                  [0.99 ** i for i in range(1, 201)], 0),
    "noisy": (dict(window=8, rel_threshold=2e-2, min_steps_between=8,
                   max_cuts=3),
              list(np.random.default_rng(0).normal(0, 0.02, 600)
                   + np.repeat([3.0, 2.5, 2.2, 2.1, 2.05, 2.0], 100)),
              None),
}


@pytest.mark.parametrize("smoothed", [False, True],
                         ids=["observe", "observe_smoothed"])
@pytest.mark.parametrize("knobs,stream,cuts", STREAMS.values(),
                         ids=STREAMS)
def test_controller_equals_reference_on_identical_streams(knobs, stream,
                                                          cuts, smoothed):
    """Every decision and the whole state after each one; the smoothed
    path gets 1-5 steps a chunk and a float32 EMA of the stream.  Halfway
    a fresh controller loads the reference's state and goes on equal."""
    ours, theirs = AdaptiveSeesaw(**knobs), JAdaptiveSeesaw(**knobs)
    rng = np.random.default_rng(1)
    ema, i, fired = np.float32(-1), 0, []
    while i < len(stream):
        if i >= len(stream) // 2 and not fired[-1:] == ["loaded"]:
            ours = AdaptiveSeesaw(**knobs).load_state_dict(
                theirs.state_dict())
            fired.append("loaded")
        if smoothed:
            n = int(rng.integers(1, 6))
            for x in stream[i:i + n]:
                x = np.float32(x)
                ema = x if ema < 0 else np.float32(
                    np.float32(0.9) * ema + np.float32(0.1) * x)
            n = len(stream[i:i + n])
            a = ours.observe_smoothed(float(ema), n)
            b = theirs.observe_smoothed(float(ema), n)
        else:
            n = 1
            a, b = ours.observe(stream[i]), theirs.observe(stream[i])
        assert a == b
        assert ours.state_dict() == theirs.state_dict()
        fired.append(a)
        i += n
    assert ours.cut_steps == theirs.cut_steps
    assert ours.lr_scale == theirs.lr_scale == \
        math.sqrt(knobs.get("alpha", 2.0)) ** -ours.n_cuts
    assert ours.batch_multiplier == theirs.batch_multiplier
    if cuts is not None and not smoothed:
        assert ours.n_cuts == cuts


# --------------------------------------------------------------------- #
# the adaptive LR over the runtime table
# --------------------------------------------------------------------- #

def test_adaptive_lr_equals_reference_at_every_token_and_step():
    """The port's LR of an extended adaptive plan (``plan_lr_fn``, on the
    host) against the reference's ``adaptive_piecewise_lr`` over the
    reference engine's runtime tables of the same plan, in float32 bits,
    by step and by tokens."""
    ours_cfg, theirs_cfg = _cfgs()
    ours, theirs = _adaptive(SS), _adaptive(JSS)
    for cut in (CUT, CUT + 40 * 8 * SEQ, CUT + 60 * 8 * SEQ):
        ours = ours.extend_at(cut, seq_len=SEQ)
        theirs = theirs.extend_at(cut, seq_len=SEQ)
    jeng = JE.PhaseEngine(theirs_cfg, JO.adamw(), _adaptive(JSS))
    jeng.update_plan(theirs)
    tables = jeng._lr_tables()
    theirs_lr = JS.adaptive_piecewise_lr(theirs.base_lr,
                                         theirs.warmup_tokens)
    lr = E.plan_lr_fn(ours, SEQ)
    rng = np.random.default_rng(2)
    top = float(ours.total_tokens)
    cuts = list(np.cumsum(ours.steps_per_phase(SEQ))[:-1])
    for tok in np.concatenate([np.linspace(0, top, 300),
                               rng.uniform(0, top, 200)]):
        for step in [-1, 0, 500] + [c + d for c in cuts for d in (-1, 0)]:
            assert np.float32(lr(float(tok), step)) == np.float32(
                theirs_lr(float(tok), step, *tables)), (tok, step)


def _cfgs(**kw):
    common = dict(seq_len=SEQ, global_batch_size=B0,
                  total_tokens=SEQ * B0 * STEPS, remat=False,
                  log_every=1000, dtype="float32", **kw)
    sch = dict(kind="adaptive-seesaw", base_lr=1e-2, warmup_frac=0.02,
               alpha=2.0, n_cuts=4, **KNOBS)
    ours = RunConfig(model=ModelConfig(**TINY),
                     schedule=ScheduleConfig(**sch),
                     optimizer=OptimizerConfig(kind="adamw"), **common)
    theirs = JRunConfig(model=JModelConfig(**TINY),
                        schedule=JScheduleConfig(**sch),
                        optimizer=JOptimizerConfig(kind="adamw"), **common)
    return ours, theirs


@pytest.mark.parametrize("max_b", [None, 8])
def test_engine_lr_table_and_host_lr_match_reference(max_b):
    """The engine's host LR of an extended plan (a clamped ramp too: the
    third phase only cuts the LR) at every step of it, against the
    reference engine's LR over its runtime table."""
    ours_cfg, theirs_cfg = _cfgs()
    ours, theirs = _adaptive(SS), _adaptive(JSS)
    for cut in (CUT, CUT + 40 * 8 * SEQ):
        ours = ours.extend_at(cut, seq_len=SEQ, max_batch_size=max_b)
        theirs = theirs.extend_at(cut, seq_len=SEQ, max_batch_size=max_b)
    eng = E.PhaseEngine(ours_cfg, O.adamw(), _adaptive(SS))
    jeng = JE.PhaseEngine(theirs_cfg, JO.adamw(), _adaptive(JSS))
    eng.update_plan(ours)
    jeng.update_plan(theirs)
    tok = 0
    for step in range(ours.total_steps(SEQ)):
        ph = ours.realized_phase_at(tok, SEQ)
        for st in (step, None):
            assert np.float32(eng.host_lr(tok, st)) == \
                np.float32(jeng.host_lr(tok, st))
        tok += ph.batch_size * SEQ
    with pytest.raises(ValueError, match="only valid for adaptive"):
        E.PhaseEngine(ours_cfg, O.adamw(), SS.build_plan(
            kind="seesaw", base_lr=1.0, total_tokens=1e5, warmup_frac=0.1,
            b0=4)).update_plan(ours)


# --------------------------------------------------------------------- #
# the adaptive TINY run, in both packages
# --------------------------------------------------------------------- #

def _loader(tr, tokens=0):
    return PhaseDataLoader(MarkovLM(128, seed=0), tr.plan, SEQ,
                           device="cpu").resume(tokens)


def _save_between_cuts(tr, path, after=16):
    """A ``stop_fn`` that saves (never stops) at the chunk boundary
    ``after`` steps past the first cut: a checkpoint between cuts, taken
    where a periodic save would be."""
    def hook():
        cuts = tr.controller.cut_steps
        if len(cuts) == 1 and tr.state.step == cuts[0] + after:
            tr.save_checkpoint(path)
        return False
    return hook


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("adaptive")
    ours_cfg, theirs_cfg = _cfgs()
    jtr = JTrainer(theirs_cfg, fuse_steps=4)
    tr = Trainer(ours_cfg, device="cpu", fuse_steps=4)
    model = from_jax_params(jax.tree.map(np.asarray, jtr.state.params),
                            ours_cfg.model, dtype=torch.float32,
                            device="cpu")
    tr.state.model.load_state_dict(model.state_dict())
    init = {k: v.clone() for k, v in tr.state.model.state_dict().items()}
    jpath, tpath = str(d / "jax"), str(d / "port")
    jtr.run(JLoader(JMarkovLM(128, seed=0), jtr.plan, SEQ),
            stop_fn=_save_between_cuts(jtr, jpath))
    tr.run(_loader(tr), stop_fn=_save_between_cuts(tr, tpath))
    return dict(jtr=jtr, tr=tr, init=init, jpath=jpath, tpath=tpath,
                cfg=ours_cfg)


def test_cuts_and_run_match_reference(runs):
    jtr, tr = runs["jtr"], runs["tr"]
    assert tr.controller.cut_steps == jtr.controller.cut_steps
    assert len(tr.controller.cut_steps) >= 2
    assert tr.cut_tokens == jtr.cut_tokens
    assert _phases(tr.plan) == _phases(jtr.plan)
    # the controllers differ only in the float of the last window's EMA
    ours, theirs = tr.controller.state_dict(), jtr.controller.state_dict()
    assert ours.pop("prev_window_mean") == pytest.approx(
        theirs.pop("prev_window_mean"), abs=5e-4)
    assert ours == theirs
    assert len(tr.history) == len(jtr.history)
    for a, b in zip(tr.history, jtr.history):
        assert (a["step"], a["tokens"], a["batch_size"], a["phase"]) == \
            (b["step"], b["tokens"], b["batch_size"], b["phase"])
        # in the warmup the reference's jitted step folds the division by
        # warmup_tokens: 1 ulp from its own eager adaptive_piecewise_lr,
        # which the port's host LR equals (the test above); past it, equal
        start = a["tokens"] - a["batch_size"] * SEQ
        np.testing.assert_array_max_ulp(
            np.float32(a["lr"]), np.float32(b["lr"]),
            1 if start < tr.plan.warmup_tokens else 0)
        assert abs(a["loss"] - b["loss"]) < 5e-4
    assert abs(tr.state.loss_ema - jtr.state.loss_ema) < 5e-4


def test_each_cut_cuts_the_lr_by_sqrt_alpha_and_doubles_the_batch(runs):
    tr = runs["tr"]
    assert [p.batch_size for p in tr.plan.phases] == \
        [B0 * 2 ** i for i in range(tr.controller.n_cuts + 1)]
    hist = {h["step"]: h for h in tr.history}
    toks = {s: h["tokens"] for s, h in hist.items()}
    assert tr.cut_tokens == [toks[s] for s in tr.controller.cut_steps]
    for s in tr.controller.cut_steps:
        assert s % 4 == 0                       # a chunk boundary
        assert hist[s + 1]["lr"] == pytest.approx(
            hist[s]["lr"] / math.sqrt(2.0), rel=1e-6)
        assert hist[s + 1]["batch_size"] == 2 * hist[s]["batch_size"]
        assert hist[s + 1]["phase"] == hist[s]["phase"] + 1


def test_one_cache_entry_per_batch_size_and_micro(runs):
    tr = runs["tr"]
    sizes = {h["batch_size"] for h in tr.history}
    assert sorted(tr._step_cache) == sorted((b, 1) for b in sizes)
    assert len(sizes) == tr.controller.n_cuts + 1 >= 3


def test_device_ema_matches_host_recursion(runs):
    """The carried EMA is the float32 recursion over the per-step losses,
    bit for bit, and a host controller fed it at the same chunk
    boundaries fires at the same steps."""
    tr = runs["tr"]
    decay = np.float32(KNOBS["ema_decay"])
    one_minus = np.float32(np.float32(1.0) - decay)
    ema, ema_at = None, {}
    for i, h in enumerate(tr.history):
        loss = np.float32(h["loss"])
        ema = loss if ema is None else np.float32(
            np.float32(decay * ema) + np.float32(one_minus * loss))
        ema_at[i + 1] = ema
    assert float(ema) == tr.state.loss_ema
    sch = tr.cfg.schedule
    ctl = AdaptiveSeesaw(alpha=sch.alpha, window=sch.plateau_window,
                         rel_threshold=sch.plateau_threshold,
                         max_cuts=sch.n_cuts,
                         min_steps_between=sch.plateau_window)
    # the chunk boundaries: every 4 steps (each cut is one, and the
    # re-chunked stream counts 4 from it) and the run's end
    prev = 0
    for b in list(range(4, len(tr.history), 4)) + [len(tr.history)]:
        ctl.observe_smoothed(float(ema_at[b]), b - prev)
        prev = b
    assert ctl.cut_steps == tr.controller.cut_steps


def test_fused_matches_eager_cut_for_cut(runs):
    ours_cfg, _ = _cfgs()
    eager = Trainer(ours_cfg, device="cpu", fuse_steps=1)
    eager.state.model.load_state_dict(runs["init"])
    eager.run(_loader(eager))
    tr = runs["tr"]
    assert eager.controller.cut_steps == tr.controller.cut_steps
    assert eager.cut_tokens == tr.cut_tokens
    assert [[h[k] for k in KEYS] for h in eager.history] == \
        [[h[k] for k in KEYS] for h in tr.history]
    for a, b in zip(eager.state.model.parameters(),
                    tr.state.model.parameters()):
        assert torch.equal(a, b)


def test_resume_between_cuts_is_bitwise(runs):
    """A fresh trainer rebuilds the extended plan from the saved cut
    tokens, reloads the controller mid-window and the carried EMA, fires
    the remaining cuts at the same steps and ends on the same bits."""
    ref = runs["tr"]
    cuts = ref.controller.cut_steps
    tr2 = Trainer(runs["cfg"], device="cpu", fuse_steps=4)
    meta = tr2.restore_checkpoint(runs["tpath"], verify=True)
    mid = cuts[0] + 16
    assert cuts[0] < mid < cuts[1] and meta["step"] == mid
    assert tr2.controller.cut_steps == [cuts[0]]
    assert tr2.controller.steps == mid
    assert [p.batch_size for p in tr2.plan.phases] == [4, 8]
    tr2.run(_loader(tr2, tr2.state.tokens_seen))
    assert tr2.controller.cut_steps == cuts
    assert tr2.cut_tokens == ref.cut_tokens
    assert tr2.controller.state_dict() == ref.controller.state_dict()
    assert [[h[k] for k in KEYS] for h in tr2.history] == \
        [[h[k] for k in KEYS] for h in ref.history[mid:]]
    assert tr2.state.loss_ema == ref.state.loss_ema
    for a, b in zip(tr2.state.model.parameters(),
                    ref.state.model.parameters()):
        assert torch.equal(a, b)


def test_jax_adaptive_checkpoint_resumes_in_the_port(runs):
    jtr = runs["jtr"]
    tr2 = Trainer(runs["cfg"], device="cpu", fuse_steps=4)
    meta = tr2.restore_checkpoint(runs["jpath"], verify=True)
    mid = jtr.controller.cut_steps[0] + 16
    assert meta["step"] == mid
    assert tr2.controller.state_dict()["cut_steps"] == \
        jtr.controller.cut_steps[:1]
    tr2.run(_loader(tr2, tr2.state.tokens_seen))
    assert tr2.controller.cut_steps == jtr.controller.cut_steps
    assert tr2.cut_tokens == jtr.cut_tokens
    rest = jtr.history[mid:]
    assert len(tr2.history) == len(rest)
    for a, b in zip(tr2.history, rest):
        assert (a["step"], a["batch_size"], a["phase"]) == \
            (b["step"], b["batch_size"], b["phase"])
        assert np.float32(a["lr"]) == np.float32(b["lr"])
        assert abs(a["loss"] - b["loss"]) < 5e-4


def test_prescheduled_checkpoint_rejected(runs, tmp_path):
    cfg = RunConfig(model=ModelConfig(**TINY),
                    schedule=ScheduleConfig(kind="seesaw", base_lr=1e-3,
                                            alpha=2.0, n_cuts=2),
                    optimizer=OptimizerConfig(kind="adamw"), seq_len=SEQ,
                    global_batch_size=B0, total_tokens=SEQ * B0 * 40,
                    remat=False)
    tr = Trainer(cfg, device="cpu")
    tr.run(_loader(tr), max_steps=8)
    path = str(tmp_path / "sched")
    tr.save_checkpoint(path)
    tr2 = Trainer(runs["cfg"], device="cpu", fuse_steps=4)
    before = [p.clone() for p in tr2.state.model.parameters()]
    with pytest.raises(ValueError, match="no adaptive"):
        tr2.restore_checkpoint(path)
    assert all(torch.equal(a, b) for a, b in
               zip(before, tr2.state.model.parameters()))


def test_host_replay_of_the_controller_gives_the_runs_cuts(runs):
    """``chip_smoke.py``'s ``controller_replay``, which tells a moved
    plateau decision from a fault in phase 10b: over the run's own
    losses it gives the trainer's cut steps, and the run's threshold lies
    in the band of thresholds it reports for them."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir,
                                   "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    tr = runs["tr"]
    sch = dataclasses.asdict(runs["cfg"].schedule)
    cuts, gains, (lo, hi) = smoke.controller_replay(
        [h["loss"] for h in tr.history], sch, 4)
    assert cuts == tr.controller.cut_steps
    assert [s for s, _ in gains][:2] == [2 * KNOBS["plateau_window"],
                                         3 * KNOBS["plateau_window"]]
    assert lo < KNOBS["plateau_threshold"] <= hi


def test_adaptive_phase_mismatch_leaves_the_trainer(runs):
    """A checkpoint whose cuts put the step in another phase of this
    trainer's plan (B0 8 where it was saved at 4) is refused before the
    plan, the controller, the loss EMA or any tensor changes."""
    cfg = dataclasses.replace(runs["cfg"], global_batch_size=2 * B0)
    tr = Trainer(cfg, device="cpu", fuse_steps=4)
    tr.run(_loader(tr), max_steps=4)
    before = dict(
        params=[p.clone() for p in tr.state.model.parameters()],
        m=[t.clone() for t in tr.state.opt_state["m"].values()],
        plan=_phases(tr.plan), engine_plan=_phases(tr.engine.plan),
        lr=tr.engine.host_lr(CUT), ctrl=tr.controller.state_dict(),
        cuts=list(tr.cut_tokens), ema=tr.state.loss_ema,
        pos=(tr.state.step, tr.state.tokens_seen))
    with pytest.raises(ValueError, match="saved in phase"):
        tr.restore_checkpoint(runs["tpath"], verify=True)
    after = dict(
        params=list(tr.state.model.parameters()),
        m=list(tr.state.opt_state["m"].values()),
        plan=_phases(tr.plan), engine_plan=_phases(tr.engine.plan),
        lr=tr.engine.host_lr(CUT), ctrl=tr.controller.state_dict(),
        cuts=list(tr.cut_tokens), ema=tr.state.loss_ema,
        pos=(tr.state.step, tr.state.tokens_seen))
    for k in ("params", "m"):
        assert all(torch.equal(a, b) for a, b in zip(before.pop(k),
                                                     after.pop(k)))
    assert before == after


# --------------------------------------------------------------------- #
# the loader's rechunk and the launcher
# --------------------------------------------------------------------- #

def _prefetch_threads():
    return {t for t in threading.enumerate()
            if t.name == "loader-prefetch" and t.is_alive()}


def test_rechunk_stops_the_superseded_stream(runs):
    """Closing a stream superseded by ``rechunk`` ends its sampling
    thread (it would keep sampled batches alive), as the trainer's run
    loop does at each cut, and the new stream starts on the cut, on the
    sequences the old plan would have fed."""
    assert runs["tr"].controller.n_cuts >= 2
    assert not _prefetch_threads()            # the trainer's cuts left none
    plan = _adaptive(SS)
    lo = PhaseDataLoader(MarkovLM(128, seed=0), plan, SEQ, device="cpu",
                         prefetch=2)
    old = lo.iter_chunks(4)
    for _ in range(3):
        next(old)
    threads = _prefetch_threads()
    assert threads
    cut = 12 * B0 * SEQ
    lo.rechunk(plan.extend_at(cut, seq_len=SEQ), cut)
    old.close()
    assert not any(t.is_alive() for t in threads)
    assert list(old) == []                         # closed: ended
    new = lo.iter_chunks(4)
    phase, chunk, m = next(new)
    new.close()
    assert not _prefetch_threads()
    assert (phase.index, chunk["tokens"].shape[1], m) == (1, 8, 4)
    want = MarkovLM(128, seed=0).sample(12 * B0, 8, SEQ)["tokens"]
    np.testing.assert_array_equal(chunk["tokens"][0].numpy(), want)


def test_launcher_runs_adaptive_seesaw(capsys):
    hist = launch_train.main([
        "--device", "cpu", "--reduced", "--seq-len", "16", "--batch-size",
        "2", "--total-tokens", str(16 * 2 * 400), "--steps", "48",
        "--fuse-steps", "4", "--schedule", "adaptive-seesaw",
        "--plateau-window", "4", "--plateau-threshold", "0.5",
        "--ema-decay", "0.5", "--max-cuts", "2"])
    out = capsys.readouterr().out
    assert "schedule=adaptive-seesaw phases=1 " in out
    assert "adaptive cuts at steps" in out
    assert [h["step"] for h in hist] == list(range(1, 49))
    assert all(np.isfinite(h["loss"]) for h in hist)
