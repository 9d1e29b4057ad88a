"""The port's compile cache (CUDA graphs on the card) against the JAX
package's, on the CPU.

On the card the engines capture one CUDA graph per key and replay it
(``tests/test_torch_card.py`` holds replays to the eager step bit for
bit); on the CPU each cache entry holds the eager step.  Either way the
bookkeeping is the reference's, and this file holds it to the
reference's over the same runs: the training step cache (one entry per
``(batch_size, micro)``; the reference keys ``(batch_size, micro, K)``
and pads tail chunks, so K never varies within a run), the serving
engine's executable counts, and the in-place updates a graph needs: the
optimizer's step count and the pool's defrag keep their storage.  The LR
the card's graphs read is staged from ``chunk_lrs``'s host values, which
must be the plan's float32 bits at every step.

Tolerances: LRs, counts and pools exact; optimizer updates 1e-6 and
training losses 5e-4 per step, as in ``tests/test_torch_train.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import OptimizerConfig as JOptimizerConfig
from repro.configs import RunConfig as JRunConfig
from repro.configs import ScheduleConfig as JScheduleConfig
from repro.configs.base import ModelConfig as JModelConfig
from repro.data import MarkovLM as JMarkovLM
from repro.data import PhaseDataLoader as JLoader
from repro.models import registry as JR
from repro.optim import optimizers as JO
from repro.serving import GenerationRequest as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving import cache as JSC
from repro.train import engine as JE
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs import (ModelConfig, OptimizerConfig, RunConfig,
                                 ScheduleConfig)
from repro_torch.data import MarkovLM, PhaseDataLoader
from repro_torch.optim import optimizers as O
from repro_torch.serving import GenerationRequest, PagePool, ServingEngine
from repro_torch.train import engine as E
from repro_torch.train.trainer import Trainer
from repro_torch.weights import from_jax_params

TINY = dict(name="graphs-tiny", arch_type="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
            max_seq_len=64, rope_theta=1e4)
SEQ, B0, MAX_DEVICE_BATCH = 16, 2, 4


def _ramp_cfg(ours: bool):
    """A 3-cut Seesaw ramp, B = 2 / 4 / (8) / 16 over 21 / 2 / 0 / 1
    steps: at fuse_steps 4 the B=2 run ends in a 1-step tail chunk, and
    the B=4 and B=16 chunks are tails; B=16 accumulates 4
    micro-batches."""
    C, Sch, Opt, Run = ((ModelConfig, ScheduleConfig, OptimizerConfig,
                         RunConfig) if ours else
                        (JModelConfig, JScheduleConfig, JOptimizerConfig,
                         JRunConfig))
    return Run(model=C(**TINY),
               schedule=Sch(kind="seesaw", base_lr=1e-3, alpha=2.0,
                            n_cuts=3),
               optimizer=Opt(), seq_len=SEQ, global_batch_size=B0,
               total_tokens=SEQ * B0 * 30, dtype="float32", remat=False)


@pytest.fixture(scope="module")
def ramps():
    """For fuse_steps 1 and 4: the reference's Trainer and the port's on
    its weights, each run through the whole plan."""
    out = {}
    for k in (1, 4):
        jtr = JTrainer(_ramp_cfg(False), fuse_steps=k,
                       max_device_batch=MAX_DEVICE_BATCH)
        tr = Trainer(_ramp_cfg(True), device="cpu", fuse_steps=k,
                     max_device_batch=MAX_DEVICE_BATCH)
        model = from_jax_params(jax.tree.map(np.asarray, jtr.state.params),
                                tr.cfg.model, dtype=torch.float32,
                                device="cpu")
        tr.state.model.load_state_dict(model.state_dict())
        jtr.run(JLoader(JMarkovLM(128, seed=0), jtr.plan, SEQ))
        tr.run(PhaseDataLoader(MarkovLM(128, seed=0), tr.plan, SEQ,
                               device="cpu"))
        out[k] = (jtr, tr)
    return out


@pytest.mark.parametrize("fuse_steps", [1, 4])
def test_step_cache_keys_match_jax_trainer(ramps, fuse_steps):
    jtr, tr = ramps[fuse_steps]
    plan = tr.plan
    assert plan.steps_per_phase(SEQ) == [21, 2, 0, 1]
    chunks = [n for _, _, n in PhaseDataLoader(
        MarkovLM(128, seed=0), plan, SEQ, device="cpu").iter_chunks(
            fuse_steps)]
    if fuse_steps > 1:                  # tail chunks ran and added no key
        assert any(n < fuse_steps for n in chunks)
    want = {(b, tr.engine.micro_batches(b)) for b, n in
            zip(plan.batch_sizes(), plan.steps_per_phase(SEQ)) if n}
    assert want == {(2, 1), (4, 1), (16, 4)}
    assert tr._step_cache is tr.engine._cache
    assert set(tr._step_cache) == want
    assert {(b, m) for b, m, _ in jtr._step_cache} == want
    assert {k for _, _, k in jtr._step_cache} == {fuse_steps}
    assert len(tr._step_cache) == len(jtr._step_cache) == 3


def test_ramp_runs_match_jax_step_for_step(ramps):
    """The runs the cache counts are the reference's, step for step, and
    fusing does not change the port's."""
    for jtr, tr in ramps.values():
        assert len(tr.history) == len(jtr.history) == 24
        for a, b in zip(tr.history, jtr.history):
            assert (a["step"], a["tokens"], a["batch_size"], a["phase"]) == \
                (b["step"], b["tokens"], b["batch_size"], b["phase"])
            assert np.float32(a["lr"]) == np.float32(b["lr"])
            assert abs(a["loss"] - b["loss"]) < 5e-4
    h1, h4 = ramps[1][1].history, ramps[4][1].history
    assert [[r[k] for k in ("lr", "loss", "grad_norm")] for r in h1] == \
        [[r[k] for k in ("lr", "loss", "grad_norm")] for r in h4]


@pytest.mark.parametrize("fuse_steps", [1, 4])
def test_staged_lrs_are_the_plan_bits(fuse_steps):
    """``chunk_lrs`` — the host values the card's graphs read from their
    staged LR tensor — equal the port's and the reference's
    ``plan_lr_fn`` in float32 bits at every step of the ramp, tail chunks
    included, by step index and by tokens alone."""
    tr = Trainer(_ramp_cfg(True), device="cpu", fuse_steps=fuse_steps)
    jtr = JTrainer(_ramp_cfg(False), fuse_steps=fuse_steps)
    lr, jlr = E.plan_lr_fn(tr.plan, SEQ), JE.plan_lr_fn(jtr.plan, SEQ)
    loader = PhaseDataLoader(MarkovLM(128, seed=0), tr.plan, SEQ,
                             device="cpu")
    step, tok, n_steps = 0, 0, 0
    for phase, stacked, n in loader.iter_chunks(fuse_steps):
        tps = phase.batch_size * SEQ
        for step0 in (step, -1):
            got = E.chunk_lrs(lr, tok, step0, n, tps)
            assert got.dtype == torch.float32 and got.shape == (n,)
            for i in range(n):
                s = -1 if step0 < 0 else step0 + i
                want = np.float32(lr(float(tok + i * tps), s))
                jwant = np.float32(jlr(jnp.float32(tok + i * tps), s))
                assert got[i].numpy().view(np.int32) == \
                    want.view(np.int32) == jwant.view(np.int32), (step, i)
        step, tok, n_steps = step + n, tok + n * tps, n_steps + n
    assert n_steps == tr.plan.total_steps(SEQ)


OPTIMIZERS = [(lambda m: m.adamw(weight_decay=0.1), "adamw"),
              (lambda m: m.sgd(momentum=0.9, grad_clip=1.0), "sgd"),
              (lambda m: m.nsgd(), "nsgd")]


@pytest.mark.parametrize("make,name", OPTIMIZERS,
                         ids=[n for _, n in OPTIMIZERS])
def test_optimizer_count_advances_in_place(make, name):
    """The step count is one tensor for the whole run, advanced in place
    (a graph captured over the state reads it at every replay), and the
    updates stay with the reference's step for step."""
    rng = np.random.default_rng(7)
    shapes = {"a": (6, 5), "b": (9,)}
    p0 = {n: rng.standard_normal(s).astype(np.float32)
          for n, s in shapes.items()}
    opt, jopt = make(O), make(JO)
    params = {n: torch.from_numpy(a.copy()) for n, a in p0.items()}
    state = opt.init(params)
    count = state["count"]
    ptr = count.data_ptr()
    jparams = {n: jnp.asarray(a) for n, a in p0.items()}
    jstate = jopt.init(jparams)
    for step, lr in enumerate((1e-2, 3e-3, 1e-3), start=1):
        g = {n: (0.4 * rng.standard_normal(s)).astype(np.float32)
             for n, s in shapes.items()}
        params, state = opt.update({n: torch.from_numpy(a)
                                    for n, a in g.items()}, state, params,
                                   torch.tensor(lr, dtype=torch.float32))
        jparams, jstate = jopt.update({n: jnp.asarray(a)
                                       for n, a in g.items()}, jstate,
                                      jparams, jnp.float32(lr))
        assert state["count"] is count and count.data_ptr() == ptr
        assert int(count) == int(jstate["count"]) == step
        for n in shapes:
            np.testing.assert_allclose(params[n].numpy(),
                                       np.asarray(jparams[n]), atol=1e-6,
                                       rtol=0, err_msg=f"{n} step {step}")


def test_defrag_keeps_the_pool_storage():
    """Defrag permutes the pool in place: a decode graph captured before
    it reads the compacted pool.  Pages and tables as the reference's."""
    cfg, jcfg = ModelConfig(**TINY), JModelConfig(**TINY)
    ours = PagePool(cfg, 9, 4, dtype=torch.float32, device="cpu")
    ref = JSC.PagePool(jcfg, 9, 4, dtype=jnp.float32)
    data = np.random.default_rng(8).standard_normal(
        tuple(ours.kv.shape)).astype(np.float32)
    ours.kv.copy_(torch.from_numpy(data))
    ref.kv = jnp.asarray(data)
    a, b, c = (ours.alloc(2), ours.alloc(3), ours.alloc(2))
    assert (a, b, c) == (ref.alloc(2), ref.alloc(3), ref.alloc(2))
    ours.free(a)
    ref.free(a)
    kv, ptr = ours.kv, ours.kv.data_ptr()
    t_ours, t_ref = [list(c), list(b)], [list(c), list(b)]
    ours.defrag(t_ours)
    ref.defrag(t_ref)
    assert ours.kv is kv and ours.kv.data_ptr() == ptr
    assert t_ours == t_ref and ours._free == ref._free
    np.testing.assert_array_equal(ours.kv.numpy(), np.asarray(ref.kv))


SERVE = dict(decode_slots=2, page_size=4, max_len=32)


@pytest.fixture(scope="module")
def serve_pair():
    jcfg = JModelConfig(**dict(TINY, vocab_size=256))
    params = JR.init_params(jax.random.PRNGKey(1), jcfg)
    cfg = ModelConfig(**dict(TINY, vocab_size=256))
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            dtype=torch.float32, device="cpu")
    return (JEngine(jcfg, params, dtype=jnp.float32, **SERVE),
            ServingEngine(cfg, model, dtype=torch.float32, **SERVE))


def _counts(eng):
    return (eng.n_prefill_executables, eng.n_decode_executables,
            eng.executables, eng.executable_budget)


def _wave(engs, seed, sizes, max_new):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 256, (s,)).astype(np.int32) for s in sizes]
    got = []
    for eng, Req in zip(engs, (JRequest, GenerationRequest)):
        for p, n in zip(prompts, max_new):
            eng.submit(Req(prompt=p, max_new_tokens=n))
        got.append({r.rid: r.tokens.tolist() for r in eng.drain()})
    assert got[0] == got[1]


def test_serving_executables_match_jax_engine(serve_pair):
    """The reference's compile invariant, counted as the reference counts
    it over the same ragged request mix: one prefill entry per bucket
    used, one decode entry, never more than the budget; prompts within
    one bucket share its entry, and ``reset()`` keeps the entries."""
    engs = serve_pair
    assert engs[1].buckets == engs[0].buckets == (16, 32)
    _wave(engs, 0, [3, 9, 17, 5, 12], [6, 4, 8, 10, 5])
    assert _counts(engs[1]) == _counts(engs[0]) == (2, 1, 3, 3)
    for eng in engs:
        eng.reset()
    # lengths 2..13 all fall in the 16-bucket
    _wave(engs, 2, [2, 5, 9, 13], [2, 2, 2, 2])
    assert _counts(engs[1]) == _counts(engs[0]) == (2, 1, 3, 3)
    for eng in engs:
        assert eng.done and eng.pool.n_used == 0
        assert eng.executables <= eng.executable_budget
