"""The port's Mamba-2 serving slice against the JAX package, on the CPU.

The same numpy inputs and weights go through the reference and through
its port: the recurrent ``ssd_step``, ``mixer_decode``, the exact-length
``prefill`` (logits, the SSD states and the conv tails) and
``decode_step`` through the registry's ``DenseKVCache``, the state
pool's scatter, gather and allocator, and the whole slice: the
reference's weights loaded through ``from_jax_params`` into the port's
``ServingEngine`` in ``"state"`` mode, which must emit the reference
engine's greedy tokens step for step in float32 under admit and evict,
with pools equal within 1e-5 outside row 0 (the null row, which takes
the inactive slots' colliding writes).  Two configs: the reduced
mamba2-2.7b (2 layers, d=256, 8 heads of 64, d_state 16, chunk 32) and
the reference serving test's ``SSM_CFG`` shape (d=32, 4 heads of 16,
d_state 16, chunk 16).  Tolerance 1e-5 (``docs/kernels.md``).

Prompts shorter than d_conv − 1 = 3 are not held to the reference: its
``prefill`` keeps fewer conv rows than the state holds, so at S = 2 its
``scatter_state`` raises and at S = 1 it broadcasts one row into every
conv slot.  The port pads the missing rows with zeros, as the causal conv
does; there its engine is held to its own full-sequence greedy.  The
card's path (kernels faked by their plain versions) is held to its
launch counts, and ``tests/test_torch_card.py`` runs the engine on the
card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import SSMConfig as JSSMConfig
from repro.models import mamba2 as JM
from repro.models import registry as JR
from repro.serving import GenerationRequest as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving import cache as JSC
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels import backend as KB
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels import ssd as SSD
from repro_torch.launch import serve as launch_serve
from repro_torch.models import mamba2 as M
from repro_torch.models.layers import lm_head_matrix
from repro_torch.models import registry as R
from repro_torch.serving import (DenseKVCache, GenerationRequest, PagePool,
                                 ServingEngine)
from repro_torch.serving import cache as SC
from repro_torch.weights import from_jax_params

TOL = dict(atol=1e-5, rtol=1e-5)
SSM_SHAPE = dict(name="torch-serve-ssm", arch_type="ssm", n_layers=2,
                 d_model=32, n_heads=2, n_kv_heads=1, head_dim=8, d_ff=64,
                 vocab_size=64, max_seq_len=64, rope_theta=1e4)
SSM_KW = dict(d_state=16, d_conv=4, expand=2, head_dim=16, chunk_size=16)
ENGINE = dict(decode_slots=2, max_len=48)
PROMPTS = (3, 9, 17, 5, 9, 33)
MAX_NEW = (6, 4, 8, 10, 5, 7)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _configs(which):
    if which == "reduced":
        return (j_get_config("mamba2-2.7b").reduced(),
                get_config("mamba2-2.7b").reduced())
    return (JModelConfig(**SSM_SHAPE, ssm=JSSMConfig(**SSM_KW)),
            ModelConfig(**SSM_SHAPE, ssm=SSMConfig(**SSM_KW)))


_PAIRS = {}


def _pair(which):
    """The reference's config and weights, and the port's model loaded
    from them (float32, CPU); built once a config."""
    if which not in _PAIRS:
        jcfg, cfg = _configs(which)
        params = JR.init_params(jax.random.PRNGKey(2), jcfg)
        model = from_jax_params(_np_tree(params), cfg, dtype=torch.float32,
                                device="cpu")
        _PAIRS[which] = (jcfg, params, cfg, model)
    return _PAIRS[which]


@pytest.fixture(params=["reduced", "ssm_cfg"])
def pair(request):
    return _pair(request.param)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=what,
                               **TOL)


# --------------------------------------------------------------------- #
# the recurrent step and the mixer's decode
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("B,H,P,N", [(3, 4, 16, 16), (2, 8, 64, 16)])
def test_ssd_step_matches_jax(B, H, P, N):
    rng = np.random.default_rng(0)
    f = np.float32
    args = (rng.standard_normal((B, H, P, N)).astype(f),
            rng.standard_normal((B, H, P)).astype(f),
            np.log1p(np.exp(rng.standard_normal((B, H)))).astype(f),
            (-np.exp(0.3 * rng.standard_normal(H))).astype(f),
            rng.standard_normal((B, N)).astype(f),
            rng.standard_normal((B, N)).astype(f),
            np.full(H, 0.5, f))
    h, y = M.ssd_step(*(_t(a) for a in args))
    jh, jy = JM.ssd_step(*(jnp.asarray(a) for a in args))
    assert h.dtype == torch.float32 and h.shape == (B, H, P, N)
    _close(h, jh, "h")
    _close(y, jy, "y")


def test_mixer_decode_matches_jax(pair):
    jcfg, params, cfg, model = pair
    s, di, H, P, N = M._dims(cfg)
    rng = np.random.default_rng(1)
    B = 3
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    state = {"h": rng.standard_normal((B, H, P, N)).astype(np.float32),
             "conv": rng.standard_normal(
                 (B, s.d_conv - 1, di + 2 * N)).astype(np.float32)}
    pm = jax.tree.map(lambda a: a[1], params["layers"]["mixer"])
    jout, jst = JM.mixer_decode(pm, jnp.asarray(x),
                                {k: jnp.asarray(v) for k, v in state.items()},
                                0, jcfg)
    with torch.inference_mode():
        out, st = M.mixer_decode(model.layers[1].mixer, _t(x),
                                 {k: _t(v) for k, v in state.items()}, cfg)
    _close(out, jout, "out")
    _close(st["h"], jst["h"], "h")
    _close(st["conv"], jst["conv"], "conv")


# --------------------------------------------------------------------- #
# prefill and decode through the registry
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("S", ["3", "chunk", "2chunk", "ragged"])
def test_prefill_matches_jax(pair, S):
    """S = 3 (d_conv − 1: the shortest prompt the reference keeps whole
    conv tails for), a multiple of the chunk, two chunks, and a ragged
    S over several chunks."""
    jcfg, params, cfg, model = pair
    Q = cfg.ssm.chunk_size
    S = {"3": 3, "chunk": Q, "2chunk": 2 * Q, "ragged": 2 * Q + 13}[S]
    toks = _tokens(cfg, (2, S), S)
    jl, jc = JR.prefill(params, jcfg, jnp.asarray(toks, jnp.int32),
                        dtype=jnp.float32)
    with torch.inference_mode():
        logits, cache = R.prefill(model, cfg, _t(toks))
    assert isinstance(cache, DenseKVCache)
    assert cache.lengths.tolist() == [S, S] == np.asarray(jc.lengths).tolist()
    assert logits.shape == (2, 1, cfg.padded_vocab)
    _close(logits, jl, "logits")
    for k in ("h", "conv"):
        assert tuple(cache.data[k].shape) == jc.data[k].shape
        _close(cache.data[k], jc.data[k], k)


def test_decode_steps_match_jax(pair):
    """Prefill, then six greedy decode steps through ``DenseKVCache``:
    logits, the state and the lengths at every step."""
    jcfg, params, cfg, model = pair
    toks = _tokens(cfg, (3, 11), 4)
    jl, jc = JR.prefill(params, jcfg, jnp.asarray(toks, jnp.int32),
                        dtype=jnp.float32)
    with torch.inference_mode():
        logits, cache = R.prefill(model, cfg, _t(toks))
        for step in range(6):
            tok = np.asarray(jl).argmax(-1).astype(np.int32)   # (B, 1)
            assert np.array_equal(logits.argmax(-1).numpy(), tok)
            before = {k: v.clone() for k, v in cache.data.items()}
            logits, new = R.decode_step(model, cfg, cache, _t(tok).long())
            for k, v in cache.data.items():          # left as it was
                assert torch.equal(v, before[k])
            cache = new
            jl, jc = JR.decode_step(params, jcfg, jc, jnp.asarray(tok),
                                    dtype=jnp.float32)
            _close(logits, jl, f"logits, step {step}")
            for k in ("h", "conv"):
                _close(cache.data[k], jc.data[k], f"{k}, step {step}")
            assert cache.lengths.tolist() == [12 + step] * 3


def test_decode_step_checks_the_cache(pair):
    """A raw cache and the ragged prefill raise for Mamba-2; the dense
    family's contiguous cache, which raised before the dense Server was
    ported, now runs through the same three registry calls (held to JAX
    in ``tests/test_torch_server.py``), and its prefill needs a cap."""
    _, _, cfg, model = pair
    tok = torch.zeros(1, 1, dtype=torch.long)
    with pytest.raises(TypeError, match="PagedKVCache"):
        R.decode_step(model, cfg, {"h": None}, tok)
    dense = ModelConfig(name="d", arch_type="dense", n_layers=1, d_model=32,
                        n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64,
                        vocab_size=64, max_seq_len=64)
    dmodel = R.init_model(dense, dtype=torch.float32, device="cpu")
    empty = R.cache_struct(dense, 2, 8, dtype=torch.float32, device="cpu")
    assert {n: tuple(t.shape) for n, t in empty.items()} == \
        {"k": (1, 2, 8, 1, 16), "v": (1, 2, 8, 1, 16)}
    with pytest.raises(ValueError, match="cache_len_cap"):
        R.prefill(dmodel, dense, tok)
    with torch.inference_mode():
        _, dcache = R.prefill(dmodel, dense, tok, cache_len_cap=8)
        assert isinstance(dcache, DenseKVCache)
        logits, dcache = R.decode_step(dmodel, dense, dcache, tok)
    assert logits.shape == (1, 1, dense.padded_vocab)
    assert dcache.lengths.tolist() == [2]
    with pytest.raises(NotImplementedError,
                       match="ragged prefill needs full attention"):
        R.prefill_ragged(model, cfg, tok, torch.ones(1, dtype=torch.int32))


# --------------------------------------------------------------------- #
# the state pool
# --------------------------------------------------------------------- #

def _pool_np(kv):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in kv.items()}


def test_cache_struct_matches_jax(pair):
    jcfg, _, cfg, _ = pair
    got = R.cache_struct(cfg, 5, 99, dtype=torch.float32, device="cpu")
    want = JR.cache_struct(jcfg, 5, 99, jnp.float32)
    assert got.keys() == want.keys()
    for k in got:
        assert tuple(got[k].shape) == want[k].shape
        assert float(got[k].abs().max()) == 0.0
    assert got["h"].dtype == torch.float32
    assert R.cache_struct(cfg, 2, device="cpu")["conv"].dtype == \
        torch.bfloat16


def test_scatter_and_gather_state_match_jax(pair):
    jcfg, _, cfg, _ = pair
    rng = np.random.default_rng(5)
    shapes = {k: tuple(v.shape) for k, v in
              R.cache_struct(cfg, 7, device="cpu").items()}
    pool = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    state = {k: rng.standard_normal((s[0], 3) + s[2:]).astype(np.float32)
             for k, s in shapes.items()}
    rows = np.array([4, 1, 6])
    torch_pool = {k: _t(v) for k, v in pool.items()}
    out = SC.scatter_state(torch_pool, {k: _t(v) for k, v in state.items()},
                           _t(rows))
    assert out is torch_pool
    want = JSC.scatter_state({k: jnp.asarray(v) for k, v in pool.items()},
                             {k: jnp.asarray(v) for k, v in state.items()},
                             jnp.asarray(rows))
    for k in pool:
        np.testing.assert_array_equal(torch_pool[k].numpy(),
                                      np.asarray(want[k]))
    got = SC.gather_state(torch_pool, _t(np.array([6, 0, 4])))
    jgot = JSC.gather_state(want, jnp.asarray([6, 0, 4]))
    for k in pool:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(jgot[k]))


def test_state_pool_matches_jax(pair):
    jcfg, _, cfg, _ = pair
    with pytest.raises(ValueError, match="page_size must be 1"):
        PagePool(cfg, 4, 4, dtype=torch.float32, device="cpu",
                 kind="state")
    with pytest.raises(ValueError):
        JSC.PagePool(jcfg, 4, 4, kind="state")
    with pytest.raises(ValueError, match="unknown pool kind"):
        PagePool(cfg, 4, 1, dtype=torch.float32, device="cpu", kind="ring")
    ours = PagePool(cfg, 7, 1, dtype=torch.float32, device="cpu",
                    kind="state")
    ref_pool = JSC.PagePool(jcfg, 7, 1, dtype=jnp.float32, kind="state")
    assert ours.kind == ref_pool.kind == "state"
    for k, v in ours.kv.items():
        assert tuple(v.shape) == ref_pool.kv[k].shape
    assert ours.nbytes == sum(v.nbytes for v in ref_pool.kv.values())
    a, b = ours.alloc(2), ours.alloc(3)
    assert (a, b) == (ref_pool.alloc(2), ref_pool.alloc(3))
    ours.free(a)
    ref_pool.free(a)
    c = ours.alloc(1)
    assert c == ref_pool.alloc(1)
    cache = ours.cache(torch.tensor([[c[0]]]), torch.tensor([3]))
    assert cache.kind == "state" and cache.page_size == 1

    rng = np.random.default_rng(6)
    leaves = {k: id(v) for k, v in ours.kv.items()}
    for k, v in ours.kv.items():
        data = rng.standard_normal(tuple(v.shape)).astype(np.float32)
        v.copy_(_t(data))
        ref_pool.kv[k] = jnp.asarray(data)
    t_ours, t_ref = [list(b), list(c)], [list(b), list(c)]
    ours.defrag(t_ours)
    ref_pool.defrag(t_ref)
    assert t_ours == t_ref and ours._free == ref_pool._free
    want = _pool_np(ref_pool.kv)
    for k, v in ours.kv.items():
        assert id(v) == leaves[k]                 # the same storage
        np.testing.assert_array_equal(v.numpy(), want[k])
    ours.reset()
    assert ours.n_used == 0
    for k, v in ours.kv.items():
        assert id(v) == leaves[k] and float(v.abs().max()) == 0.0


# --------------------------------------------------------------------- #
# the whole slice: the port's engine against the reference's
# --------------------------------------------------------------------- #

def _engines(pair, **kw):
    jcfg, params, cfg, model = pair
    return (ServingEngine(cfg, model, dtype=torch.float32,
                          **dict(ENGINE, **kw)),
            JEngine(jcfg, params, dtype=jnp.float32, **dict(ENGINE, **kw)))


def _prompts(cfg, seed=0, sizes=PROMPTS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (s,)).astype(np.int32)
            for s in sizes]


def _submit_both(eng, j_eng, prompts, max_new, eos_id=None):
    for rid, (p, n) in enumerate(zip(prompts, max_new)):
        eng.submit(GenerationRequest(prompt=p, max_new_tokens=n,
                                     eos_id=eos_id, rid=rid))
        j_eng.submit(JRequest(prompt=p, max_new_tokens=n, eos_id=eos_id,
                              rid=rid))


def _pools_close(eng, j_eng):
    want = _pool_np(j_eng.pool.kv)
    for k, v in eng.pool.kv.items():
        np.testing.assert_allclose(v.numpy()[:, 1:], want[k][:, 1:],
                                   err_msg=k, **TOL)


def test_state_engine_matches_jax_engine(pair):
    """Six requests through 2 slots (queueing, admit and evict at every
    step): the same events step for step, the same pools (outside the
    null row) after every step, one prefill entry per distinct prompt
    length and one decode entry."""
    eng, j_eng = _engines(pair)
    cfg = pair[2]
    assert (eng.mode, eng.page_size, eng.pages_per_slot) == \
        (j_eng.mode, j_eng.page_size, j_eng.pages_per_slot) == ("state", 1, 1)
    assert eng.pool.kind == "state" and eng.pool.capacity == 2
    _submit_both(eng, j_eng, _prompts(cfg), MAX_NEW)
    n_steps = 0
    while not (eng.done and j_eng.done):
        assert eng.step() == j_eng.step(), f"step {n_steps}"
        _pools_close(eng, j_eng)
        n_steps += 1
        assert n_steps < 200
    for rid, n in enumerate(MAX_NEW):
        got, want = eng.result(rid), j_eng.result(rid)
        np.testing.assert_array_equal(got.tokens, want.tokens)
        assert got.finish_reason == want.finish_reason == "length"
        assert len(got.tokens) == n
    assert eng.pool.n_used == 0 and eng._reserved == 0
    assert eng.n_prefill_executables == j_eng.n_prefill_executables \
        == len(set(PROMPTS))
    assert eng.n_decode_executables == 1
    assert eng.executables == eng.executable_budget \
        == j_eng.executable_budget


def test_state_engine_eos_eviction_matches_jax(pair):
    cfg = pair[2]
    prompts = _prompts(cfg, 1)
    eng, j_eng = _engines(pair)
    j_eng.submit(JRequest(prompt=prompts[0], max_new_tokens=8, rid=0))
    j_eng.drain()
    eos = int(j_eng.result(0).tokens[2])       # a token the model emits
    j_eng.reset()
    _submit_both(eng, j_eng, prompts, MAX_NEW, eos_id=eos)
    got = {r.rid: r for r in eng.drain()}
    want = {r.rid: r for r in j_eng.drain()}
    assert got.keys() == want.keys()
    for rid in got:
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens)
        assert got[rid].finish_reason == want[rid].finish_reason
    assert got[0].finish_reason == "eos"
    assert eng.pool.n_used == 0
    _pools_close(eng, j_eng)


def test_state_engine_defrag_and_reset(pair):
    """Defrag between steps permutes the state rows in place and changes
    no token; a reset keeps the entries."""
    cfg = pair[2]
    prompts = _prompts(cfg, 2)
    plain, _ = _engines(pair)
    defragged, _ = _engines(pair, n_pages=6)
    for eng in (plain, defragged):
        for p, n in zip(prompts, MAX_NEW):
            eng.submit(GenerationRequest(prompt=p, max_new_tokens=n))
    while not plain.done:
        ev = plain.step()
        defragged.defrag()
        assert defragged.step() == ev
    n = defragged.executables
    defragged.reset()
    assert defragged.executables == n and defragged.pool.n_used == 0


def _own_greedy(model, cfg, prompt, n):
    """The port's own reference: the full-sequence forward over the
    growing sequence, greedy at its last position."""
    seq = list(prompt)
    out = []
    with torch.inference_mode():
        for _ in range(n):
            h = M.forward_hidden(model, cfg, torch.tensor([seq]),
                                 dtype=torch.float32, remat=False)
            tok = int((h[:, -1] @ lm_head_matrix(model)).argmax(-1))
            out.append(tok)
            seq.append(tok)
    return out


@pytest.mark.parametrize("S", [1, 2])
def test_short_prompts_match_own_full_sequence_greedy(pair, S):
    """Prompts shorter than d_conv − 1, where the reference is wrong
    (module docstring): the state engine's tokens equal the port's
    full-sequence greedy, and its prefill state continues the
    sequence as the full forward does."""
    _, _, cfg, model = pair
    eng, _ = _engines(pair)
    prompts = _prompts(cfg, 3 + S, sizes=(S, S, S + 4))
    for p in prompts:
        eng.submit(GenerationRequest(prompt=p, max_new_tokens=6))
    got = {r.rid: r.tokens.tolist() for r in eng.drain()}
    for rid, p in enumerate(prompts):
        assert got[rid] == _own_greedy(model, cfg, p, 6), f"rid {rid}"
    with torch.inference_mode():
        _, cache = R.prefill(model, cfg, torch.from_numpy(prompts[0][None]))
    K = cfg.ssm.d_conv
    assert float(cache.data["conv"][:, :, :K - 1 - S].abs().max()) == 0.0


def test_submit_needs_no_bucket_in_state_mode(pair):
    eng, _ = _engines(pair, buckets=(4,))
    cfg = pair[2]
    eng.submit(GenerationRequest(prompt=_prompts(cfg, 4, sizes=(30,))[0],
                                 max_new_tokens=2))
    assert len(eng.drain()[0].tokens) == 2
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(GenerationRequest(prompt=np.zeros(47, np.int32),
                                     max_new_tokens=2))


# --------------------------------------------------------------------- #
# the card's path, kernels faked by their plain versions
# --------------------------------------------------------------------- #

class _FakeCard:
    """``_on_card`` says yes and each kernel wrapper becomes its plain
    version, counting its launches (the pattern of
    ``tests/test_torch_mamba2.py``); the plain SSD scan must not run."""

    def __init__(self, monkeypatch):
        self.n = dict(ssd_chunk=0, rmsnorm_fwd=0)

        def count(name, fn):
            def wrapped(*a):
                self.n[name] += 1
                return fn(*a)
            return wrapped

        def refuse(*a, **k):
            raise AssertionError("the plain SSD scan ran on the card path")

        monkeypatch.setattr(KB, "_on_card", lambda t, op: True)
        monkeypatch.setattr(SSD, "ssd_chunk",
                            count("ssd_chunk", ref.ssd_chunk_ref))
        monkeypatch.setattr(RN, "rmsnorm_fwd",
                            count("rmsnorm_fwd", ref.rmsnorm_ref))
        monkeypatch.setattr(M, "ssd_chunked", refuse)


def test_card_path_launches_and_tokens(monkeypatch):
    """The engine on the card's path: ``ssd_chunk`` L times a prefill,
    the RMSNorm forward 2L+1 times a prefill and a decode step, and the
    plain engine's tokens."""
    jcfg, params, cfg, model = _pair("reduced")
    prompts = _prompts(cfg, 7, sizes=(3, 40, 70))
    news = (5, 3, 4)

    def serve():
        eng = ServingEngine(cfg, model, dtype=torch.float32,
                            **dict(ENGINE, max_len=80))
        for p, n in zip(prompts, news):
            eng.submit(GenerationRequest(prompt=p, max_new_tokens=n))
        return eng, {r.rid: r.tokens.tolist() for r in eng.drain()}

    _, want = serve()
    fake = _FakeCard(monkeypatch)
    eng, got = serve()
    assert got == want
    L = cfg.n_layers
    assert fake.n == dict(ssd_chunk=L * len(prompts),
                          rmsnorm_fwd=(2 * L + 1) * (len(prompts)
                                                     + eng.steps))


def test_launcher_serves_mamba2_on_the_cpu(capsys):
    launch_serve.main(["--arch", "mamba2-2.7b", "--device", "cpu",
                       "--requests", "5", "--max-len", "40", "--max-new",
                       "6", "--quiet"])
    out = capsys.readouterr().out
    assert out.startswith("arch=mamba2-2.7b-smoke device=cpu mode=state ")
    assert "page_size=1" in out and "5 requests" in out
    n, budget = out.split("; ")[-1].split(" executables (budget ")
    assert int(n) == int(budget.rstrip(")\n"))


def test_state_prefill_scatters_the_prefill_state(pair):
    """The engine's prefill entry writes exactly ``registry.prefill``'s
    state into the request's page and touches no other row."""
    _, _, cfg, model = pair
    eng, _ = _engines(pair)
    p = _prompts(cfg, 8, sizes=(13,))[0]
    eng.submit(GenerationRequest(prompt=p, max_new_tokens=1))
    before = {k: v.clone() for k, v in eng.pool.kv.items()}
    eng._admit([])                 # the first page handed out is 1
    assert eng.slots[0] is None    # one new token: finished at once
    with torch.inference_mode():
        _, cache = R.prefill(model, cfg, torch.from_numpy(p[None]))
    for k, v in eng.pool.kv.items():
        assert torch.equal(v[:, 1], cache.data[k][:, 0])
        assert torch.equal(v[:, 0], before[k][:, 0])
        assert torch.equal(v[:, 2:], before[k][:, 2:])
