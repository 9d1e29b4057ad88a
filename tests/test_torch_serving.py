"""The port's paged KV cache and serving engine against the JAX package.

Layout plumbing (interleave, page gather, prefill scatter, the page
allocator and defrag) must agree exactly.  The whole slice — the
reference's weights loaded through ``from_jax_params`` into the port's
``ServingEngine`` — must emit the same greedy tokens, step for step, as
the reference's ``ServingEngine`` in float32, with pools equal within
1e-5 (page 0, the null page, takes colliding junk writes and is
excluded).  Everything runs on the CPU, through the plain versions of
the kernels; ``tests/test_torch_card.py`` runs the engine on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import registry as JR
from repro.serving import GenerationRequest as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving import cache as JSC
from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry as R
from repro_torch.serving import (GenerationRequest, OutOfPages, PagePool,
                                 ServingEngine, pow2_buckets)
from repro_torch.serving import cache as SC
from repro_torch.weights import from_jax_params

TINY = dict(name="torch-serve-tiny", arch_type="dense", n_layers=2,
            d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
            vocab_size=256, max_seq_len=64, rope_theta=1e4)
ENGINE = dict(decode_slots=2, page_size=4, max_len=32)
PROMPTS = (3, 9, 17, 5, 12)
MAX_NEW = (6, 4, 8, 10, 5)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """The reference's weights and config, and the port's model loaded
    from them (float32, CPU)."""
    jcfg = JModelConfig(**TINY)
    params = JR.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = ModelConfig(**TINY)
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            dtype=torch.float32, device="cpu")
    return jcfg, params, cfg, model


@pytest.fixture(scope="module")
def j_engine(pair):
    jcfg, params, _, _ = pair
    return JEngine(jcfg, params, dtype=jnp.float32, **ENGINE)


def _engine(pair, **kw):
    _, _, cfg, model = pair
    return ServingEngine(cfg, model, dtype=torch.float32,
                         **dict(ENGINE, **kw))


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TINY["vocab_size"], (s,)).astype(np.int32)
            for s in PROMPTS]


def _pool_np(pool):
    return pool.kv.numpy() if isinstance(pool.kv, torch.Tensor) \
        else np.asarray(pool.kv)


# --------------------------------------------------------------------- #
# layout plumbing: exact
# --------------------------------------------------------------------- #

def test_kv_interleave_matches_jax():
    rng = np.random.default_rng(0)
    k, v = _normal(rng, (2, 5, 3, 8)), _normal(rng, (2, 5, 3, 8))
    got = SC.kv_interleave(torch.from_numpy(k), torch.from_numpy(v))
    want = JSC.kv_interleave(jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kk, vv = SC.kv_deinterleave(got)
    np.testing.assert_array_equal(kk.numpy(), k)
    np.testing.assert_array_equal(vv.numpy(), v)


@pytest.mark.parametrize("page_size", [1, 4, 16])
def test_gather_pages_matches_jax(page_size):
    rng = np.random.default_rng(1)
    pool = _normal(rng, (9, page_size, 4, 8))
    pages = rng.integers(0, 9, (3, 4)).astype(np.int64)
    got = SC.gather_pages(torch.from_numpy(pool), torch.from_numpy(pages),
                          page_size=page_size)
    want = JSC.gather_pages(jnp.asarray(pool), jnp.asarray(pages),
                            page_size=page_size)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("page_size", [1, 4, 16])
def test_scatter_prefill_matches_jax(page_size):
    rng = np.random.default_rng(2)
    L, B, S, Hkv, hd, P = 2, 3, 16, 2, 8, 16 // page_size + 1
    n_pages = B * P + 1
    pool = _normal(rng, (L, n_pages, page_size, 2 * Hkv, hd))
    k, v = _normal(rng, (L, B, S, Hkv, hd)), _normal(rng, (L, B, S, Hkv, hd))
    pages = (1 + rng.permutation(B * P)).reshape(B, P).astype(np.int64)
    lengths = np.array([16, 7, 1], np.int32)
    got = SC.scatter_prefill(torch.from_numpy(pool.copy()),
                             torch.from_numpy(k), torch.from_numpy(v),
                             torch.from_numpy(pages),
                             torch.from_numpy(lengths), page_size=page_size)
    want = JSC.scatter_prefill(jnp.asarray(pool), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(pages),
                               jnp.asarray(lengths), page_size=page_size)
    np.testing.assert_array_equal(got.numpy()[:, 1:],
                                  np.asarray(want)[:, 1:])


def test_page_pool_matches_jax():
    cfg, jcfg = ModelConfig(**TINY), JModelConfig(**TINY)
    ours = PagePool(cfg, 9, 4, dtype=torch.float32, device="cpu")
    ref = JSC.PagePool(jcfg, 9, 4, dtype=jnp.float32)
    assert ours.kv.shape == ref.kv.shape == (2, 9, 4, 4, 16)
    a, b = ours.alloc(3), ours.alloc(2)
    assert (a, b) == (ref.alloc(3), ref.alloc(2))
    ours.free(a)
    ref.free(a)
    c = ours.alloc(4)
    assert c == ref.alloc(4)
    assert (ours.n_free, ours.n_used) == (ref.n_free, ref.n_used)
    with pytest.raises(OutOfPages):
        ours.alloc(ours.n_free + 1)
    scratch = PagePool(cfg, 4, 4, dtype=torch.float32, device="cpu")
    x = scratch.alloc(2)
    scratch.free(x[:1])
    with pytest.raises(ValueError, match="double free"):
        scratch.free(x[:1])
    with pytest.raises(ValueError, match="double free"):
        scratch.free([x[1], x[1]])        # the port also refuses this
    with pytest.raises(ValueError, match="invalid page"):
        scratch.free([0])

    rng = np.random.default_rng(3)
    data = _normal(rng, tuple(ours.kv.shape))
    ours.kv = torch.from_numpy(data.copy())
    ref.kv = jnp.asarray(data)
    t_ours, t_ref = [list(b), list(c)], [list(b), list(c)]
    ours.defrag(t_ours)
    ref.defrag(t_ref)
    assert t_ours == t_ref and ours._free == ref._free
    np.testing.assert_array_equal(ours.kv.numpy(), np.asarray(ref.kv))
    ours.reset()
    assert ours.n_used == 0 and float(ours.kv.abs().max()) == 0.0


# --------------------------------------------------------------------- #
# the whole slice: the port's engine against the reference's
# --------------------------------------------------------------------- #

def _submit_both(eng, j_eng, prompts, max_new, eos_id=None):
    for rid, (p, n) in enumerate(zip(prompts, max_new)):
        eng.submit(GenerationRequest(prompt=p, max_new_tokens=n,
                                     eos_id=eos_id, rid=rid))
        j_eng.submit(JRequest(prompt=p, max_new_tokens=n, eos_id=eos_id,
                              rid=rid))


def test_engine_matches_jax_engine(pair, j_engine):
    j_engine.reset()
    eng = _engine(pair)
    _submit_both(eng, j_engine, _prompts(), MAX_NEW)
    n_steps = 0
    while not (eng.done and j_engine.done):
        assert eng.step() == j_engine.step(), f"step {n_steps}"
        n_steps += 1
        assert n_steps < 200
    for rid, n in enumerate(MAX_NEW):
        got, want = eng.result(rid), j_engine.result(rid)
        np.testing.assert_array_equal(got.tokens, want.tokens)
        assert got.finish_reason == want.finish_reason == "length"
        assert len(got.tokens) == n
    assert eng.pool.n_used == 0 and eng._reserved == 0
    np.testing.assert_allclose(_pool_np(eng.pool)[:, 1:],
                               _pool_np(j_engine.pool)[:, 1:],
                               atol=1e-5, rtol=1e-5)


def test_engine_eos_eviction_matches_jax(pair, j_engine):
    prompts = _prompts(1)
    j_engine.reset()
    j_engine.submit(JRequest(prompt=prompts[0], max_new_tokens=8, rid=0))
    j_engine.drain()
    eos = int(j_engine.result(0).tokens[2])    # a token the model emits
    j_engine.reset()
    eng = _engine(pair)
    _submit_both(eng, j_engine, prompts, MAX_NEW, eos_id=eos)
    got = {r.rid: r for r in eng.drain()}
    want = {r.rid: r for r in j_engine.drain()}
    assert got.keys() == want.keys()
    for rid in got:
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens)
        assert got[rid].finish_reason == want[rid].finish_reason
    assert got[0].finish_reason == "eos"
    assert eng.pool.n_used == 0


def test_tiny_pool_serializes_like_jax(pair):
    jcfg, params, _, _ = pair
    # 6 usable pages: the first request reserves all of them
    kw = dict(ENGINE, n_pages=7)
    j_eng = JEngine(jcfg, params, dtype=jnp.float32, **kw)
    eng = _engine(pair, n_pages=7)
    _submit_both(eng, j_eng, _prompts(2)[2:], MAX_NEW[2:])
    eng.step()
    assert eng.n_active == 1 and eng.n_pending == 2
    got, want = eng.drain(), j_eng.drain()
    assert [r.rid for r in got] == [r.rid for r in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_generate_matches_jax(pair, j_engine):
    j_engine.reset()
    rng = np.random.default_rng(4)
    toks = rng.integers(0, TINY["vocab_size"], (3, 7)).astype(np.int32)
    np.testing.assert_array_equal(_engine(pair).generate(toks, 5),
                                  j_engine.generate(toks, 5))


def test_defrag_mid_decode_is_transparent(pair):
    prompts = _prompts(5)
    plain, defragged = _engine(pair), _engine(pair)
    for eng in (plain, defragged):
        for p, n in zip(prompts, MAX_NEW):
            eng.submit(GenerationRequest(prompt=p, max_new_tokens=n))
    while not plain.done:
        ev = plain.step()
        defragged.defrag()
        assert defragged.step() == ev


def test_submit_validation_and_rids(pair):
    eng = _engine(pair)
    with pytest.raises(ValueError, match="non-empty"):
        eng.submit(GenerationRequest(prompt=np.zeros(0, np.int32),
                                     max_new_tokens=2))
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(GenerationRequest(prompt=np.zeros(30, np.int32),
                                     max_new_tokens=3))
    assert eng.submit(GenerationRequest(prompt=np.ones(3, np.int32),
                                        max_new_tokens=2)) == 0
    assert eng.submit(GenerationRequest(prompt=np.ones(3, np.int32),
                                        max_new_tokens=2, rid=7)) == 7
    with pytest.raises(ValueError, match="already queued"):
        eng.submit(GenerationRequest(prompt=np.ones(3, np.int32),
                                     max_new_tokens=2, rid=7))
    assert eng.submit(GenerationRequest(prompt=np.ones(3, np.int32),
                                        max_new_tokens=2)) == 8
    eng.step()
    eng.reset()
    assert eng.done and eng.pool.n_used == 0


def test_engine_checks_dtype_and_buckets(pair):
    _, _, cfg, model = pair
    with pytest.raises(ValueError, match="dtype"):
        ServingEngine(cfg, model, dtype=torch.bfloat16, **ENGINE)
    with pytest.raises(ValueError, match="bucket"):
        ServingEngine(cfg, model, dtype=torch.float32, buckets=(64,),
                      **ENGINE)
    assert pow2_buckets(1024) == (16, 32, 64, 128, 256, 512, 1024)
    assert pow2_buckets(40) == (16, 32, 40)


def test_decode_step_needs_a_paged_cache(pair):
    _, _, cfg, model = pair
    with pytest.raises(TypeError, match="PagedKVCache"):
        R.decode_step(model, cfg, object(), torch.zeros(1, 1).long())
