"""The port's RG-LRU hybrid served through the blocking ``Server``,
against the JAX package on the CPU in float32.

- ``registry.prefill``, ``decode_step`` and ``cache_struct`` for the
  hybrid (a list of per-layer caches: recurrent conv rows and state,
  rings of min(window, max_len) slots) against the reference's: logits
  within 1e-4, caches within 1e-5.
- ``Server.generate`` emits the reference ``Server``'s greedy tokens for
  prompts of S >= 3, one of them longer than the window of 64 (the ring
  is built from S >= W and wraps as it decodes).
- Prompts of 1 and 2 tokens, where the reference's first decode step
  fails (it keeps ``y[:, -(K-1):]``, too few conv rows), decode in the
  port and equal its own full-sequence greedy.
- The ragged decode at head_dim 256 (recurrentgemma's MQA: 16 query
  heads on one kv head) through ``decode_attn``'s ring against the
  reference's.
- The card's path with the kernels faked by their plain versions:
  launches per prefill and decode step; the engine and the serving
  launcher point at the ``Server``.

The reduced recurrentgemma is cut to 5 layers (``reduced()`` keeps 2,
both recurrent): layers 2 is its one attention layer.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as JA
from repro.models import registry as JR
from repro.train.serve import Server as JServer
from repro_torch.configs import get_config
from repro_torch.kernels import backend as KB
from repro_torch.kernels import paged as PG
from repro_torch.kernels import ref
from repro_torch.kernels import rglru as RG
from repro_torch.kernels import rmsnorm as RN
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention as A
from repro_torch.models import registry as R
from repro_torch.models import rglru as H
from repro_torch.models.layers import lm_head_matrix
from repro_torch.serving import DenseKVCache, ServingEngine
from repro_torch.train.serve import Server
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


ARCH = "recurrentgemma-9b"
TOL = dict(atol=1e-5, rtol=1e-5)
LOGITS = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def pair():
    """(reference config, its params, the port's config, the port's
    float32 model on the reference's weights) at 5 layers."""
    jcfg = dataclasses.replace(j_get_config(ARCH).reduced(), n_layers=5)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_layers=5)
    params = JR.init_params(jax.random.PRNGKey(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            dtype=torch.float32, device="cpu")
    return jcfg, params, cfg, model


def _prompts(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _quiet(fn, *a, **k):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn(*a, **k)


def _close(got, want, what="", tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=what, **tol)


def _close_caches(pc, jc, what):
    assert len(pc) == len(jc)
    for i, (p, j) in enumerate(zip(pc, jc)):
        assert set(p) == set(j), i
        for n in j:
            _close(p[n], j[n], f"{what}: layer {i} {n}")


# --------------------------------------------------------------------- #
# the registry's contiguous caches
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("S,cap,steps", [
    (11, 32, 6),          # ring of 32 slots, not yet full
    (70, 128, 5)])        # ring of 64 built from S >= W, wrapped at once
def test_registry_prefill_and_decode_match_reference(pair, S, cap, steps):
    jcfg, params, cfg, model = pair
    toks = _prompts(S, 2, S, cfg.vocab_size)
    jl, jc = JR.prefill(params, jcfg, jnp.asarray(toks), cache_len_cap=cap,
                        dtype=jnp.float32)
    with torch.inference_mode():
        pl, pc = R.prefill(model, cfg, torch.from_numpy(toks).long(),
                           cache_len_cap=cap)
    assert isinstance(pc, DenseKVCache) and isinstance(pc.data, list)
    assert pc.lengths.tolist() == [S, S]
    _close(pl, jl, "prefill logits", LOGITS)
    _close_caches(pc.data, jc.data, "prefill")
    for step in range(steps):
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None]
        jl, jc = JR.decode_step(params, jcfg, jc, jnp.asarray(tok),
                                dtype=jnp.float32)
        with torch.inference_mode():
            pl, pc2 = R.decode_step(model, cfg, pc,
                                    torch.from_numpy(np.array(tok)))
        assert pc2.data is pc.data                 # written in place
        pc = pc2
        _close(pl, jl, f"logits, step {step}", LOGITS)
        _close_caches(pc.data, jc.data, f"step {step}")
        assert pc.lengths.tolist() == [S + step + 1] * 2


@pytest.mark.parametrize("max_len", [24, 200])
def test_cache_struct_matches_reference(pair, max_len):
    """Recurrent layers' zero conv rows (K − 1) and float32 state; the
    attention layer's ring of min(64, max_len) slots, ``pos`` at -1."""
    jcfg, _, cfg, _ = pair
    want = JR.cache_struct(jcfg, 3, max_len, dtype=jnp.float32)
    got = R.cache_struct(cfg, 3, max_len, dtype=torch.float32,
                         device="cpu")
    assert len(got) == len(want) == cfg.n_layers
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for n in w:
            assert np.array_equal(g[n].numpy(), np.asarray(w[n])), n
            assert g[n].numpy().dtype == np.asarray(w[n]).dtype, n
    assert got[2]["k"].shape == (3, min(64, max_len), 1, 64)


# --------------------------------------------------------------------- #
# the Server against the reference's
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("S,n_new,max_len", [
    (3, 10, 32),          # the shortest prompt the reference decodes
    (50, 20, 128),        # the ring wraps at decode step 15
    (90, 8, 128)])        # the prompt is past the window of 64
def test_generate_matches_reference_server(pair, S, n_new, max_len):
    jcfg, params, cfg, model = pair
    toks = _prompts(1000 + S, 2, S, cfg.vocab_size)
    want = _quiet(JServer(jcfg, params, max_len=max_len,
                          dtype=jnp.float32).generate, toks, n_new)
    srv = Server(cfg, model, max_len=max_len, dtype=torch.float32)
    got = _quiet(srv.generate, toks, n_new)
    assert not srv.bucketed and got.shape == (2, n_new)
    assert np.array_equal(got, np.asarray(want))


def _own_greedy(model, cfg, prompt, n):
    """The port's own reference: the full-sequence forward over the
    growing sequence, greedy at its last position."""
    seq = list(prompt)
    out = []
    with torch.inference_mode():
        for _ in range(n):
            h = H.forward_hidden(model, cfg, torch.tensor([seq]),
                                 dtype=torch.float32, remat=False)
            tok = int((h[:, -1] @ lm_head_matrix(model)).argmax(-1))
            out.append(tok)
            seq.append(tok)
    return out


@pytest.mark.parametrize("S", [1, 2])
def test_short_prompts_match_own_full_sequence_greedy(pair, S):
    """The reference's first decode step after a prompt of 1 or 2 tokens
    raises (its conv state holds S < K − 1 rows; ROADMAP Queue 3).  The
    port pads the missing rows with zeros: a batch of such prompts
    decodes through the Server and each row's tokens equal the port's
    full-sequence greedy."""
    jcfg, params, cfg, model = pair
    toks = _prompts(S, 2, S, cfg.vocab_size)
    _, jc = JR.prefill(params, jcfg, jnp.asarray(toks), cache_len_cap=16,
                       dtype=jnp.float32)
    with pytest.raises(ValueError):
        JR.decode_step(params, jcfg, jc, jnp.asarray(toks[:, -1:]),
                       dtype=jnp.float32)
    got = _quiet(Server(cfg, model, max_len=32,
                        dtype=torch.float32).generate, toks, 6)
    for b in range(2):
        assert got[b].tolist() == _own_greedy(model, cfg, toks[b], 6), b
    with torch.inference_mode():
        _, cache = R.prefill(model, cfg, torch.from_numpy(toks).long(),
                             cache_len_cap=32)
    K = cfg.hybrid.conv1d_width
    assert float(cache.data[0]["conv"][:, :K - 1 - S].abs().max()) == 0.0


def test_decode_writes_the_cache_in_place(pair):
    """``decode_step`` returns the cache it was given, every leaf written
    where it lies (what a captured graph replays)."""
    _, _, cfg, model = pair
    toks = torch.from_numpy(_prompts(4, 2, 9, cfg.vocab_size)).long()
    with torch.inference_mode():
        _, cache = R.prefill(model, cfg, toks, cache_len_cap=32)
        ptrs = [t.data_ptr() for d in cache.data for t in d.values()]
        before = [t.clone() for d in cache.data for t in d.values()]
        _, new = R.decode_step(model, cfg, cache, toks[:, -1:])
    assert new.data is cache.data
    assert [t.data_ptr() for d in new.data for t in d.values()] == ptrs
    after = [t for d in new.data for t in d.values()]
    assert all(not torch.equal(a, b) for a, b in zip(after, before))


# --------------------------------------------------------------------- #
# the ragged decode at head_dim 256
# --------------------------------------------------------------------- #

def test_hd256_ring_decode_matches_jax():
    """recurrentgemma's attention shape (16 query heads of 256 on one kv
    head), narrowed to d_model 64: a ring of W = 8 from a prefill of 5,
    then 8 decode steps, which wrap it; ``decode_attn`` runs
    ``ragged_decode_ref`` at lengths min(pos, W − 1), the reference its
    chunked scan: out, K, V and pos within 1e-5."""
    D, Hq, Hkv, HD, W, S0 = 64, 16, 1, 256, 8, 5
    params = jax.tree.map(np.asarray, JA.init_attention(
        jax.random.PRNGKey(3), D, Hq, Hkv, HD, 2))
    mod = A.Attention(D, Hq, Hkv, HD, dtype=torch.float32, device="cpu")
    for n, w in params.items():
        getattr(mod, n).data.copy_(torch.from_numpy(np.array(w)))
    x = np.random.default_rng(3).standard_normal(
        (2, S0 + 8, D)).astype(np.float32)
    kw = dict(n_heads=Hq, n_kv_heads=Hkv, head_dim=HD, rope_theta=1e4)
    _, (k, v) = JA.attn_forward(params, jnp.asarray(x[:, :S0]), causal=True,
                                window=W, chunk=8, **kw)
    jc = JA.ring_from_prefill(k, v, S0, W)
    pc = A.ring_from_prefill(torch.from_numpy(np.array(k)),
                             torch.from_numpy(np.array(v)), S0, W)
    for t in range(S0, S0 + 8):
        want, jc = JA.decode_attn(params, jnp.asarray(x[:, t:t + 1]), jc,
                                  jnp.asarray(np.int32(t)), window=W, **kw)
        got, pc = A.decode_attn(mod, torch.from_numpy(x[:, t:t + 1]), pc,
                                torch.tensor(t), window=W, **kw)
        _close(got, want, f"out, step {t}")
        for n in jc:
            _close(pc[n], jc[n], f"{n}, step {t}")


# --------------------------------------------------------------------- #
# the card's path, kernels faked by their plain versions
# --------------------------------------------------------------------- #

def test_card_path_launches(pair, monkeypatch):
    """The Server on the card's path (``_on_card`` says yes, each kernel
    wrapper is its plain version, counted): the same tokens; the scan
    kernel once per recurrent layer a prefill and never in a decode
    step (the O(1) step), its backward never, the ragged decode once per
    attention layer a decode step, RMSNorm's forward 2L+1 times a
    prefill and a decode step, flash never (the windowed layer runs
    ``chunked_attention``)."""
    _, _, cfg, model = pair
    S, n_new, max_len = 70, 6, 128
    toks = _prompts(8, 2, S, cfg.vocab_size)
    want = _quiet(Server(cfg, model, max_len=max_len,
                         dtype=torch.float32).generate, toks, n_new)
    n = dict(rglru_scan_fwd=0, rglru_scan_bwd=0, ragged_decode=0,
             rmsnorm_fwd=0, flash=0)

    def count(name, fn):
        def wrapped(*a, **k):
            n[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(KB, "_on_card", lambda t, op: True)
    monkeypatch.setattr(RG, "rglru_scan_fwd",
                        count("rglru_scan_fwd", ref.rglru_scan_ref))
    monkeypatch.setattr(RG, "rglru_scan_bwd",
                        count("rglru_scan_bwd", ref.rglru_scan_bwd_ref))
    monkeypatch.setattr(PG, "ragged_decode_attention",
                        count("ragged_decode", ref.ragged_decode_ref))
    monkeypatch.setattr(RN, "rmsnorm_fwd",
                        count("rmsnorm_fwd", ref.rmsnorm_ref))
    monkeypatch.setattr(KB, "attention", count("flash", KB.attention))
    got = _quiet(Server(cfg, model, max_len=max_len,
                        dtype=torch.float32).generate, toks, n_new)
    assert np.array_equal(got, want)
    L, n_rec = cfg.n_layers, 4
    assert n == dict(rglru_scan_fwd=n_rec, rglru_scan_bwd=0,
                     ragged_decode=(L - n_rec) * (n_new - 1),
                     rmsnorm_fwd=(2 * L + 1) * n_new, flash=0)


def test_hybrid_points_at_the_server(pair):
    """No engine mode, as in the reference: a ring's rows share one
    position array.  The engine and the serving launcher name the
    Server."""
    jcfg, _, cfg, model = pair
    assert R.serving_mode(cfg) is None is JR.serving_mode(jcfg)
    assert not R.supports_paged(cfg)
    with pytest.raises(NotImplementedError, match="train.serve.Server"):
        ServingEngine(cfg, model, dtype=torch.float32)
    with pytest.raises(SystemExit, match="train.serve.Server"):
        launch_serve.main(["--arch", ARCH, "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="exact-length"):
        R.prefill_ragged(model, cfg, torch.zeros(1, 4).long(),
                         torch.tensor([4]))
