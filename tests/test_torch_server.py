"""The port's blocking ``Server`` and the contiguous caches it decodes
against, held to the JAX package on the CPU in float32.

- ``Server.generate`` emits the reference ``Server``'s greedy tokens,
  token for token, on the reference's weights (``from_jax_params``) for
  three configs: the serving tests' dense ``tiny_cfg`` (bucketed
  prefill, full cache at per-request depths), their ``SSM_CFG`` (the
  exact-length path, recurrent state) and the reduced starcoder2 (a
  ring of 64 slots that the decode wraps).
- ``registry.prefill``, ``decode_step`` and ``cache_struct`` for the
  dense family, full and ring, equal the reference's within 1e-5.
- The engine is held to the port's own solo ``Server``, as the
  reference's engine is to its own: paged and state modes.
- Two faults of the reference's ``Server`` that the port rejects, each
  shown on the reference first.
- No module of the port, nor ``chip_smoke.py``, imports JAX or the JAX
  package.
"""
import ast
import pathlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import SSMConfig as JSSMConfig
from repro.models import registry as JR
from repro.train.serve import Server as JServer
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels import backend as KB
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import paged as PG
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as RN
from repro_torch.launch import serve as launch_serve
from repro_torch.models import registry as R
from repro_torch.serving import DenseKVCache, GenerationRequest, \
    ServingEngine
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


ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-5, rtol=1e-5)
TINY = dict(name="serve-tiny", arch_type="dense", n_layers=2, d_model=32,
            n_heads=2, n_kv_heads=1, head_dim=8, d_ff=64, vocab_size=64,
            max_seq_len=128, rope_theta=1e4)
SSM = dict(name="serve-ssm", arch_type="ssm", n_layers=2, d_model=32,
           n_heads=2, n_kv_heads=1, head_dim=8, d_ff=64, vocab_size=64,
           max_seq_len=64, rope_theta=1e4)
SSM_KW = dict(d_state=16, d_conv=4, expand=2, head_dim=16, chunk_size=16)


def _configs(which):
    if which == "tiny":
        return JModelConfig(**TINY), ModelConfig(**TINY)
    if which == "window":
        kw = dict(TINY, sliding_window=8)
        return JModelConfig(**kw), ModelConfig(**kw)
    if which == "ssm":
        return (JModelConfig(**SSM, ssm=JSSMConfig(**SSM_KW)),
                ModelConfig(**SSM, ssm=SSMConfig(**SSM_KW)))
    return (j_get_config("starcoder2-3b").reduced(),
            get_config("starcoder2-3b").reduced())


_PAIRS = {}


def _pair(which):
    """(reference config, its params, the port's config, the port's
    float32 model on the reference's weights), built once a config."""
    if which not in _PAIRS:
        jcfg, cfg = _configs(which)
        params = JR.init_params(jax.random.PRNGKey(0), jcfg)
        model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                dtype=torch.float32, device="cpu")
        _PAIRS[which] = (jcfg, params, cfg, model)
    return _PAIRS[which]


def _prompts(seed, sizes, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (s,)).astype(np.int32) for s in sizes]


def _quiet(fn, *a, **k):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn(*a, **k)


def _close(got, want, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=what, **TOL)


# --------------------------------------------------------------------- #
# Server.generate against the reference's Server
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("which,S,n_new,max_len", [
    ("tiny", 11, 9, 32),            # bucket 16, full cache of 32
    ("ssm", 9, 8, 32),              # exact length, recurrent state
    ("starcoder2", 60, 20, 128),    # ring of 64 slots, wrapped at 64
])
def test_generate_matches_reference_server(which, S, n_new, max_len):
    jcfg, params, cfg, model = _pair(which)
    toks = np.stack(_prompts(1, [S, S], cfg.vocab_size))
    want = _quiet(JServer(jcfg, params, max_len=max_len,
                          dtype=jnp.float32).generate, toks, n_new)
    srv = Server(cfg, model, max_len=max_len, dtype=torch.float32)
    got = _quiet(srv.generate, toks, n_new)
    assert got.dtype == np.int32 and got.shape == (2, n_new)
    assert np.array_equal(got, np.asarray(want))
    assert srv.bucketed == (which == "tiny")


@pytest.mark.parametrize("which", ["tiny", "window", "starcoder2"])
def test_registry_prefill_and_decode_match_reference(which):
    """The dense family's contiguous cache through the registry: the
    prefill's logits and cache, then decode steps' logits and cache (a
    full cache at per-request depths; a ring that wraps: W = 8 after a
    prefill of 11, W = 64 after one of 60), within 1e-5."""
    jcfg, params, cfg, model = _pair(which)
    cap, S = (32, 11) if which != "starcoder2" else (96, 60)
    toks = np.stack(_prompts(2, [S, S], cfg.vocab_size))
    jl, jc = JR.prefill(params, jcfg, jnp.asarray(toks), cache_len_cap=cap,
                        dtype=jnp.float32)
    with torch.inference_mode():
        pl, pc = R.prefill(model, cfg, torch.from_numpy(toks).long(),
                           cache_len_cap=cap)
    assert isinstance(pc, DenseKVCache)
    assert pc.lengths.tolist() == [S, S] and pc.lengths.dtype == torch.int32
    _close(pl, jl, "prefill logits")
    assert set(pc.data) == set(jc.data)
    for step in range(6):
        for n in jc.data:
            _close(pc.data[n], jc.data[n], f"{n}, step {step}")
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None]
        jl, jc = JR.decode_step(params, jcfg, jc, jnp.asarray(tok),
                                dtype=jnp.float32)
        with torch.inference_mode():
            pl, pc = R.decode_step(model, cfg, pc,
                                   torch.from_numpy(np.array(tok)))
        _close(pl, jl, f"logits, step {step}")
        assert pc.lengths.tolist() == [S + step + 1] * 2


@pytest.mark.parametrize("which,max_len", [("tiny", 24), ("window", 24),
                                           ("window", 5)])
def test_cache_struct_matches_reference(which, max_len):
    """Full cache of max_len positions; ring of min(window, max_len)
    slots with ``pos`` at -1."""
    jcfg, _, cfg, _ = _pair(which)
    want = JR.cache_struct(jcfg, 3, max_len, dtype=jnp.float32)
    got = R.cache_struct(cfg, 3, max_len, dtype=torch.float32,
                         device="cpu")
    assert set(got) == set(want)
    for n in want:
        assert np.array_equal(got[n].numpy(), np.asarray(want[n])), n
        assert got[n].numpy().dtype == np.asarray(want[n]).dtype, n
    with pytest.raises(ValueError, match="max_len"):
        R.cache_struct(cfg, 3, 0, device="cpu")


def test_server_bucketed_prefill_single_executable():
    """The reference's ``test_server_bucketed_prefill_single_executable``:
    two prompt lengths in one bucket share one prefill key, a longer one
    adds a second, and the tokens equal a manual exact-length prefill and
    decode through the registry (and the reference Server's)."""
    jcfg, params, cfg, model = _pair("tiny")
    srv = Server(cfg, model, max_len=64, dtype=torch.float32)
    jsrv = JServer(jcfg, params, max_len=64, dtype=jnp.float32)
    outs = {}
    for S in (8, 11):                               # the 16-bucket
        toks = np.stack(_prompts(13, [S, S], cfg.vocab_size))
        outs[S] = _quiet(srv.generate, toks, 4)
        assert np.array_equal(outs[S], _quiet(jsrv.generate, toks, 4))
    assert srv.bucketed and srv.n_prefill_executables == 1
    _quiet(srv.generate, np.stack(_prompts(14, [20, 20], cfg.vocab_size)),
           2)                                       # the 32-bucket
    assert srv.n_prefill_executables == 2
    for S, got in outs.items():
        toks = torch.from_numpy(np.stack(_prompts(13, [S, S],
                                                  cfg.vocab_size))).long()
        with torch.inference_mode():
            logits, cache = R.prefill(model, cfg, toks, cache_len_cap=64)
            want = []
            for _ in range(4):
                tok = logits[:, -1].argmax(-1, keepdim=True)
                want.append(tok)
                logits, cache = R.decode_step(model, cfg, cache, tok)
        assert np.array_equal(got, torch.cat(want, 1).numpy())


def test_server_generate_deprecated():
    _, _, cfg, model = _pair("tiny")
    srv = Server(cfg, model, max_len=32, dtype=torch.float32)
    with pytest.warns(DeprecationWarning, match="ServingEngine"):
        srv.generate(np.zeros((1, 4), np.int32), 1)


def test_server_sampling_and_argument_checks():
    """Temperature sampling draws from the seeded generator (repeatable,
    in the vocab); a model in another dtype, a prefix embedding and a
    prompt past the largest bucket raise."""
    _, _, cfg, model = _pair("tiny")
    srv = Server(cfg, model, max_len=32, dtype=torch.float32)
    toks = np.stack(_prompts(3, [6, 6], cfg.vocab_size))
    a = _quiet(srv.generate, toks, 5, temperature=1.0, seed=3)
    assert np.array_equal(a, _quiet(srv.generate, toks, 5, temperature=1.0,
                                    seed=3))
    assert a.shape == (2, 5) and 0 <= a.min() and a.max() < cfg.padded_vocab
    with pytest.raises(ValueError, match="dtype"):
        Server(cfg, model, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="VLM"):
        _quiet(srv.generate, toks, 2, prefix_emb=np.zeros((2, 1, 32)))
    small = Server(cfg, model, max_len=64, buckets=(16,),
                   dtype=torch.float32)
    with pytest.raises(ValueError, match="largest bucket"):
        _quiet(small.generate, np.zeros((1, 20), np.int32), 1)


# --------------------------------------------------------------------- #
# two faults of the reference's Server, rejected by the port
# --------------------------------------------------------------------- #

def test_decode_past_a_full_cache_raises():
    """The reference decodes past its full cache without an error: its
    ragged scatter drops the write at position >= max_len while the
    length mask admits the slot, so from that step on its logits leave
    those of a larger cache.  ``Server(max_len=16).generate`` of an
    8-token prompt returns 20 tokens there.  The port raises before the
    prefill once a write would reach position max_len, and serves up to
    it."""
    jcfg, params, cfg, model = _pair("tiny")
    prompt = np.stack(_prompts(4, [8], cfg.vocab_size))
    assert _quiet(JServer(jcfg, params, max_len=16,
                          dtype=jnp.float32).generate,
                  prompt, 20).shape == (1, 20)
    caps = {}
    for cap in (16, 64):
        logits, cache = JR.prefill(params, jcfg, jnp.asarray(prompt),
                                   cache_len_cap=cap, dtype=jnp.float32)
        tok = jnp.asarray(prompt[:, :1])
        steps = []
        for _ in range(10):
            logits, cache = JR.decode_step(params, jcfg, cache, tok,
                                           dtype=jnp.float32)
            steps.append(np.asarray(logits))
        caps[cap] = steps
    diff = [float(np.abs(a - b).max()) for a, b in zip(caps[16], caps[64])]
    assert max(diff[:8]) < 1e-6 and min(diff[8:]) > 1e-4   # position 16 on
    srv = Server(cfg, model, max_len=16, dtype=torch.float32)
    with pytest.raises(ValueError, match="max_len 16"):
        _quiet(srv.generate, prompt, 20)
    with pytest.raises(ValueError, match="max_len 16"):
        _quiet(srv.generate, prompt, 10)      # would write position 16
    got = _quiet(srv.generate, prompt, 9)     # writes positions 8..15
    assert np.array_equal(got, _quiet(JServer(jcfg, params, max_len=16,
                                              dtype=jnp.float32).generate,
                                      prompt, 9))


def test_generate_of_no_tokens_raises():
    """The reference's ``generate(tokens, 0)`` returns one token a row;
    the port's raises."""
    jcfg, params, cfg, model = _pair("tiny")
    prompt = np.stack(_prompts(5, [6, 6], cfg.vocab_size))
    assert _quiet(JServer(jcfg, params, max_len=32,
                          dtype=jnp.float32).generate,
                  prompt, 0).shape == (2, 1)
    with pytest.raises(ValueError, match="n_new"):
        _quiet(Server(cfg, model, max_len=32, dtype=torch.float32).generate,
               prompt, 0)


def test_ring_has_no_length_limit():
    """A ring serves past max_len: 60 + 70 tokens through max_len 64."""
    _, _, cfg, model = _pair("starcoder2")
    srv = Server(cfg, model, max_len=64, dtype=torch.float32)
    got = _quiet(srv.generate, np.stack(_prompts(6, [60], cfg.vocab_size)),
                 70)
    assert got.shape == (1, 70)


# --------------------------------------------------------------------- #
# the engine against the port's own solo Server
# --------------------------------------------------------------------- #

def _solo(srv, prompt, n):
    return _quiet(srv.generate, np.asarray(prompt)[None], n)[0]


def test_engine_matches_solo_oracle():
    """The reference's ``test_engine_matches_solo_oracle``: 5 ragged
    requests through 2 slots (queueing, page reuse), each equal to its
    solo run through a Server sized to the engine's page window."""
    _, _, cfg, model = _pair("tiny")
    eng = ServingEngine(cfg, model, decode_slots=2, page_size=4, max_len=32,
                        dtype=torch.float32)
    oracle = Server(cfg, model, max_len=eng.pages_per_slot * eng.page_size,
                    buckets=eng.buckets, dtype=torch.float32)
    sizes, news = [3, 16, 7, 1, 12], [6, 4, 8, 3, 5]
    prompts = _prompts(0, sizes, cfg.vocab_size)
    for i, (p, n) in enumerate(zip(prompts, news)):
        eng.submit(GenerationRequest(rid=i, prompt=p, max_new_tokens=n))
    eng.drain(max_steps=300)
    for i, (p, n) in enumerate(zip(prompts, news)):
        assert np.array_equal(eng.result(i).tokens, _solo(oracle, p, n)), i
    assert eng.pool.n_used == 0


def test_state_mode_engine_matches_solo_oracle():
    """The reference's ``test_state_mode_engine_matches_dense_oracle``:
    an SSM engine against the exact-length Server."""
    _, _, cfg, model = _pair("ssm")
    eng = ServingEngine(cfg, model, decode_slots=2, max_len=32,
                        dtype=torch.float32)
    srv = Server(cfg, model, max_len=32, dtype=torch.float32)
    assert eng.mode == "state" and not srv.bucketed
    sizes, news = [3, 9, 6], [5, 3, 4]
    prompts = _prompts(7, sizes, cfg.vocab_size)
    for i, (p, n) in enumerate(zip(prompts, news)):
        eng.submit(GenerationRequest(rid=i, prompt=p, max_new_tokens=n))
    eng.drain(max_steps=100)
    for i, (p, n) in enumerate(zip(prompts, news)):
        assert np.array_equal(eng.result(i).tokens, _solo(srv, p, n)), i
    assert eng.n_prefill_executables == len(set(sizes))


def test_windowed_archs_point_at_the_server(capsys):
    _, _, cfg, model = _pair("starcoder2")
    assert R.serving_mode(cfg) is None
    with pytest.raises(NotImplementedError, match="train.serve.Server"):
        ServingEngine(cfg, model, dtype=torch.float32)
    with pytest.raises(SystemExit, match="train.serve.Server"):
        launch_serve.main(["--arch", "starcoder2-3b", "--device", "cpu"])


# --------------------------------------------------------------------- #
# the card's path, kernels faked by their plain versions
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("which", ["tiny", "starcoder2"])
def test_card_path_launches(monkeypatch, which):
    """The Server on the card's path (``_on_card`` says yes, each kernel
    wrapper is its plain version, counted): the same tokens; the ragged
    decode L times a decode step, the RMSNorm forward 2L+1 times a
    prefill and a decode step, and flash L times a prefill for full
    attention and never for a window."""
    _, _, cfg, model = _pair(which)
    S, n_new, max_len = (11, 6, 32) if which == "tiny" else (60, 8, 128)
    toks = np.stack(_prompts(8, [S, S], cfg.vocab_size))
    want = _quiet(Server(cfg, model, max_len=max_len,
                         dtype=torch.float32).generate, toks, n_new)
    n = dict(ragged_decode=0, rmsnorm_fwd=0, flash_fwd=0)

    def count(name, fn):
        def wrapped(*a):
            n[name] += 1
            return fn(*a)
        return wrapped

    def flash(q, k, v):
        out, _ = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2))
        return out.transpose(1, 2)

    monkeypatch.setattr(KB, "_on_card", lambda t, op: True)
    monkeypatch.setattr(PG, "ragged_decode_attention",
                        count("ragged_decode", ref.ragged_decode_ref))
    monkeypatch.setattr(RN, "rmsnorm_fwd",
                        count("rmsnorm_fwd", ref.rmsnorm_ref))
    monkeypatch.setattr(FA, "attention", count("flash_fwd", flash))
    got = _quiet(Server(cfg, model, max_len=max_len,
                        dtype=torch.float32).generate, toks, n_new)
    assert np.array_equal(got, want)
    L = cfg.n_layers
    assert n == dict(ragged_decode=L * (n_new - 1),
                     rmsnorm_fwd=(2 * L + 1) * n_new,
                     flash_fwd=L if which == "tiny" else 0)


# --------------------------------------------------------------------- #
# the port stands alone
# --------------------------------------------------------------------- #

def _imports(path):
    """Top-level package names ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 40
    bad = {str(f.relative_to(ROOT)): sorted(_imports(f) & {"jax", "repro"})
           for f in files}
    assert {f: n for f, n in bad.items() if n} == {}
