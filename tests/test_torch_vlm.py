"""The port's VLM prefix (``models/transformer.py`` with ``arch_type ==
"vlm"``) and the two dense configs registered with it, mistral-nemo-12b
and yi-34b, against the JAX package, on the CPU in float32.

The reduced internvl2-76b takes a prefix of 16 projected patches ahead
of its text: ``loss_fn`` (the loss on the text only) and its grads, the
bucketed ``prefill_ragged`` with lengths that count the prefix, the
exact-length ``prefill`` and decode steps, and the ``Server``'s greedy
tokens with ``prefix_emb`` (the bucketed path) against the reference
``Server``'s; the engine serves its text from pages.  The reduced
mistral-nemo-12b and yi-34b: loss and grads.

Tolerances (``docs/kernels.md``'s model rows): loss 1e-5, grads 1e-4 of
each tensor's max, logits 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import registry as JR
from repro.models import transformer as JT
from repro.train import serve as JS
from repro_torch.configs import get_config
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.serving import GenerationRequest, ServingEngine
from repro_torch.train.serve import Server
from repro_torch.weights import _ref_leaf, from_jax_params


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these small models run many small ops, which
    the thread pools of several test workers on a shared CPU slow down
    many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "internvl2-76b"


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _close_to_max(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    tol = rel * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: {err:.3g} > {tol:.3g}"


def _load(arch, seed=5):
    jcfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    params = JR.init_params(jax.random.PRNGKey(seed), jcfg)
    model = from_jax_params(_np_tree(params), cfg, dtype=torch.float32,
                            device="cpu", trainable=True)
    return jcfg, cfg, params, model


@pytest.fixture(scope="module")
def vlm():
    return _load(ARCH)


def _prefix(cfg, B, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)


def _loss_and_grads_match(jcfg, cfg, params, model, batch):
    jb = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
          for k, v in batch.items()}
    (jloss, _), jgrads = jax.value_and_grad(JT.loss_fn, has_aux=True)(
        params, jcfg, jb, dtype=jnp.float32, remat=True)
    loss, _ = R.loss_fn(model, cfg,
                        {k: torch.from_numpy(v) for k, v in batch.items()},
                        dtype=torch.float32, remat=True)
    assert abs(loss.item() - float(jloss)) < 1e-5
    grads = torch.autograd.grad(loss, list(model.parameters()))
    jg = _np_tree(jgrads)
    for (n, _), g in zip(model.named_parameters(), grads):
        _close_to_max(g.numpy(), _ref_leaf(jg, n, cfg), 1e-4, n)
    return loss.item()


# --------------------------------------------------------------------- #
# training: the prefix ahead of the text, the loss on the text only
# --------------------------------------------------------------------- #

def test_vlm_loss_and_grads_match_jax(vlm):
    jcfg, cfg, params, model = vlm
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (2, 24))
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
             "prefix_emb": _prefix(cfg, 2, 7),
             "mask": (rng.random((2, 24)) > 0.2).astype(np.float32)}
    with_prefix = _loss_and_grads_match(jcfg, cfg, params, model, batch)
    del batch["prefix_emb"]
    assert _loss_and_grads_match(jcfg, cfg, params, model, batch) != \
        with_prefix


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "yi-34b"])
def test_dense_configs_train_like_jax(arch):
    jcfg, cfg, params, model = _load(arch, seed=8)
    assert cfg.arch_type == "dense" and R.family(cfg) is T
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab_size, (2, 40))
    _loss_and_grads_match(jcfg, cfg, params, model, {
        "tokens": toks, "labels": np.roll(toks, -1, axis=1)})


# --------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------- #

def test_prefill_ragged_with_prefix_matches_jax(vlm):
    """The bucketed prefill: text right-padded to a bucket of 16 behind
    the prefix, lengths counting the prefix; logits at each row's last
    real token within 1e-4, and K/V at the real positions."""
    jcfg, cfg, params, model = vlm
    rng = np.random.default_rng(10)
    P = cfg.frontend_tokens
    text = np.array([9, 16, 3])
    toks = rng.integers(0, cfg.vocab_size, (3, 16))
    lengths = P + text
    pre = _prefix(cfg, 3, 11)
    jl, jk, jv = JR.prefill_ragged(params, jcfg, jnp.asarray(toks, jnp.int32),
                                   jnp.asarray(lengths, jnp.int32),
                                   prefix_emb=jnp.asarray(pre),
                                   dtype=jnp.float32)
    with torch.no_grad():
        logits, k, v = R.prefill_ragged(
            model, cfg, torch.from_numpy(toks),
            torch.from_numpy(lengths.astype(np.int32)),
            prefix_emb=torch.from_numpy(pre))
    _close_to_max(logits.numpy(), np.asarray(jl), 1e-4, "logits")
    assert k.shape == (cfg.n_layers, 3, P + 16, cfg.n_kv_heads, cfg.head_dim)
    for b, n in enumerate(lengths):
        _close_to_max(k[:, b, :n].numpy(), np.asarray(jk)[:, b, :n], 1e-4)
        _close_to_max(v[:, b, :n].numpy(), np.asarray(jv)[:, b, :n], 1e-4)


def test_prefill_and_decode_with_prefix_match_jax(vlm):
    jcfg, cfg, params, model = vlm
    rng = np.random.default_rng(12)
    toks = rng.integers(0, cfg.vocab_size, (2, 6))
    pre = _prefix(cfg, 2, 13)
    jl, jcache = JR.prefill(params, jcfg, jnp.asarray(toks, jnp.int32),
                            prefix_emb=jnp.asarray(pre), cache_len_cap=40,
                            dtype=jnp.float32)
    with torch.no_grad():
        logits, cache = R.prefill(model, cfg, torch.from_numpy(toks),
                                  cache_len_cap=40,
                                  prefix_emb=torch.from_numpy(pre))
        assert cache.lengths.tolist() == \
            np.asarray(jcache.lengths).tolist() == [22, 22]
        _close_to_max(logits.numpy(), np.asarray(jl), 1e-4, "prefill")
        tok = logits[:, -1].argmax(-1, keepdim=True)
        for i in range(3):
            jl, jcache = JR.decode_step(params, jcfg, jcache,
                                        jnp.asarray(tok.numpy(), jnp.int32),
                                        dtype=jnp.float32)
            logits, cache = R.decode_step(model, cfg, cache, tok)
            _close_to_max(logits.numpy(), np.asarray(jl), 1e-4, f"step {i}")
            tok = logits[:, -1].argmax(-1, keepdim=True)


def test_server_with_prefix_matches_jax_server(vlm):
    """The bucketed Server with the patches as ``prefix_emb``: greedy
    tokens equal the reference Server's; the bucket plus the prefix must
    fit ``max_len``."""
    jcfg, cfg, params, _ = vlm
    model = from_jax_params(_np_tree(params), cfg, dtype=torch.float32,
                            device="cpu")
    rng = np.random.default_rng(14)
    toks = rng.integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    pre = _prefix(cfg, 2, 15)
    with pytest.warns(DeprecationWarning):
        want = JS.Server(jcfg, params, max_len=64,
                         dtype=jnp.float32).generate(
            toks, 12, prefix_emb=jnp.asarray(pre))
    srv = Server(cfg, model, max_len=64, dtype=torch.float32)
    with pytest.warns(DeprecationWarning):
        got = srv.generate(toks, 12, prefix_emb=pre)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert srv.bucketed and srv.n_prefill_executables == 1
    with pytest.raises(ValueError, match="prefix"):
        srv.prefill(torch.from_numpy(toks).repeat(1, 5).long(),
                    prefix_emb=pre)
    with pytest.warns(DeprecationWarning), \
            pytest.raises(ValueError, match="full cache"):
        srv.generate(toks, 40, prefix_emb=pre)


def test_engine_serves_the_vlm_text_from_pages(vlm):
    """The engine serves the VLM's text (no prefix), as the reference's
    does; its tokens equal the Server's on the same prompt."""
    _, cfg, params, _ = vlm
    model = from_jax_params(_np_tree(params), cfg, dtype=torch.float32,
                            device="cpu")
    assert R.serving_mode(cfg) == "paged"
    eng = ServingEngine(cfg, model, decode_slots=2, page_size=8, max_len=48,
                        dtype=torch.float32)
    prompt = np.random.default_rng(16).integers(0, cfg.vocab_size, (9,))
    rid = eng.submit(GenerationRequest(prompt=prompt.astype(np.int32),
                                       max_new_tokens=6))
    while not eng.done:
        eng.step()
    srv = Server(cfg, model, max_len=48, dtype=torch.float32)
    with pytest.warns(DeprecationWarning):
        want = srv.generate(prompt[None], 6)
    assert list(eng.result(rid).tokens) == want[0].tolist()
