"""The port's encoder-decoder (``models/encdec.py``) against the JAX
package's, on the CPU in float32.

Both arch types of the family: the reduced seamless-m4t-medium
(``"audio"``; ``reduced()`` keeps its 12 encoder layers) and a tiny
``"encdec"`` config (2 encoder layers).  The same numpy weights
(``weights.from_jax_params``) and inputs go through both packages:
``loss_fn`` and its grads (with and without remat), ``prefill`` and
several decode steps, the ``Server``'s greedy tokens with the source
frames as ``prefix_emb``, the decode's cross-attention through
``ragged_decode_ref`` against the reference's ``_cross_attend``, and a
5-step AdamW run of the engine's grad step, micro-batched, against the
reference's ``make_grad_step`` on the same batches.  Also the
reference's two config faults for ``"audio"``, which the port keeps.

Tolerances (``docs/kernels.md``'s model rows): loss 1e-5, grads 1e-4 of
each tensor's max, logits 1e-4, the training run's losses 5e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import encdec as JE
from repro.models import registry as JR
from repro.optim import optimizers as JO
from repro.train import serve as JS
from repro.train.engine import make_grad_step as j_make_grad_step
from repro_torch.configs import (OptimizerConfig, RunConfig, ScheduleConfig,
                                 get_config)
from repro_torch.configs.base import ModelConfig
from repro_torch.core.seesaw import build_plan
from repro_torch.models import encdec as E
from repro_torch.models import registry as R
from repro_torch.optim import optimizers as O
from repro_torch.serving import ServingEngine
from repro_torch.train import engine as TE
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


ARCH = "seamless-m4t-medium"
TINY = dict(name="torch-tiny-encdec", arch_type="encdec", n_layers=2,
            n_encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=128, vocab_size=256, max_seq_len=128,
            rope_theta=1e4, act="gelu", frontend_tokens=24,
            frontend_dim=64)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _close_to_max(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    tol = rel * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: {err:.3g} > {tol:.3g}"


def _configs(kind):
    if kind == "audio":
        return j_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    return JModelConfig(**TINY), ModelConfig(**TINY)


@pytest.fixture(scope="module", params=["audio", "encdec"])
def fam(request):
    """(kind, reference config, port config, reference params, port model
    in float32)."""
    jcfg, cfg = _configs(request.param)
    assert cfg.arch_type == request.param
    params = JR.init_params(jax.random.PRNGKey(3), jcfg)
    model = from_jax_params(_np_tree(params), cfg, dtype=torch.float32,
                            device="cpu", trainable=True)
    return request.param, jcfg, cfg, params, model


def _batch(cfg, B=2, S=20, seed=4):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    return {"src_emb": rng.standard_normal(
                (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32),
            "tokens": toks, "labels": np.roll(toks, -1, axis=1),
            "mask": (rng.random((B, S)) > 0.2).astype(np.float32)}


def _jax_batch(b):
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in b.items()}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


# --------------------------------------------------------------------- #
# configs and the weights' name map
# --------------------------------------------------------------------- #

def test_reference_config_faults_are_kept():
    """The reference counts seamless's parameters with the formula of the
    decoder alone (its encoder and cross-attention are added for
    ``"encdec"`` only) and ``reduced()`` keeps all 12 encoder layers for
    ``"audio"``.  The port keeps both (plans and token budgets must equal
    the reference's); the model holds the true count."""
    for jc, c in ((j_get_config(ARCH), get_config(ARCH)),
                  (j_get_config(ARCH).reduced(), get_config(ARCH).reduced())):
        held = jax.eval_shape(lambda: JR.init_params(jax.random.PRNGKey(0),
                                                     jc))
        n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(held))
        assert c.param_count() == jc.param_count() < n_ref
        with torch.device("meta"):
            model = E.EncDec(c, dtype=torch.float32, device="meta")
        assert sum(p.numel() for p in model.parameters()) == n_ref
    assert get_config(ARCH).param_count() == 675_729_408
    assert n_ref == 7_086_080
    assert get_config(ARCH).reduced().n_encoder_layers == 12
    assert ModelConfig(**TINY).reduced().n_encoder_layers == 2


def test_from_jax_params_maps_the_encdec_tree(fam):
    kind, jcfg, cfg, params, model = fam
    tree = _np_tree(params)
    names = dict(model.named_parameters())
    assert len(names) == (
        cfg.n_encoder_layers * len(jax.tree.leaves(tree["encoder"]))
        + cfg.n_layers * len(jax.tree.leaves(tree["decoder"]))
        + len(jax.tree.leaves(tree["embed"])) + 2)
    for n, p in names.items():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      _ref_leaf(tree, n, cfg))
    assert "decoder.1.norm3" in names and "enc_norm" in names


# --------------------------------------------------------------------- #
# the training loss
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_jax(fam, remat):
    kind, jcfg, cfg, params, model = fam
    b = _batch(cfg)
    (jloss, jm), jgrads = jax.value_and_grad(JE.loss_fn, has_aux=True)(
        params, jcfg, _jax_batch(b), dtype=jnp.float32, remat=remat)
    loss, m = R.loss_fn(model, cfg, _torch_batch(b), dtype=torch.float32,
                        remat=remat)
    assert abs(loss.item() - float(jloss)) < 1e-5
    assert abs(m["z_sq"].item() - float(jm["z_sq"])) < 1e-5 * float(
        jm["z_sq"])
    grads = torch.autograd.grad(loss, list(model.parameters()))
    jg = _np_tree(jgrads)
    for (n, _), g in zip(model.named_parameters(), grads):
        _close_to_max(g.numpy(), _ref_leaf(jg, n, cfg), 1e-4, n)


def test_concrete_inputs_match_reference(fam):
    kind, jcfg, cfg, _, _ = fam
    for mode, key in (("train", "src_emb"), ("prefill", "prefix_emb")):
        want = JR.concrete_inputs(jcfg, mode, 2, cfg.frontend_tokens + 9,
                                  seed=1)
        got = R.concrete_inputs(cfg, mode, 2, cfg.frontend_tokens + 9,
                                seed=1, device="cpu")
        assert set(got) == set(want) and key in got
        assert got["tokens"].shape == (2, 9)
        for k, v in want.items():
            np.testing.assert_array_equal(
                got[k].float().numpy(), np.asarray(v, np.float32), k)
    assert R.text_len(cfg, 5) == JR.text_len(jcfg, 5) == 1


# --------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------- #

def test_prefill_and_decode_match_jax(fam):
    """The exact-length prefill and 4 decode steps: logits within 1e-4
    of the reference's; the cache's ek/ev in the kernel's layout, never
    written by a decode step."""
    kind, jcfg, cfg, params, model = fam
    rng = np.random.default_rng(7)
    B, S, cap = 2, 9, 24
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    src = rng.standard_normal((B, cfg.frontend_tokens,
                               cfg.d_model)).astype(np.float32)
    jl, jcache = JR.prefill(params, jcfg, jnp.asarray(toks, jnp.int32),
                            prefix_emb=jnp.asarray(src), cache_len_cap=cap,
                            dtype=jnp.float32)
    with torch.no_grad():
        model.requires_grad_(False)
        logits, cache = R.prefill(model, cfg, torch.from_numpy(toks),
                                  cache_len_cap=cap,
                                  prefix_emb=torch.from_numpy(src))
        _close_to_max(logits.numpy(), np.asarray(jl), 1e-4, "prefill")
        np.testing.assert_allclose(
            cache.data["ek"].numpy(),
            np.asarray(jcache.data["ek"]).transpose(0, 1, 3, 2, 4),
            atol=1e-5, rtol=1e-5)
        ek = cache.data["ek"].clone()
        tok = logits[:, -1].argmax(-1, keepdim=True)
        for i in range(4):
            jl, jcache = JR.decode_step(params, jcfg, jcache,
                                        jnp.asarray(tok.numpy(), jnp.int32),
                                        dtype=jnp.float32)
            logits, cache = R.decode_step(model, cfg, cache, tok)
            _close_to_max(logits.numpy(), np.asarray(jl), 1e-4, f"step {i}")
            tok = logits[:, -1].argmax(-1, keepdim=True)
        assert torch.equal(cache.data["ek"], ek)
        assert cache.lengths.tolist() == [S + 4] * B
    model.requires_grad_(True)


def test_cross_decode_matches_reference_cross_attend(fam):
    """One token's cross-attention through the ragged decode's plain
    version (every frame valid) against the reference's ``_cross_attend``
    (``chunked_attention(causal=False)``) at Sq = 1."""
    kind, jcfg, cfg, params, model = fam
    rng = np.random.default_rng(8)
    h = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((3, cfg.frontend_tokens,
                               cfg.d_model)).astype(np.float32)
    pa = jax.tree.map(lambda x: x[0], params["decoder"]["cross_attn"])
    jk, jv = JE._enc_kv(pa, jnp.asarray(enc), jcfg)
    want = JE._cross_attend(pa, jnp.asarray(h), jk, jv, jcfg)
    p = model.decoder[0].cross_attn
    with torch.no_grad():
        k, v = E._enc_kv(p, torch.from_numpy(enc), cfg)
        got = E._cross_decode(p, torch.from_numpy(h),
                              k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous(), cfg)
    _close_to_max(got.numpy(), np.asarray(want), 1e-5, "cross-attention")


def test_server_matches_jax_server(fam):
    """The blocking Server, source frames as ``prefix_emb``: greedy
    tokens equal to the reference Server's (exact-length path)."""
    kind, jcfg, cfg, params, _ = fam
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab_size, (2, 7)).astype(np.int32)
    src = rng.standard_normal((2, cfg.frontend_tokens,
                               cfg.d_model)).astype(np.float32)
    model = from_jax_params(_np_tree(params), cfg, dtype=torch.float32,
                            device="cpu")
    with pytest.warns(DeprecationWarning):
        want = JS.Server(jcfg, params, max_len=32,
                         dtype=jnp.float32).generate(
            toks, 10, prefix_emb=jnp.asarray(src))
    srv = Server(cfg, model, max_len=32, dtype=torch.float32)
    with pytest.warns(DeprecationWarning):
        got = srv.generate(toks, 10, prefix_emb=src)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert not srv.bucketed and srv.full_cache
    with pytest.raises(ValueError, match="full cache"):
        srv.generate(toks, 27, prefix_emb=src)
    with pytest.raises(ValueError, match="prefix_emb"):
        srv.generate(toks, 2)


def test_family_serves_through_the_server_only(fam):
    kind, _, cfg, _, model = fam
    assert R.family(cfg) is E and R.serving_mode(cfg) is None
    assert not R.supports_paged(cfg)
    with pytest.raises(NotImplementedError, match="train.serve.Server"):
        ServingEngine(cfg, model, dtype=torch.float32)


# --------------------------------------------------------------------- #
# training through the engine's grad step
# --------------------------------------------------------------------- #

def test_grad_step_run_matches_reference_make_grad_step(fam):
    """5 AdamW steps (clip 1.0) on the same batches: the port's
    ``PhaseEngine`` (the ``src_emb`` float leaf beside the token leaves
    in its stacked batch, micro-batched 2 ways) against the reference's
    ``make_grad_step`` at micro 2: losses within 5e-4, grad norms within
    1e-4 relative."""
    kind, jcfg, cfg, params, _ = fam
    B, S, lr = 4, 12, 3e-3
    batches = [_batch(cfg, B=B, S=S, seed=20 + i) for i in range(5)]
    for b in batches:
        del b["mask"]
    jopt = JO.adamw(grad_clip=1.0)
    jstep = jax.jit(j_make_grad_step(jcfg, jopt, micro_batches=2,
                                     dtype=jnp.float32, remat=True))
    jp, jo = params, jopt.init(params)
    jl = []
    for b in batches:
        jp, jo, m = jstep(jp, jo, _jax_batch(b), jnp.float32(lr))
        jl.append((float(m["loss"]), float(m["grad_norm"])))
    model = from_jax_params(_np_tree(params), cfg, dtype=torch.float32,
                            device="cpu", trainable=True)
    run = RunConfig(model=cfg, schedule=ScheduleConfig(kind="constant",
                                                       base_lr=lr,
                                                       warmup_frac=0.0),
                    optimizer=OptimizerConfig(kind="adamw"), seq_len=S,
                    global_batch_size=B, total_tokens=5 * B * S,
                    dtype="float32")
    opt = O.from_config(run.optimizer)
    plan = build_plan(kind="constant", base_lr=lr,
                      total_tokens=run.total_tokens, warmup_frac=0.0, b0=B)
    eng = TE.PhaseEngine(run, opt, plan, max_device_batch=2)
    assert eng.micro_batches(B) == 2
    st = opt.init(dict(model.named_parameters()))
    stacked = {k: torch.from_numpy(np.stack([b[k] for b in batches]))
               for k in batches[0]}
    assert stacked["src_emb"].dtype == torch.float32
    model, st, m = eng.run_chunk(model, st, 0, stacked, step=0)
    for i, (loss, gn) in enumerate(jl):
        assert float(m["lr"][i]) == np.float32(lr)
        assert abs(m["loss"][i].item() - loss) < 5e-4, i
        assert abs(m["grad_norm"][i].item() - gn) < 1e-4 * gn, i


def test_launchers_refuse_the_frontend_archs(capsys):
    """The token loader makes no source frames or patches: the training
    launcher refuses seamless and internvl with a clear error; the
    serving launcher refuses the enc-dec, naming the Server."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    for arch in (ARCH, "internvl2-76b"):
        with pytest.raises(SystemExit):
            launch_train.main(["--arch", arch, "--reduced", "--device",
                               "cpu", "--steps", "2"])
        assert "stub frontend" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="train.serve.Server"):
        launch_serve.main(["--arch", ARCH, "--device", "cpu"])
