"""The port's configs, layers, attention and ragged prefill against the
JAX package, on the same numpy inputs and weights, in float32 on the
CPU (tolerance 1e-5: the two frameworks sum in other orders)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import registry as JR
from repro.models import transformer as JT
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry as R
from repro_torch.models.attention import Attention, attn_forward
from repro_torch.models.layers import MLP, apply_rope, mlp
from repro_torch.serving import ServingEngine
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


TOL = dict(atol=1e-5, rtol=1e-5)

TINY = dict(name="torch-tiny", arch_type="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
            max_seq_len=64, rope_theta=1e4)


def _normal(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _load(module, arrays):
    for name, a in arrays.items():
        getattr(module, name).data.copy_(torch.from_numpy(np.asarray(a)))
    return module


# --------------------------------------------------------------------- #
# configs: the port's copies equal the reference's
# --------------------------------------------------------------------- #

def _field(cfg, name):
    """A config field, nested configs (``ssm``, ``moe``) as plain dicts:
    the two packages define their own dataclasses."""
    v = getattr(cfg, name)
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


@pytest.mark.parametrize("name", list_archs())
def test_configs_match_reference(name):
    ours, ref = get_config(name), j_get_config(name)
    for f in dataclasses.fields(ModelConfig):
        assert _field(ours, f.name) == _field(ref, f.name), f.name
    assert ours.padded_vocab == ref.padded_vocab
    assert ours.param_count() == ref.param_count()
    red, jred = ours.reduced(), ref.reduced()
    for f in dataclasses.fields(ModelConfig):
        assert _field(red, f.name) == _field(jred, f.name), f.name


def test_seesaw_150m_shapes():
    cfg = get_config("seesaw-150m")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff) == (12, 1024, 16, 16, 64, 4096)
    assert cfg.padded_vocab == cfg.vocab_size == 32128
    assert not cfg.tie_embeddings and cfg.rope_theta == 1e4


# --------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("ragged", [False, True])
def test_apply_rope_matches_jax(ragged):
    rng = np.random.default_rng(0)
    x = _normal(rng, (3, 7, 4, 16))
    pos = (rng.integers(0, 1000, (3, 7)) if ragged
           else np.broadcast_to(np.arange(7), (3, 7))).astype(np.int32)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_jax(act):
    rng = np.random.default_rng(1)
    d, f = 32, 64
    w = {"w_up": _normal(rng, (d, f), 0.1),
         "w_down": _normal(rng, (f, d), 0.1)}
    if act == "silu":
        w["w_gate"] = _normal(rng, (d, f), 0.1)
    x = _normal(rng, (2, 5, d))
    m = _load(MLP(d, f, act, dtype=torch.float32, device="cpu"), w)
    got = mlp(m, torch.from_numpy(x), act)
    want = JL.mlp({k: jnp.asarray(a) for k, a in w.items()}, jnp.asarray(x),
                  act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("H,Hkv,S", [(4, 2, 11), (2, 2, 16), (4, 1, 5)])
def test_attn_forward_matches_jax(H, Hkv, S):
    rng = np.random.default_rng(2)
    d, hd = 32, 16
    w = {"w_q": _normal(rng, (d, H * hd), 0.2),
         "w_k": _normal(rng, (d, Hkv * hd), 0.2),
         "w_v": _normal(rng, (d, Hkv * hd), 0.2),
         "w_o": _normal(rng, (H * hd, d), 0.2)}
    x = _normal(rng, (2, S, d))
    p = _load(Attention(d, H, Hkv, hd, dtype=torch.float32, device="cpu"), w)
    kw = dict(n_heads=H, n_kv_heads=Hkv, head_dim=hd, rope_theta=1e4)
    out, (k, v) = attn_forward(p, torch.from_numpy(x), **kw)
    j_out, (jk, jv) = JA.attn_forward(
        {n: jnp.asarray(a) for n, a in w.items()}, jnp.asarray(x), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)


# --------------------------------------------------------------------- #
# the whole prefill
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def tiny():
    jcfg = JModelConfig(**TINY)
    params = JR.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = ModelConfig(**TINY)
    model = from_jax_params(_np_tree(params), cfg, dtype=torch.float32,
                            device="cpu")
    return jcfg, params, cfg, model


def test_prefill_ragged_matches_jax(tiny):
    jcfg, params, cfg, model = tiny
    rng = np.random.default_rng(3)
    S = 16
    tokens = rng.integers(0, cfg.vocab_size, (3, S)).astype(np.int32)
    lengths = np.array([16, 9, 1], np.int32)
    j_logits, jk, jv = JT.prefill_ragged(params, jcfg, jnp.asarray(tokens),
                                         jnp.asarray(lengths),
                                         dtype=jnp.float32)
    logits, k, v = R.prefill_ragged(model, cfg,
                                    torch.from_numpy(tokens).long(),
                                    torch.from_numpy(lengths))
    assert logits.shape == (3, 1, cfg.padded_vocab)
    assert k.shape == (cfg.n_layers, 3, S, cfg.n_kv_heads, cfg.head_dim)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)


def test_from_jax_params_rejects_wrong_shapes(tiny):
    jcfg, params, cfg, _ = tiny
    tree = _np_tree(params)
    tree["layers"]["attn"]["w_q"] = tree["layers"]["attn"]["w_q"][..., :-1]
    with pytest.raises(ValueError, match="w_q"):
        from_jax_params(tree, cfg, dtype=torch.float32, device="cpu")


def test_from_jax_params_casts_matrices_keeps_norms_f32(tiny):
    jcfg, params, cfg, _ = tiny
    m = from_jax_params(_np_tree(params), cfg, dtype=torch.bfloat16,
                        device="cpu")
    assert m.dtype == torch.bfloat16
    assert m.layers[0].attn.w_q.dtype == torch.bfloat16
    assert m.layers[0].norm1.dtype == m.final_norm.dtype == torch.float32


# --------------------------------------------------------------------- #
# registry
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("arch_type,window", [
    ("dense", None), ("dense", 8), ("moe", None), ("ssm", None),
    ("hybrid", None), ("encdec", None)])
def test_serving_mode_matches_reference(arch_type, window):
    kw = dict(TINY, arch_type=arch_type, sliding_window=window)
    assert R.serving_mode(ModelConfig(**kw)) == \
        JR.serving_mode(JModelConfig(**kw))
    assert R.supports_paged(ModelConfig(**kw)) == \
        JR.supports_paged(JModelConfig(**kw))


@pytest.mark.parametrize("arch_type,slice_name", [
    ("hybrid", "other-families"), ("ssm", "Mamba-2")])
def test_unported_families_name_their_slice(arch_type, slice_name):
    """The RG-LRU hybrid is not ported at all.  Mamba-2 trains and serves from the
    recurrent state pool; the one serving path closed to it, the
    bucketed ragged prefill, says that Mamba-2 keeps the exact-length
    path."""
    cfg = ModelConfig(**dict(TINY, arch_type=arch_type))
    if arch_type == "ssm":
        model = R.init_model(cfg, dtype=torch.float32, device="cpu")
        assert ServingEngine(cfg, model, dtype=torch.float32).mode == \
            "state"
        with pytest.raises(NotImplementedError, match=slice_name):
            R.prefill_ragged(model, cfg, torch.zeros(1, 4).long(),
                             torch.tensor([4]))
        return
    with pytest.raises(NotImplementedError, match=slice_name):
        model = R.init_model(cfg, dtype=torch.float32, device="cpu")
        ServingEngine(cfg, model, dtype=torch.float32)


def test_init_model_follows_reference_rules():
    cfg = ModelConfig(**TINY)
    m = R.init_model(cfg, seed=0, dtype=torch.float32, device="cpu")
    again = R.init_model(cfg, seed=0, dtype=torch.float32, device="cpu")
    assert torch.equal(m.tok, again.tok)
    assert float(m.final_norm.abs().max()) == 0.0
    w_o = m.layers[0].attn.w_o
    assert abs(float(w_o.std()) - 0.02 / np.sqrt(4)) < 2e-3
    assert float(m.tok.abs().max()) <= 3 * 0.02 + 1e-7


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = ModelConfig(**TINY)
    with pytest.raises((RuntimeError, AssertionError)):
        R.init_model(cfg)                     # device defaults to cuda
