"""The port's attention module against the JAX package's, on the same
numpy inputs and weights, in float32 on the CPU (tolerance 1e-5: the
two frameworks sum in other orders): ``chunked_attention`` with windows,
offsets, length masks and explicit key positions; the windowed
``attn_forward``; the caches (``init_cache``, ``init_ring_cache``,
``ring_from_prefill``); and ``decode_attn`` in its three forms (full
cache at one depth, full cache at per-request depths, ring), whose
attention runs the ragged decode's plain version (``ragged_decode_ref``)
where the reference runs its chunked scan."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro_torch.models import attention as A


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
B, H, HKV, HD, D = 2, 4, 2, 16, 32


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=what, **TOL)


@pytest.fixture(scope="module")
def layer():
    """The reference's attention weights and the port's module holding
    them."""
    params = JA.init_attention(jax.random.PRNGKey(0), D, H, HKV, HD, 2)
    params = jax.tree.map(np.asarray, params)
    mod = A.Attention(D, H, HKV, HD, dtype=torch.float32, device="cpu")
    for n, w in params.items():
        getattr(mod, n).data.copy_(_t(w))
    return params, mod


# --------------------------------------------------------------------- #
# chunked attention
# --------------------------------------------------------------------- #

def _chunked_case(form, Sk, rng):
    """(q, k, v, keyword arguments) of one form of call: self-attention
    over Sk positions; a block of 3 queries at offset 20 with a length
    mask; per-row (B, 1) offsets and (B, 1, 1) lengths; explicit key
    positions of a ring (a permutation with empty slots)."""
    Sq = Sk if form == "self" else 3
    q = _normal(rng, (B, Sq, H, HD))
    k = _normal(rng, (B, Sk, HKV, HD))
    v = _normal(rng, (B, Sk, HKV, HD))
    if form == "self":
        return q, k, v, {}
    if form == "offset":
        return q, k, v, dict(q_offset=20, kv_len=23)
    if form == "rows":
        off = np.array([[5], [31]], np.int32)
        return q, k, v, dict(q_offset=off, kv_len=off[:, :, None] + 3)
    kpos = rng.permutation(Sk).astype(np.int32) + 10
    kpos[rng.choice(Sk, 5, replace=False)] = -1
    return q, k, v, dict(q_offset=Sk + 7, kpos=kpos)


@pytest.mark.parametrize("window", [None, 1, 7, 16])
@pytest.mark.parametrize("chunk", [8, 12, 64])
@pytest.mark.parametrize("form", ["self", "offset", "rows", "kpos"])
def test_chunked_attention_matches_reference(form, chunk, window):
    """Chunks of 8 divide Sk = 40, 12 do not (keys padded at position
    -1), 64 exceed it; windows of 1, 7 and 16."""
    rng = np.random.default_rng([len(form), chunk, window or 0])
    q, k, v, kw = _chunked_case(form, 40, rng)
    want = JA.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, chunk=chunk,
        **{n: jnp.asarray(a) for n, a in kw.items()})
    got = A.chunked_attention(_t(q), _t(k), _t(v), causal=True,
                              window=window, chunk=chunk,
                              **{n: (_t(a) if isinstance(a, np.ndarray)
                                     else a) for n, a in kw.items()})
    _close(got, want)


def test_chunked_attention_not_causal():
    rng = np.random.default_rng(1)
    q, k, v, _ = _chunked_case("self", 40, rng)
    want = JA.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=False, chunk=12)
    _close(A.chunked_attention(_t(q), _t(k), _t(v), causal=False,
                               chunk=12), want)


@pytest.mark.parametrize("window", [None, 4, 16])
def test_attn_forward_matches_reference(layer, window):
    """Full layers take the flash path's plain version, windowed layers
    the chunked attention; both with RoPE, K/V returned after it."""
    params, mod = layer
    x = _normal(np.random.default_rng(2), (B, 21, D))
    want, (wk, wv) = JA.attn_forward(
        params, jnp.asarray(x), n_heads=H, n_kv_heads=HKV, head_dim=HD,
        rope_theta=100.0, causal=True, window=window, chunk=8)
    got, (k, v) = A.attn_forward(mod, _t(x), n_heads=H, n_kv_heads=HKV,
                                 head_dim=HD, rope_theta=100.0,
                                 window=window)
    _close(got, want)
    _close(k, wk)
    _close(v, wv)


# --------------------------------------------------------------------- #
# caches
# --------------------------------------------------------------------- #

def test_empty_caches_match_reference():
    want = JA.init_cache(B, 12, HKV, HD, dtype=jnp.float32)
    got = A.init_cache(B, 12, HKV, HD, dtype=torch.float32, device="cpu")
    assert set(got) == set(want) == {"k", "v"}
    want = JA.init_ring_cache(B, 8, HKV, HD, dtype=jnp.float32)
    got = A.init_ring_cache(B, 8, HKV, HD, dtype=torch.float32,
                            device="cpu")
    assert set(got) == set(want) == {"k", "v", "pos"}
    for n in want:
        assert np.array_equal(got[n].numpy(), np.asarray(want[n])), n
        assert got[n].numpy().dtype == np.asarray(want[n]).dtype, n


@pytest.mark.parametrize("S", [5, 8, 13, 19])
def test_ring_from_prefill_matches_reference(S):
    """W = 8: S < W (empty slots at -1), S = W, and S > W (position p at
    slot p mod W, the last W positions)."""
    W = 8
    rng = np.random.default_rng(S)
    k, v = _normal(rng, (B, S, HKV, HD)), _normal(rng, (B, S, HKV, HD))
    want = JA.ring_from_prefill(jnp.asarray(k), jnp.asarray(v), S, W)
    got = A.ring_from_prefill(_t(k), _t(v), S, W)
    for n in ("k", "v", "pos"):
        assert np.array_equal(got[n].numpy(), np.asarray(want[n])), n
    assert got["pos"].dtype == torch.int32
    pos = got["pos"].numpy()
    live = pos >= 0
    assert np.array_equal(np.flatnonzero(live) % W, pos[live] % W)


# --------------------------------------------------------------------- #
# decode_attn
# --------------------------------------------------------------------- #

def _prefilled(mod, params, x, S, cap):
    """Both packages' full caches of ``cap`` rows after prefilling x[:,
    :S] (the reference's from its own forward)."""
    _, (k, v) = JA.attn_forward(params, jnp.asarray(x[:, :S]), n_heads=H,
                                n_kv_heads=HKV, head_dim=HD,
                                rope_theta=100.0, causal=True, chunk=8)
    pad = ((0, 0), (0, cap - S), (0, 0), (0, 0))
    jc = {"k": jnp.pad(k, pad), "v": jnp.pad(v, pad)}
    pc = {n: _t(a) for n, a in jc.items()}
    return jc, pc


def _decode_both(params, mod, x, jc, pc, cache_len, window=None):
    want, jc = JA.decode_attn(params, jnp.asarray(x), jc,
                              jnp.asarray(cache_len), n_heads=H,
                              n_kv_heads=HKV, head_dim=HD, rope_theta=100.0,
                              window=window)
    got, same = A.decode_attn(mod, _t(x), pc, _t(cache_len), n_heads=H,
                              n_kv_heads=HKV, head_dim=HD, rope_theta=100.0,
                              window=window)
    assert same is pc                          # written in place
    _close(got, want, "out")
    for n in jc:
        _close(pc[n], jc[n], n)
    return jc, pc


def test_decode_full_cache_at_one_depth(layer):
    params, mod = layer
    x = _normal(np.random.default_rng(3), (B, 16, D))
    jc, pc = _prefilled(mod, params, x, 10, 16)
    for t in range(10, 14):
        jc, pc = _decode_both(params, mod, x[:, t:t + 1], jc, pc,
                              np.int32(t))


def test_decode_full_cache_at_per_request_depths(layer):
    """Rows at depths 6 and 11 of one cache, each written at its own
    position; the next steps carry on from there."""
    params, mod = layer
    rng = np.random.default_rng(4)
    x = _normal(rng, (B, 16, D))
    jc, pc = _prefilled(mod, params, x, 11, 16)
    depth = np.array([6, 11], np.int32)
    for step in range(3):
        tok = np.stack([x[b, depth[b] + step] for b in range(B)])[:, None]
        jc, pc = _decode_both(params, mod, tok, jc, pc, depth + step)


@pytest.mark.parametrize("S0", [3, 8, 12])
def test_decode_ring_matches_reference(layer, S0):
    """A ring of W = 8 built from a prefill of S0 (below, at and past W),
    then 10 steps, which wrap it: out, K, V and pos as the reference's
    (its chunked scan over ``kpos``; here the ragged decode at
    min(pos, W - 1))."""
    params, mod = layer
    W = 8
    x = _normal(np.random.default_rng(5 + S0), (B, S0 + 10, D))
    _, (k, v) = JA.attn_forward(params, jnp.asarray(x[:, :S0]), n_heads=H,
                                n_kv_heads=HKV, head_dim=HD,
                                rope_theta=100.0, causal=True, window=W,
                                chunk=8)
    jc = JA.ring_from_prefill(k, v, S0, W)
    pc = A.ring_from_prefill(_t(k), _t(v), S0, W)
    for t in range(S0, S0 + 10):
        jc, pc = _decode_both(params, mod, x[:, t:t + 1], jc, pc,
                              np.int32(t), window=W)


def test_ring_cache_decode_matches_full(layer):
    """The reference's ``test_ring_cache_decode_matches_full``: a ring
    decode (W = 8) across a wrap equals the windowed forward over the
    whole sequence, position by position."""
    params, mod = layer
    W, S0 = 8, 12
    x = _t(_normal(np.random.default_rng(6), (1, S0 + 6, D)))
    kw = dict(n_heads=H, n_kv_heads=HKV, head_dim=HD, rope_theta=10.0)
    full, _ = A.attn_forward(mod, x, window=W, **kw)
    _, (k, v) = A.attn_forward(mod, x[:, :S0], window=W, **kw)
    cache = A.ring_from_prefill(k, v, S0, W)
    for t in range(6):
        o, cache = A.decode_attn(mod, x[:, S0 + t:S0 + t + 1], cache,
                                 torch.tensor(S0 + t), window=W, **kw)
        torch.testing.assert_close(o, full[:, S0 + t:S0 + t + 1], **TOL)


def test_decode_refuses_what_it_cannot_compute(layer):
    _, mod = layer
    kw = dict(n_heads=H, n_kv_heads=HKV, head_dim=HD, rope_theta=10.0)
    x = torch.zeros(B, 1, D)
    ring = A.init_ring_cache(B, 8, HKV, HD, dtype=torch.float32,
                             device="cpu")
    with pytest.raises(ValueError, match="ring caches share"):
        A.decode_attn(mod, x, ring, torch.tensor([1, 2]), window=8, **kw)
    with pytest.raises(ValueError, match="wider than the window"):
        A.decode_attn(mod, x, ring, torch.tensor(1), window=4, **kw)
    full = A.init_cache(B, 8, HKV, HD, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="ring cache"):
        A.decode_attn(mod, x, full, torch.tensor(1), window=4, **kw)
    half = A.init_cache(B, 8, HKV, HD, dtype=torch.bfloat16, device="cpu")
    with pytest.raises(TypeError, match="dtype"):
        A.decode_attn(mod, x, half, torch.tensor(1), **kw)
