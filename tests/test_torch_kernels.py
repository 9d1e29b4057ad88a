"""The port's kernel ops against the JAX package's kernels.

On the CPU, ``repro_torch.kernels.backend`` runs the plain PyTorch
versions; these tests hold them against the reference's Pallas kernels
(interpret mode) and its XLA entries, on the same numpy inputs, in
float32 at the tolerance of ``docs/kernels.md`` (2e-5).

The hand-written CUDA kernels themselves are held against these plain
versions on the card by ``tests/test_torch_card.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import backend as JKB
from repro.kernels import ref as jref
from repro.kernels.flash_attention import _flash_fwd
from repro.kernels.paged import ragged_decode_attention as j_ragged
from repro.kernels.rmsnorm import rmsnorm as j_rmsnorm
from repro_torch.kernels import backend as KB
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import paged as PG
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as RN

F32 = dict(atol=2e-5, rtol=2e-5)


def _normal(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# --------------------------------------------------------------------- #
# CPU: the port's plain versions against the reference's kernels
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("shape", [(4, 7, 64), (33, 256), (1, 1024)])
def test_rmsnorm_matches_jax(shape):
    rng = np.random.default_rng(0)
    x, s = _normal(rng, shape), _normal(rng, shape[-1:], 0.1)
    got = KB.rmsnorm(_t(x), _t(s), eps=1e-5).numpy()
    pallas = np.asarray(j_rmsnorm(jnp.asarray(x), jnp.asarray(s), eps=1e-5,
                                  interpret=True))
    xla = np.asarray(jref.rmsnorm_ref(jnp.asarray(x), jnp.asarray(s), 1e-5))
    np.testing.assert_allclose(got, pallas, **F32)
    np.testing.assert_allclose(got, xla, **F32)


@pytest.mark.parametrize("B,H,Hkv,S,hd,blk", [
    (2, 4, 2, 32, 16, 16),      # GQA, S a block multiple
    (1, 4, 1, 40, 32, 16),      # MQA, ragged tail
    (1, 2, 2, 17, 8, 8),        # MHA, ragged tail
])
def test_attention_and_lse_match_jax_flash(B, H, Hkv, S, hd, blk):
    rng = np.random.default_rng(1)
    q = _normal(rng, (B, H, S, hd))
    k = _normal(rng, (B, Hkv, S, hd))
    v = _normal(rng, (B, Hkv, S, hd))
    # the Pallas kernel needs S a block multiple: zero-pad (padded keys
    # sit above every real query's causal reach) and slice
    Sp = -(-S // blk) * blk
    pad = ((0, 0), (0, 0), (0, Sp - S), (0, 0))
    j_out, j_lse = _flash_fwd(jnp.asarray(np.pad(q, pad)),
                              jnp.asarray(np.pad(k, pad)),
                              jnp.asarray(np.pad(v, pad)), causal=True,
                              block_q=blk, block_k=blk, interpret=True)
    j_out = np.asarray(j_out)[:, :, :S]
    j_lse = np.asarray(j_lse)[:, :S]

    out, lse = ref.attention_ref(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(out.numpy(), j_out, **F32)
    np.testing.assert_allclose(lse.numpy(), j_lse, **F32)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jref.attention_ref(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))), **F32)

    # the models' layout through the backend, against the reference's
    # padded Pallas route
    qm, km, vm = (np.swapaxes(a, 1, 2) for a in (q, k, v))
    got = KB.attention(_t(qm), _t(km), _t(vm)).numpy()
    want = np.asarray(JKB.attention(
        jnp.asarray(qm), jnp.asarray(km), jnp.asarray(vm), causal=True,
        backend="pallas_interpret", block_q=blk, block_k=blk))
    np.testing.assert_allclose(got, want, **F32)


def _decode_inputs(rng, B, H, Hkv, Skv, hd):
    q = _normal(rng, (B, 1, H, hd))
    k = _normal(rng, (B, Skv, Hkv, hd))
    v = _normal(rng, (B, Skv, Hkv, hd))
    return q, k, v


@pytest.mark.parametrize("H,Hkv", [(4, 2), (2, 2), (4, 1)])
def test_ragged_decode_matches_jax(H, Hkv):
    """Ragged lengths with stale data past each length (every slot holds
    random junk) and an inactive slot (length 0)."""
    rng = np.random.default_rng(2)
    B, Skv, hd = 4, 24, 16
    q, k, v = _decode_inputs(rng, B, H, Hkv, Skv, hd)
    lengths = np.array([5, 23, 0, 12], np.int32)
    got = KB.paged_decode_attention(_t(q), _t(k), _t(v),
                                    _t(lengths)).numpy()
    pallas = np.asarray(j_ragged(
        jnp.asarray(q[:, 0]), jnp.asarray(np.swapaxes(k, 1, 2)),
        jnp.asarray(np.swapaxes(v, 1, 2)), jnp.asarray(lengths),
        block_k=8, interpret=True))
    xla = np.asarray(JKB.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        backend="xla"))
    np.testing.assert_allclose(got[:, 0], pallas, **F32)
    np.testing.assert_allclose(got, xla, **F32)


def test_ragged_decode_ignores_stale_tail():
    rng = np.random.default_rng(3)
    q, k, v = _decode_inputs(rng, 3, 4, 2, 16, 8)
    lengths = np.array([3, 15, 0], np.int32)
    a = KB.paged_decode_attention(_t(q), _t(k), _t(v), _t(lengths))
    k2, v2 = k.copy(), v.copy()
    for b, n in enumerate(lengths):
        k2[b, n + 1:] = 1e4
        v2[b, n + 1:] = -1e4
    b_ = KB.paged_decode_attention(_t(q), _t(k2), _t(v2), _t(lengths))
    assert torch.equal(a, b_)


def test_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never runs its plain version: given a tensor that
    is not on a CUDA device it raises before building anything."""
    before = (RN.launches, FA.launches, PG.launches)
    x = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        RN.rmsnorm_fwd(x, torch.zeros(64))
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_fwd(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        PG.ragged_decode_attention(torch.zeros(1, 2, 64), q, q,
                                   torch.zeros(1, dtype=torch.int32))
    assert (RN.launches, FA.launches, PG.launches) == before


def test_backend_refuses_other_devices():
    x = torch.zeros(2, 64, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        KB.rmsnorm(x, torch.zeros(64, device="meta"))
