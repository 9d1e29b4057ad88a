"""``repro_torch.kernels.ops`` against ``repro.kernels.ops`` on the CPU, at
small shapes, float32, at ``docs/kernels.md``'s tolerance for a kernel's
forward against its plain version (2e-5 abs/rel).

- ``use_pallas=False``: the port's plain versions (``attention_ref``,
  ``rmsnorm_ref``, the naive sequential ``ssd_ref``) against the
  reference's.
- ``use_pallas=True``: on the CPU the port routes through
  ``kernels.backend`` to the kernels' plain versions (the chunked scan
  for ``ssd``), held to the reference's Pallas kernels in interpret
  mode; ``flash_attention(causal=False)`` runs the port's chunked
  attention (the port has no bidirectional kernel).
- The mapping is explicit: ``use_pallas=False`` is the plain version
  itself, bit for bit, and there is no environment switch.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JO
from repro_torch.kernels import ops as PO
from repro_torch.kernels import ref as R

TOL = 2e-5


def _close(got, want, tol=TOL):
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _qkv(seed=0, B=2, H=4, Hkv=2, S=64, hd=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd))]


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention(causal, use_pallas):
    q, k, v = _qkv(1 + causal)
    want = JO.flash_attention(*(jnp.asarray(t) for t in (q, k, v)),
                              causal=causal, use_pallas=use_pallas)
    got = PO.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                             causal=causal, use_pallas=use_pallas)
    _close(got, want)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_rmsnorm(use_pallas):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    s = (0.1 * rng.standard_normal(64)).astype(np.float32)
    want = JO.rmsnorm(jnp.asarray(x), jnp.asarray(s), use_pallas=use_pallas)
    got = PO.rmsnorm(torch.from_numpy(x), torch.from_numpy(s),
                     use_pallas=use_pallas)
    _close(got, want)


def _ssd_inputs(seed=4, B=2, S=64, H=4, P=16, N=8):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(
        np.float32) * 0.5
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    return xh, dt, A, Bm, Cm, D


@pytest.mark.parametrize("use_pallas", [False, True])
def test_ssd(use_pallas):
    args = _ssd_inputs()
    wy, wh = JO.ssd(*(jnp.asarray(a) for a in args), chunk=16,
                    use_pallas=use_pallas)
    gy, gh = PO.ssd(*(torch.from_numpy(a) for a in args), chunk=16,
                    use_pallas=use_pallas)
    _close(gy, wy)
    _close(gh, wh)


def test_use_pallas_false_is_the_plain_version_itself():
    q, k, v = (torch.from_numpy(t) for t in _qkv(5))
    assert torch.equal(PO.flash_attention(q, k, v, use_pallas=False),
                       R.attention_ref(q, k, v)[0])
    args = [torch.from_numpy(a) for a in _ssd_inputs(6)]
    for a, b in zip(PO.ssd(*args, use_pallas=False), R.ssd_ref(*args)):
        assert torch.equal(a, b)
    x, s = torch.randn(4, 32), torch.zeros(32)
    assert torch.equal(PO.rmsnorm(x, s, use_pallas=False),
                       R.rmsnorm_ref(x, s))
    assert "os.environ" not in inspect.getsource(PO)
