"""The split-row RMSNorm's plain versions against the reference, on the
CPU.

Mamba-2's gated norm on a model axis normalises rows whose d_inner
columns are cut over the model ranks.  Here a row of d is cut in 1, 2 or
4 parts, as that many ranks hold it: each part's partial sums
(``rmsnorm_split_sumsq_ref``, ``rmsnorm_split_dot_ref``) are added as the
all-reduce adds them, and each part's output and grads
(``rmsnorm_split_fwd_ref``, ``rmsnorm_split_bwd_ref``) are joined.  The
forward is held within 2e-5 of the JAX ``rmsnorm_ref``, dx and dscale
within 2e-5 of its VJP, float32, at d 512 and 5,120 (mamba2-2.7b's
d_inner).  ``kernels.backend.rmsnorm_split`` on one part is the whole
row's norm under autograd.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import rmsnorm_ref as j_rmsnorm_ref
from repro_torch.kernels import backend as KB
from repro_torch.kernels import ref

EPS = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(d, seed=0, rows=24):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, d)).astype(np.float32),
            (0.1 * rng.standard_normal(d)).astype(np.float32),
            rng.standard_normal((rows, d)).astype(np.float32))


def _split(x, s, g, parts):
    """The split row's output, dx and dscale over ``parts`` column
    blocks, the partial sums added as an all-reduce over the parts."""
    d = x.shape[1]
    xs, ss_, gs = (torch.from_numpy(a).chunk(parts, -1) for a in (x, s, g))
    ss = sum(ref.rmsnorm_split_sumsq_ref(a, b) for a, b in zip(xs, ss_))
    dot = sum(ref.rmsnorm_split_dot_ref(a, b, c)
              for a, b, c in zip(xs, ss_, gs))
    y = torch.cat([ref.rmsnorm_split_fwd_ref(a, b, ss, d, EPS)
                   for a, b in zip(xs, ss_)], -1)
    bwd = [ref.rmsnorm_split_bwd_ref(a, b, c, ss, dot, d, EPS)
           for a, b, c in zip(xs, ss_, gs)]
    return (y, torch.cat([b[0] for b in bwd], -1),
            torch.cat([b[1] for b in bwd]))


@pytest.mark.parametrize("d", [512, 5120])
@pytest.mark.parametrize("parts", [1, 2, 4])
def test_split_row_matches_reference_and_its_vjp(parts, d):
    x, s, g = _inputs(d, seed=parts)
    y, dx, ds = _split(x, s, g, parts)
    want, vjp = jax.vjp(lambda a, b: j_rmsnorm_ref(a, b, EPS),
                        jnp.asarray(x), jnp.asarray(s))
    wdx, wds = vjp(jnp.asarray(g))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(wdx), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(ds.numpy(), np.asarray(wds), atol=2e-5,
                               rtol=2e-5)


def test_backend_split_row_on_one_part_is_the_whole_row_norm():
    """Under autograd, with a reduce that leaves the sums as they are."""
    x, s, g = (torch.from_numpy(a) for a in _inputs(512, seed=9))
    x = x.reshape(2, 12, 512).requires_grad_()
    s.requires_grad_()
    y = KB.rmsnorm_split(x, s, d_full=512, reduce=lambda t: t, eps=EPS)
    dx, ds = torch.autograd.grad(y, (x, s), g.reshape(2, 12, 512))
    want = ref.rmsnorm_ref(x, s, EPS)
    wdx, wds = ref.rmsnorm_bwd_ref(x, s, g.reshape(2, 12, 512), EPS)
    torch.testing.assert_close(y, want, atol=2e-6, rtol=2e-6)
    torch.testing.assert_close(dx, wdx, atol=2e-6, rtol=2e-6)
    torch.testing.assert_close(ds, wds, atol=2e-5, rtol=2e-5)
