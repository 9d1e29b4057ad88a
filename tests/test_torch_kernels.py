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
from repro.serving.cache import gather_pages as j_gather_pages
from repro_torch.kernels import backend as KB
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import paged as PG
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as RN


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these small models run many small ops, which
    the thread pools of several test workers on a shared CPU slow down
    many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32 = dict(atol=2e-5, rtol=2e-5)


def _normal(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# --------------------------------------------------------------------- #
# CPU: the port's plain versions against the reference's kernels
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("shape", [
    (4, 7, 64), (33, 256), (1, 1024),
    # the card's forward layout switches here: 1 warp a bfloat16 row up
    # to d = 1024 (2 a float32 row), 2 warps just above; 4 at 2560, 8 at
    # 5120
    (5, 8), (3, 1016), (6, 1024), (3, 1032), (4, 2560), (2, 5120)])
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


def split_merge_decode(q, k, v, lengths, split):
    """What the decode kernel computes, in float32 plain torch: each split
    of ``split`` keys keeps its own softmax state (m, l, acc) over the
    valid keys it holds, and the states are merged one after another in
    split order, l clamped at 1e-30.  q (B, H, hd); k, v (B, Hkv, Skv,
    hd); lengths (B,).  Returns (B, H, hd) float32."""
    B, H, hd = q.shape
    Skv = k.shape[2]
    G = H // k.shape[1]
    k = k.float().repeat_interleave(G, dim=1)
    v = v.float().repeat_interleave(G, dim=1)
    s = torch.einsum("bhd,bhkd->bhk", q.float(), k) / np.sqrt(hd)
    kpos = torch.arange(Skv)
    valid = kpos[None, :] <= lengths.long()[:, None]          # (B, Skv)
    states = []
    for s0 in range(0, Skv, split):
        inside = valid[:, None, s0:s0 + split]
        ss = s[..., s0:s0 + split].masked_fill(~inside, ref.NEG_INF)
        m = ss.amax(-1)
        p = torch.exp(ss - m[..., None]) * inside
        states.append((m, p.sum(-1),
                       torch.einsum("bhk,bhkd->bhd", p,
                                    v[:, :, s0:s0 + split])))
    M = torch.full((B, H), ref.NEG_INF)
    L = torch.zeros(B, H)
    A = torch.zeros(B, H, hd)
    for m, l, acc in states:
        mx = torch.maximum(M, m)
        ca, cb = torch.exp(M - mx), torch.exp(m - mx)
        L = L * ca + l * cb
        A = A * ca[..., None] + acc * cb[..., None]
        M = mx
    return A / L.clamp_min(1e-30)[..., None]


@pytest.mark.parametrize("split", [4, 7, 128])
@pytest.mark.parametrize("H,Hkv", [(4, 2), (2, 2), (4, 1)])
def test_split_merge_decode_matches_plain_and_jax(H, Hkv, split):
    """The decode kernel's split-and-merge order of the softmax, with
    splits that cut a request's keys into 1-7 pieces, against the plain
    version and the reference's Pallas kernel (interpret mode)."""
    rng = np.random.default_rng(4)
    B, Skv, hd = 5, 24, 16
    q, k, v = _decode_inputs(rng, B, H, Hkv, Skv, hd)
    q, k, v = q[:, 0], np.swapaxes(k, 1, 2), np.swapaxes(v, 1, 2)
    lengths = np.array([5, 23, 0, 12, 7], np.int32)
    got = split_merge_decode(_t(q), _t(k), _t(v), _t(lengths), split)
    want = ref.ragged_decode_ref(_t(q), _t(k), _t(v), _t(lengths))
    torch.testing.assert_close(got, want, **F32)
    pallas = np.asarray(j_ragged(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(lengths),
                                 block_k=8, interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, **F32)


def page_table_case(rng, page_size, P, n_pages, H, Hkv, hd):
    """A pool of random junk (the null page too), and a table of 5
    requests: lengths page_size - 1, page_size and page_size + 1 (the
    page edges), an inactive slot (length 0, all-null row) and the
    window's last key, P·page_size - 1.
    Live pages are distinct, shuffled ids; entries past a request's last
    page are the null page 0."""
    pool = _normal(rng, (n_pages, page_size, 2 * Hkv, hd))
    lengths = np.array([page_size - 1, page_size, page_size + 1, 0,
                        P * page_size - 1], np.int32)
    ids = rng.permutation(np.arange(1, n_pages))
    pages = np.zeros((len(lengths), P), np.int64)
    used = 0
    for b, n in enumerate(lengths):
        if b == 3:
            continue                             # inactive: all null
        need = n // page_size + 1
        pages[b, :need] = ids[used:used + need]
        used += need
    q = _normal(rng, (len(lengths), H, hd))
    return q, pool, pages, lengths


@pytest.mark.parametrize("page_size", [1, 4, 16])
@pytest.mark.parametrize("H,Hkv", [(4, 2), (3, 1)])
def test_paged_decode_ref_matches_jax_gather_and_ragged(page_size, H, Hkv):
    """The plain version of the page-table read against the reference's
    gather_pages + ragged_decode_attention (interpret mode); the backend
    op on CPU tensors runs it."""
    rng = np.random.default_rng(page_size)
    P = -(-40 // page_size)
    q, pool, pages, lengths = page_table_case(rng, page_size, P,
                                              4 * P + 1, H, Hkv, 16)
    got = ref.paged_decode_ref(_t(q), _t(pool), _t(pages), _t(lengths),
                               page_size=page_size)
    jk, jv = j_gather_pages(jnp.asarray(pool),
                            jnp.asarray(pages.astype(np.int32)),
                            page_size=page_size)
    want = np.asarray(j_ragged(
        jnp.asarray(q), jnp.swapaxes(jk, 1, 2), jnp.swapaxes(jv, 1, 2),
        jnp.asarray(lengths), block_k=8, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **F32)
    op = KB.paged_decode_attention_pool(_t(q)[:, None], _t(pool),
                                        _t(pages), _t(lengths),
                                        page_size=page_size)
    assert torch.equal(op[:, 0], got)


def test_paged_decode_refuses_a_pool_of_another_dtype():
    q = torch.zeros(1, 1, 2, 64)
    pool = torch.zeros(3, 4, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="pool dtype"):
        KB.paged_decode_attention_pool(q, pool,
                                       torch.zeros(1, 2, dtype=torch.int64),
                                       torch.zeros(1, dtype=torch.int32),
                                       page_size=4)


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
    with pytest.raises(ValueError, match="CUDA"):
        PG.paged_decode_attention_pool(
            torch.zeros(1, 2, 64), torch.zeros(3, 4, 2, 64),
            torch.zeros(1, 2, dtype=torch.int64),
            torch.zeros(1, dtype=torch.int32), page_size=4)
    assert (RN.launches, FA.launches, PG.launches) == before


def test_backend_refuses_other_devices():
    x = torch.zeros(2, 64, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        KB.rmsnorm(x, torch.zeros(64, device="meta"))
