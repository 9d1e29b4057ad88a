"""The plain versions of the cut caches' decode kernels, on the CPU,
against ``kernels.ref.ragged_decode_ref`` on whole heads: the head_dim
cut (each of M slices scored by ``decode_scores_ref``, the scores summed,
``decode_softmax_pv_ref`` on each slice of V, the slices joined) and the
sequence cut (``decode_partial_ref`` on each of M blocks of keys, merged
in rank order by ``models.attention.merge_decode_partials``), in one
process, float32 within 1e-5; GQA and MHA, lengths 0 and Skv − 1, blocks
past a request's length.  ``kernels.backend`` sends CPU tensors to them.
"""
import pytest
import torch

from repro_torch.kernels import backend as KB
from repro_torch.kernels import ref
from repro_torch.models.attention import merge_decode_partials


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(B, H, Hkv, S, hd, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, H, hd, generator=g)
    k = torch.randn(B, S, Hkv, hd, generator=g)
    v = torch.randn(B, S, Hkv, hd, generator=g)
    lens = torch.randint(1, S - 1, (B,), generator=g)
    lens[0], lens[1] = 0, S - 1
    lens = lens.to(torch.int32)
    want = ref.ragged_decode_ref(q, k.transpose(1, 2), v.transpose(1, 2),
                                 lens)
    return q, k, v, lens, want


SHAPES = [(5, 6, 2, 64, 64), (3, 4, 4, 96, 32), (4, 8, 1, 128, 128)]


@pytest.mark.parametrize("M", [1, 2, 4])
@pytest.mark.parametrize("B,H,Hkv,S,hd", SHAPES)
def test_head_dim_cut_sums_to_the_whole_heads(B, H, Hkv, S, hd, M):
    q, k, v, lens, want = _case(B, H, Hkv, S, hd)
    w = hd // M
    sl = [slice(i * w, (i + 1) * w) for i in range(M)]
    s = sum(KB.decode_scores(q[..., c], k[..., c], lens) for c in sl)
    out = torch.cat([KB.decode_softmax_pv(s, v[..., c], lens, head_dim=hd)
                     for c in sl], dim=-1)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
    # the scale is the whole head's: the slice's would be sqrt(M) off
    wrong = KB.decode_softmax_pv(s, v, lens, head_dim=w)
    if M > 1:
        assert (wrong - want).abs().max() > 1e-3


@pytest.mark.parametrize("M", [1, 2, 4])
@pytest.mark.parametrize("B,H,Hkv,S,hd", SHAPES)
def test_sequence_cut_merges_to_the_whole_heads(B, H, Hkv, S, hd, M):
    q, k, v, lens, want = _case(B, H, Hkv, S, hd)
    n = S // M
    parts = torch.stack([
        KB.decode_partial(q, k[:, i * n:(i + 1) * n], v[:, i * n:(i + 1) * n],
                          lens - i * n) for i in range(M)])
    torch.testing.assert_close(merge_decode_partials(parts), want,
                               atol=1e-5, rtol=1e-5)


def test_an_empty_block_is_the_merge_identity():
    q, k, v, lens, _ = _case(2, 4, 2, 32, 64)
    part = ref.decode_partial_ref(q, k, v, torch.tensor([-1, -5]))
    assert (part[..., 0] == ref.NEG_INF).all()
    assert (part[..., 1:] == 0).all()
    full = ref.decode_partial_ref(q, k, v, lens)
    merged = merge_decode_partials(torch.stack([full, part]))
    alone = merge_decode_partials(full[None])
    assert torch.equal(merged, alone)


def test_scores_are_unscaled_and_zero_past_the_length():
    q, k, _, lens, _ = _case(3, 4, 2, 40, 32)
    s = ref.decode_scores_ref(q, k, lens)
    kk = k.repeat_interleave(2, dim=2)
    want = torch.einsum("bhd,bkhd->bhk", q, kk)
    for b in range(3):
        n = int(lens[b]) + 1
        torch.testing.assert_close(s[b, :, :n], want[b, :, :n])
        assert (s[b, :, n:] == 0).all()
