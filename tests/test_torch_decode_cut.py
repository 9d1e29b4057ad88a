"""The head_dim cut's two decode kernels (``kernels.paged.decode_scores``
and ``decode_softmax_pv``) as far as the CPU reaches them: the tile
chooser ``cut_tiles`` at the shapes the card runs and at every config of
the repo, and both wrappers on meta tensors (the dry-run's shape-only
path): outputs, scratch, counted operations, no launch, and the same
refusals as on the card.  The kernels themselves run only on the card
(``tests/test_torch_card.py``, ``chip_smoke.py`` phases 20a and 22a).
"""
import math

import pytest
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.kernels import _build
from repro_torch.kernels import paged as PG

SMS = PG.H100_SMS

# (B, Hkv, Skv) → (tile, per) of pass 1 and of pass 2 on an H100: the
# shapes of chip_smoke.py's phase 20a (llama3.2-3b's decode,
# recurrentgemma-9b's ring, seamless-m4t-medium's cross K/V,
# starcoder2-3b's ring), 22a (a cut 16 ways) and 20b's llama3.2-3b serving
CHOSEN = {(16, 8, 4096): ((64, 2), (64, 8)),
          (2, 1, 2048): ((32, 1), (64, 2)),
          (2, 16, 1024): ((64, 1), (64, 2)),
          (2, 2, 4096): ((32, 1), (64, 4)),
          (8, 8, 1024): ((64, 1), (64, 3)),
          (16, 8, 1024): ((64, 1), (64, 7))}


@pytest.mark.parametrize("shape", sorted(CHOSEN))
def test_cut_tiles_at_the_card_shapes(shape):
    one, two = CHOSEN[shape]
    assert PG.cut_tiles(*shape, SMS) == one
    assert PG.cut_tiles(*shape, SMS, merge=True) == two


def _groups():
    """(arch, query heads, KV heads) of every config with attention."""
    return [(a, c.n_heads, c.n_kv_heads) for a in list_archs()
            for c in [get_config(a)] if c.n_heads]


@pytest.mark.parametrize("arch,H,Hkv", _groups())
def test_cut_tiles_at_every_config(arch, H, Hkv):
    """At B 1-128 and 1-32,768 keys: tiles of 32 or 64 keys, 1-8 tiles a
    block in pass 1, never more tiles than the row has; pass 1 gives 2
    blocks an SM wherever tiles of 32 would; pass 2 takes tiles of 64, at
    least 2 a block where the row has them, and spans at most 16 splits a
    row; and the group fits one block."""
    assert H // Hkv <= PG.SOURCE_LAYOUT[2]
    for B in (1, 2, 16, 128):
        for S in (1, 31, 64, 1000, 4096, 32768):
            rows = B * Hkv
            tile, per = PG.cut_tiles(B, Hkv, S, SMS)
            n_tiles = math.ceil(S / tile)
            assert tile in (32, 64) and 1 <= per <= min(PG.CUT_MAX_PER,
                                                         n_tiles)
            if rows * math.ceil(S / 32) >= 2 * SMS:
                assert rows * math.ceil(n_tiles / per) >= 2 * SMS
            t2, p2 = PG.cut_tiles(B, Hkv, S, SMS, merge=True)
            n2 = math.ceil(S / 64)
            assert t2 == 64 and min(2, n2) <= p2 <= n2
            assert math.ceil(S / (t2 * p2)) <= PG.PV_MAX_SPLITS


def _meta(B, H, Hkv, S, hd, dtype):
    q = torch.empty(B, 2 * H, hd, dtype=dtype, device="meta")[:, ::2]
    k = torch.empty(B, S, Hkv, hd, dtype=dtype, device="meta")
    v = torch.empty(B, Hkv, S, hd, dtype=dtype,
                    device="meta").transpose(1, 2)
    lens = torch.empty(B, dtype=torch.int32, device="meta")
    return q, k, v, lens


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,S,hd",
                         [(16, 24, 8, 4096, 64), (2, 16, 1, 2048, 128),
                          (2, 16, 16, 1024, 32), (8, 16, 8, 1024, 4),
                          (1, 12, 1, 40, 16)])
def test_wrappers_on_meta(B, H, Hkv, S, hd, dtype, monkeypatch):
    """Shape-only calls: s (B, H, Skv) float32 and out (B, H, hd_r) in the
    cache's dtype; pass 2 allocates the split states the card path
    allocates; the operations of each pass's bound are counted into
    ``_build.meta_ops``; nothing is launched or loaded."""
    q, k, v, lens = _meta(B, H, Hkv, S, hd, dtype)
    made = []
    empty = torch.empty

    def record(*size, **kw):
        t = empty(*size, **kw)
        made.append((tuple(t.shape), t.dtype))
        return t

    monkeypatch.setattr(torch, "empty", record)
    monkeypatch.setattr(_build, "function", None)      # never loaded
    monkeypatch.setattr(_build, "meta_ops", 0.0)
    n1, n2 = PG.scores_launches, PG.softmax_pv_launches
    s = PG.decode_scores(q, k, lens)
    assert (tuple(s.shape), s.dtype) == ((B, H, S), torch.float32)
    assert _build.meta_ops == 2 * B * S * H * hd
    made.clear()
    o = PG.decode_softmax_pv(s, v, lens, head_dim=hd * 4)
    assert (tuple(o.shape), o.dtype) == ((B, H, hd), dtype)
    assert _build.meta_ops == 2 * B * S * H * hd + B * S * H * (2 * hd + 4)
    tile, per, n_part = PG.pv_scratch(B, H, Hkv, S, hd, SMS)
    n_split = math.ceil(S / (tile * per))
    assert n_part == (B * H * n_split * (hd + 4) if n_split > 1 else 0)
    assert made == [((B, H, hd), dtype), ((n_part,), torch.float32)]
    assert (PG.scores_launches, PG.softmax_pv_launches) == (n1, n2)


def test_wrappers_refuse_on_meta_as_on_the_card():
    """More than 16 query heads a KV head, a slice the kernels do not
    take, lengths of another dtype, scores of another shape: ValueError
    before any allocation or launch."""
    q, k, v, lens = _meta(2, 34, 2, 64, 32, torch.bfloat16)
    with pytest.raises(ValueError, match="query heads a KV head"):
        PG.decode_scores(q, k, lens)
    q, k, v, lens = _meta(2, 8, 2, 64, 48, torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim slice"):
        PG.decode_scores(q, k, lens)
    q, k, v, lens = _meta(2, 8, 2, 64, 32, torch.bfloat16)
    with pytest.raises(ValueError, match="int32"):
        PG.decode_scores(q, k, lens.long())
    s = torch.empty(2, 8, 63, device="meta")
    with pytest.raises(ValueError, match="scores"):
        PG.decode_softmax_pv(s, v, lens, head_dim=64)
    with pytest.raises(ValueError, match="scores"):
        PG.decode_softmax_pv(torch.empty(2, 8, 64, device="meta",
                                         dtype=torch.bfloat16), v, lens,
                             head_dim=64)
