"""The hot-path ops, in the models' tensor layouts.

The counterpart of ``repro.kernels.backend``, without a backend switch:
the device of the input picks the code.

- A tensor on the CPU runs the plain PyTorch version (``kernels.ref``),
  the path the CPU tests hold against the JAX package; torch's autograd
  differentiates it.
- A tensor on a CUDA device runs the hand-written kernel, or the call
  raises (no nvcc, a failed build, an unsupported shape).  ``rmsnorm``
  and ``attention`` are ``torch.autograd.Function``s there, whose
  backward is the backward kernel, and so is ``rglru_scan``'s;
  ``ssd``'s backward recomputes
  through the plain chunked scan, as the reference's does (it has no
  backward kernel).  Nothing falls back to the plain version or to the
  CPU.
- A tensor on the meta device (the dry-run, ``launch.dryrun``) takes
  the card's path: each wrapper allocates what it allocates on the card
  and the tensors its ``autograd.Function`` saves, adds its call's
  operation count to ``kernels._build.meta_ops``, and launches nothing
  (``_build.shape_only``).  Nothing on meta computes, and no plain
  version runs there (the plain attention's B·H·S² scores would
  describe a path the card does not take).
- Any other device raises.

The ops take the models' layouts (attention: (B, S, H, hd)); the kernels
read strides, so the transposes here are views, not copies.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged as _paged
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rglru as _rglru
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd as _ssd


def _on_card(t: torch.Tensor, op: str) -> bool:
    if t.device.type in ("cuda", "meta"):
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{op}: no implementation for device {t.device}; "
                     f"the port runs on 'cuda' (kernels), 'cpu' (plain "
                     f"versions) or 'meta' (shape only)")


def rmsnorm(x, scale, *, eps: float = 1e-5):
    """x: (..., d); scale: (d,) float32.  y = x·rsqrt(mean(x²)+eps)·
    (1+scale), in x's dtype."""
    if _on_card(x, "rmsnorm"):
        return _rn.rmsnorm(x, scale, eps)
    return _ref.rmsnorm_ref(x, scale, eps)


def rmsnorm_split(x, scale, *, d_full: int, reduce, eps: float = 1e-5):
    """RMSNorm of rows cut over a group: x (..., d) holds this rank's d of
    each row's ``d_full`` columns, scale (d,) float32 theirs; ``reduce``
    sums a float32 tensor of row sums over the group.  The split-row
    kernels on the card, their plain versions on the CPU, both under
    ``kernels.rmsnorm.SplitRMSNorm``'s autograd."""
    ops = _rn.SPLIT if _on_card(x, "rmsnorm_split") else _ref.RMSNORM_SPLIT
    return _rn.SplitRMSNorm.apply(x, scale, eps, d_full, reduce, ops)


def attention(q, k, v):
    """Causal self-attention in the models' layout: q (B, S, H, hd),
    k/v (B, S, Hkv, hd) -> (B, S, H, hd).  On the card the flash kernels
    mask a ragged S themselves, so nothing is padded."""
    if _on_card(q, "attention"):
        return _fa.attention(q, k, v)
    out, _lse = _ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=True)
    return out.transpose(1, 2)


def paged_decode_attention(q, k, v, lengths):
    """Ragged single-token decode attention over a gathered page window.

    q: (B, 1, H, hd), the new token's query at per-request position
    ``lengths[b]``; k, v: (B, Skv, Hkv, hd) whose slot ``s`` holds
    absolute position ``s``; lengths: (B,) int32.  Keys 0..lengths[b]
    inclusive are valid (slot ``lengths[b]`` is the token just written);
    everything later contributes nothing.  Returns (B, 1, H, hd)."""
    qt = q[:, 0]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    if _on_card(q, "paged_decode_attention"):
        out = _paged.ragged_decode_attention(qt, kt, vt, lengths)
    else:
        out = _ref.ragged_decode_ref(qt, kt, vt, lengths)
    return out[:, None]


def decode_partial(q, k, v, lengths):
    """The sequence cut's partial softmax state: q (B, H, hd) whole heads,
    k, v (B, Skv, Hkv, hd) a rank's block of the keys, lengths (B,) int32
    the requests' lengths less the block's first position (negative: no
    key of the block is valid).  Returns (B, H, hd + 2) float32 (m, l,
    acc), merged over the ranks by ``models.attention.
    merge_decode_partials``."""
    if _on_card(q, "decode_partial"):
        return _paged.ragged_decode_partial(q, k, v, lengths)
    return _ref.decode_partial_ref(q, k, v, lengths)


def decode_scores(q, k, lengths):
    """The head_dim cut's partial scores: q (B, H, hd_r), k (B, Skv, Hkv,
    hd_r), a rank's slices; lengths (B,) int32.  Returns (B, H, Skv)
    float32 (entries past lengths[b] not to be read)."""
    if _on_card(q, "decode_scores"):
        return _paged.decode_scores(q, k, lengths)
    return _ref.decode_scores_ref(q, k, lengths)


def decode_softmax_pv(s, v, lengths, *, head_dim: int):
    """After the scores' sum over the group: the softmax of
    s/sqrt(``head_dim``) over keys 0..lengths[b] and P V over a rank's
    slice v (B, Skv, Hkv, hd_r).  Returns (B, H, hd_r) in v's dtype."""
    if _on_card(v, "decode_softmax_pv"):
        return _paged.decode_softmax_pv(s, v, lengths, head_dim=head_dim)
    return _ref.decode_softmax_pv_ref(s, v, lengths, head_dim)


def paged_decode_attention_pool(q, pool_layer, pages, lengths, *,
                                page_size: int):
    """Ragged single-token decode attention with K and V read through the
    page table from the pool (the serving hot path; see
    ``repro_torch.serving.cache``): what ``paged_decode_attention``
    computes over the gathered window, with no window gathered on the
    card.

    q: (B, 1, H, hd) at per-request position ``lengths[b]``; pool_layer:
    (n_pages, page_size, 2·Hkv, hd) in q's dtype, head-interleaved;
    pages: (B, P) int64, key s of request b at row s % page_size of page
    pages[b, s // page_size]; lengths: (B,) int32, keys 0..lengths[b]
    inclusive valid.  Returns (B, 1, H, hd)."""
    if pool_layer.dtype != q.dtype:
        raise TypeError(f"paged_decode_attention_pool: pool dtype "
                        f"{pool_layer.dtype} differs from q's {q.dtype}")
    if _on_card(q, "paged_decode_attention_pool"):
        out = _paged.paged_decode_attention_pool(q[:, 0], pool_layer, pages,
                                                 lengths,
                                                 page_size=page_size)
    else:
        out = _ref.paged_decode_ref(q[:, 0], pool_layer, pages, lengths,
                                    page_size=page_size)
    return out[:, None]


def ssd(xh, dt, A, Bm, Cm, D, *, chunk: int):
    """The Mamba-2 SSD scan: xh (B, S, H, P), dt (B, S, H) float32
    (post-softplus), A (H,) float32, Bm/Cm (B, S, N) in xh's dtype, D
    (H,) float32 -> (y (B, S, H, P) in xh's dtype, h_final (B, H, P, N)
    float32).  On the card the chunk kernel's forward with the plain
    recompute backward; on the CPU the plain chunked scan."""
    if _on_card(xh, "ssd"):
        return _ssd.ssd(xh, dt, A, Bm, Cm, D, chunk=chunk)
    from repro_torch.models.mamba2 import ssd_chunked    # import cycle
    return ssd_chunked(xh, dt, A, Bm, Cm, D, chunk=chunk)


def rglru_scan(a, b, h0=None):
    """The RG-LRU linear recurrence h_t = a_t·h_{t−1} + b_t: a, b (B, S,
    W) float32, h0 (B, W) or None (zeros) -> (hs (B, S, W), h_last (B,
    W)) float32.  On the card the scan kernel and its reverse-sweep
    backward; on the CPU the reference's chunked scan, differentiated by
    autograd."""
    if _on_card(a, "rglru_scan"):
        return _rglru.rglru_scan(a, b, h0)
    return _ref.rglru_scan_ref(a, b, h0)
