"""The serving caches (``repro.serving.cache`` in PyTorch): the
contiguous ``DenseKVCache`` and the pooled ``PagedKVCache`` of two
kinds.

- ``kind="attn"``: one preallocated pool per model holds every
  request's K/V in fixed-size pages, head-interleaved as in the
  reference:

      kv: (L, n_pages, page_size, 2 * n_kv_heads, head_dim)

  where head h's K lives at index 2h and its V at 2h + 1 —
  ``[K0, V0, K1, V1, ...]`` — so one page gather lands both operands of
  attention.
- ``kind="state"``: a recurrent family (Mamba-2) holds O(1) state, so a
  request owns exactly one page (``page_size == 1``) of a pool whose
  leaves put the page id on axis 1: {"h": (L, n_pages, H, P, N) float32,
  "conv": (L, n_pages, d_conv − 1, d_inner + 2N)}.  The decode step
  gathers the rows of its slots, steps them and scatters them back.

Keeping the reference's layouts lets the tests compare pools directly.

Page 0 is the NULL page: never handed out, it takes every write of an
inactive decode slot or of prefill padding, so inactive slots run the
same code as live ones.  Stale data in it, or in any page beyond a
request's length, is unreachable: the decode attention reads no key past
``lengths[b]``.

The decode step's attention reads K and V through the page table
(``kernels.backend.paged_decode_attention_pool``): on the card the
kernel reads the pool in place, so no window is gathered; on the CPU
the plain version gathers the window (``gather_pages``) and attends, as
the reference does.

Unlike the reference, whose arrays are immutable, the prefill scatter
and the decode write update the pool in place (``index_put_``,
``index_copy_``), which spares a copy of the whole pool per step; and
``reset`` and ``defrag`` write into the same storage, because captured
CUDA graphs hold the pool's addresses.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import backend as KB
from repro_torch.models.layers import apply_rope, rmsnorm
from repro_torch.models.transformer import ffn, logits_from_hidden

NULL_PAGE = 0


class OutOfPages(RuntimeError):
    """The pool has no free page for a required allocation."""


@dataclasses.dataclass
class DenseKVCache:
    """The contiguous per-family cache: ``data`` is what the family's
    ``prefill`` builds (row b of every leaf is request b) and
    ``lengths`` (B,) int32 the tokens cached per request; the recurrent
    state keeps all rows at one depth.  On a mesh ``layout`` (a
    ``parallel.CacheLayout``) says which block of each leaf this rank's
    ``data`` holds; ``lengths`` stays whole, as its spec replicates it."""

    data: Any
    lengths: torch.Tensor
    layout: Any = None


@dataclasses.dataclass
class PagedKVCache:
    """The pool buffer ``kv`` (the attention pool, or the state dict for
    ``kind="state"``) plus a batch's page tables ``pages`` (B, P) int64
    (unused entries hold ``NULL_PAGE``) and ``lengths`` (B,) int32, the
    tokens cached per request."""

    kv: Any
    pages: torch.Tensor
    lengths: torch.Tensor
    page_size: int = 16
    kind: str = "attn"


# --------------------------------------------------------------------- #
# host-side page allocator
# --------------------------------------------------------------------- #

class PagePool:
    """Preallocated paged pool + host-side page allocator.

    ``capacity`` usable pages (page 0 is the null page).  The device
    buffer ``kv`` is written in place by the prefill scatter and the
    decode step; the host side only tracks which page ids are free."""

    def __init__(self, cfg: ModelConfig, n_pages: int, page_size: int, *,
                 dtype=torch.bfloat16, device="cuda", kind: str = "attn"):
        if n_pages < 2:
            raise ValueError("PagePool needs >= 2 pages (page 0 is the "
                             "reserved null page)")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if kind not in ("attn", "state"):
            raise ValueError(f"unknown pool kind {kind!r}")
        if kind == "state" and page_size != 1:
            raise ValueError("state pools hold one fixed-size state per "
                             "page; page_size must be 1")
        self.cfg = cfg
        self.page_size = page_size
        self.n_pages = n_pages
        self.dtype = dtype
        self.kind = kind
        if kind == "attn":
            self.kv = torch.zeros(
                (cfg.n_layers, n_pages, page_size, 2 * cfg.n_kv_heads,
                 cfg.head_dim), dtype=dtype, device=device)
        else:
            from repro_torch.models import registry as R   # import cycle
            # the state's leaves with the page id on axis 1
            self.kv = R.cache_struct(cfg, n_pages, dtype=dtype,
                                     device=device)
        # LIFO free list: freshly freed (hot) pages are reused first
        self._free: List[int] = list(range(n_pages - 1, 0, -1))

    def leaves(self) -> List[torch.Tensor]:
        """The pool's buffers: the attention pool, or the state's leaves."""
        return [self.kv] if isinstance(self.kv, torch.Tensor) \
            else list(self.kv.values())

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.leaves())

    def cache(self, pages, lengths) -> PagedKVCache:
        """View the pool + a batch's tables/lengths as a PagedKVCache."""
        return PagedKVCache(kv=self.kv, pages=pages, lengths=lengths,
                            page_size=self.page_size, kind=self.kind)

    @property
    def capacity(self) -> int:
        return self.n_pages - 1

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.capacity - self.n_free

    def occupancy(self) -> float:
        return self.n_used / self.capacity

    def pages_for(self, n_tokens: int) -> int:
        return max(-(-n_tokens // self.page_size), 1)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise OutOfPages(
                f"need {n} pages, {len(self._free)} free "
                f"(capacity {self.capacity})")
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: Sequence[int]) -> None:
        seen = set()
        for p in pages:
            if not 0 < p < self.n_pages:
                raise ValueError(f"free of invalid page id {p}")
            if p in self._free or p in seen:
                raise ValueError(f"double free of page {p}")
            seen.add(p)
        self._free.extend(pages)

    def reset(self) -> None:
        """Free everything and zero the buffers, in place."""
        for t in self.leaves():
            t.zero_()
        self._free = list(range(self.n_pages - 1, 0, -1))

    def defrag(self, tables: Sequence[List[int]]) -> None:
        """Compact every live page to the lowest ids: one device gather
        a buffer permutes the pool in place, and each table in ``tables``
        (mutable lists of page ids) is rewritten in place.  Pages not
        covered by any table are treated as free."""
        live = [p for table in tables for p in table]
        if len(set(live)) != len(live):
            raise ValueError("defrag: a page id appears in two tables")
        remap = {old: new for new, old in enumerate(live, start=1)}
        src = list(range(self.n_pages))          # new id -> old id
        for old, new in remap.items():
            src[new] = old
        bufs = self.leaves()
        perm = torch.tensor(src, dtype=torch.long, device=bufs[0].device)
        # back into the same storage: a CUDA graph captured over the pool
        # reads it where it was
        for t in bufs:
            t.copy_(t.index_select(1, perm))
        for table in tables:
            table[:] = [remap[p] for p in table]
        self._free = list(range(self.n_pages - 1, len(live), -1))


# --------------------------------------------------------------------- #
# device-side layout plumbing
# --------------------------------------------------------------------- #

def kv_interleave(k, v):
    """k, v: (..., Hkv, hd) -> (..., 2*Hkv, hd) as [K0, V0, K1, V1, ...]."""
    Hkv, hd = k.shape[-2], k.shape[-1]
    return torch.stack([k, v], dim=-2).reshape(*k.shape[:-2], 2 * Hkv, hd)


def kv_deinterleave(kv):
    """(..., 2*Hkv, hd) -> (k, v) each (..., Hkv, hd), as strided views."""
    return kv[..., 0::2, :], kv[..., 1::2, :]


def gather_pages(pool_layer, pages, *, page_size: int):
    """pool_layer: (n_pages, page_size, 2*Hkv, hd); pages: (B, P) int64.
    Returns (k, v) each (B, P * page_size, Hkv, hd) — slot s holds
    absolute position s of its request."""
    B, P = pages.shape
    kv = pool_layer[pages]                       # (B, P, ps, 2Hkv, hd)
    kv = kv.reshape(B, P * page_size, *kv.shape[3:])
    return kv_deinterleave(kv)


def scatter_prefill(pool_kv, k, v, pages, lengths, *, page_size: int):
    """Write prompt K/V into the pool, in place.  pool_kv: (L, n_pages,
    ps, 2Hkv, hd); k, v: (L, B, S, Hkv, hd) from ``prefill_ragged``;
    pages: (B, P) page-table rows (P * ps >= S); lengths: (B,) true prompt
    lengths — rows at positions >= lengths[b] (bucket padding) go to the
    null page.  Returns ``pool_kv``."""
    S = k.shape[2]
    t = torch.arange(S, device=pool_kv.device)
    page_of_t = torch.where(t[None, :] < lengths.long()[:, None],
                            pages[:, t // page_size], NULL_PAGE)  # (B, S)
    offs = (t % page_size).expand_as(page_of_t)
    kv = kv_interleave(k, v).to(pool_kv.dtype)   # (L, B, S, 2Hkv, hd)
    pool_kv[:, page_of_t, offs] = kv
    return pool_kv


def scatter_state(pool_kv, state, rows):
    """Write per-request recurrent state into its pool rows, in place.
    pool_kv leaves: (L, n_pages, ...); state leaves: (L, B, ...); rows:
    (B,) int64 page ids (one page per request).  Repeated ids (inactive
    slots, all at the null page) leave the null page's row undefined,
    which no request reads.  Returns ``pool_kv``."""
    for k, p in pool_kv.items():
        p.index_copy_(1, rows, state[k].to(p.dtype))
    return pool_kv


def gather_state(pool_kv, rows):
    """Per-request state rows out of the pool: the inverse of
    ``scatter_state`` (leaves (L, n_pages, ...) -> (L, B, ...))."""
    return {k: p.index_select(1, rows) for k, p in pool_kv.items()}


# --------------------------------------------------------------------- #
# paged decode forward
# --------------------------------------------------------------------- #

def paged_decode_attn(p, x, pool_layer, pages, lengths, *, page_size: int,
                      n_heads: int, n_kv_heads: int, head_dim: int,
                      rope_theta: float):
    """One layer of paged decode attention.  x: (B, 1, d); pool_layer:
    (n_pages, ps, 2Hkv, hd), written in place; pages: (B, P); lengths:
    (B,) int32 tokens already cached per slot (= the new token's absolute
    position).  Inactive slots carry all-null page rows, so their writes
    land in the null page and their outputs are discarded by the host.
    The attention reads K and V through ``pages`` (no window is gathered
    on the card); the pool's dtype must be x's.  Returns out (B, 1, d)."""
    B = x.shape[0]
    q = (x @ p.w_q).reshape(B, 1, n_heads, head_dim)
    k = (x @ p.w_k).reshape(B, 1, n_kv_heads, head_dim)
    v = (x @ p.w_v).reshape(B, 1, n_kv_heads, head_dim)
    pos = lengths.long()
    if rope_theta:
        q = apply_rope(q, pos[:, None], rope_theta)
        k = apply_rope(k, pos[:, None], rope_theta)

    # the new token: position lengths[b] lives in page lengths[b] // ps
    # at offset lengths[b] % ps of that slot's table
    kv_tok = kv_interleave(k[:, 0], v[:, 0]).to(pool_layer.dtype)
    page = pages.gather(1, (pos // page_size)[:, None])[:, 0]   # (B,)
    pool_layer[page, pos % page_size] = kv_tok

    o = KB.paged_decode_attention_pool(q, pool_layer, pages, lengths,
                                       page_size=page_size)
    return o.reshape(B, 1, n_heads * head_dim) @ p.w_o


def _paged_attn_decode(model, cfg: ModelConfig, cache: PagedKVCache,
                       token):
    """One decode step over the attention page pool.  token: (B, 1)
    int64.  Returns (logits (B, 1, V) float32, the cache with lengths +
    1); the pool is updated in place."""
    x = model.tok[token]
    for layer, pool_layer in zip(model.layers, cache.kv):
        h = rmsnorm(x, layer.norm1, cfg.norm_eps)
        x = x + paged_decode_attn(
            layer.attn, h, pool_layer, cache.pages, cache.lengths,
            page_size=cache.page_size, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta)
        h = rmsnorm(x, layer.norm2, cfg.norm_eps)
        x = x + ffn(layer, h, cfg)[0]
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    logits = logits_from_hidden(model, x)
    return logits, dataclasses.replace(cache, lengths=cache.lengths + 1)


def _paged_state_decode(model, cfg: ModelConfig, cache: PagedKVCache,
                        token):
    """One decode step of a recurrent family served from a state pool:
    gather each slot's state row (``pages[:, 0]``), run the family's
    decode step, which needs no position, and scatter the rows back in
    place.  Inactive slots read and write the null row, which no live
    request reads."""
    from repro_torch.models import registry as R   # import cycle
    rows = cache.pages[:, 0]
    logits, state = R.family(cfg).decode_step(
        model, cfg, gather_state(cache.kv, rows), token)
    scatter_state(cache.kv, state, rows)
    return logits, dataclasses.replace(cache, lengths=cache.lengths + 1)


def paged_decode(model, cfg: ModelConfig, cache: PagedKVCache, token):
    """``registry.decode_step``'s paged branch, dispatched on the pool
    kind.  token: (B, 1) int64.  Returns (logits (B, 1, V) float32, the
    cache with lengths + 1); the pool is updated in place."""
    if cache.kind == "attn":
        return _paged_attn_decode(model, cfg, cache, token)
    return _paged_state_decode(model, cfg, cache, token)
