"""Continuous-batching serving engine over a page pool
(``repro.serving.engine`` in PyTorch).

- **Request API.**  Callers ``submit()`` a ``GenerationRequest`` and
  either pump ``step()`` (each returns (rid, token, finished) events as
  they are sampled) or call ``drain()`` for the finished
  ``GenerationResult``s; ``generate()`` is the blocking wrapper.
- **Two modes** (``registry.serving_mode``).  ``"paged"`` (the dense
  family): prefill runs one request at a time through the bucketed
  ragged prefill (prompts right-padded to a ladder of bucket lengths),
  then the page scatter and a greedy first token; pages of
  ``page_size`` tokens are allocated lazily, when a slot's length
  crosses a page boundary.  ``"state"`` (Mamba-2): each request holds
  exactly one page of recurrent state that never grows
  (``page_size == pages_per_slot == 1``), and prefill runs at the
  prompt's exact length (padding would run the recurrence over the
  padding tokens), so there is one prefill entry per distinct prompt
  length instead of per bucket.  Decode runs every slot, live or not,
  at one fixed slot count.
- **Admit/evict at every step.**  A pending request is admitted when the
  pool can cover its worst-case page demand (so no admitted request can
  run out mid-decode); a finished one (EOS or max tokens) is evicted and
  its pages freed the step it finishes.
- **Greedy decoding**, held token for token against the reference
  engine by the tests.
- **The compile cache.**  As the reference keeps one prefill executable
  per prompt bucket (per prompt length in state mode) and one decode
  executable, the engine keeps one entry per bucket or length
  (``_prefill_fns``) and one for its fixed decode slot count
  (``_decode_fns``), with the reference's bookkeeping
  (``executables <= executable_budget``).  Each entry reads one packed
  int64 input: the tokens, the page-table rows and the lengths, built on
  the host and sent in one copy.  On the card an entry holds a CUDA
  graph captured over a static copy of that input, the weights and the
  pool, which the step updates in place; a step is one staged copy from
  pinned memory and one replay, and the sampled tokens are read back
  outside the graph.  The first prefill and the first decode of an
  engine run eagerly (they build the kernels and make cuBLAS's handles
  and the decode kernel's counters); every later call replays its
  entry's graph, capturing it first if it is new.  ``reset()`` keeps the
  graphs, as the reference keeps its executables.  A failed capture
  raises.  On the CPU an entry holds the eager function.

Inactive slots run with an all-null page-table row: their writes land in
the null page (the null state row) and their outputs are discarded.

The engine runs on the model's device: the kernels on the card, the
plain versions on the CPU.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import graphs as G
from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry as R
from repro_torch.serving import cache as SC


def pow2_buckets(max_prompt_len: int, min_bucket: int = 16) -> Tuple[int, ...]:
    """Power-of-two bucket ladder covering 1..max_prompt_len."""
    out, b = [], min_bucket
    while b < max_prompt_len:
        out.append(b)
        b *= 2
    out.append(max(max_prompt_len, min_bucket))
    return tuple(dict.fromkeys(out))


@dataclass
class GenerationRequest:
    """One generation job.  ``rid`` is assigned by ``submit()`` when
    omitted."""

    prompt: np.ndarray                  # (S,) int32 token ids
    max_new_tokens: int
    eos_id: Optional[int] = None
    rid: Optional[int] = None


@dataclass
class GenerationResult:
    """A finished request: generated ids, why decoding stopped
    (``"eos"`` or ``"length"``) and, with a ``detokenizer``, the text."""

    rid: int
    tokens: np.ndarray                  # (n,) int32 generated ids
    finish_reason: str
    prompt_len: int
    text: Optional[str] = None


class _Call:
    """One entry of the engine's cache: ``fn(packed) -> (B, 1)`` int64
    greedy tokens, and on the card the static packed input it reads and,
    once captured, its graph."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.packed: Optional[torch.Tensor] = None
        self.graph: Optional[G.Graph] = None


@dataclass
class _Slot:
    req: GenerationRequest
    length: int                         # tokens currently in the cache
    pages: List[int]
    total_pages: int                    # worst-case demand (reservation)
    out: List[int] = field(default_factory=list)
    last_token: int = 0


class ServingEngine:
    def __init__(self, cfg: ModelConfig, model, *, decode_slots: int = 4,
                 page_size: int = 16, max_len: int = 256,
                 n_pages: Optional[int] = None,
                 buckets: Optional[Sequence[int]] = None,
                 dtype=torch.bfloat16,
                 detokenizer: Optional[Callable[[Sequence[int]], str]]
                 = None):
        self.mode = R.serving_mode(cfg)
        if self.mode is None:
            raise NotImplementedError(
                f"continuous batching needs a paged or single-page cache; "
                f"arch_type={cfg.arch_type!r} with sliding_window="
                f"{cfg.sliding_window} is served by "
                f"repro_torch.train.serve.Server")
        if model.dtype != dtype:
            raise ValueError(f"model holds {model.dtype} weights; build it "
                             f"with dtype={dtype} to serve in {dtype}")
        self.cfg = cfg
        self.model = model
        self.dtype = dtype
        self.device = model.device
        self.page_size = page_size if self.mode == "paged" else 1
        self.max_len = max_len                    # prompt + generated cap
        self.decode_slots = decode_slots
        self.detokenizer = detokenizer
        if self.mode == "paged":
            self.pages_per_slot = -(-max_len // self.page_size)
        else:
            self.pages_per_slot = 1               # O(1) recurrent state
        if n_pages is None:
            n_pages = decode_slots * self.pages_per_slot + 1
        self.pool = SC.PagePool(
            cfg, n_pages, self.page_size, dtype=dtype, device=self.device,
            kind="attn" if self.mode == "paged" else "state")
        self.buckets = tuple(sorted(buckets)) if buckets else \
            pow2_buckets(max_len)
        if self.mode == "paged" and \
                self.buckets[-1] > self.pages_per_slot * self.page_size:
            raise ValueError(
                f"largest bucket {self.buckets[-1]} exceeds the per-slot "
                f"page window {self.pages_per_slot * page_size}")
        self.slots: List[Optional[_Slot]] = [None] * decode_slots
        self._pending: deque = deque()
        self._completed: List[GenerationResult] = []
        self._results: Dict[int, GenerationResult] = {}
        self._live_rids: set = set()
        self._next_rid = 0
        self._reserved = 0              # future pages owed to active slots
        self.steps = 0
        self._occupancy_sum = 0.0
        self._prefill_fns: Dict[int, _Call] = {}     # bucket/length -> entry
        self._decode_fns: Dict[int, _Call] = {}      # batch -> entry
        self._warm: set = set()         # kinds whose first call has run
        self.captures = 0               # graphs captured
        self.capture_s = 0.0            # seconds spent capturing them
        if self.device.type == "cuda":
            self._stage = G.PinnedStage(torch.int64)
            self._pool = torch.cuda.graph_pool_handle()

    # ----------------------------------------------------------------- #
    # compile-cache bookkeeping
    # ----------------------------------------------------------------- #

    @property
    def n_prefill_executables(self) -> int:
        return len(self._prefill_fns)

    @property
    def n_decode_executables(self) -> int:
        return len(self._decode_fns)

    @property
    def executables(self) -> int:
        return self.n_prefill_executables + self.n_decode_executables

    @property
    def executable_budget(self) -> int:
        """The serving compile invariant: one prefill entry per prompt
        bucket (``"paged"``; per distinct prompt length for ``"state"``,
        whose exact-length prefill cannot be padded) plus one decode
        entry for the engine's one fixed slot count."""
        if self.mode == "paged":
            return len(self.buckets) + 1
        return len(self._prefill_fns) + 1

    def _run(self, kind: str, fns: Dict[int, _Call], key: int,
             make: Callable[[], Callable], host: np.ndarray) -> torch.Tensor:
        """Run the entry ``fns[key]`` (its function made by ``make`` on
        first use: a partial holding no reference to the engine, so a
        dropped engine frees its graphs at once) on the packed host input
        ``host``; returns its (B, 1) tokens on the engine's device."""
        ent = fns.get(key)
        if ent is None:
            ent = fns[key] = _Call(make())
        if self.device.type != "cuda":
            return ent.fn(torch.from_numpy(host))
        if ent.packed is None:
            ent.packed = torch.empty(host.shape, dtype=torch.int64,
                                     device=self.device)
        ent.packed.copy_(self._stage.put(host), non_blocking=True)
        self._stage.done()
        if kind not in self._warm:
            self._warm.add(kind)
            return ent.fn(ent.packed)
        if ent.graph is None:
            ent.graph = G.Graph(lambda: ent.fn(ent.packed), self._pool)
            self.captures += 1
            self.capture_s += ent.graph.capture_s
        return ent.graph.replay()

    def _bucket_for(self, s: int) -> int:
        for b in self.buckets:
            if s <= b:
                return b
        raise ValueError(f"prompt length {s} exceeds largest bucket "
                         f"{self.buckets[-1]}")

    # ----------------------------------------------------------------- #
    # request lifecycle
    # ----------------------------------------------------------------- #

    def submit(self, req: GenerationRequest) -> int:
        """Queue a request; returns its rid.  Admission into a decode
        slot happens inside ``step()`` once the page pool can cover the
        request's worst-case demand."""
        s = int(np.asarray(req.prompt).shape[0])
        if s < 1 or req.max_new_tokens < 1:
            raise ValueError("prompt and max_new_tokens must be "
                             "non-empty")
        if s + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request: prompt {s} + max_new_tokens "
                f"{req.max_new_tokens} exceeds max_len {self.max_len}")
        if self.mode == "paged":
            self._bucket_for(s)         # fail fast on oversized prompts
        if req.rid is None:
            req.rid = self._next_rid
            self._next_rid += 1
        else:
            self._next_rid = max(self._next_rid, req.rid + 1)
        if req.rid in self._live_rids:
            raise ValueError(f"rid {req.rid} is already queued or active")
        self._live_rids.add(req.rid)
        self._pending.append(req)
        return req.rid

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def n_pending(self) -> int:
        return len(self._pending)

    @property
    def done(self) -> bool:
        return not self._pending and self.n_active == 0

    def _admit(self, events) -> None:
        """Admit head-of-line pending requests into free slots while the
        pool can cover their worst-case page demand."""
        for i, slot in enumerate(self.slots):
            if slot is not None or not self._pending:
                continue
            req = self._pending[0]
            S = len(req.prompt)
            # the last sampled token is never written back, so the
            # worst case stores S + max_new_tokens - 1 positions
            # (recurrent state is O(1): always exactly one page)
            total = self._pages_needed(S + req.max_new_tokens - 1)
            if self.pool.n_free - self._reserved < total:
                break                   # head-of-line blocking, FIFO order
            self._pending.popleft()
            pages = self.pool.alloc(self._pages_needed(S))
            self._reserved += total - len(pages)
            slot = _Slot(req=req, length=0, pages=pages, total_pages=total)
            self.slots[i] = slot
            tok = self._run_prefill(slot)
            slot.length = S
            self._emit(i, slot, tok, events)

    def _run_prefill(self, slot: _Slot) -> int:
        S = len(slot.req.prompt)
        if self.mode == "state":
            # exact length: the prompt, its length, its one page id
            host = np.zeros(S + 2, np.int64)
            host[:S] = slot.req.prompt
            host[S] = S
            host[S + 1] = slot.pages[0]
            tok = self._run("prefill", self._prefill_fns, S,
                            lambda: partial(_state_prefill_packed,
                                            self.model, self.cfg,
                                            self.pool.kv, length=S), host)
            return int(tok[0, 0])
        bucket = self._bucket_for(S)
        # packed: the right-padded prompt, its length, its page-table row
        host = np.zeros(bucket + 1 + self.pages_per_slot, np.int64)
        host[:S] = slot.req.prompt
        host[bucket] = S
        host[bucket + 1:] = SC.NULL_PAGE
        host[bucket + 1:bucket + 1 + len(slot.pages)] = slot.pages
        tok = self._run("prefill", self._prefill_fns, bucket,
                        lambda: partial(_prefill_packed, self.model,
                                        self.cfg, self.pool.kv,
                                        bucket=bucket,
                                        page_size=self.page_size), host)
        return int(tok[0, 0])

    def _emit(self, i: int, slot: _Slot, tok: int, events) -> None:
        slot.out.append(tok)
        slot.last_token = tok
        eos = (slot.req.eos_id is not None and tok == slot.req.eos_id)
        done = eos or len(slot.out) >= slot.req.max_new_tokens
        events.append((slot.req.rid, tok, done))
        if done:
            self._finish(i, "eos" if eos else "length")

    def _finish(self, i: int, reason: str) -> None:
        slot = self.slots[i]
        self.pool.free(slot.pages)
        self._reserved -= slot.total_pages - len(slot.pages)
        toks = np.asarray(slot.out, np.int32)
        res = GenerationResult(
            rid=slot.req.rid, tokens=toks, finish_reason=reason,
            prompt_len=len(slot.req.prompt),
            text=(self.detokenizer(toks.tolist())
                  if self.detokenizer else None))
        self._completed.append(res)
        self._results[slot.req.rid] = res
        self._live_rids.discard(slot.req.rid)
        self.slots[i] = None

    def _pages_needed(self, n_tokens: int) -> int:
        """Worst-case pages for ``n_tokens``: token-granular for the
        paged mode, exactly one fixed-size state page for ``"state"``."""
        if self.mode == "state":
            return 1
        return self.pool.pages_for(n_tokens)

    def _grow_pages(self) -> None:
        """Lazy allocation: a slot gets its next page only when the next
        write would cross into it (covered by the admit reservation).
        State slots never grow: their page holds O(1) state."""
        if self.mode == "state":
            return
        for slot in self.slots:
            if slot is None:
                continue
            if slot.length >= len(slot.pages) * self.page_size:
                slot.pages.extend(self.pool.alloc(1))
                self._reserved -= 1

    # ----------------------------------------------------------------- #
    # the step loop
    # ----------------------------------------------------------------- #

    def step(self) -> List[Tuple[int, int, bool]]:
        """One engine step: admit + prefill new requests, then one decode
        step over every slot.  Returns (rid, token, finished) streaming
        events in emission order."""
        events: List[Tuple[int, int, bool]] = []
        self._admit(events)
        active = [(i, s) for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return events
        self._grow_pages()
        B = self.decode_slots
        nxt = self._run("decode", self._decode_fns, B, lambda: partial(
            _decode_packed, self.model, self.cfg, self.pool.kv, slots=B,
            page_size=self.page_size, kind=self.pool.kind),
            self._decode_inputs(active))
        nxt = nxt.cpu().numpy()
        for i, slot in active:
            slot.length += 1
            self._emit(i, slot, int(nxt[i, 0]), events)
        self.steps += 1
        self._occupancy_sum += len(active) / self.decode_slots
        return events

    def _decode_inputs(self, active) -> np.ndarray:
        """The decode step's packed input: every slot's last token, its
        page-table row (all null for an inactive slot) and its length."""
        B, P = self.decode_slots, self.pages_per_slot
        host = np.zeros(B + B * P + B, np.int64)
        pages = host[B:B + B * P].reshape(B, P)
        pages[:] = SC.NULL_PAGE
        for i, slot in active:
            host[i] = slot.last_token
            pages[i, :len(slot.pages)] = slot.pages
            host[B + B * P + i] = slot.length
        return host

    def drain(self, max_steps: Optional[int] = None) \
            -> List[GenerationResult]:
        """Step until every queued request finishes; returns the results
        completed since the last drain, in completion order."""
        n = 0
        while not self.done:
            self.step()
            n += 1
            if max_steps is not None and n >= max_steps:
                raise RuntimeError(f"engine not drained after {n} steps")
        out, self._completed = self._completed, []
        return out

    def result(self, rid: int) -> Optional[GenerationResult]:
        return self._results.get(rid)

    def generate(self, tokens: np.ndarray, n_new: int, *,
                 eos_id: Optional[int] = None) -> np.ndarray:
        """Blocking wrapper over submit/drain: tokens (B, S) prompt rows,
        returns (B, n_new) greedy ids (rows that hit ``eos_id`` early are
        zero-padded)."""
        tokens = np.asarray(tokens)
        rids = [self.submit(GenerationRequest(
            prompt=tokens[b].astype(np.int32), max_new_tokens=n_new,
            eos_id=eos_id)) for b in range(tokens.shape[0])]
        self.drain()
        out = np.zeros((tokens.shape[0], n_new), np.int32)
        for b, rid in enumerate(rids):
            got = self._results[rid].tokens
            out[b, :len(got)] = got
        return out

    # ----------------------------------------------------------------- #
    # maintenance
    # ----------------------------------------------------------------- #

    def defrag(self) -> None:
        """Compact live pages to the low pool ids (one device gather);
        active slots' page tables are rewritten in place."""
        self.pool.defrag([s.pages for s in self.slots if s is not None])

    def reset(self) -> None:
        """Drop all requests and free every page; the cache's entries and
        graphs are kept (capturing them is the expensive part)."""
        for i, slot in enumerate(self.slots):
            if slot is not None:
                self._finish(i, "reset")
        self._pending.clear()
        self._completed.clear()
        self._results.clear()
        self._live_rids.clear()
        self.steps = 0
        self._occupancy_sum = 0.0
        if self._reserved != 0 or self.pool.n_used != 0:
            raise RuntimeError("reset left pages reserved or in use")

    def mean_occupancy(self) -> float:
        return self._occupancy_sum / max(self.steps, 1)


# --------------------------------------------------------------------- #
# the device work of one prefill and one decode step
# --------------------------------------------------------------------- #

def _greedy(logits):
    return logits[:, -1].argmax(dim=-1, keepdim=True)


@torch.inference_mode()
def _prefill(model, cfg, pool_kv, tokens, lengths, pages_row, *,
             page_size):
    """Prefill one request (B=1), scatter its K/V into its pages (in
    place) and greedy-sample the first token."""
    logits, k, v = R.prefill_ragged(model, cfg, tokens, lengths)
    SC.scatter_prefill(pool_kv, k, v, pages_row, lengths,
                       page_size=page_size)
    return _greedy(logits)


@torch.inference_mode()
def _state_prefill(model, cfg, pool_kv, tokens, pages_row):
    """Prefill one request (B=1) at its exact length, scatter its state
    into its one page (in place) and greedy-sample the first token."""
    logits, cache = R.prefill(model, cfg, tokens)
    SC.scatter_state(pool_kv, cache.data, pages_row[:, 0])
    return _greedy(logits)


@torch.inference_mode()
def _decode(model, cfg, cache, token):
    """One decode step over every slot + greedy sampling."""
    logits, _ = R.decode_step(model, cfg, cache, token)
    return _greedy(logits)


@torch.inference_mode()
def _prefill_packed(model, cfg, pool_kv, packed, *, bucket, page_size):
    """``_prefill`` on the engine's packed input (bucket + 1 + P,) int64:
    the right-padded prompt, its length, its page-table row."""
    return _prefill(model, cfg, pool_kv, packed[:bucket][None],
                    packed[bucket:bucket + 1].to(torch.int32),
                    packed[bucket + 1:][None], page_size=page_size)


@torch.inference_mode()
def _state_prefill_packed(model, cfg, pool_kv, packed, *, length):
    """``_state_prefill`` on the engine's packed input (length + 2,)
    int64: the prompt, its length, its page id."""
    return _state_prefill(model, cfg, pool_kv, packed[:length][None],
                          packed[length + 1:][None])


@torch.inference_mode()
def _decode_packed(model, cfg, pool_kv, packed, *, slots, page_size,
                   kind="attn"):
    """``_decode`` on the engine's packed input (B + B·P + B,) int64:
    the slots' last tokens, their page-table rows and their lengths."""
    B = slots
    P = (packed.shape[0] - 2 * B) // B
    cache = SC.PagedKVCache(kv=pool_kv, pages=packed[B:B + B * P].view(B, P),
                            lengths=packed[B + B * P:].to(torch.int32),
                            page_size=page_size, kind=kind)
    return _decode(model, cfg, cache, packed[:B][:, None])
