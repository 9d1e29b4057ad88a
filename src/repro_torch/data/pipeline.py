"""Phase-aware data loading (``repro.data.pipeline`` in PyTorch, single
process).

Follows a SeesawPlan's batch ramp and keeps equal-token data order
across schedulers: one stream indexed by absolute sequence number,
partitioned into batches by the plan.  Two ways to consume it:

- ``__iter__`` — one (phase, step, batch) at a time;
- ``iter_chunks(k)`` — stacked (k, B, ...) chunks for the engine's
  k-step dispatch.  Adjacent phases of one batch size merge into one
  segment, and the tail chunk of every segment is padded up to k by
  repeating its last step; each chunk comes with ``m``, the number of
  real leading steps, which the engine takes as ``n_valid``.

A daemon thread samples ahead of the consumer through a bounded queue.
Batches reach the device as int64 tensors: on a CUDA device through
pinned host memory with ``non_blocking=True``.  ``resume(tokens_seen)``
repositions the stream on the exact step boundary a run stopped at, and
``rechunk(plan, tokens_seen)`` swaps in an extended plan there (an
adaptive cut); the caller closes the streams it superseded.

Feeding per host (``per_host``, a mesh) comes with the multi-process
slice.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.core.seesaw import SeesawPlan
from repro_torch.data.synthetic import MarkovLM
from repro_torch.train.checkpoint import exact_tokens

_DONE = object()


class PhaseDataLoader:
    """Iterates a plan's (phase, step, batch) stream on ``device``."""

    def __init__(self, source: MarkovLM, plan: SeesawPlan, seq_len: int, *,
                 device="cuda", prefetch: int = 2):
        self.source = source
        self.plan = plan
        self.seq_len = seq_len
        self.device = torch.device(device)
        self.prefetch = prefetch
        # (phase_idx, steps_done_in_phase, absolute seq cursor)
        self._start: Tuple[int, int, int] = (0, 0, 0)

    # -- resume --------------------------------------------------------- #
    def position_at(self, tokens_seen) -> Tuple[int, int, int]:
        """(phase_idx, steps_done_in_phase, seq_cursor) for a token count
        on a step boundary of the plan, in exact integer arithmetic."""
        steps = self.plan.steps_per_phase(self.seq_len)
        tok = exact_tokens(tokens_seen)
        cursor = 0
        for pi, (p, n) in enumerate(zip(self.plan.phases, steps)):
            per = p.batch_size * self.seq_len
            if tok < n * per:
                done, rem = divmod(tok, per)
                if rem:
                    raise ValueError(
                        f"tokens_seen={tokens_seen} is not on a step "
                        f"boundary of phase {pi} (B={p.batch_size})")
                return pi, done, cursor + done * p.batch_size
            tok -= n * per
            cursor += n * p.batch_size
        return len(steps), 0, cursor

    def resume(self, tokens_seen) -> "PhaseDataLoader":
        """Reposition the stream to continue a run at ``tokens_seen``."""
        self._start = self.position_at(tokens_seen)
        return self

    def rechunk(self, plan, tokens_seen) -> "PhaseDataLoader":
        """Swap in an extended plan mid-stream (an adaptive cut) and
        reposition on the exact ``tokens_seen`` boundary.  The sequence
        stream is indexed by absolute sequence number, so the examples
        after the cut are the ones the old plan would have produced; only
        their grouping into batches changes.  Streams made before (live
        ``iter_chunks`` / ``__iter__`` generators) are superseded: the
        caller must ``close()`` them, which stops and joins their
        sampling threads and drops the batches they hold.  Make a fresh
        one after rechunking."""
        self.plan = plan
        return self.resume(tokens_seen)

    # -- to the device -------------------------------------------------- #
    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v, np.int64))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            elif self.device.type != "cpu":
                raise ValueError(f"PhaseDataLoader: no device "
                                 f"{self.device}; 'cuda' or 'cpu'")
            out[k] = t
        return out

    # -- host-side production ------------------------------------------- #
    def _host_steps(self) -> Iterator[Tuple[Any, int, Dict]]:
        steps = self.plan.steps_per_phase(self.seq_len)
        p0, s0, cursor = self._start
        for pi in range(p0, len(self.plan.phases)):
            phase, n = self.plan.phases[pi], steps[pi]
            for s in range(s0 if pi == p0 else 0, n):
                batch = self.source.sample(cursor, phase.batch_size,
                                           self.seq_len)
                cursor += phase.batch_size
                yield phase, s, batch

    def _resume_segments(self):
        """The plan's merged same-batch-size segments with the resume
        offset applied."""
        p0, s0, _ = self._start
        segs = []
        for b, entries in self.plan.merged_segments(self.seq_len):
            cur = []
            for phase, n in entries:
                if phase.index < p0:
                    continue
                if phase.index == p0:
                    n -= s0
                if n > 0:
                    cur.append((phase, n))
            if cur:
                segs.append((b, cur))
        return segs

    def _host_chunks(self, k: int) -> Iterator[Tuple[Any, Dict, int]]:
        """k steps at a time across each same-batch-size segment, the
        segment's tail chunk padded up to k by repeating its last step
        (padding consumes no cursor)."""
        _, _, cursor = self._start
        for b, entries in self._resume_segments():
            qi, qoff = 0, 0                 # phase pointer in segment
            remaining = sum(n for _, n in entries)
            while remaining:
                m = min(k, remaining)
                raw = self.source.sample(cursor, m * b, self.seq_len)
                chunk = {key: v.reshape(m, b, *v.shape[1:])
                         for key, v in raw.items()}
                if m < k:
                    chunk = {key: np.concatenate(
                        [v, np.repeat(v[-1:], k - m, axis=0)])
                        for key, v in chunk.items()}
                phase = entries[qi][0]      # phase of the chunk's head
                adv = m
                while adv:
                    take = min(adv, entries[qi][1] - qoff)
                    qoff += take
                    adv -= take
                    if qoff == entries[qi][1]:
                        qi, qoff = qi + 1, 0
                cursor += m * b
                remaining -= m
                yield phase, chunk, m

    @staticmethod
    def _prefetched(gen, depth: int):
        """Run ``gen`` in a daemon thread, ``depth`` items ahead.  The
        thread ends when ``gen`` does, or when the consumer closes this
        generator (or drops it); then the queue it fed is emptied."""
        q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for item in gen:
                    if not put(item):
                        return
                put(_DONE)
            except BaseException as e:            # propagate to consumer
                put(e)

        t = threading.Thread(target=worker, daemon=True,
                             name="loader-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is _DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()
            while not q.empty():
                q.get_nowait()

    # -- consumption ---------------------------------------------------- #
    def __iter__(self) -> Iterator[Tuple[Any, int, Dict[str, Any]]]:
        gen = self._host_steps()
        if self.prefetch:
            gen = self._prefetched(gen, self.prefetch)
        try:
            for phase, s, batch in gen:
                yield phase, s, self._to_device(batch)
        finally:
            gen.close()

    def iter_chunks(self, k: int) -> Iterator[Tuple[Any, Dict, int]]:
        """Yield (phase of the first step, stacked (k, B, ...) chunk on
        the device, m): only the first ``m`` steps are real — pass ``m``
        to ``PhaseEngine.run_chunk`` as ``n_valid``.  A chunk may span a
        phase boundary of one batch size, so each step's phase comes
        from its token count, not from the head phase."""
        gen = self._host_chunks(k)
        if self.prefetch:
            gen = self._prefetched(gen, self.prefetch)
        try:
            for phase, chunk, m in gen:
                yield phase, self._to_device(chunk), m
        finally:
            gen.close()
