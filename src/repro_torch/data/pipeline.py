"""Phase-aware data loading (``repro.data.pipeline`` in PyTorch).

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

Two feeding modes:

- default: this process samples the whole global batch;
- ``per_host=True``: each process of a multi-process run samples only
  its rank's contiguous block of ``B / process_count`` rows a step, the
  block the data-parallel engine trains on that rank
  (``launch.mesh.assert_per_host_row_blocks``).  ``process_index`` and
  ``process_count`` default to the process group's rank and size; given
  explicitly they simulate N-process feeding in one process (the
  equivalence tests concatenate the shards and compare them with the
  single-process stream).  ``validate_per_host_plan`` checks up front
  that every phase still ahead divides across the processes.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.seesaw import SeesawPlan
from repro_torch.data.synthetic import MarkovLM
from repro_torch.launch import mesh
from repro_torch.train.checkpoint import exact_tokens

_DONE = object()


def validate_per_host_plan(plan: SeesawPlan, process_count: int,
                           n_data_devices: int = 1, *,
                           start_phase: int = 0) -> SeesawPlan:
    """Check that the per-host shard divides evenly across the ramp.

    Every phase's global batch must split into ``process_count`` equal
    per-process blocks and still shard over all ``n_data_devices``
    data-parallel devices: a ramp that divides only in its early phases
    would fail mid-run, so the launcher checks it up front and an
    adaptive cut checks its new stage.  An elastic resume passes
    ``start_phase``: the phases the checkpoint consumed are skipped, and
    a stage the new topology cannot feed is reported against the resume
    point."""
    suffix = (f" (resuming at phase {start_phase})"
              if start_phase > 0 else "")
    for p in plan.phases:
        if p.index < start_phase:
            continue
        if p.batch_size % max(process_count, 1):
            raise ValueError(
                f"phase {p.index}: global batch {p.batch_size} does "
                f"not divide across {process_count} host "
                f"processes{suffix}")
        if n_data_devices and p.batch_size % n_data_devices:
            raise ValueError(
                f"phase {p.index}: global batch {p.batch_size} does "
                f"not divide across {n_data_devices} data "
                f"devices{suffix}")
    return plan


class PhaseDataLoader:
    """Iterates a plan's (phase, step, batch) stream on ``device``.  In
    per-host mode process p yields rows ``[p·B/N, (p+1)·B/N)`` of every
    step's global batch, so the concatenation over the processes is the
    single-process stream row for row."""

    def __init__(self, source: MarkovLM, plan: SeesawPlan, seq_len: int, *,
                 device="cuda", prefetch: int = 2, per_host: bool = False,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 validate: bool = True):
        self.source = source
        self.plan = plan
        self.seq_len = seq_len
        self.device = torch.device(device)
        self.prefetch = prefetch
        self.per_host = per_host
        if per_host:
            self._pcount = process_count or mesh.world_size()
            self._pidx = (mesh.rank() if process_index is None
                          else process_index)
            # validate=False leaves the whole-ramp check to resume(): an
            # elastic resume onto a new topology must not fail on a phase
            # the checkpoint already consumed
            if validate:
                validate_per_host_plan(plan, self._pcount)
            if not 0 <= self._pidx < self._pcount:
                raise ValueError(
                    f"process_index {self._pidx} outside "
                    f"[0, {self._pcount})")
        else:
            self._pcount, self._pidx = 1, 0
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
        """Reposition the stream to continue a run at ``tokens_seen``.  In
        per-host mode the rest of the ramp is checked against this
        loader's process count from the resumed phase on: an elastic
        resume need not have the saving run's count, but it must feed
        every phase still ahead."""
        self._start = self.position_at(tokens_seen)
        if self.per_host:
            validate_per_host_plan(self.plan, self._pcount,
                                   start_phase=self._start[0])
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
        one after rechunking.  In per-host mode the phases from the cut on
        are checked, so a cut to a stage the processes cannot feed fails
        at the cut."""
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
    def _local_rows(self, batch_size: int) -> Tuple[int, int]:
        """(row offset within the step's global batch, rows to sample)
        for this process: the whole batch outside per-host mode."""
        bl = batch_size // self._pcount
        return self._pidx * bl, bl

    def _host_steps(self) -> Iterator[Tuple[Any, int, Dict]]:
        steps = self.plan.steps_per_phase(self.seq_len)
        p0, s0, cursor = self._start
        for pi in range(p0, len(self.plan.phases)):
            phase, n = self.plan.phases[pi], steps[pi]
            for s in range(s0 if pi == p0 else 0, n):
                off, bl = self._local_rows(phase.batch_size)
                batch = self.source.sample(cursor + off, bl, self.seq_len)
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

    def _sample_chunk(self, cursor: int, m: int, b: int) -> Dict:
        """m steps of (this process's rows of) the global batch b,
        stacked to (m, local b, ...)."""
        if self._pcount == 1:
            raw = self.source.sample(cursor, m * b, self.seq_len)
            return {key: v.reshape(m, b, *v.shape[1:])
                    for key, v in raw.items()}
        off, bl = self._local_rows(b)
        parts = [self.source.sample(cursor + s * b + off, bl, self.seq_len)
                 for s in range(m)]
        return {key: np.stack([p[key] for p in parts]) for key in parts[0]}

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
                chunk = self._sample_chunk(cursor, m, b)
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
