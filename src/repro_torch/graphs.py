"""CUDA graphs: the port's counterpart of the reference's compile cache.

The reference runs one compiled executable per key: per training
``(batch_size, micro, K)`` (``repro.train.engine.PhaseEngine._cache``),
per serving prompt bucket and one decode step
(``repro.serving.engine.ServingEngine``).  On the card the port captures
one CUDA graph per key instead, over static buffers, and replays it: one
``cudaGraphLaunch`` in place of the thousands of kernel launches an eager
step issues from Python.  The engines own their caches; this module holds
what they share.

- ``Graph`` captures one call of a function and replays it.  A capture
  runs nothing on the card, so it leaves the kernels' launch counters
  where they were: the launches made on the capture stream go to the
  capture's own tally (``kernels._build.capture_tally``), whichever
  thread makes them, and every replay adds that tally to the counters,
  so they go on counting launches through replays.  It captures in
  thread-local mode: another thread may meanwhile copy on its own stream
  (an async checkpoint's writer) or launch and replay (the training loop,
  while the engine captures the next batch size's graph in the
  background).  Captures take turns, on one capture stream a device.
- ``PinnedStage`` carries host values to the card without a sync: a
  ``copy_`` from pageable memory would synchronise the stream.

A failed capture raises: nothing falls back to the eager step.
"""
from __future__ import annotations

import gc
import threading
import time
from typing import Callable, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import overlap as _ov
from repro_torch.kernels import paged as _pg
from repro_torch.kernels import rglru as _rg
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd as _ssd

# every kernel wrapper's launch counter: (module, attribute)
COUNTERS = ((_rn, "launches"), (_rn, "bwd_launches"), (_fa, "launches"),
            (_fa, "dq_launches"), (_fa, "dkv_launches"), (_pg, "launches"),
            (_ssd, "launches"), (_ov, "launches"), (_rg, "launches"),
            (_rg, "bwd_launches"), (_rn, "split_sumsq_launches"),
            (_rn, "split_fwd_launches"), (_rn, "split_dot_launches"),
            (_rn, "split_bwd_launches"), (_pg, "partial_launches"),
            (_pg, "scores_launches"), (_pg, "softmax_pv_launches"))


def launch_counts() -> Tuple[int, ...]:
    """The launch counters, in the order of ``COUNTERS``."""
    return tuple(getattr(m, a) for m, a in COUNTERS)


def tally_counts(tally) -> Tuple[int, ...]:
    """A capture's tally (``kernels._build.capture_tally``) as launch
    counts in the order of ``COUNTERS``."""
    return tuple(tally.get((m.__name__, a), 0) for m, a in COUNTERS)


def add_launch_counts(delta: Sequence[int]) -> None:
    for (m, a), d in zip(COUNTERS, delta):
        if d:
            setattr(m, a, getattr(m, a) + d)


_capture_lock = threading.Lock()


def _warm_blas(stream: torch.cuda.Stream) -> None:
    """Make this thread's cuBLAS and cuBLASLt handles, and their
    workspaces on ``stream``, by running small products there: a thread
    that first multiplies inside a capture would make them mid-capture."""
    with torch.cuda.stream(stream):
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.ones(16, 16, dtype=dtype, device="cuda")
            torch.nn.functional.linear(a, a, a[0])
            a @ a


class Graph:
    """One captured CUDA graph of ``fn()``, whose tensors (inputs,
    parameters, state) must stay where they are for as long as the
    graph is replayed; ``out`` is what the captured call returned, which
    every replay overwrites in place.  ``pool`` is the memory pool the
    capture allocates from (``torch.cuda.graph_pool_handle()``), shared
    by graphs that are never replayed concurrently.  Any thread may
    capture; captures take turns on torch's capture stream."""

    def __init__(self, fn: Callable, pool=None):
        t = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        with _capture_lock:
            # thread-local: other threads' CUDA calls leave this capture
            # alone
            ctx = torch.cuda.graph(self.graph, pool=pool,
                                   capture_error_mode="thread_local")
            stream = ctx.capture_stream
            _warm_blas(stream)
            # Python's collector stays off while capturing: a dead cycle
            # that holds another graph, an event or pinned memory would
            # free them mid-capture, on this thread, and those CUDA calls
            # end the capture.  Collected first, the cycles also give back
            # the card memory they hold.  Captures take turns, so the
            # collector's state is saved and restored by one at a time.
            gc.collect()
            was_enabled = gc.isenabled()
            gc.disable()
            try:
                with _build.capture_tally(stream.cuda_stream) as tally:
                    with ctx:
                        self.out = fn()
            finally:
                if was_enabled:
                    gc.enable()
        self.capture_s = time.perf_counter() - t
        self.launches = tally_counts(tally)     # launches a replay makes

    def replay(self):
        self.graph.replay()
        add_launch_counts(self.launches)
        return self.out


class PinnedStage:
    """Host values to the card with one non-blocking copy from pinned
    memory.  Two pinned buffers are used in turn; before the host writes
    one again it waits for the event recorded behind the copies that
    read it last (``done``), so a copy still queued never sees a later
    value."""

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype
        self._bufs: list = [None, None]
        self._done: list = [None, None]
        self._i = 0

    def put(self, values) -> torch.Tensor:
        """Write ``values`` (a CPU tensor or array of ``dtype``) into the
        next buffer and return it (a pinned CPU tensor of their length);
        copy from it with ``non_blocking=True``, then call ``done``."""
        values = torch.as_tensor(values, dtype=self.dtype).reshape(-1)
        self._i = (self._i + 1) % len(self._bufs)
        ev = self._done[self._i]
        if ev is not None:
            ev.synchronize()
        buf = self._bufs[self._i]
        if buf is None or buf.numel() < values.numel():
            buf = torch.empty(max(values.numel(), 1), dtype=self.dtype,
                              pin_memory=True)
            self._bufs[self._i] = buf
        buf = buf[:values.numel()]
        buf.copy_(values)
        return buf

    def done(self) -> None:
        """Mark the current buffer free once the work queued so far on the
        current stream has run."""
        event = torch.cuda.Event()
        event.record()
        self._done[self._i] = event
