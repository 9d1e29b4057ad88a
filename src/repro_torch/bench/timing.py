"""Device time of a call on the card, and the least time the card could
take for the same work.

``Timer`` times calls with CUDA events, the L2 cache flushed and the
host's enqueue hidden behind a device spin; ``GraphTimer`` times a call
as a CUDA graph replays it, among many others, with no launch cost of
the host's; ``bound`` turns a call's bytes and operations into the
H100's least time for them.  ``chip_smoke.py``
and ``repro_torch.bench.kernels`` time with these, so their numbers are
comparable.  Everything here needs a CUDA device.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.launch.mesh import (H100_HBM_BW, H100_PEAK_FLOPS_BF16,
                                     H100_PEAK_FLOPS_F32)

HBM_BYTES_PER_S = H100_HBM_BW       # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: H100_PEAK_FLOPS_BF16,
            torch.float32: H100_PEAK_FLOPS_F32}


class Timer:
    """Device time of one call: CUDA events around each call, median of
    ``iters``.  Before each call the queue is drained, a 64 MB write
    leaves the 50 MB L2 cold,
    as the bound assumes, and a device spin keeps the card busy while the
    host enqueues the call, so the events bracket the call's kernels and
    not the host's time to launch them.  The spin is sized from the
    call's own host time (four times ``host_us`` plus 50 us), and each
    call's enqueue time is measured: a timing counts only if the host
    finished enqueuing within three quarters of the spin, and if fewer
    than half do, the spin doubles and the timing is made again.

    ``host_us`` is the mean wall time of one call with the queue never
    drained in between: what a decode step pays per call when the card
    waits for the host."""

    def __init__(self, iters: int = 30, warmup: int = 3):
        self.iters, self.warmup = iters, warmup
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        # clock cycles of torch.cuda._sleep per microsecond
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        torch.cuda._sleep(4_000_000)
        end.record()
        torch.cuda.synchronize()
        self.cycles_per_us = 4_000_000 / (start.elapsed_time(end) * 1e3)

    def __call__(self, fn) -> float:
        for _ in range(self.warmup):
            fn()
        spin_us = 4 * self.host_us(fn, calls=20) + 50
        for _ in range(6):
            ev = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(self.iters)]
            enqueue_us = []
            for start, end in ev:
                torch.cuda.synchronize()        # an empty queue each time
                self.flush.zero_()
                torch.cuda._sleep(int(spin_us * self.cycles_per_us))
                t = time.perf_counter()
                start.record()
                fn()
                end.record()
                enqueue_us.append((time.perf_counter() - t) * 1e6)
            torch.cuda.synchronize()
            on_time = [s.elapsed_time(e) for (s, e), u in zip(ev, enqueue_us)
                       if u < 0.75 * spin_us]
            if 2 * len(on_time) >= self.iters:
                return float(np.median(on_time))
            spin_us *= 2
        raise RuntimeError("timer: the host never got ahead of the device")

    def host_us(self, fn, calls: int = 200) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        t = time.perf_counter() - t
        torch.cuda.synchronize()
        return t / calls * 1e6


class GraphTimer:
    """Device time of one call as a graph replay pays it, in
    microseconds: ``n`` back-to-back calls captured in one CUDA graph
    (``repro_torch.graphs.Graph``, which leaves the launch counters as
    they were; the replays here count nothing), replayed ``warmup``
    times, then ``iters`` times between CUDA events; the median replay
    over ``n``.  Nothing is flushed between the calls, so the L2 holds
    what the last one left, as in the serving and training graphs, where
    a norm reads the x the kernel before it just wrote.  Below ``Timer``'s
    floor of a few microseconds (its events and the spin around one
    launch), this is the number that says what a decode step's launches
    cost."""

    def __init__(self, n: int = 200, iters: int = 20, warmup: int = 3):
        self.n, self.iters, self.warmup = n, iters, warmup

    def __call__(self, fn) -> float:
        from repro_torch.graphs import Graph
        fn()                    # anything made at a first call, made here
        torch.cuda.synchronize()

        def calls():
            for _ in range(self.n):
                fn()            # each output freed, its memory reused
        graph = Graph(calls).graph
        for _ in range(self.warmup):
            graph.replay()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(self.iters)]
        for start, end in ev:
            start.record()
            graph.replay()
            end.record()
        torch.cuda.synchronize()
        ms = float(np.median([s.elapsed_time(e) for s, e in ev]))
        del graph
        return ms * 1e3 / self.n


def bound(n_bytes: float, n_ops: float, dtype) -> dict:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": n_ops}
