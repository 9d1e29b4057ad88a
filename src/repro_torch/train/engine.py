"""The phase execution engine (``repro.train.engine`` in PyTorch) — the
one train-step stack under ``Trainer`` and ``launch.train``.

1. ``make_grad_step`` — one optimizer step ``(model, opt_state, batch,
   lr) → (model, opt_state, metrics)``: micro-batch accumulation that
   averages the grads and means the metrics, then the optimizer.
2. ``plan_lr_fn`` — the plan's token-indexed LR, with the realized
   (step-quantized) cut boundaries summed as exact integers and the
   exact int32 step compare.
3. ``chunk_lrs`` — the LR of each step of a K-step chunk, on the host,
   with the reference's exact int step offset and ``step0 < 0``
   sentinel.
4. ``PhaseEngine`` — the accumulation count per batch size, the step
   cache and ``run_chunk``: up to K steps a call, with the reference's
   ``n_valid`` mask; metrics come back stacked ``(K,)`` on the device,
   read by the caller at its log boundaries.

The step cache is the reference's compile cache (one executable per
``(batch_size, micro, K)``): one entry per ``(batch_size, micro)`` in
``PhaseEngine._cache``, K being a loop on the host.  On the card an
entry holds a CUDA graph of one optimizer step, ``make_grad_step``'s
body, captured over static buffers: the batch, the LR as a 0-d device
tensor, the metrics, and the parameters and optimizer state, which the
step updates in place.  ``run_chunk`` replays it once per real step:
batch i is copied into the static batch on the device, the LR staged
from pinned memory (no sync), the graph replayed and its metric row
copied into the chunk's stacked outputs; rows past ``n_valid`` stay
zero, so a short chunk captures nothing new.  The engine's first step
runs eagerly: it builds the kernels and makes cuBLAS's handles and the
kernels' counters before any capture.  Every later key is captured
directly and then replayed, with no eager step of its own (at 2.7B an
eager step would not fit beside the graphs' pool).  The graphs of one
engine share one memory pool, captured in ramp order and never replayed
concurrently.  A failed capture raises.  On the CPU an entry holds the
eager step, which ``run_chunk`` calls: the same bookkeeping and the
same numbers.

The LR is evaluated on the host in float32 torch arithmetic (the
reference's); the CPU step reads it as a 0-d CPU tensor.

An ``adaptive-seesaw`` plan grows at runtime.  Its LR is
``plan_lr_fn`` of the current plan, rebuilt at each cut
(``update_plan``): a cut changes values the host computes and nothing
on the card, so no graph is captured again, and a cut that only cuts
the LR (a ramp clamped by ``max_batch_size``) keeps its batch size's
graph.  (The reference passes the phase table as runtime arguments,
padded to a fixed width, only because its step is compiled.)
``run_chunk`` then also carries the loss EMA the plateau controller
reads, one float32 scalar a chunk (``make_fused_step(ema_decay=...)`` in
the reference).  At a cut to a new batch size ``prewarm_async`` captures
its graph in a thread while the loop goes on (the reference compiles it
in one); the key's first chunk joins it.

In a multi-process run (a ``torch.distributed`` group) every rank holds
the model and trains on its own rows of each global batch; a step
averages the ranks' grads and metrics with one all-reduce of a flat
float32 buffer before the norm, the clip and the optimizer
(``SplitStep``, ``FlatReduce``).  A gloo collective is host work that no
CUDA graph holds, so on the card a key holds two graphs, the grad half
and the update half, and the all-reduce runs between their replays.
With one process nothing of this runs: one graph a key, as before.

On a data × model mesh of processes (``PhaseEngine(mesh=...)``, the
launcher's ``--mesh``) each rank holds shards of the weights and of
AdamW's state (``parallel.shard``) and trains on its data slot's rows;
the step is a :class:`MeshStep`.  It runs eagerly on the card too: a
gloo collective is host work that no CUDA graph holds, and a sharded
step issues dozens of them (a gather before each weight's use, the
model group's all-reduces, the recompute's again).  Capturing NCCL
collectives waits for a cell whose ranks have cards of their own.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import graphs as G
from repro_torch import parallel
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import schedules as S
from repro_torch.core.seesaw import SeesawPlan
from repro_torch.launch import mesh as MESH
from repro_torch.models import registry as R
from repro_torch.models.layers import P
from repro_torch.optim import optimizers as O

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


# --------------------------------------------------------------------- #
# 1. the single grad step
# --------------------------------------------------------------------- #

def _local_grads(model, cfg, batch, names, params, micro_batches, z_loss,
                 dtype, remat, seq_shard: bool = True,
                 remat_policy: str = ""):
    """(grads in ``names``' order, float32 metrics) of ``batch`` on this
    process: with ``micro_batches`` > 1 the batch splits along its first
    dim, the grads are summed and divided by the count, the metrics
    averaged.  ``seq_shard`` and ``remat_policy`` go to
    ``registry.loss_fn`` (which families honour them is said there); on a
    mesh the record of the grads the forward leaves partial over the
    model group starts empty (``parallel.reduce_grads`` reads it)."""
    tp = parallel.tp_of(model)
    if tp is not None:
        tp.model_partial.clear()
    kw = dict(z_loss=z_loss, dtype=dtype, remat=remat, seq_shard=seq_shard,
              remat_policy=remat_policy)
    if micro_batches > 1:
        b = next(iter(batch.values())).shape[0] // micro_batches
        gacc, rows = None, []
        for i in range(micro_batches):
            mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
            loss, aux = R.loss_fn(model, cfg, mb, **kw)
            g = torch.autograd.grad(loss, [params[n] for n in names])
            if gacc is None:
                gacc = list(g)
            else:                   # in place: one set of grads held
                for a, gi in zip(gacc, g):
                    a.add_(gi)
            # freed before the next backward, which would otherwise
            # hold a third set of grads from the third micro-batch on
            g = gi = None
            rows.append(dict(aux, loss=loss))
        grads = [a.div_(micro_batches) for a in gacc]
        metrics = {k: torch.stack([r[k].detach() for r in rows]).mean()
                   for k in rows[0]}
    else:
        loss, metrics = R.loss_fn(model, cfg, batch, **kw)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
    return grads, {k: v.detach().float() for k, v in metrics.items()}


def opt_state_specs(param_spec_tree, opt_state):
    """The param specs mirrored onto the ``m``/``v``/``mu`` slots; the
    scalars (``count``) replicated."""
    return {k: param_spec_tree if k in ("m", "v", "mu") else P()
            for k in opt_state}


def make_grad_step(cfg: ModelConfig, optimizer: O.Optimizer, *,
                   micro_batches: int = 1, z_loss: float = 0.0,
                   dtype=torch.bfloat16, remat: bool = True,
                   reduce: Optional["FlatReduce"] = None,
                   mesh=None, seq_shard: bool = True,
                   remat_policy: str = "") -> Callable:
    """The one training step builder: ``step(model, opt_state, batch,
    lr) → (model, opt_state, metrics)``.  With ``micro_batches`` > 1 the
    batch splits along its first dim; the grads are summed and divided
    by the count, the metrics averaged.  ``metrics["grad_norm"]`` is the
    global norm of the averaged grads before clipping.  With ``reduce``
    (more than one rank) the step is a :class:`SplitStep`: this rank's
    grads and metrics are averaged over the ranks before the norm, the
    clip and the optimizer.  With ``mesh`` (a model cut to a data × model
    mesh) the step is a :class:`MeshStep`.  ``seq_shard`` (the reference's
    default: the sequence-parallel residual on a mesh; nothing on one
    process) and ``remat_policy`` ("dots": the products' outputs kept
    under remat) reach the family's loss (``registry.loss_fn``)."""
    kw = dict(micro_batches=micro_batches, z_loss=z_loss, dtype=dtype,
              remat=remat, seq_shard=seq_shard, remat_policy=remat_policy)
    if mesh is not None:
        return MeshStep(cfg, optimizer, **kw)
    if reduce is not None:
        return SplitStep(cfg, optimizer, reduce=reduce, **kw)

    def step(model, opt_state, batch, lr):
        params = dict(model.named_parameters())
        names = list(params)
        grads, metrics = _local_grads(model, cfg, batch, names, params,
                                      micro_batches, z_loss, dtype, remat,
                                      seq_shard, remat_policy)
        metrics["grad_norm"] = O.global_norm(grads)
        _, opt_state = optimizer.update(dict(zip(names, grads)), opt_state,
                                        params, lr)
        return model, opt_state, metrics

    return step


class FlatReduce:
    """The one float32 buffer a multi-rank step all-reduces: every
    parameter's grad in ``named_parameters`` order, then the metrics in
    a fixed order.  Made at the first step, which runs eagerly before
    any capture, and shared by every batch size's step (and graphs): its
    address is what the graphs read and write.  ``all_reduce`` sums it
    over the process group; the update half divides by the world size.
    The collective runs between the two halves' graphs, since a gloo
    collective is host work that no CUDA graph holds.  Its time is kept:
    CUDA events around it on the card (read at the end, no sync), the
    host clock on the CPU."""

    def __init__(self, world: int):
        self.world = world
        self.flat: Optional[torch.Tensor] = None
        self.views: List[torch.Tensor] = []
        self.metric_names: List[str] = []
        self.calls = 0
        self._events: List[Tuple] = []
        self._host_s = 0.0

    def buffers(self, params: List[torch.Tensor], metrics: Dict):
        """(grad views, metric view) of the buffer, made at first use
        (the metrics' names fix their order)."""
        if self.flat is None:
            if params[0].is_cuda and \
                    torch.cuda.is_current_stream_capturing():
                raise RuntimeError("the all-reduce buffer would be made "
                                   "during a capture; run a step first")
            self.metric_names = sorted(metrics)
            n = sum(p.numel() for p in params)
            self.flat = torch.zeros(n + len(self.metric_names),
                                    dtype=torch.float32,
                                    device=params[0].device)
            off = 0
            for p in params:
                self.views.append(self.flat[off:off + p.numel()]
                                  .view(p.shape))
                off += p.numel()
        return self.views, self.flat[-len(self.metric_names):]

    def all_reduce(self) -> None:
        if self.flat.is_cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            dist.all_reduce(self.flat)
            ev[1].record()
            self._events.append(ev)
        else:
            t = time.perf_counter()
            dist.all_reduce(self.flat)
            self._host_s += time.perf_counter() - t
        self.calls += 1

    def ms(self) -> float:
        """Milliseconds spent in the all-reduces so far."""
        for a, b in self._events:
            b.synchronize()
            self._host_s += a.elapsed_time(b) / 1e3
        self._events.clear()
        return self._host_s * 1e3


class SplitStep:
    """A multi-rank optimizer step in two halves around the all-reduce.
    ``grad_half(model, batch)`` writes this rank's grads (averaged over
    its micro-batches, as the one-rank step) and metrics into the
    :class:`FlatReduce` buffer; ``update_half(model, opt_state, lr)``
    divides the summed buffer by the world size, takes the global norm
    and runs the optimizer (its clip too) on the averaged grads, and
    returns the metrics.  Calling the step runs both with the
    all-reduce between them; on the card the engine captures each half
    in a graph of its own and runs the all-reduce between their
    replays."""

    def __init__(self, cfg, optimizer, *, micro_batches, z_loss, dtype,
                 remat, reduce: FlatReduce, seq_shard: bool = True,
                 remat_policy: str = ""):
        self.cfg, self.optimizer = cfg, optimizer
        self.micro_batches, self.z_loss = micro_batches, z_loss
        self.dtype, self.remat = dtype, remat
        self.seq_shard, self.remat_policy = seq_shard, remat_policy
        self.reduce = reduce

    def grad_half(self, model, batch) -> None:
        params = dict(model.named_parameters())
        names = list(params)
        grads, metrics = _local_grads(model, self.cfg, batch, names, params,
                                      self.micro_batches, self.z_loss,
                                      self.dtype, self.remat, self.seq_shard,
                                      self.remat_policy)
        views, mvec = self.reduce.buffers([params[n] for n in names],
                                          metrics)
        for v, g in zip(views, grads):
            v.copy_(g)
        mvec.copy_(torch.stack([metrics[k]
                                for k in self.reduce.metric_names]))

    def update_half(self, model, opt_state, lr) -> Dict[str, torch.Tensor]:
        params = dict(model.named_parameters())
        red = self.reduce
        red.flat.div_(red.world)
        grads = red.views
        mvec = red.flat[-len(red.metric_names):]
        metrics = {k: mvec[i].clone()
                   for i, k in enumerate(red.metric_names)}
        metrics["grad_norm"] = O.global_norm(grads)
        self.optimizer.update(dict(zip(params, grads)), opt_state, params,
                              lr)
        return metrics

    def __call__(self, model, opt_state, batch, lr):
        self.grad_half(model, batch)
        self.reduce.all_reduce()
        return model, opt_state, self.update_half(model, opt_state, lr)


def slot_rows(batch: Dict[str, torch.Tensor], mesh,
              rank: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The rows of a global batch that ``rank``'s data slot trains on:
    every leaf (tokens, labels, mask, and a frontend's ``src_emb`` or
    ``prefix_emb``) cut along its first dim to the slot's block of
    B / (P·D) rows.  The ranks of one slot take the same rows."""
    rank = MESH.rank() if rank is None else rank
    i, n = mesh.fsdp_index(rank), mesh.n_fsdp
    out = {}
    for name, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"{name}: {v.shape[0]} rows do not split over "
                             f"{n} data slots")
        b = v.shape[0] // n
        out[name] = v[i * b:(i + 1) * b]
    return out


class MeshStep:
    """An optimizer step of a model cut to a data × model mesh
    (``parallel.shard``).  The backward sums each data-sharded grad over
    the FSDP group inside the weights' gathers; then one float32
    all-reduce over the FSDP group sums the replicated grads (the norms)
    and the metrics; every grad and metric is divided by P·D, so the
    metrics are the data slots' mean.  ``grad_norm`` counts each distinct
    block once (``parallel.global_norm``, one scalar all-reduce over the
    whole group); the optimizer's clip (and normalized SGD) use it, and
    AdamW updates the rank's shards in place.  With ``seq_shard`` (the
    reference's default) the families cut the residual along the sequence
    (``parallel``'s docstring), and the norm scales the forward records as
    partial are summed over the model group in the same all-reduce."""

    def __init__(self, cfg, optimizer, *, micro_batches, z_loss, dtype,
                 remat, seq_shard: bool = True, remat_policy: str = ""):
        self.cfg, self.optimizer = cfg, optimizer
        self.micro_batches, self.z_loss = micro_batches, z_loss
        self.dtype, self.remat = dtype, remat
        self.seq_shard, self.remat_policy = seq_shard, remat_policy

    def __call__(self, model, opt_state, batch, lr):
        tp = model.tp
        params = dict(model.named_parameters())
        names = list(params)
        plist = [params[n] for n in names]
        grads, metrics = _local_grads(model, self.cfg, batch, names, params,
                                      self.micro_batches, self.z_loss,
                                      self.dtype, self.remat, self.seq_shard,
                                      self.remat_policy)
        grads, metrics = parallel.reduce_grads(tp, plist, grads, metrics)
        norm = parallel.global_norm(tp, plist, grads)
        metrics["grad_norm"] = norm
        self.optimizer.update(dict(zip(names, grads)), opt_state, params,
                              lr, norm=norm)
        return model, opt_state, metrics


# --------------------------------------------------------------------- #
# 2. token-indexed LR
# --------------------------------------------------------------------- #

def plan_lr_fn(plan: SeesawPlan,
               seq_len: Optional[int] = None) -> Callable:
    """The plan's LR curve ``lr(tokens_seen, step=None)``: the
    continuous quarter-cosine for cosine plans, else
    :func:`schedules.piecewise_lr` over the phase table.  With
    ``seq_len`` the cut thresholds are the *realized* phase starts of
    ``steps_per_phase`` (where the loader switches batch size), summed
    in exact integers, and the cumulative step boundaries go with them,
    so a step that knows its global index selects its phase by an exact
    int32 compare."""
    if plan.kind == "cosine":
        return S.quarter_cosine_lr(plan.base_lr, plan.total_tokens,
                                   plan.warmup_tokens)
    if seq_len:
        ends, step_ends, tok, n_cum = [], [], 0, 0
        for p, n in zip(plan.phases, plan.steps_per_phase(seq_len)):
            tok += n * p.batch_size * seq_len
            n_cum += n
            ends.append(tok)
            step_ends.append(n_cum)
    else:
        ends = [p.end_tokens for p in plan.phases]
        step_ends = None
    return S.piecewise_lr(plan.base_lr, plan.warmup_tokens, ends,
                          [p.lr_scale for p in plan.phases],
                          phase_end_steps=step_ends)


# --------------------------------------------------------------------- #
# 3. the LRs of a K-step chunk
# --------------------------------------------------------------------- #

def chunk_lrs(lr_fn: Callable, tokens_seen, step0: int, n: int,
              tokens_per_step: int) -> torch.Tensor:
    """The (n,) float32 LRs of a chunk's first n steps, on the host.
    Step i's token count is the once-rounded float32 ``tokens_seen``
    plus ``i * tokens_per_step`` computed in int32; its global step index
    is ``step0 + i``, or the sentinel -1 for every step when ``step0 <
    0``."""
    tps = torch.tensor(int(tokens_per_step), dtype=torch.int32)
    tok0 = torch.tensor(float(tokens_seen), dtype=torch.float32)
    lrs = [lr_fn(tok0 + (torch.tensor(i, dtype=torch.int32) * tps).float(),
                 -1 if step0 < 0 else step0 + i) for i in range(n)]
    return torch.stack(lrs) if lrs else torch.zeros(0)


# --------------------------------------------------------------------- #
# 4. the engine
# --------------------------------------------------------------------- #

class _Step:
    """One cache entry: the grad step of a ``(batch_size, micro)`` key
    and, on the card once captured, its graph (with more than one rank
    two: ``graph`` the grad half, ``update`` the update half), the static
    batch it reads and the (model, optimizer state) it updates."""

    def __init__(self, grad: Callable):
        self.grad = grad
        self.graph: Optional[G.Graph] = None
        self.update: Optional[G.Graph] = None
        self.batch: Optional[Dict[str, torch.Tensor]] = None
        self.state: Optional[Tuple] = None


def ema_update(ema: torch.Tensor, losses: torch.Tensor, n: int,
               decay: float) -> torch.Tensor:
    """The reference's loss-EMA carry over a chunk's first ``n`` steps:
    ``ema ← d·ema + (1−d)·loss`` per step in float32, ``1−d`` computed in
    float32, seeded by the first loss when ``ema < 0`` (unseeded); padded
    steps leave it alone.  Runs where ``losses`` lie, without a sync."""
    d = torch.tensor(decay, dtype=torch.float32, device=losses.device)
    one_minus = torch.tensor(1.0, dtype=torch.float32,
                             device=losses.device) - d
    for i in range(n):
        loss = losses[i]
        ema = torch.where(ema < 0, loss, d * ema + one_minus * loss)
    return ema


class PhaseEngine:
    """Dispatcher for one run: the accumulation count per batch size, the
    step cache and the K-step chunk call.  An ``adaptive-seesaw`` plan
    adds the live plan (``update_plan``) and the loss EMA
    (``run_chunk(loss_ema=)``).  In a multi-process run (a
    ``torch.distributed`` group of more than one rank) each rank trains
    on its own rows of every global batch and the steps average grads
    and metrics over the ranks (:class:`SplitStep`).  With ``mesh`` (a
    ``launch.mesh.Mesh`` the model is cut to) each data slot trains on
    its rows, the steps are :class:`MeshStep`s, run eagerly.
    ``remat_policy`` is the steps' (``recompute``'s; "dots" keeps the
    products' outputs), fixed for the engine's life: the reference's
    trainer runs the loss's default ("") and ``seq_shard=True``
    (``make_grad_step``'s)."""

    def __init__(self, cfg: RunConfig, optimizer: O.Optimizer,
                 plan: SeesawPlan, *, max_device_batch: Optional[int] = None,
                 mesh=None, remat_policy: str = ""):
        self.cfg = cfg
        self.model = cfg.model
        self.optimizer = optimizer
        self.plan = plan
        self.max_device_batch = max_device_batch
        self.adaptive = plan.kind == "adaptive-seesaw"
        if self.adaptive:
            self.ema_decay = float(cfg.schedule.ema_decay or 0.98)
        self.lr_fn = plan_lr_fn(plan, cfg.seq_len)
        self.dtype = DTYPES[cfg.dtype]
        self.mesh = mesh
        self.remat_policy = remat_policy
        self.world = MESH.world_size()
        self.reduce = (FlatReduce(self.world)
                       if self.world > 1 and mesh is None else None)
        self._cache: Dict[Tuple[int, int], _Step] = {}
        self.captures = 0                 # graphs captured
        self.capture_s = 0.0              # seconds spent capturing them
        self.lr: Optional[torch.Tensor] = None   # the graphs' LR (card)
        self._warm = False                # the first (eager) step has run
        self._pool = None
        self._stage: Optional[G.PinnedStage] = None
        # the (model, optimizer state) of the last chunk, which a
        # background capture is made over
        self._live: Optional[Tuple] = None
        # background captures: key -> [thread, error]; join wait by key
        self._prewarm: Dict[Tuple[int, int], list] = {}
        self.prewarm_wait_s: Dict[Tuple[int, int], float] = {}

    def n_data_devices(self) -> int:
        """The data-parallel width: the mesh's data slots (P·D), else the
        process group's size (1 in a single-process run)."""
        if self.mesh is not None:
            return self.mesh.n_fsdp
        return self.world

    def micro_batches(self, batch_size: int) -> int:
        """Accumulation count for a global batch.  The micro-batch is a
        slice of the global batch, so it must divide the global batch and
        still split evenly across the data ranks; the least such count
        whose per-rank share holds at most ``max_device_batch`` rows.
        When no count satisfies both, raise (a fractional per-rank share
        is what the check rules out)."""
        if not self.max_device_batch:
            return 1
        n_dev = max(self.n_data_devices(), 1)
        per_dev = batch_size // n_dev
        micro = max(-(-per_dev // self.max_device_batch), 1)
        while micro <= batch_size:
            if (batch_size % micro == 0
                    and (batch_size // micro) % n_dev == 0):
                return micro
            micro += 1
        raise ValueError(
            f"no gradient-accumulation count splits global batch "
            f"{batch_size} into microbatches of <= "
            f"{self.max_device_batch} rows per device across {n_dev} "
            f"data devices: every divisor of {batch_size} leaves a "
            f"per-device share that is fractional — use a batch size "
            f"divisible by {n_dev}")

    def update_plan(self, plan: SeesawPlan) -> None:
        """Swap in an extended plan after an adaptive cut.  Only for the
        adaptive kind: a prescheduled plan's LR is fixed for the run."""
        if not self.adaptive:
            raise ValueError(
                "update_plan is only valid for adaptive-seesaw engines; "
                "a prescheduled plan is fixed for the run")
        self.plan = plan
        self.lr_fn = plan_lr_fn(plan, self.cfg.seq_len)

    def host_lr(self, tokens: float, step: Optional[int] = None) -> float:
        """The schedule's LR at a host-known position."""
        return float(self.lr_fn(float(tokens), step))

    def make_checkpoint_manager(self, **kw):
        """A :class:`checkpoint.CheckpointManager` bound to this engine's
        plan and seq_len, so its saves carry the phase metadata of the
        trainer's sync path; ``kw`` passes through (``chunk_bytes``)."""
        from repro_torch.train.checkpoint import CheckpointManager
        return CheckpointManager(plan=self.plan, seq_len=self.cfg.seq_len,
                                 **kw)

    def step_for(self, batch_size: int) -> _Step:
        """The cache entry of a global batch size (made on first use).  A
        background capture of its key still under way is joined first,
        and its error raised here."""
        micro = self.micro_batches(batch_size)
        key = self._key(batch_size)
        self._join(key)
        ent = self._cache.get(key)
        if ent is None:
            if self.mesh is not None:     # before the step's collectives
                parallel.check_batch(self.model, self.mesh,
                                     batch_size // micro, self.cfg.seq_len)
            ent = self._cache[key] = _Step(make_grad_step(
                self.model, self.optimizer, micro_batches=micro,
                z_loss=self.cfg.z_loss, dtype=self.dtype,
                remat=self.cfg.remat, reduce=self.reduce, mesh=self.mesh,
                remat_policy=self.remat_policy))
        return ent

    def _key(self, batch_size: int) -> tuple:
        """The step cache's key: (batch_size, micro), the reference's.
        Neither knob keys anything: the remat policy is the engine's, and
        ``seq_shard`` changes nothing on one process, while a mesh
        captures no graph."""
        return (batch_size, self.micro_batches(batch_size))

    def run_chunk(self, model, opt_state, tokens_seen, stacked_batch,
                  n_valid: Optional[int] = None,
                  step: Optional[int] = None, loss_ema=None):
        """One call: up to K optimizer steps.  Returns (model, opt_state,
        stacked metrics) without a sync; rows past ``n_valid`` (default
        all K) are zeros.  ``tokens_seen`` is the host's exact token
        count; ``step`` the global index of the chunk's first step
        (None: select LR cuts by tokens).  Metrics come back stacked
        (K,): the LR on the host, the rest on the batch's device.  An
        adaptive engine returns a fourth element, the loss EMA after the
        chunk (a float32 0-d tensor on the batch's device), carried from
        ``loss_ema`` (None: unseeded, the first loss seeds it).  In a
        multi-process run ``stacked_batch`` holds this rank's rows (its
        data slot's on a mesh), and the metrics are the global batch's.
        A mesh's steps run eagerly on the card too."""
        first = next(iter(stacked_batch.values()))
        k = first.shape[0]
        batch_size = first.shape[1] * self.n_data_devices()
        n = k if n_valid is None else min(int(n_valid), k)
        if k * batch_size * self.cfg.seq_len >= 2 ** 31:
            raise ValueError(
                f"chunk of {k}x{batch_size}x{self.cfg.seq_len} tokens "
                f"overflows the int32 token offset — lower fuse_steps")
        ent = self.step_for(batch_size)
        lrs = chunk_lrs(self.lr_fn, tokens_seen,
                        -1 if step is None else int(step), n,
                        batch_size * self.cfg.seq_len)
        self._live = (model, opt_state)
        if first.device.type == "cuda" and self.mesh is None:
            metrics = self._run_card(ent, model, opt_state, stacked_batch,
                                     lrs, k)
        else:
            rows = []
            for i in range(n):
                model, opt_state, m = ent.grad(
                    model, opt_state,
                    {name: v[i] for name, v in stacked_batch.items()},
                    lrs[i])
                rows.append(m)
            metrics = {}
            for name in (rows[0] if rows else ()):
                col = torch.stack([r[name] for r in rows])
                metrics[name] = torch.cat([col, col.new_zeros(k - n)])
        if n:
            metrics["lr"] = torch.cat([lrs, lrs.new_zeros(k - n)])
        if not self.adaptive:
            return model, opt_state, metrics
        ema = torch.tensor(-1.0 if loss_ema is None else float(loss_ema),
                           dtype=torch.float32, device=first.device)
        if n:
            ema = ema_update(ema, metrics["loss"], n, self.ema_decay)
        return model, opt_state, metrics, ema

    # -- the card: eager first step, then captured graphs --------------- #
    def _run_card(self, ent: _Step, model, opt_state, stacked, lrs,
                  k: int) -> Dict[str, torch.Tensor]:
        device = next(iter(stacked.values())).device
        if self.lr is None:
            self.lr = torch.zeros((), dtype=torch.float32, device=device)
            self._stage = G.PinnedStage(torch.float32)
            self._pool = torch.cuda.graph_pool_handle()
        host_lrs = self._stage.put(lrs)
        out: Dict[str, torch.Tensor] = {}
        for i in range(len(lrs)):
            self.lr.copy_(host_lrs[i], non_blocking=True)
            batch = {name: v[i] for name, v in stacked.items()}
            if not self._warm:
                _, _, m = ent.grad(model, opt_state, batch, self.lr)
                self._warm = True
                # the eager step's cached blocks go back before the
                # graphs' pool takes its own
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            else:
                if ent.graph is None:
                    self._capture(ent, model, opt_state, batch)
                elif ent.state[0] is not model or ent.state[1] is not \
                        opt_state:
                    raise ValueError(
                        "run_chunk: this batch size's graph was captured "
                        "over another model or optimizer state")
                for name, buf in ent.batch.items():
                    buf.copy_(batch[name])
                m = ent.graph.replay()
                if ent.update is not None:
                    self.reduce.all_reduce()
                    m = ent.update.replay()
            if not out:
                rows = torch.zeros(len(m), k, dtype=torch.float32,
                                   device=device)
                out = dict(zip(m, rows.unbind()))
            for name, v in m.items():
                out[name][i].copy_(v)
        self._stage.done()
        return out

    def _capture(self, ent: _Step, model, opt_state, batch) -> None:
        """Capture ``ent``'s step over a static copy of ``batch``, the
        engine's LR and the given model and state: one graph, or with
        more than one rank the grad half's and the update half's."""
        ent.batch = {name: v.clone() for name, v in batch.items()}
        ent.state = (model, opt_state)
        if isinstance(ent.grad, SplitStep):
            ent.graph = G.Graph(lambda: ent.grad.grad_half(model, ent.batch)
                                or {}, self._pool)
            ent.update = G.Graph(
                lambda: ent.grad.update_half(model, opt_state, self.lr),
                self._pool)
            graphs = (ent.graph, ent.update)
        else:
            ent.graph = G.Graph(
                lambda: ent.grad(model, opt_state, ent.batch, self.lr)[2],
                self._pool)
            graphs = (ent.graph,)
        self.captures += len(graphs)
        self.capture_s += sum(g.capture_s for g in graphs)

    # -- the next batch size's graph, captured in the background --------- #
    def prewarm_async(self, batch_size: int, k: int, stacked_batch):
        """Capture the step of a future batch size in a daemon thread (the
        reference's background compile at an adaptive cut), so its first
        chunk replays a graph instead of capturing one.  ``stacked_batch``
        is the current chunk, read for its per-row shapes and dtypes only:
        the capture reads a static batch of the new shape, which each
        replay fills.  ``k`` (the chunk length) keys nothing here: one
        graph holds one step.

        Returns the started thread, or ``None`` when the key is captured
        or warming already, when the batch lies on the CPU or the engine
        runs a mesh (nothing to capture) or before the engine's first,
        eager, step.
        :meth:`step_for` joins a thread in flight for its key before
        using the entry, so a key is never captured twice.  Where the
        reference lets a failed background compile fall back to a lazy
        compile, a failed capture here raises, in the main thread, at
        that join: nothing falls back to the eager step.  While the
        capture runs, the other threads may launch, replay, copy and sync
        their own streams, but not the whole device: CUDA refuses a
        ``torch.cuda.synchronize()`` while a stream captures.  The
        trainer's loop syncs its own stream only, and joins the capture
        (at the new key's first chunk, or at the end of the run) before
        anything else could."""
        first = next(iter(stacked_batch.values()))
        key = self._key(batch_size)
        if first.device.type != "cuda" or self.mesh is not None or \
                not self._warm or self._live is None or \
                key in self._prewarm:
            return None
        ent = self.step_for(batch_size)
        if ent.graph is not None:
            return None
        model, opt_state = self._live
        rows = batch_size // self.n_data_devices()
        batch = {name: torch.zeros((rows,) + tuple(v.shape[2:]),
                                   dtype=v.dtype, device=v.device)
                 for name, v in stacked_batch.items()}
        slot = [None, None]
        device = first.device

        def work():
            try:
                torch.cuda.set_device(device)
                self._capture(ent, model, opt_state, batch)
            except Exception as e:                # raised at the join
                slot[1] = e

        t = threading.Thread(target=work, daemon=True,
                             name=f"prewarm-b{batch_size}")
        slot[0] = t
        self._prewarm[key] = slot
        t.start()
        return t

    def _join(self, key) -> None:
        slot = self._prewarm.pop(key, None)
        if slot is None:
            return
        t = time.perf_counter()
        slot[0].join()
        self.prewarm_wait_s[key] = time.perf_counter() - t
        if slot[1] is not None:
            raise slot[1]

    def join_prewarm(self) -> None:
        """Join every background capture still under way, raising the
        first failure."""
        for key in list(self._prewarm):
            self._join(key)
