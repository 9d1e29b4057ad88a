"""Model-axis sharding over a data × model mesh of processes: the
reference's ``param_specs`` carried out by hand, for the dense family.

The reference lets GSPMD place every weight by its spec and insert the
collectives.  Here each rank holds the block of each parameter that
``launch.mesh.shard_box`` gives it (``nn.Parameter``s of the shard's
shape, AdamW's ``m`` and ``v`` alike), and the forward issues the
collectives itself, as ``torch.autograd.Function``s:

- **FSDP over the data axes** (P·D ranks at one model coordinate):
  :meth:`TensorParallel.weight` all-gathers a weight's shards along its
  data-sharded dim just before use, cast to the compute dtype first (a
  bf16 gather moves half the bytes).  Its backward sums the full grad
  over the FSDP group in float32 and keeps the rank's slice.  gloo has
  no reduce-scatter, so both backends run an all-reduce and keep the
  slice.  The layers call it inside their recompute region, so no
  gathered weight outlives its layer: the backward's recompute gathers
  again.
- **Tensor-parallel over the model axis** (the M ranks of one data
  slot): q/k/v, up and gate are column-parallel (the rank's H/M query
  heads, Hkv/M KV heads, d_ff/M columns), o and down row-parallel.  The
  input of a column-parallel product goes through :meth:`to_model`
  (identity forward, all-reduce backward), so the grads reaching the
  replicated residual and norms are whole on every model rank; the
  output of a row-parallel product through :meth:`from_model`
  (all-reduce forward, identity backward).  Partial sums are all-reduced
  in float32.
- **Vocab-parallel embedding and head**: ``tok`` is split by vocab rows
  over model; a rank looks up the ids it holds, writes zeros for the
  rest, and the rows are summed over the model group.  The head (the
  untied ``lm_head``, or the tied ``tok``) splits by vocab columns and
  ``layers.cross_entropy_chunked`` reduces the row max, the sum of exps
  and the target's logit over the model group: no rank holds a (rows,
  vocab) float32 logits tensor.

Every rank issues the same collectives in the same order (the recompute
under remat too): the autograd graph is the same on every rank.  The
collectives are timed by kind (:class:`Comms`) on the host clock, the
rank's stream synced first on the card, so a time is the collective's
alone.

Only the dense family (``arch_type == "dense"``) runs on a mesh; every
family's specs are ported (``models.registry.param_specs``), their
execution is not.  :func:`check` refuses a mesh before any collective.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as MESH

KINDS = ("fsdp_gather", "grad_reduce", "model_all_reduce")


class Comms:
    """Calls, bytes and seconds of each kind of collective: the FSDP
    gathers, the grad reduction (the gathers' backward, the replicated
    grads' and the metrics' all-reduce, the norm's) and the model
    group's all-reduces (forward and backward)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls = {k: 0 for k in KINDS}
        self.bytes = {k: 0 for k in KINDS}
        self.seconds = {k: 0.0 for k in KINDS}

    def run(self, kind: str, t: torch.Tensor, fn) -> None:
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()
        t0 = time.perf_counter()
        fn()
        self.seconds[kind] += time.perf_counter() - t0
        self.calls[kind] += 1
        self.bytes[kind] += t.numel() * t.element_size()

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"calls": self.calls[k], "ms": self.seconds[k] * 1e3,
                    "MB": self.bytes[k] / 1e6} for k in KINDS}


# --------------------------------------------------------------------- #
# the collectives as autograd Functions
# --------------------------------------------------------------------- #

class _FsdpGather(torch.autograd.Function):
    """A weight's shards gathered along ``dim`` over the FSDP group, in
    ``dtype``; the backward sums the grad over the group in float32 and
    keeps this rank's slice."""

    @staticmethod
    def forward(ctx, w, tp, dim, dtype):
        ctx.tp, ctx.dim, ctx.wdtype = tp, dim, w.dtype
        return tp.gather(w.detach().to(dtype), dim)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        g = g.to(torch.float32, copy=True).contiguous()
        tp.all_reduce(g, tp.fsdp_group, "grad_reduce")
        n = g.shape[ctx.dim] // tp.n_fsdp
        keep = g.narrow(ctx.dim, tp.fsdp_index * n, n)
        return keep.to(ctx.wdtype).contiguous(), None, None, None


class _ToModel(torch.autograd.Function):
    """Identity forward, all-reduce over the model group backward (the
    input of a column-parallel product)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.sum_over_model(g), None


class _FromModel(torch.autograd.Function):
    """All-reduce over the model group forward, identity backward (the
    output of a row-parallel product; every model rank then computes the
    same function of it)."""

    @staticmethod
    def forward(ctx, x, tp):
        return tp.sum_over_model(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


# --------------------------------------------------------------------- #
# a rank's place on the mesh
# --------------------------------------------------------------------- #

class TensorParallel:
    """This process's place on a :class:`launch.mesh.Mesh`: its
    coordinates, its FSDP and model groups, each sharded parameter's
    data-sharded dim, and the collectives' :class:`Comms`."""

    def __init__(self, mesh: MESH.Mesh, rank: int):
        self.mesh, self.rank = mesh, rank
        self.n_fsdp, self.n_model = mesh.n_fsdp, mesh.n_model
        self.fsdp_index = mesh.fsdp_index(rank)
        self.model_index = mesh.model_index(rank)
        self.fsdp_group, self.model_group = mesh.groups()
        self.fsdp_dims: Dict[int, Optional[int]] = {}
        self.first_holder: Dict[int, bool] = {}
        self.comms = Comms()

    # -- raw collectives (timed) ----------------------------------------- #
    def all_reduce(self, t: torch.Tensor, group, kind: str,
                   op=dist.ReduceOp.SUM) -> None:
        self.comms.run(kind, t,
                       lambda: dist.all_reduce(t, op=op, group=group))

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.n_fsdp)]
        self.comms.run("fsdp_gather", x, lambda: dist.all_gather(
            parts, x, group=self.fsdp_group))
        return torch.cat(parts, dim)

    def sum_over_model(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the model group, in float32, cast back."""
        y = x.to(torch.float32, copy=True).contiguous()
        self.all_reduce(y, self.model_group, "model_all_reduce")
        return y.to(x.dtype)

    def max_over_model(self, x: torch.Tensor) -> torch.Tensor:
        y = x.detach().contiguous().clone()
        if self.n_model > 1:
            self.all_reduce(y, self.model_group, "model_all_reduce",
                            op=dist.ReduceOp.MAX)
        return y

    # -- the layers' entry points ---------------------------------------- #
    def weight(self, w: torch.Tensor, dtype) -> torch.Tensor:
        """The weight whole along its data-sharded dim, in ``dtype``."""
        dim = self.fsdp_dims.get(id(w))
        if dim is None or self.n_fsdp == 1:
            return w.to(dtype)
        return _FsdpGather.apply(w, self, dim, dtype)

    def head(self, model, dtype) -> torch.Tensor:
        """(d, V/M): this rank's vocab columns of the head."""
        if model.lm_head is not None:
            return self.weight(model.lm_head, dtype)
        return self.weight(model.tok, dtype).T

    def to_model(self, x):
        return x if self.n_model == 1 else _ToModel.apply(x, self)

    def from_model(self, x):
        return x if self.n_model == 1 else _FromModel.apply(x, self)

    def vocab_start(self, v_local: int) -> int:
        return self.model_index * v_local


def weight(w: torch.Tensor, dtype, tp: Optional[TensorParallel] = None):
    """``w`` in ``dtype`` for a product: gathered over the FSDP group on a
    mesh, else cast as the reference casts (``W.astype(x.dtype)``)."""
    return w.to(dtype) if tp is None else tp.weight(w, dtype)


def tp_of(model) -> Optional[TensorParallel]:
    """The model's :class:`TensorParallel`, or None (not sharded)."""
    return getattr(model, "tp", None)


# --------------------------------------------------------------------- #
# the plan: specs onto the port's parameters
# --------------------------------------------------------------------- #

def _spec_at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def leaf_specs(model, cfg: ModelConfig,
               multi_pod: bool = False) -> Dict[str, tuple]:
    """{port parameter name: its spec}: the reference's spec at the
    parameter's reference path (``weights._ref_path``), its stacked
    layer entry dropped (the port's ``ModuleList`` has no such dim)."""
    from repro_torch.models import registry as R
    from repro_torch.weights import _ref_path
    tree = R.param_specs(cfg, multi_pod)
    out = {}
    for name, _ in model.named_parameters():
        path, layer = _ref_path(name, cfg)
        spec = tuple(_spec_at(tree, path))
        out[name] = spec[1:] if layer is not None else spec
    return out


def _fsdp_dim(spec) -> Optional[int]:
    for i, e in enumerate(spec):
        axes = MESH._spec_axes(e)
        if "data" in axes or "pod" in axes:
            return i
    return None


def check_model(cfg: ModelConfig, mesh: MESH.Mesh) -> Dict[str, tuple]:
    """Refuse a model the port cannot cut to ``mesh`` (no process group
    needed): a family other than dense, a head count or a dim its mesh
    axis does not divide.  Returns the leaf specs of a meta-device model
    (no memory)."""
    if cfg.arch_type != "dense":
        raise ValueError(
            f"arch_type {cfg.arch_type!r} does not run on a mesh yet: the "
            f"port shards the dense family only (its specs are ported for "
            f"every family; ROADMAP Queue 1 lists the model axis of the "
            f"others)")
    M = mesh.n_model
    for n, what, leaf in ((cfg.n_heads, "query heads", "w_q"),
                          (cfg.n_kv_heads, "KV heads", "w_k")):
        if n % M:
            raise ValueError(
                f"layers/attn/{leaf}: dim 1 holds {n} {what}, which mesh "
                f"axis 'model' of {M} does not divide")
    from repro_torch.models import registry as R
    model = R.family(cfg).Model(cfg, dtype=torch.float32, device="meta")
    specs = leaf_specs(model, cfg, "pod" in mesh.shape)
    for name, p in model.named_parameters():
        MESH.shard_box(tuple(p.shape), specs[name], mesh, 0, name=name)
    return specs


def check(cfg: ModelConfig, mesh: MESH.Mesh) -> Dict[str, tuple]:
    """:func:`check_model`, and a mesh whose size is not the process
    group's; raised before any collective."""
    specs = check_model(cfg, mesh)
    if mesh.size != MESH.world_size():
        raise ValueError(
            f"mesh {mesh.shape} has {mesh.size} slots but the process "
            f"group has {MESH.world_size()} processes")
    return specs


def _first_holder(spec, mesh: MESH.Mesh, rank: int) -> bool:
    """Whether ``rank`` is the first of the ranks holding its block: at
    coordinate 0 along every axis the spec does not name."""
    named = {a for e in spec for a in MESH._spec_axes(e)}
    c = mesh.coords(rank)
    return all(c[a] == 0 for a in mesh.axis_names if a not in named)


def shard(model, cfg: ModelConfig, mesh: MESH.Mesh,
          rank: Optional[int] = None):
    """Cut ``model``'s parameters to ``rank``'s blocks (in place: each
    ``nn.Parameter`` is replaced by one of the block's shape) and attach
    its :class:`TensorParallel` as ``model.tp`` (this makes the mesh's
    groups: every rank calls it).  ``rank`` defaults to the process
    group's."""
    specs = check(cfg, mesh)
    rank = MESH.rank() if rank is None else rank
    boxes, shapes = {}, {}
    for name, p in list(model.named_parameters()):
        shapes[name] = tuple(p.shape)
        box = MESH.shard_box(tuple(p.shape), specs[name], mesh, rank,
                             name=name)
        local = p.detach()[tuple(slice(a, b) for a, b in box)].clone()
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        setattr(mod, attr, nn.Parameter(local,
                                        requires_grad=p.requires_grad))
        boxes[name] = box
    tp = TensorParallel(mesh, rank)
    for name, p in model.named_parameters():
        tp.fsdp_dims[id(p)] = _fsdp_dim(specs[name])
        tp.first_holder[id(p)] = _first_holder(specs[name], mesh, rank)
    model.tp = tp
    model.specs = specs
    model.boxes = boxes
    model.full_shapes = shapes
    return model


# --------------------------------------------------------------------- #
# the step's reductions
# --------------------------------------------------------------------- #

def reduce_grads(tp: TensorParallel, params: List[torch.Tensor],
                 grads: List[torch.Tensor],
                 metrics: Dict[str, torch.Tensor]
                 ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """This rank's grads and metrics averaged over the data slots: the
    data-sharded grads were summed by the gathers' backward; the rest
    (the replicated norms) and the metrics are summed by one float32
    all-reduce over the FSDP group; all are divided by P·D."""
    grads = list(grads)
    if tp.n_fsdp == 1:
        return grads, metrics
    rep = [i for i, p in enumerate(params)
           if tp.fsdp_dims.get(id(p)) is None]
    names = sorted(metrics)
    flat = torch.cat([grads[i].reshape(-1).float() for i in rep]
                     + [torch.stack([metrics[k].float() for k in names])])
    tp.all_reduce(flat, tp.fsdp_group, "grad_reduce")
    off = 0
    for i in rep:
        n = grads[i].numel()
        grads[i] = flat[off:off + n].view(grads[i].shape).to(
            grads[i].dtype)
        off += n
    inv = 1.0 / tp.n_fsdp
    grads = [g.mul_(inv) for g in grads]
    metrics = {k: flat[off + j] * inv for j, k in enumerate(names)}
    return grads, metrics


def global_norm(tp: TensorParallel, params: List[torch.Tensor],
                grads: List[torch.Tensor]) -> torch.Tensor:
    """√Σ‖g‖² over the whole model, each distinct block counted once (by
    its first holder) and summed over every rank: one process's
    ``optimizers.global_norm``."""
    parts = [g.float().square().sum() for p, g in zip(params, grads)
             if tp.first_holder[id(p)]]
    sq = (torch.stack(parts).sum() if parts
          else torch.zeros((), device=grads[0].device)).reshape(1)
    tp.all_reduce(sq, None, "grad_reduce")
    return sq[0].sqrt()


# --------------------------------------------------------------------- #
# whole tensors back
# --------------------------------------------------------------------- #

def gather_full(local: torch.Tensor, shape, boxes) -> torch.Tensor:
    """The whole tensor of ``shape`` from every rank's block of it,
    ``boxes[r]`` rank r's (an all-gather over the process group;
    collective)."""
    local = local.detach().contiguous()
    parts = [torch.empty_like(local) for _ in boxes]
    dist.all_gather(parts, local)
    out = local.new_empty(tuple(shape))
    for box, part in zip(boxes, parts):
        out[tuple(slice(a, b) for a, b in box)] = part
    return out
