"""Model-axis sharding over a data × model mesh of processes: the
reference's ``param_specs`` carried out by hand, for every family in
training.

The reference lets GSPMD place every weight by its spec and insert the
collectives.  Here each rank holds the block of each parameter that
``launch.mesh.shard_box`` gives it (``nn.Parameter``s of the shard's
shape, AdamW's ``m`` and ``v`` alike), and the forward issues the
collectives itself, as ``torch.autograd.Function``s:

- **FSDP over the data axes** (P·D ranks at one model coordinate):
  :meth:`TensorParallel.weight` all-gathers a weight's shards along its
  data-sharded dim just before use, cast to the compute dtype first (a
  bf16 gather moves half the bytes).  Its backward sums the full grad
  over the FSDP group in float32 and keeps the rank's slice, by an
  all-reduce and a slice on both backends.  (gloo takes
  ``reduce_scatter_tensor`` too, on CPU tensors and, with torch
  2.11.0+cu128, on CUDA tensors, as NCCL does; it takes
  ``all_to_all_single`` but not the list ``all_to_all``.)  The layers
  call it inside their recompute region, so no gathered weight outlives
  its layer: the backward's recompute gathers again.  A model cut for
  serving with ``serve_resident`` holds no FSDP dim: its weights are
  whole over data and split over model only, and nothing is gathered.
- **Tensor-parallel over the model axis** (the M ranks of one data
  slot): q/k/v, up and gate are column-parallel (the rank's H/M query
  heads, Hkv/M KV heads, d_ff/M columns), o and down row-parallel.  The
  input of a column-parallel product goes through :meth:`to_model`
  (identity forward, all-reduce backward), so the grads reaching the
  replicated residual and norms are whole on every model rank (where the
  residual is whole; the cut residual is below); the
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

- **Whole grads on every model rank.**  Wherever every model rank
  computes a tensor whole and then each rank computes only its own part
  from it, the tensor passes :meth:`to_model` where the whole
  computation ends (the block input before a column-parallel product;
  the MoE's token rows and gates before the rank's experts; Mamba-2's
  B, C, dt, A and D before the rank's heads; the encoder output before
  the cross-attention's K/V).  A weight whose stored block is not the
  block the rank computes with (Mamba-2's conv over (x, B, C), whose
  model cut is not its heads' cut) and an activation a rank needs whole
  (the RG-LRU's y before its (W, W) gates, K/V of KV heads the model
  axis does not divide) are gathered over the model group by
  :meth:`model_gather`, whose backward sums over the group in float32
  and keeps the rank's slice.  So every grad that reaches a weight
  replicated over ``model`` is whole, none is summed twice, and
  :func:`reduce_grads` needs no family's case, with one exception: the
  norm scales of the cut residual below.
- **The sequence-parallel residual** (the reference's ``residual_spec``,
  Megatron-SP; its default ``seq_shard=True``): where :func:`seq_cut`
  holds, the residual stream between blocks is cut along the sequence
  over the model group, each rank holding S/M rows.  A block enters by
  :meth:`TensorParallel.seq_gather`, an all-gather along S of the normed
  rows in the compute dtype, whose backward sums the grad over the group
  in float32 and keeps the rank's rows (:class:`_ModelGather` along S);
  a block whose every consumer of the gathered rows already gives whole
  grads (the MoE's replicated router and its ``to_model`` rows, Mamba-2's
  B, C and dt and its ``to_model`` input) enters with ``whole_grad``,
  whose backward only keeps the rank's rows.  A block leaves by
  :meth:`TensorParallel.seq_scatter`, a float32 reduce-scatter along S of
  the row-parallel partial sums (its backward all-gathers the grad), in
  place of the all-reduce.  The vocab-parallel embedding leaves by the
  reduce-scatter too, and the final hiddens are gathered before the head
  (a sum-backward gather, so the head's ``to_model`` does not run as
  well).  The norm scales applied to the cut rows see only the rank's
  tokens, so their grads are partial over ``model``: the forward records
  them in :attr:`TensorParallel.model_partial` and :func:`reduce_grads`
  sums them over the model group, inside its one flat buffer.  Where 16
  divides S but M does not, the reference's GSPMD pads the cut; the port
  keeps the residual whole there: the layout differs, the numbers do
  not.
- **KV heads the model axis does not divide** (MQA, and GQA with Hkv mod
  M ≠ 0): ``w_k`` and ``w_v`` keep the spec's column blocks; k and v are
  gathered over the model group after the product and each rank attends
  its H/M query heads to the KV heads they map to (:func:`kv_block`).
- **Query heads the model axis does not divide** (24 on 16): the stored
  blocks stay the reference's (1.5 heads of ``w_q`` a rank); q's columns
  and the attention's output are gathered over the model group, and each
  rank attends a block of ceil(H/M) whole heads (:func:`head_block`).
- **An MoE routing group that spans several data slots** (a decode
  step's 128 tokens over 16 slots): the slots that hold it gather its
  rows (:meth:`TensorParallel.slot_gather`), route it whole and keep
  their own.

Sharded serving (every family's prefill and decode on a mesh) adds the
serving collectives: :meth:`TensorParallel.model_all_to_all` (the re-cut
of a prompt's K/V or Mamba-2 state to its cache's box, and of the decode
attention's output to the rank's heads), :meth:`TensorParallel.greedy`
(the greedy pick over the ranks' vocab blocks), and :func:`cache_layout`,
each decode cache leaf's box of the reference's ``input_shardings`` (the
layer-stacked caches, and the hybrid's per-layer list by leaf name).

Every rank issues the same collectives in the same order (the recompute
under remat too): the autograd graph is the same on every rank.  The
collectives are timed by kind (:class:`Comms`) on the host clock, the
rank's stream synced first on the card, so a time is the collective's
alone.

:func:`check` refuses a mesh before any collective: experts, SSD
heads, the RG-LRU width or any dim its mesh axis does not divide;
:func:`check_batch` a batch its data slots do not divide.
"""
from __future__ import annotations

import time
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as MESH

KINDS = ("fsdp_gather", "grad_reduce", "model_all_reduce",
         "model_all_gather", "model_all_to_all", "model_reduce_scatter",
         "slot_gather")

# the reference's residual_spec cuts the sequence where 16 divides it
SEQ_MULTIPLE = 16


def seq_cut(S: int, n_model: int) -> bool:
    """Whether a residual of S rows is cut along the sequence over a model
    axis of ``n_model``: the reference's rule (``S % 16 == 0``, its
    ``layers.residual_spec``) where the axis also divides S.  Where 16
    divides S but the axis does not (3, say), the reference's GSPMD pads
    the cut; the port keeps the residual whole there, which changes the
    layout and not the numbers.  A model axis of 1 cuts nothing."""
    return n_model > 1 and S % SEQ_MULTIPLE == 0 and S % n_model == 0


def seq_of(tp, S: int, seq_shard: bool = True) -> bool:
    """Whether a forward of S rows on ``tp`` (None: one process) runs the
    cut residual: ``seq_shard`` asks for it and :func:`seq_cut` holds."""
    return tp is not None and seq_shard and seq_cut(S, tp.n_model)


class Comms:
    """Calls, bytes and seconds of each kind of collective: the FSDP
    gathers, the grad reduction (the gathers' backward, the slot
    gathers' too, the replicated grads' and the metrics' all-reduce, the
    norm's), the model group's all-reduces (forward and backward, the
    model gathers' backward included), its all-gathers, its all-to-alls
    and its reduce-scatters (the cut residual's), and the MoE's gathers
    of a routing group's tokens over the data slots that hold it
    (:meth:`TensorParallel.slot_gather`).  Bytes are those of the tensor
    handed to the collective: a rank's block for an all-gather, the
    whole float32 partial sums for a reduce-scatter, as for an
    all-reduce."""

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


class _ModelGather(torch.autograd.Function):
    """The model group's blocks of x along ``dim`` gathered whole; the
    backward sums the grad over the group in float32 and keeps this
    rank's slice.  With ``whole_grad`` the grad reaching the gathered
    tensor is already whole on every rank (each of its consumers sums
    its own over the group), and the backward only keeps the slice."""

    @staticmethod
    def forward(ctx, x, tp, dim, whole_grad=False):
        ctx.tp, ctx.dim, ctx.whole_grad = tp, dim, whole_grad
        return tp.gather_model(x.detach(), dim)

    @staticmethod
    def backward(ctx, g):
        tp, dim = ctx.tp, ctx.dim
        n = g.shape[dim] // tp.n_model
        if ctx.whole_grad:
            keep = g.narrow(dim, tp.model_index * n, n)
            return keep.contiguous(), None, None, None
        g32 = g.to(torch.float32, copy=True).contiguous()
        tp.all_reduce(g32, tp.model_group, "model_all_reduce")
        keep = g32.narrow(dim, tp.model_index * n, n)
        return keep.to(g.dtype).contiguous(), None, None, None


class _SlotGather(torch.autograd.Function):
    """x (b, ...), this rank's rows, gathered along dim 0 over the
    ``span`` consecutive data slots of its slot group, in slot order; the
    backward sums the grad over the group in float32 and keeps this
    rank's rows."""

    @staticmethod
    def forward(ctx, x, tp, span):
        ctx.tp, ctx.span = tp, span
        return tp.gather_slots(x.detach(), span)

    @staticmethod
    def backward(ctx, g):
        tp, span = ctx.tp, ctx.span
        g32 = g.to(torch.float32, copy=True).contiguous()
        tp.all_reduce(g32, tp.mesh.slot_group(span), "grad_reduce")
        n = g.shape[0] // span
        keep = g32.narrow(0, tp.fsdp_index % span * n, n)
        return keep.to(g.dtype).contiguous(), None, None


class _SeqScatter(torch.autograd.Function):
    """The model group's partial sums x (B, S, ...) summed in float32 and
    cut along S, this rank's S/M rows kept (one reduce-scatter), cast
    back; the backward all-gathers the grad along S."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return tp.reduce_scatter(x.detach())

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.gather_model(g, 1), None


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
        self.fsdp_dims: Dict[int, Optional[int]] = {}
        self.first_holder: Dict[int, bool] = {}
        self.comms = Comms()
        # ids of the parameters whose grads the forward left partial over
        # the model group (the norm scales of the cut residual)
        self.model_partial: set = set()

    # the groups are made at the first collective (``Mesh.groups``, which
    # every rank reaches at the same point of the same program)
    @property
    def fsdp_group(self):
        return self.mesh.groups()[0]

    @property
    def model_group(self):
        return self.mesh.groups()[1]

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

    def gather_model(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.n_model)]
        self.comms.run("model_all_gather", x, lambda: dist.all_gather(
            parts, x, group=self.model_group))
        return torch.cat(parts, dim)

    def gather_slots(self, x: torch.Tensor, span: int) -> torch.Tensor:
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(span)]
        self.comms.run("slot_gather", x, lambda: dist.all_gather(
            parts, x, group=self.mesh.slot_group(span)))
        return torch.cat(parts, 0)

    def slot_gather(self, x, span: int):
        """x (b, ...), the rows of this rank's data slot -> the rows of
        the ``span`` consecutive slots of its block (``Mesh.
        slot_group``), in slot order (one all-gather); the backward sums
        the grad over them in float32 and keeps the rank's rows.  The
        MoE's routing group that spans several slots."""
        return _SlotGather.apply(x, self, span)

    def slot_rows(self, y, span: int):
        """The rows of this rank's slot from y (span·b, ...), the rows of
        its slot block (``slot_gather``'s)."""
        n = y.shape[0] // span
        return y.narrow(0, self.fsdp_index % span * n, n)

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, S, ...): the model group's partial sums, summed in float32
        and cut along S; this rank's S/M rows, cast back (one
        reduce-scatter over the model group)."""
        M, (B, S) = self.n_model, x.shape[:2]
        parts = x.to(torch.float32).reshape(B, M, S // M, *x.shape[2:])
        inp = parts.transpose(0, 1).reshape(M * B, S // M, *x.shape[2:])
        out = inp.new_empty(B, S // M, *x.shape[2:])
        self.comms.run("model_reduce_scatter", inp,
                       lambda: dist.reduce_scatter_tensor(
                           out, inp, group=self.model_group))
        return out.to(x.dtype)

    def model_all_to_all(self, x: torch.Tensor, split_dim: int,
                         cat_dim: int) -> torch.Tensor:
        """x cut in M equal parts along ``split_dim``, part j sent to model
        rank j; the parts received, in rank order, joined along
        ``cat_dim`` (one ``all_to_all_single`` over the model group)."""
        if self.n_model == 1:
            return x
        inp = torch.stack(x.chunk(self.n_model, split_dim)).contiguous()
        out = torch.empty_like(inp)
        self.comms.run("model_all_to_all", inp,
                       lambda: dist.all_to_all_single(
                           out, inp, group=self.model_group))
        return torch.cat(out.unbind(0), cat_dim)

    def greedy(self, logits: torch.Tensor) -> torch.Tensor:
        """The greedy pick over vocab blocks: logits (B, S, V/M), this
        rank's columns -> (B, S) int64, the id of the largest logit over
        the whole vocab, the first such id on a tie (the reference's
        ``argmax``).  Each rank's (max, first index) go to every rank of
        the model group (one all-gather); the ranks' blocks are in vocab
        order, so the first rank holding the max holds its first id."""
        v, i = logits.float().max(dim=-1)
        i = i + self.vocab_start(logits.shape[-1])
        if self.n_model == 1:
            return i
        pair = torch.stack([v.double(), i.double()], dim=-1)
        parts = self.gather_model(pair[None], 0)          # (M, B, S, 2)
        best = parts[..., 0].argmax(dim=0, keepdim=True)  # first max rank
        return parts[..., 1].gather(0, best)[0].long()

    def sum_over_model(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the model group, in float32, cast back."""
        y = x.to(torch.float32, copy=True).contiguous()
        self.all_reduce(y, self.model_group, "model_all_reduce")
        return y.to(x.dtype)

    def mean_over_data(self, x: torch.Tensor) -> torch.Tensor:
        """x's mean over the data slots (no grad), in float32."""
        y = x.detach().to(torch.float32, copy=True).contiguous()
        self.all_reduce(y, self.fsdp_group, "grad_reduce")
        return y / self.n_fsdp

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

    def model_gather(self, x, dim: int = -1):
        """x's blocks over the model group, whole along ``dim``."""
        if self.n_model == 1:
            return x
        return _ModelGather.apply(x, self, dim % x.dim())

    # -- the cut residual (module doc) ------------------------------------ #
    def seq_gather(self, x, whole_grad: bool = False):
        """x (B, S/M, ...), this rank's rows of the cut residual -> (B, S,
        ...) every rank's, in x's dtype.  The backward sums the grad over
        the model group and keeps the rank's rows; with ``whole_grad``
        (every consumer of the result already gives whole grads) it only
        keeps them."""
        return _ModelGather.apply(x, self, 1, whole_grad)

    def seq_scatter(self, x):
        """x (B, S, ...): the partial sums of a row-parallel product ->
        this rank's S/M rows of their sum (a float32 reduce-scatter; the
        backward all-gathers the grad)."""
        return _SeqScatter.apply(x, self)

    def enter(self, x, seq: bool):
        """A block's input before its column-parallel products:
        :meth:`seq_gather` of the cut residual's rows (``seq``), else
        :meth:`to_model` of the whole residual."""
        return self.seq_gather(x) if seq else self.to_model(x)

    def leave(self, x, seq: bool):
        """A block's row-parallel output: :meth:`seq_scatter` into the cut
        residual (``seq``), else :meth:`from_model`."""
        return self.seq_scatter(x) if seq else self.from_model(x)

    def last_row(self, x, seq: bool):
        """x[:, -1:] of the residual x (B, S', d).  With ``seq`` x is the
        rank's rows of the cut residual, whose last row lies on the last
        model rank: every rank's last row is gathered over the model group
        (one all-gather) and the last rank's kept."""
        last = x[:, -1:].contiguous()
        if not seq:
            return last
        return self.gather_model(last, 1)[:, -1:].contiguous()

    def note_partial(self, *params) -> None:
        """Record parameters whose grads this forward leaves partial over
        the model group (applied to the cut residual's rows only); while
        grads are being taken, for :func:`reduce_grads`."""
        if torch.is_grad_enabled():
            self.model_partial.update(id(p) for p in params)

    def model_slice(self, n: int) -> slice:
        """This rank's block of ``n`` · M entries cut in M."""
        return slice(self.model_index * n, (self.model_index + 1) * n)

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


def leaf_specs(model, cfg: ModelConfig, multi_pod: bool = False,
               serve_resident: bool = False) -> Dict[str, tuple]:
    """{port parameter name: its spec}: the reference's spec at the
    parameter's reference path (``weights._ref_path``), its stacked
    layer entry dropped (the port's ``ModuleList`` has no such dim);
    ``serve_resident`` drops the FSDP axes (``registry.param_specs``)."""
    from repro_torch.models import registry as R
    from repro_torch.weights import _ref_path
    tree = R.param_specs(cfg, multi_pod, serve_resident=serve_resident)
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


def kv_block(n_heads: int, n_kv_heads: int, n_model: int,
             index: int) -> Tuple[int, int]:
    """(first, count) of the KV heads that model rank ``index``'s H/M query
    heads attend to, when the model axis does not divide the KV heads.
    Raises unless the rank's query heads take whole GQA groups, or all lie
    in one (then each rank's heads keep a GQA ratio of their own)."""
    hl, group = n_heads // n_model, n_heads // n_kv_heads
    first = index * hl // group
    count = (index * hl + hl - 1) // group + 1 - first
    if hl % count or any((index * hl + j) // group - first != j // (
            hl // count) for j in range(hl)):
        raise ValueError(
            f"{n_heads} query heads over {n_kv_heads} KV heads: model rank "
            f"{index} of {n_model} holds query heads that split a GQA "
            f"group unevenly")
    return first, count


def uneven_heads(n_heads: int, tp) -> bool:
    """Whether a mesh's model axis does not divide the query heads (24
    heads on 16 ranks, say).  The stored blocks are the reference's all
    the same: a rank holds H·hd/M columns of ``w_q`` (1.5 heads at 24 on
    16) and H·hd/M rows of ``w_o``; the attention regroups them
    (:func:`head_block`, ``models.attention.rank_heads`` and
    ``rank_cols``)."""
    return tp is not None and n_heads % tp.n_model != 0


def head_block(n_heads: int, n_model: int, index: int) -> Tuple[int, int]:
    """(first, count) of the whole query heads model rank ``index``
    attends to: its H/M where the model axis divides H, else a block of
    ceil(H/M), the last ranks fewer or none (24 heads on 16 ranks: 2
    each on ranks 0-11, none on 12-15).  Rank 0 holds the largest
    block."""
    per = -(-n_heads // n_model)
    first = min(index * per, n_heads)
    return first, min(per, n_heads - first)


def _divides(n: int, M: int, what: str, leaf: str, dim: int) -> None:
    if n % M:
        raise ValueError(
            f"{leaf}: dim {dim} holds {n} {what}, which mesh axis 'model' "
            f"of {M} does not divide")


def check_model(cfg: ModelConfig, mesh: MESH.Mesh,
                serve_resident: bool = False) -> Dict[str, tuple]:
    """Refuse a model the port cannot cut to ``mesh`` (no process group
    needed): experts, SSD heads or the RG-LRU width the model axis does
    not divide; query heads the axis divides that split a GQA group
    unevenly where the KV heads do not divide; any dim its mesh axis
    does not divide (which the reference could not lower either).  Query
    heads the axis does not divide are taken: the stored blocks are the
    reference's, and the attention regroups them (:func:`head_block`).
    Returns the leaf specs of a meta-device model (no memory), the
    serving specs with ``serve_resident``."""
    M = mesh.n_model
    if cfg.arch_type == "ssm":
        from repro_torch.models.mamba2 import _dims
        _divides(_dims(cfg)[2], M, "SSD heads", "layers/mixer/A_log", 0)
    elif cfg.n_kv_heads % M and cfg.n_heads % M == 0:
        for r in range(M):
            kv_block(cfg.n_heads, cfg.n_kv_heads, M, r)
    if cfg.arch_type == "moe":
        _divides(cfg.moe.num_experts, M, "experts", "layers/moe/w_gate", 0)
    if cfg.arch_type == "hybrid":
        from repro_torch.models.rglru import _hybrid
        _divides(_hybrid(cfg)[1], M, "RG-LRU channels",
                 "temporal/w_gate", 1)
    from repro_torch.models import registry as R
    model = R.family(cfg).Model(cfg, dtype=torch.float32, device="meta")
    specs = leaf_specs(model, cfg, "pod" in mesh.shape, serve_resident)
    for name, p in model.named_parameters():
        MESH.shard_box(tuple(p.shape), specs[name], mesh, 0, name=name)
    return specs


def check_batch(cfg: ModelConfig, mesh: MESH.Mesh, batch_size: int,
                seq_len: int) -> None:
    """Refuse a (micro-)batch of ``batch_size`` rows of ``seq_len``
    tokens across the mesh's data slots that the port cannot split there
    (no process group needed): rows the slots do not divide, and an MoE
    whose tokens do not split into whole routing groups of min(2048,
    B·S) (the reference refuses those too; a group may span several
    slots, ``moe.slot_span``)."""
    if batch_size % mesh.n_fsdp:
        raise ValueError(f"{batch_size} rows do not split over "
                         f"{mesh.n_fsdp} data slots")
    from repro_torch.models import moe
    moe.check_tokens(cfg, batch_size // mesh.n_fsdp * seq_len,
                     n_slots=mesh.n_fsdp)


def check(cfg: ModelConfig, mesh: MESH.Mesh,
          serve_resident: bool = False) -> Dict[str, tuple]:
    """:func:`check_model`, and a mesh whose size is not the process
    group's; raised before any collective."""
    specs = check_model(cfg, mesh, serve_resident)
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


def _attach(model, specs, boxes, shapes, mesh: MESH.Mesh, rank: int,
            serve_resident: bool):
    """Attach the :class:`TensorParallel` of ``rank`` and the cut's
    record (specs, boxes, whole shapes) to a model whose parameters are
    already the rank's blocks."""
    tp = TensorParallel(mesh, rank)
    for name, p in model.named_parameters():
        tp.fsdp_dims[id(p)] = _fsdp_dim(specs[name])
        tp.first_holder[id(p)] = _first_holder(specs[name], mesh, rank)
    model.tp = tp
    model.specs = specs
    model.boxes = boxes
    model.full_shapes = shapes
    model.serve_resident = serve_resident
    return model


def _set_param(model, name: str, value: nn.Parameter) -> None:
    mod_name, _, attr = name.rpartition(".")
    mod = model.get_submodule(mod_name) if mod_name else model
    setattr(mod, attr, value)


def shard(model, cfg: ModelConfig, mesh: MESH.Mesh,
          rank: Optional[int] = None, *, serve_resident: bool = False):
    """Cut ``model``'s parameters to ``rank``'s blocks (in place: each
    ``nn.Parameter`` is replaced by one of the block's shape) and attach
    its :class:`TensorParallel` as ``model.tp``.  ``rank`` defaults to
    the process group's.  ``serve_resident`` cuts by the serving specs
    (no FSDP dim: the weights whole over data, split over model)."""
    specs = check(cfg, mesh, serve_resident)
    rank = MESH.rank() if rank is None else rank
    boxes, shapes = {}, {}
    for name, p in list(model.named_parameters()):
        shapes[name] = tuple(p.shape)
        box = MESH.shard_box(tuple(p.shape), specs[name], mesh, rank,
                             name=name)
        local = p.detach()[tuple(slice(a, b) for a, b in box)].clone()
        _set_param(model, name, nn.Parameter(
            local, requires_grad=p.requires_grad))
        boxes[name] = box
    return _attach(model, specs, boxes, shapes, mesh, rank, serve_resident)


def init_blocks(model, cfg: ModelConfig, mesh: MESH.Mesh, rank: int,
                generator: torch.Generator, device, *,
                serve_resident: bool = False):
    """The rank-only init: ``model`` built on the meta device (whole
    shapes, no memory) gets, for each parameter, an empty block of the
    rank's box on ``device``, marked with its whole shape and box
    (``layers.trunc_normal_`` and ``layers.copy_whole_`` read the mark:
    each draws the whole parameter from ``generator``, in the order
    ``init_weights`` draws, and keeps the block).  One whole parameter
    lives at a time, so the peak is the largest parameter, and the blocks
    are bitwise those of ``init_weights`` followed by :func:`shard`."""
    specs = check(cfg, mesh, serve_resident)
    boxes, shapes = {}, {}
    for name, p in list(model.named_parameters()):
        shapes[name] = tuple(p.shape)
        box = boxes[name] = MESH.shard_box(shapes[name], specs[name], mesh,
                                           rank, name=name)
        local = nn.Parameter(torch.empty(
            tuple(b - a for a, b in box), dtype=p.dtype, device=device),
            requires_grad=False)
        local.whole = (shapes[name], box)
        _set_param(model, name, local)
    model.init_weights(generator)
    for _, p in model.named_parameters():
        del p.whole
    return _attach(model, specs, boxes, shapes, mesh, rank, serve_resident)


# --------------------------------------------------------------------- #
# the decode caches' boxes
# --------------------------------------------------------------------- #

@dataclasses.dataclass
class CacheLayout:
    """A rank's blocks of a decode cache cut by the reference's
    ``input_shardings``: each leaf's whole shape, spec and box (by leaf
    name: "k", "v", "pos"; "h", "conv"; the enc-dec's "ek", "ev"),
    ``rows`` the rank's rows of the batch (its block of the token's
    spec) and ``batch`` the whole batch.  ``stacked`` says whether the
    leaves carry a leading layer dim; the hybrid's per-layer caches do
    not, and a name stands for every layer that holds it (all of one
    shape and one spec)."""
    shapes: Dict[str, tuple]
    specs: Dict[str, tuple]
    boxes: Dict[str, MESH.Block]
    rows: Tuple[int, int]
    batch: int
    stacked: bool = True

    def model_cut(self, name: str) -> Optional[Tuple[int, int, int]]:
        """(dim, start, stop) of leaf ``name``'s cut over 'model', or
        None where the leaf is whole over 'model'."""
        for dim, e in enumerate(self.specs[name]):
            if "model" in MESH._spec_axes(e):
                return (dim, *self.boxes[name][dim])
        return None

    def layer_cut(self, name: str) -> Optional[Tuple[int, int, int]]:
        """:meth:`model_cut` in one layer's dims (the layer dim dropped
        from a stacked leaf)."""
        cut = self.model_cut(name)
        if cut is None or not self.stacked:
            return cut
        return cut[0] - 1, cut[1], cut[2]

    def block(self, name: str, t: torch.Tensor,
              layer_dim: bool = True) -> torch.Tensor:
        """The rank's block of leaf ``name`` from ``t``, the leaf whole
        but for its layer dim (absent from ``t`` when ``layer_dim`` is
        False; a leaf that is not stacked has none)."""
        box = self.boxes[name][1 if self.stacked and not layer_dim else 0:]
        return t[tuple(slice(a, b) for a, b in box)]


def _named_leaves(data):
    """(name, leaf) of a decode cache's data: a dict of leaves, or the
    hybrid's list of per-layer dicts, in order."""
    for layer in (data if isinstance(data, list) else [data]):
        yield from layer.items()


def cache_layout(cfg: ModelConfig, tp: TensorParallel, batch: int,
                 max_len: int, cache_seq_shard: bool = False) -> CacheLayout:
    """The rank's boxes of the decode cache of ``batch`` rows and
    ``max_len`` positions (a full cache, a ring of min(window, max_len)
    slots, Mamba-2's state, the hybrid's per-layer states and rings, the
    enc-dec's self- and cross-attention caches): the reference's
    ``input_shardings`` of a decode shape, ``cache_seq_shard`` choosing
    the sequence cut over the head_dim cut, read through
    ``launch.mesh.shard_box``."""
    from repro_torch.configs.base import InputShape
    from repro_torch.models import registry as R
    multi_pod = "pod" in tp.mesh.shape
    shape = InputShape("serve", max_len, batch, "decode")
    specs = R.input_shardings(cfg, shape, multi_pod,
                              cache_seq_shard=cache_seq_shard)
    struct = R.decode_struct(cfg, batch, max_len)
    shapes, cspecs = {}, {}
    for (n, t), (_, sp) in zip(_named_leaves(struct["cache"].data),
                               _named_leaves(specs["cache"].data)):
        one = (tuple(t.shape), tuple(sp))
        if (shapes.setdefault(n, one[0]), cspecs.setdefault(n, one[1])) \
                != one:
            raise ValueError(f"cache leaf {n!r}: {one} in one layer, "
                             f"{(shapes[n], cspecs[n])} in another")
    boxes = {n: MESH.shard_box(shapes[n], cspecs[n], tp.mesh, tp.rank,
                               name=f"cache/{n}") for n in shapes}
    rows = MESH.shard_box((batch, 1), specs["token"], tp.mesh, tp.rank,
                          name="token")[0]
    return CacheLayout(shapes, cspecs, boxes, rows, batch,
                       stacked=not isinstance(struct["cache"].data, list))


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
    all-reduce over the FSDP group; all are divided by P·D.

    The grads the forward left partial over the model group
    (``tp.model_partial``: the norm scales of the cut residual) are
    summed over it in the same buffer: where both axes are > 1 the buffer
    is all-reduced over the whole group, every other entry (whole on each
    model rank) put in by model rank 0 only, zeros elsewhere; with one
    data slot one all-reduce over the model group sums them alone.  The
    record is cleared."""
    grads = list(grads)
    part = {i for i, p in enumerate(params) if id(p) in tp.model_partial}
    tp.model_partial.clear()
    if tp.n_fsdp == 1:
        if part:
            idx = sorted(part)
            flat = torch.cat([grads[i].reshape(-1).float() for i in idx])
            tp.all_reduce(flat, tp.model_group, "grad_reduce")
            _unflatten(flat, grads, idx)
        return grads, metrics
    rep = [i for i, p in enumerate(params)
           if tp.fsdp_dims.get(id(p)) is None]
    if part - set(rep):
        raise ValueError("a data-sharded parameter's grad is partial over "
                         "the model group")
    names = sorted(metrics)
    keep = float(tp.model_index == 0) if part else 1.0
    flat = torch.cat([grads[i].reshape(-1).float()
                      * (1.0 if i in part else keep) for i in rep]
                     + [torch.stack([metrics[k].float() for k in names])
                        * keep])
    tp.all_reduce(flat, None if part else tp.fsdp_group, "grad_reduce")
    off = _unflatten(flat, grads, rep)
    inv = 1.0 / tp.n_fsdp
    grads = [g.mul_(inv) for g in grads]
    metrics = {k: flat[off + j] * inv for j, k in enumerate(names)}
    return grads, metrics


def _unflatten(flat: torch.Tensor, grads: List[torch.Tensor],
               idx: List[int]) -> int:
    """grads[i] for i in ``idx`` <- their runs of ``flat`` in order, in
    each grad's dtype; returns the offset past them."""
    off = 0
    for i in idx:
        n = grads[i].numel()
        grads[i] = flat[off:off + n].view(grads[i].shape).to(grads[i].dtype)
        off += n
    return off


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
