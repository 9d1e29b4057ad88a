"""Workload wiring (``repro.launch.steps`` in PyTorch): the train,
prefill or decode step of an (arch × shape) with its argument stand-ins
and its in/out spec trees, allocating nothing.

The reference returns a jit-able ``fn`` over global arrays, and GSPMD
places each by its spec.  The port's ``fn`` runs on one rank's real
tensors: a model cut to a mesh (``parallel.shard`` or
``registry.init_model(mesh=)``), the rank's blocks of the inputs by
``in_specs`` (``launch.mesh.shard_box``), and it returns the rank's
blocks by ``out_specs``.  The spec trees are the reference's, leaf for
leaf.  ``args`` are meta-device stand-ins (``registry._meta``): the
model built on the meta device, AdamW's state of it, the inputs of
``registry.input_specs``.

- ``train``: the engine's grad step (``train.engine.make_grad_step``,
  a ``MeshStep`` for a model on a mesh), returning (model, opt_state,
  loss).
- ``prefill``: the rank's vocab block of the last position's logits
  (the reference's ``P(b, None, 'model')``); the cache it builds is
  dropped, as the reference's is.
- ``decode``: (the logits block, the cache), the cache the rank's
  blocks (from ``registry.prefill`` of the same model), written in
  place.

The serving steps run in the dtype the model's weights are held in, so
``dtype`` must be that dtype there.  The knobs default to the
reference's.  ``seq_shard=True`` (the sequence-parallel residual:
each rank holds S/M rows of the residual between blocks, gathered on a
block's entry and reduce-scattered on its exit, ``parallel``'s
docstring) reaches the train step's family loss, where the transformer
family honours it and Mamba-2, the hybrid and the enc-dec cut whatever
is asked, as their reference losses swallow it; the prefill step passes
no knob, as the reference's does, so every family's prefill cuts
(``parallel.seq_cut``: where 16 and the model axis divide S).
``seq_shard=False`` keeps the residual whole on every model rank where
the family honours it.  ``remat_policy="dots"`` keeps the products'
outputs under remat in the transformer family (``layers.recompute``).
The one knob refused is ``block_skip`` (the XLA chunked attention's
triangular blocking): the port's causal attention is the flash kernel,
which skips masked tiles itself.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig, OptimizerConfig
from repro_torch.launch import mesh as MESH
from repro_torch.models import registry as R
from repro_torch.models.layers import P
from repro_torch.optim import optimizers as O
from repro_torch.parallel import tp_of
from repro_torch.train import engine as E

# long_500k needs sub-quadratic decoding (the reference's DESIGN.md §6)
LONG_CONTEXT_ARCHS = {"recurrentgemma-9b", "mamba2-2.7b", "starcoder2-3b"}


def validate_feeding(plan, mesh, *, process_count: Optional[int] = None,
                     start_tokens=None, seq_len: Optional[int] = None):
    """Check that a plan's batch ramp is feedable on this topology: every
    phase's global batch divides across the feeding processes and the
    data-parallel slots, each process owning a contiguous, process-ordered
    row block (``launch.mesh.assert_per_host_row_blocks`` of a
    ``GroupMesh``).  On a data × model :class:`launch.mesh.Mesh` the
    feeders are its data slots (each slot's ranks sample the slot's
    block, in slot order, by construction), so ``process_count``
    defaults to P·D there and to the process group's size otherwise.

    ``start_tokens`` (a checkpoint's exact ``tokens_seen``) makes it the
    elastic-resume check: only the ramp from the phase that count lands
    in must be feedable, found on the realized boundaries with
    ``seq_len``, on the plan's ideal ones without.  Raises
    ``ValueError`` at the first phase that cannot be fed; returns the
    plan."""
    from repro_torch.data.pipeline import validate_per_host_plan
    from repro_torch.train.checkpoint import exact_tokens
    if isinstance(mesh, MESH.Mesh):
        n_proc = mesh.n_fsdp if process_count is None else process_count
    else:
        n_proc = (MESH.world_size() if process_count is None
                  else process_count)
        if mesh is not None:
            MESH.assert_per_host_row_blocks(mesh, n_proc)
    start_phase = 0
    if start_tokens is not None:
        tok = exact_tokens(start_tokens)
        ph = (plan.realized_phase_at(tok, seq_len) if seq_len
              else plan.phase_at_tokens(tok))
        start_phase = ph.index
    return validate_per_host_plan(plan, n_proc,
                                  MESH.data_parallel_size(mesh),
                                  start_phase=start_phase)


def shape_supported(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    if shape.name == "long_500k" and cfg.name not in LONG_CONTEXT_ARCHS:
        return False, ("skipped: full-attention arch at 500k decode "
                       "(see DESIGN.md §6)")
    return True, ""


def _refuse(block_skip: bool) -> None:
    if block_skip:
        raise NotImplementedError(
            "build_workload: block_skip=True has no path in the port (the "
            "causal attention is the flash kernel, which skips masked "
            "tiles itself)")


def _check_dtype(model, dtype) -> None:
    if model.dtype != dtype:
        raise ValueError(f"the serving steps run in the weights' dtype: "
                         f"the model is held in {model.dtype}, dtype "
                         f"{dtype} asked")


def build_workload(cfg: ModelConfig, shape: InputShape, *,
                   multi_pod: bool = False, opt_kind: str = "adamw",
                   z_loss: float = 0.0, remat: bool = True,
                   block_skip: bool = False, seq_shard: bool = True,
                   remat_policy: str = "", serve_resident: bool = False,
                   cache_seq_shard: bool = False, dtype=torch.bfloat16):
    """Returns (fn, args of meta-device stand-ins, in_specs, out_specs) of
    ``shape``'s mode (see the module's docstring)."""
    _refuse(block_skip)
    pspec = R.param_specs(cfg, multi_pod,
                          serve_resident=(serve_resident and
                                          shape.mode != "train"))
    model = R.family(cfg).Model(
        cfg, dtype=torch.float32 if shape.mode == "train" else dtype,
        device="meta")
    ispec = R.input_shardings(cfg, shape, multi_pod,
                              cache_seq_shard=cache_seq_shard)
    istruct = R.input_specs(cfg, shape)

    if shape.mode == "train":
        opt = O.from_config(OptimizerConfig(kind=opt_kind))
        ostruct = opt.init(dict(model.named_parameters()))
        ospec = E.opt_state_specs(pspec, ostruct)
        steps = {}

        def train_step(model, opt_state, batch, lr):
            tp = tp_of(model)
            mesh = None if tp is None else tp.mesh
            if mesh not in steps:
                steps[mesh] = E.make_grad_step(
                    cfg, opt, z_loss=z_loss, dtype=dtype, remat=remat,
                    mesh=mesh, seq_shard=seq_shard,
                    remat_policy=remat_policy)
            model, opt_state, metrics = steps[mesh](model, opt_state, batch,
                                                    lr)
            return model, opt_state, metrics["loss"]

        args = (model, ostruct, istruct, R._meta((), torch.float32))
        return (train_step, args, (pspec, ospec, ispec, P()),
                (pspec, ospec, P()))

    if shape.mode == "prefill":
        def prefill_step(model, batch):
            _check_dtype(model, dtype)
            sharded = tp_of(model) is not None
            logits, _cache = R.prefill(
                model, cfg, batch["tokens"],
                prefix_emb=batch.get("prefix_emb"),
                cache_len_cap=shape.seq_len,
                global_batch=shape.global_batch if sharded else None,
                cache_seq_shard=cache_seq_shard)
            return logits

        b = ispec["tokens"]
        return (prefill_step, (model, istruct), (pspec, ispec),
                P(b[0], None, "model"))

    def serve_step(model, cache, token):
        _check_dtype(model, dtype)
        return R.decode_step(model, cfg, cache, token)

    b = ispec["token"]
    return (serve_step, (model, istruct["cache"], istruct["token"]),
            (pspec, ispec["cache"], ispec["token"]),
            (P(b[0], None, "model"), ispec["cache"]))
