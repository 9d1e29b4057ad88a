"""The name map between the port's model and the reference package's
parameter pytree, both ways.

``from_jax_params`` takes the reference's parameter pytree as nested
dicts of numpy arrays (``jax.tree.map(np.asarray, params)`` on the
reference side), so this module never imports JAX.  The reference's
layout, by family (``arch_type``):

- both: ``embed.tok`` (V, d), ``embed.lm_head`` (d, V) unless tied;
  ``final_norm`` (d,);
- dense: ``layers.*`` stacked along a leading L dim:
  ``attn.w_q/w_k/w_v/w_o``, ``mlp.w_up/w_down[/w_gate]``,
  ``norm1``/``norm2`` (L, d);
- moe: the dense layout with ``moe.router`` (L, d, E) and
  ``moe.w_gate/w_up`` (L, E, d, d_expert), ``moe.w_down`` (L, E,
  d_expert, d) in place of ``mlp``;
- ssm (Mamba-2): ``layers.mixer.*`` (``w_z``, ``w_x``, ``w_B``, ``w_C``,
  ``w_dt``, ``dt_bias``, ``A_log``, ``D``, ``conv_w``, ``conv_b``,
  ``norm``, ``w_out``) and ``layers.norm`` (L, d), stacked along L;
- hybrid (RG-LRU): the n_full = L // 3 groups of the pattern stacked
  along a leading dim of n_full, ``groups.slot{j}.*`` for the group's
  j-th layer, then the remainder unstacked, ``rem{r}.*``; each layer's
  ``temporal.*`` (the recurrent block's ``w_gate``, ``w_x``, ``conv_w``,
  ``conv_b``, ``w_r``, ``w_i``, ``lam``, ``w_out``, or the attention's
  ``w_q/w_k/w_v/w_o``), ``mlp.*``, ``norm1``, ``norm2``.  Port layer i
  is ``groups/slot{i mod 3}`` at group i // 3 while i < 3·n_full, else
  ``rem{i − 3·n_full}``;
- vlm: the dense layout;
- encdec and audio: ``encoder.*`` (``attn.w_q/w_k/w_v/w_o``, ``mlp.*``,
  ``norm1``, ``norm2``) stacked along the encoder's depth,
  ``decoder.*`` (``self_attn.*``, ``cross_attn.*``, ``mlp.*``,
  ``norm1``, ``norm2``, ``norm3``) along the decoder's, and
  ``enc_norm`` (d,).

The leading L dim is split into the ``ModuleList``; matrices keep their
``(d_in, d_out)`` layout (the port multiplies ``x @ W`` as the
reference does).  Norm scales are zero-initialised and used as
``(1 + scale)`` in both packages, so they copy as they are, in float32.
Matrices, the conv and the embedding are cast once to ``dtype``: the
compute dtype to serve, float32 (with ``trainable=True``) to train; the
SSD's per-head parameters stay float32.

The other way, ``param_tree`` and ``opt_tree`` give the reference's
layout over the port's live tensors without copying them: a per-layer
leaf is a :class:`Stacked` of the L layers' tensors, stacked only where
it is written (the checkpoint streams layer i's bytes after layer
i−1's).  ``to_jax_params`` / ``to_jax_opt_state`` materialise them as
numpy, and ``from_jax_opt_state`` maps the reference's optimizer state
(``{"m": tree, "v": tree, "count"}``, or ``{"count"}`` / ``{"mu",
"count"}`` for SGD and normalized SGD) onto the port's ``{slot: {name:
tensor}}``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.encdec import EncDec
from repro_torch.models.mamba2 import Mamba2
from repro_torch.models.rglru import Hybrid
from repro_torch.models.rglru import groups as hybrid_groups
from repro_torch.models.transformer import Transformer
from repro_torch.train.checkpoint import Sharded, Stacked


def _copy(dst: torch.Tensor, src: np.ndarray, name: str) -> None:
    src = np.asarray(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: reference shape {tuple(src.shape)} != "
                         f"port shape {tuple(dst.shape)}")
    dst.data.copy_(torch.from_numpy(np.array(src)))   # a writable copy


def _embed_and_final(model, tree) -> None:
    emb = tree["embed"]
    _copy(model.tok, emb["tok"], "embed.tok")
    if model.lm_head is not None:
        _copy(model.lm_head, emb["lm_head"], "embed.lm_head")
    elif "lm_head" in emb:
        raise ValueError("tied config, but the tree has embed.lm_head")
    _copy(model.final_norm, tree["final_norm"], "final_norm")


def _dense(tree, cfg: ModelConfig, dtype, device) -> Transformer:
    model = Transformer(cfg, dtype=dtype, device=device)
    _embed_and_final(model, tree)
    layers = tree["layers"]
    for i, layer in enumerate(model.layers):
        _copy(layer.norm1, layers["norm1"][i], f"layers.norm1[{i}]")
        _copy(layer.norm2, layers["norm2"][i], f"layers.norm2[{i}]")
        for n in ("w_q", "w_k", "w_v", "w_o"):
            _copy(getattr(layer.attn, n), layers["attn"][n][i],
                  f"layers.attn.{n}[{i}]")
        if cfg.arch_type == "moe":
            for n in ("router", "w_gate", "w_up", "w_down"):
                _copy(getattr(layer.moe, n), layers["moe"][n][i],
                      f"layers.moe.{n}[{i}]")
            continue
        for n in ("w_up", "w_down", "w_gate"):
            w = getattr(layer.mlp, n)
            if w is not None:
                _copy(w, layers["mlp"][n][i], f"layers.mlp.{n}[{i}]")
    return model


def _ssm(tree, cfg: ModelConfig, dtype, device) -> Mamba2:
    model = Mamba2(cfg, dtype=dtype, device=device)
    _embed_and_final(model, tree)
    layers = tree["layers"]
    for i, blk in enumerate(model.layers):
        _copy(blk.norm, layers["norm"][i], f"layers.norm[{i}]")
        for n, w in blk.mixer.named_parameters():
            _copy(w, layers["mixer"][n][i], f"layers.mixer.{n}[{i}]")
    return model


def _by_name(cls):
    """A loader that builds ``cls`` and copies every parameter past the
    embedding and the final norm from its reference path."""

    def load(tree, cfg: ModelConfig, dtype, device):
        model = cls(cfg, dtype=dtype, device=device)
        _embed_and_final(model, tree)
        for name, p in model.named_parameters():
            if name not in ("tok", "lm_head", "final_norm"):
                _copy(p, _ref_leaf(tree, name, cfg), name)
        return model

    return load


_FAMILIES = {"dense": _dense, "moe": _dense, "vlm": _dense, "ssm": _ssm,
             "hybrid": _by_name(Hybrid), "encdec": _by_name(EncDec),
             "audio": _by_name(EncDec)}


def from_jax_params(tree: Dict[str, Any], cfg: ModelConfig, *,
                    dtype=torch.bfloat16, device="cuda",
                    trainable: bool = False, mesh=None,
                    rank: Optional[int] = None):
    """Build the port's model of ``cfg``'s family (``Transformer`` for
    dense, moe and vlm, ``Mamba2`` for ssm, ``Hybrid`` for hybrid,
    ``EncDec`` for encdec and audio) from the
    reference's parameter pytree (numpy arrays); ``trainable`` turns on
    the parameters' gradients.  With ``mesh`` the model is cut to
    ``rank``'s shards (``parallel.shard``; the process group's rank by
    default)."""
    load = _FAMILIES.get(cfg.arch_type)
    if load is None:
        raise NotImplementedError(
            f"from_jax_params: arch_type {cfg.arch_type!r} is not ported")
    model = load(tree, cfg, dtype, device).requires_grad_(trainable)
    if mesh is not None:
        from repro_torch import parallel
        parallel.shard(model, cfg, mesh, rank)
    return model


# --------------------------------------------------------------------- #
# the port's tensors in the reference's layout
# --------------------------------------------------------------------- #

def _ref_path(name: str, cfg: Optional[ModelConfig] = None
              ) -> Tuple[Tuple[str, ...], Optional[int]]:
    """(reference path, index along its stacked dim or None) of a port
    parameter name: ``tok`` -> ``embed/tok``, ``layers.3.attn.w_q`` ->
    ``layers/attn/w_q`` at layer 3 (``encoder.3.…`` and ``decoder.3.…``
    likewise); for the hybrid ``layers.4.mlp.w_up``
    -> ``groups/slot1/mlp/w_up`` at group 1, and a layer past the full
    groups -> ``rem{r}/...`` unstacked (``cfg`` names the family; None
    is a layer-stacked one)."""
    parts = name.split(".")
    if parts[0] in ("tok", "lm_head"):
        return ("embed", parts[0]), None
    if parts[0] not in ("layers", "encoder", "decoder"):
        return tuple(parts), None
    i = int(parts[1])
    if cfg is None or cfg.arch_type != "hybrid":
        return (parts[0], *parts[2:]), i
    pat, n_full, _ = hybrid_groups(cfg)
    if i < n_full * len(pat):
        return ("groups", f"slot{i % len(pat)}", *parts[2:]), i // len(pat)
    return (f"rem{i - n_full * len(pat)}", *parts[2:]), None


def _put(tree: Dict, path: Tuple[str, ...], leaf) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def _tree_of(model, tensors: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's tree over ``tensors`` (keyed by ``model``'s
    parameter names)."""
    if getattr(model.cfg, "arch_type", None) not in _FAMILIES:
        raise NotImplementedError(
            f"no reference layout for arch_type {model.cfg.arch_type!r}")
    tree: Dict[str, Any] = {}
    stacks: Dict[Tuple[str, ...], List] = {}
    first: Dict[Tuple[str, ...], str] = {}
    for name, _ in model.named_parameters():
        path, layer = _ref_path(name, model.cfg)
        if layer is None:
            _put(tree, path, _sharded(model, name, tensors[name]))
        else:
            stacks.setdefault(path, []).append((layer, tensors[name]))
            first.setdefault(path, name)
    for path, items in stacks.items():
        items.sort(key=lambda it: it[0])
        if [i for i, _ in items] != list(range(len(items))):
            raise ValueError(f"{'/'.join(path)}: layers "
                             f"{[i for i, _ in items]} are not 0..L-1")
        _put(tree, path, _sharded(model, first[path],
                                  Stacked(t for _, t in items)))
    return tree


def _sharded(model, name: str, leaf):
    """``leaf`` as a :class:`Sharded` block when ``model`` is cut to a
    mesh (a :class:`Stacked` leaf's blocks take the whole layer dim),
    else as it is."""
    tp = getattr(model, "tp", None)
    if tp is None:
        return leaf
    from repro_torch.launch.mesh import shard_box
    shape, spec = model.full_shapes[name], model.specs[name]
    boxes = [shard_box(shape, spec, tp.mesh, r) for r in
             range(tp.mesh.size)]
    if isinstance(leaf, Stacked):
        shape = (len(leaf),) + shape
        boxes = [((0, len(leaf)),) + b for b in boxes]
    return Sharded(leaf, shape, boxes, tp.rank)


def param_tree(model) -> Dict[str, Any]:
    """The reference's parameter tree over ``model``'s live parameters
    (no copy)."""
    return _tree_of(model, dict(model.named_parameters()))


def opt_tree(model, opt_state: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's optimizer-state tree over the port's live state:
    each per-parameter slot (``m``, ``v``, ``mu``) in the parameters'
    layout, ``count`` as it is."""
    return {slot: _tree_of(model, v) if isinstance(v, dict) else v
            for slot, v in opt_state.items()}


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, Sharded):
        return _gathered(tree)
    if isinstance(tree, Stacked):
        return np.stack([t.detach().cpu().numpy() for t in tree])
    return tree.detach().cpu().numpy().copy()


def _gathered(leaf: Sharded) -> np.ndarray:
    """The whole leaf from every rank's block (collective: an all-gather
    over the process group a tensor)."""
    from repro_torch.parallel import gather_full
    if isinstance(leaf.local, Stacked):
        boxes = [b[1:] for b in leaf.boxes]
        return np.stack([gather_full(t, leaf.shape[1:], boxes)
                         .cpu().numpy() for t in leaf.local])
    return gather_full(leaf.local, leaf.shape, leaf.boxes).cpu().numpy()


def to_jax_params(model) -> Dict[str, Any]:
    """``model``'s parameters as the reference's pytree of numpy arrays
    (the inverse of :func:`from_jax_params`; on a mesh every rank calls
    it and gets the whole tree)."""
    return _to_numpy(param_tree(model))


def to_jax_opt_state(model, opt_state: Dict[str, Any]) -> Dict[str, Any]:
    """The port's optimizer state as the reference's pytree of numpy
    arrays."""
    return _to_numpy(opt_tree(model, opt_state))


def _ref_leaf(tree, name: str,
              cfg: Optional[ModelConfig] = None) -> np.ndarray:
    path, layer = _ref_path(name, cfg)
    node = tree
    for k in path:
        node = node[k]
    return np.asarray(node if layer is None else node[layer])


def from_jax_opt_state(tree: Dict[str, Any], model) -> Dict[str, Any]:
    """The reference's optimizer state (numpy leaves) as the port's
    ``{slot: {name: tensor}, "count": tensor}`` on ``model``'s device
    (each parameter's block of it on a mesh)."""
    device = next(model.parameters()).device
    boxes = getattr(model, "boxes", None)
    out: Dict[str, Any] = {}
    for slot, v in tree.items():
        if isinstance(v, dict):
            out[slot] = {}
            for name, p in model.named_parameters():
                a = _ref_leaf(v, name, model.cfg)
                if boxes is not None:
                    a = a[tuple(slice(lo, hi) for lo, hi in boxes[name])]
                if tuple(a.shape) != tuple(p.shape):
                    raise ValueError(f"{slot}/{name}: reference shape "
                                     f"{tuple(a.shape)} != port shape "
                                     f"{tuple(p.shape)}")
                out[slot][name] = torch.from_numpy(np.array(a)).to(device)
        else:
            out[slot] = torch.from_numpy(np.array(v)).to(device)
    return out
