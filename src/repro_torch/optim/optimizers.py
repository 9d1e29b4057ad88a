"""Optimizers from scratch (``repro.optim.optimizers`` in PyTorch): SGD
(with momentum), normalized SGD (the paper's Adam proxy, eq. 4), Adam
and AdamW, as functional pairs over a dict of named tensors:
``init(params) → state`` and ``update(grads, state, params, lr) →
(params, state)``.

The arithmetic is the reference's, in float32: global-norm clipping,
bias correction from the int32 step ``count``, weight decay decoupled
and added after ``m̂/(√v̂+eps)``.  ``torch.optim`` is not used: its
arithmetic differs.  To keep one copy of the weights and of the moments
on the card, ``update`` works in place: it writes the new values into
the ``params`` and ``state`` tensors (and clips ``grads`` in place) and
returns the same dicts.  The step ``count`` too is advanced in place,
in the tensor ``init`` made, so a CUDA graph captured over the state
reads and advances the same count at every replay.  ``lr`` is a float
or a float32 0-d tensor (a CPU one is read by the card's kernels without
a sync; a captured graph reads a device one).  ``norm`` (optional) is the grads' global norm when the
caller holds only shards of them (``parallel.global_norm`` on a mesh):
the clip and normalized SGD use it in place of the local one.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import OptimizerConfig

Tensors = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Tensors], Tensors]
    update: Callable[..., Tuple[Tensors, Tensors]]
    # update(grads, state, params, lr, norm=None) -> (params, state)


def global_norm(tensors) -> torch.Tensor:
    """√Σ‖x‖² over the tensors, in float32."""
    return torch.stack([x.float().square().sum()
                        for x in tensors]).sum().sqrt()


def _clip_by_global_norm_(grads: Tensors, max_norm: float,
                          norm=None) -> None:
    if not max_norm:
        return
    if norm is None:
        norm = global_norm(grads.values())
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in grads.values():
        g.mul_(scale)


def _count0(params: Tensors) -> torch.Tensor:
    device = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=device)


def sgd(momentum: float = 0.0, grad_clip: float = 0.0) -> Optimizer:
    def init(params):
        state = {"count": _count0(params)}
        if momentum:
            state["mu"] = {n: torch.zeros_like(p)
                           for n, p in params.items()}
        return state

    @torch.no_grad()
    def update(grads, state, params, lr, norm=None):
        _clip_by_global_norm_(grads, grad_clip, norm)
        for n, p in params.items():
            g = grads[n]
            if momentum:
                g = state["mu"][n].mul_(momentum).add_(g)
            p.sub_(lr * g)
        state["count"].add_(1)
        return params, state

    return Optimizer(init, update)


def nsgd(grad_clip: float = 0.0, eps: float = 1e-12) -> Optimizer:
    """Normalized SGD: θ ← θ − η g/‖g‖ (global normalization — the
    scalar-preconditioner Adam proxy of paper eq. 4).  ``grad_clip`` is
    accepted and unused, as in the reference."""

    def init(params):
        return {"count": _count0(params)}

    @torch.no_grad()
    def update(grads, state, params, lr, norm=None):
        if norm is None:
            norm = global_norm(grads.values())
        scale = lr / torch.clamp(norm, min=eps)
        for n, p in params.items():
            p.sub_(scale * grads[n])
        state["count"].add_(1)
        return params, state

    return Optimizer(init, update)


def adamw(beta1: float = 0.9, beta2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, grad_clip: float = 1.0) -> Optimizer:
    def init(params):
        return {"m": {n: torch.zeros_like(p) for n, p in params.items()},
                "v": {n: torch.zeros_like(p) for n, p in params.items()},
                "count": _count0(params)}

    @torch.no_grad()
    def update(grads, state, params, lr, norm=None):
        _clip_by_global_norm_(grads, grad_clip, norm)
        c = state["count"].add_(1)
        bc1 = 1.0 - torch.pow(beta1, c.float())
        bc2 = 1.0 - torch.pow(beta2, c.float())
        for n, p in params.items():
            g = grads[n]
            m = state["m"][n].mul_(beta1).add_((1 - beta1) * g)
            v = state["v"][n].mul_(beta2).add_((1 - beta2) * g * g)
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                step = step + weight_decay * p
            p.sub_(lr * step)
        return params, state

    return Optimizer(init, update)


def adam(beta1=0.9, beta2=0.95, eps=1e-8, grad_clip=1.0) -> Optimizer:
    return adamw(beta1, beta2, eps, 0.0, grad_clip)


def from_config(cfg: OptimizerConfig) -> Optimizer:
    if cfg.kind == "adamw":
        return adamw(cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay,
                     cfg.grad_clip)
    if cfg.kind == "adam":
        return adam(cfg.beta1, cfg.beta2, cfg.eps, cfg.grad_clip)
    if cfg.kind == "sgd":
        return sgd(0.0, cfg.grad_clip)
    if cfg.kind == "nsgd":
        return nsgd(cfg.grad_clip)
    raise ValueError(cfg.kind)
