"""Top-k mixture-of-experts FFN with capacity-based dispatch
(``repro.models.moe`` in PyTorch).

The reference routes each group of ``g`` tokens to its experts through
one-hot einsums: a (G, g, E, C) dispatch tensor of 0/1 and a combine
tensor of gate weights, contracted with the tokens and the experts'
outputs.  The port computes the same function with the one-hot tensors
replaced by tables of indices:

- **Routing** as the reference's: router logits in the compute dtype,
  a float32 softmax, top-k, the k gates renormalised to sum to 1.  Each
  (token, choice) takes the next place of its expert's queue in
  token-major, choice-minor order within its group (a cumulative count
  of one-hots); a choice whose place is ``cap`` or more is dropped, its
  gate kept in the renormalisation and zeroed after it.
- **Slot tables**, static in shape: the experts' inputs are E·G·C rows,
  row e·G·C + grp·C + c the c-th place of expert e's queue in group
  grp.  ``slot_src`` holds, for each row, the flat id t·k + j of the
  (token, choice) in it, or T·k for an empty row; ``tok_slot`` holds,
  for each (token, choice), its row, or E·G·C when it was dropped.
  Both are built by scatters whose targets are all distinct (each
  dropped choice writes a scratch cell of its own), with no ``nonzero``
  and no sync, so a CUDA graph can capture them.
- **Dispatch and combine as gathers**, in both directions
  (``_Dispatch`` and ``_Combine``): the dispatch gathers token rows
  into the experts' rows, empty rows reading a zero row; its backward
  gathers each token's k rows of the gradient and sums them in choice
  order.  The combine gathers each token's k expert outputs and sums
  them weighted by the gates (a (1, k) @ (k, d) product a token); its
  backward writes each expert row once, from the one (token, choice)
  in it.  No ``index_add_`` and no atomics: a step's bits do not depend
  on the order threads run in, so replays of a captured step equal
  eager steps and runs repeat.
- **The experts** as batched matmuls over (E, G·C, d): SwiGLU, gate and
  up in the compute dtype, then down.  The reference computes them as
  XLA einsums, outside any Pallas kernel, so they stay ``torch.matmul``.

``moe_forward_ref`` is the reference's one-hot einsum formulation in
PyTorch, the plain version the tests and the card's check hold the main
one to.

Ties in top-k: ``jax.lax.top_k`` and ``torch.topk`` may order equal
probabilities differently, so a tie can route a token to another
expert in the two packages.  Float32 probabilities from random weights
tie with negligible probability.

The reference asserts that the tokens of a call split into whole
groups (``tokens % g == 0`` once B·S exceeds ``group_size``); the port
raises ``ValueError`` there (:func:`check_tokens`), before any work.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import P, out_std, param, trunc_normal_

GROUP_SIZE = 2048


class MoE(nn.Module):
    """The router (d, E) and the experts' SwiGLU weights: ``w_gate`` and
    ``w_up`` (E, d, d_expert), ``w_down`` (E, d_expert, d), in the
    reference's layout."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        m = cfg.moe
        if m is None:
            raise ValueError(f"{cfg.name}: arch_type 'moe' needs cfg.moe")
        d, E, f = cfg.d_model, m.num_experts, m.d_expert
        self.router = param((d, E), dtype=dtype, device=device)
        self.w_gate = param((E, d, f), dtype=dtype, device=device)
        self.w_up = param((E, d, f), dtype=dtype, device=device)
        self.w_down = param((E, f, d), dtype=dtype, device=device)

    def init_weights(self, generator: torch.Generator, n_layers: int):
        trunc_normal_(self.router, 0.02, generator)
        trunc_normal_(self.w_gate, 0.02, generator)
        trunc_normal_(self.w_up, 0.02, generator)
        trunc_normal_(self.w_down, out_std(n_layers), generator)


def moe_specs(fsdp, lead: tuple = ()):
    """Experts over ``model``; the router replicated."""
    return {"router": P(*lead, None, None),
            "w_gate": P(*lead, "model", fsdp, None),
            "w_up": P(*lead, "model", fsdp, None),
            "w_down": P(*lead, "model", None, fsdp)}


def groups(cfg: ModelConfig, n_tokens: int,
           group_size: int = GROUP_SIZE) -> Tuple[int, int, int]:
    """(groups G, tokens a group g, capacity C) of a call over
    ``n_tokens`` tokens, the reference's arithmetic."""
    m = cfg.moe
    g = min(group_size, n_tokens)
    cap = int(math.ceil(g * m.top_k * m.capacity_factor / m.num_experts))
    cap = min(max(cap, m.top_k), g)
    return n_tokens // g, g, cap


def check_tokens(cfg: ModelConfig, n_tokens: int,
                 group_size: int = GROUP_SIZE) -> None:
    """Raise ``ValueError`` unless ``n_tokens`` split into whole groups
    (the reference asserts it inside its jitted forward)."""
    if cfg.arch_type != "moe" or n_tokens <= 0:
        return
    g = min(group_size, n_tokens)
    if n_tokens % g:
        raise ValueError(
            f"{cfg.name}: {n_tokens} tokens do not split into groups of "
            f"{g} (the MoE routes whole groups of min({group_size}, "
            f"B*S) tokens; the reference asserts tokens % g == 0)")


# --------------------------------------------------------------------- #
# dispatch and combine
# --------------------------------------------------------------------- #

def _pad_row(x: torch.Tensor) -> torch.Tensor:
    """x (N, ...) with one zero row appended."""
    return torch.cat([x, x.new_zeros((1, *x.shape[1:]))])


class _Dispatch(torch.autograd.Function):
    """x (T, d), slot_tok (S,) the token of each expert row (T: empty),
    tok_slot (T, k) each choice's row (S: dropped) -> expert rows (S,
    d).  The backward sums each token's k rows in choice order."""

    @staticmethod
    def forward(ctx, x, slot_tok, tok_slot):
        ctx.save_for_backward(tok_slot)
        return _pad_row(x)[slot_tok]

    @staticmethod
    def backward(ctx, grad):
        (tok_slot,) = ctx.saved_tensors
        return _pad_row(grad)[tok_slot].sum(1), None, None


class _Combine(torch.autograd.Function):
    """ex (S, d) expert outputs, w (T, k) gates in the compute dtype (0
    where dropped), tok_slot (T, k), slot_src (S,) the flat choice of
    each row (T·k: empty) -> y (T, d), y[t] = Σ_j w[t, j] ex[tok_slot[t,
    j]].  The backward writes each expert row once, from its choice."""

    @staticmethod
    def forward(ctx, ex, w, tok_slot, slot_src):
        ctx.save_for_backward(ex, w, tok_slot, slot_src)
        return (w[:, None, :] @ _pad_row(ex)[tok_slot])[:, 0]

    @staticmethod
    def backward(ctx, grad):
        ex, w, tok_slot, slot_src = ctx.saved_tensors
        k = w.shape[1]
        d_ex = d_w = None
        if ctx.needs_input_grad[0]:
            w_of = _pad_row(w.reshape(-1))[slot_src]           # (S,)
            d_ex = w_of[:, None] * _pad_row(grad)[slot_src // k]
        if ctx.needs_input_grad[1]:
            d_w = (_pad_row(ex)[tok_slot] @ grad[:, :, None])[..., 0]
        return d_ex, d_w, None, None


def _onehot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) bool one-hots of ``idx`` (a compare: no range check,
    so no sync on the card)."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def _route(probs: torch.Tensor, k: int, cap: int):
    """probs (G, g, E) float32 -> (gate_vals (G, g, k) renormalised,
    gate_idx (G, g, k), pos (G, g, k) each choice's place in its
    expert's queue, keep (G, g, k))."""
    G, g, E = probs.shape
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    flat = gate_idx.reshape(G, g * k)
    # (G, E, g·k) one-hots counted along their last, contiguous dim (a
    # scan over dim 1 of (G, g·k, E) took 3 ms a call at 4 x 16,384 x 32
    # on an H100)
    onehot = (flat[:, None, :] == torch.arange(
        E, device=flat.device)[None, :, None]).to(torch.int32)
    pos = onehot.cumsum(2, dtype=torch.int32).gather(1, flat[:, None, :])
    pos = (pos[:, 0] - 1).reshape(G, g, k)
    return gate_vals, gate_idx, pos, pos < cap


def _slot_tables(gate_idx, pos, keep, E: int, cap: int):
    """(slot_src (S,), slot_tok (S,), tok_slot (T, k)) over all groups:
    S = E·G·C expert rows, T = G·g tokens (see the module's
    docstring)."""
    G, g, k = gate_idx.shape
    T, S = G * g, E * G * cap
    dev = gate_idx.device
    grp = torch.arange(G, device=dev)[:, None, None]
    row = gate_idx * (G * cap) + grp * cap + pos.long()           # (G,g,k)
    flat = torch.arange(T * k, device=dev)
    # a dropped choice writes scratch cell S + its flat id: all distinct
    target = torch.where(keep.reshape(-1), row.reshape(-1), S + flat)
    slot_src = torch.full((S + T * k,), T * k, dtype=torch.long,
                          device=dev)
    slot_src.scatter_(0, target, flat)
    slot_src = slot_src[:S]
    tok_slot = torch.where(keep, row, S).reshape(T, k)
    return slot_src, slot_src // k, tok_slot


def moe_forward(moe: MoE, x: torch.Tensor, cfg: ModelConfig, *,
                group_size: int = GROUP_SIZE):
    """x: (B, S, d) -> (y (B, S, d), aux) with aux {lb_loss, rz_loss,
    frac_dropped}, float32 scalars, as the reference's ``moe_forward``.
    Raises ``ValueError`` when B·S does not split into whole groups."""
    m = cfg.moe
    B, S_, d = x.shape
    E, k = m.num_experts, m.top_k
    check_tokens(cfg, B * S_, group_size)
    G, g, cap = groups(cfg, B * S_, group_size)
    xt = x.reshape(G * g, d)
    logits = (xt @ moe.router.to(x.dtype)).float().reshape(G, g, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx, pos, keep = _route(probs, k, cap)
    slot_src, slot_tok, tok_slot = _slot_tables(gate_idx, pos, keep, E,
                                                cap)

    ex = _Dispatch.apply(xt, slot_tok, tok_slot).reshape(E, G * cap, d)
    h = F.silu(ex @ moe.w_gate.to(x.dtype)) * (ex @ moe.w_up.to(x.dtype))
    ex_out = (h @ moe.w_down.to(x.dtype)).reshape(E * G * cap, d)
    w = (gate_vals * keep).to(x.dtype).reshape(G * g, k)
    y = _Combine.apply(ex_out, w, tok_slot, slot_src)
    return y.reshape(B, S_, d), _aux(probs, logits, gate_idx, keep, E)


def _aux(probs, logits, gate_idx, keep, E: int) -> Dict[str, torch.Tensor]:
    """The reference's switch load balance, router z-loss and dropped
    share."""
    me = probs.mean(1)                                     # (G, E)
    ce = _onehot(gate_idx[..., 0], E).float().mean(1)      # (G, E)
    lb_loss = E * (me * ce).sum(-1).mean()
    rz_loss = torch.logsumexp(logits, dim=-1).square().mean()
    frac_dropped = 1.0 - keep.float().mean()
    return {"lb_loss": lb_loss, "rz_loss": rz_loss,
            "frac_dropped": frac_dropped}


def moe_aux_total(aux: Dict[str, torch.Tensor], cfg: ModelConfig):
    m = cfg.moe
    return m.load_balance_loss * aux["lb_loss"] \
        + m.router_z_loss * aux["rz_loss"]


# --------------------------------------------------------------------- #
# the plain version: the reference's one-hot einsums
# --------------------------------------------------------------------- #

def route_ref(probs: torch.Tensor, k: int, cap: int):
    """The reference's routing by one-hots: probs (G, g, E) float32 ->
    (gate_vals (G, g, k) renormalised, gate_idx (G, g, k), onehot (G, g,
    k, E), each choice's queue place (G, g, k), keep (G, g, k))."""
    G, g, E = probs.shape
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    onehot = F.one_hot(gate_idx, E).float()                 # (G,g,k,E)
    flat = onehot.reshape(G, g * k, E)
    pos = (flat.cumsum(1) - flat).reshape(G, g, k, E)
    keep = ((pos < cap) & (onehot > 0)).any(-1)
    pos_cap = torch.einsum("Gske,Gske->Gsk", pos, onehot).long()
    return gate_vals, gate_idx, onehot, pos_cap, keep


def moe_forward_ref(moe: MoE, x: torch.Tensor, cfg: ModelConfig, *,
                    group_size: int = GROUP_SIZE):
    """The reference's formulation, one-hot dispatch and combine tensors
    contracted by einsums.  Holds ``moe_forward`` to the reference's
    arithmetic in the tests and on the card; the model never calls
    it."""
    m = cfg.moe
    B, S_, d = x.shape
    E, k = m.num_experts, m.top_k
    check_tokens(cfg, B * S_, group_size)
    G, g, cap = groups(cfg, B * S_, group_size)
    xt = x.reshape(G, g, d)
    logits = (xt @ moe.router.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx, onehot, pos_cap, keep = route_ref(probs, k, cap)
    pos_onehot = F.one_hot(pos_cap.clamp(max=cap), cap + 1)[..., :cap] \
        .float()                                            # (G,g,k,C)
    combine = torch.einsum("Gsk,Gske,Gskc->Gsec", gate_vals * keep, onehot,
                           pos_onehot).to(x.dtype)
    dispatch = (combine > 0).to(x.dtype)
    ex_in = torch.einsum("Gsec,Gsd->eGcd", dispatch, xt)
    wg, wu, wd = (w.to(x.dtype) for w in (moe.w_gate, moe.w_up,
                                           moe.w_down))
    h = F.silu(torch.einsum("eGcd,edf->eGcf", ex_in, wg)) \
        * torch.einsum("eGcd,edf->eGcf", ex_in, wu)
    ex_out = torch.einsum("eGcf,efd->eGcd", h, wd)
    y = torch.einsum("Gsec,eGcd->Gsd", combine, ex_out)
    return y.reshape(B, S_, d), _aux(probs, logits, gate_idx, keep, E)
