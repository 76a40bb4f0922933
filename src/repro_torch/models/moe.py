"""Mixture-of-Experts FFN with sort-based capacity dispatch, drop policy
(port of repro/models/moe.py).

Routing and dispatch run per batch row. Each token's K expert choices are
"copies" (copy t = s·K + k); a stable sort of the copies by expert gives every
copy a slot (e, c) of its expert's capacity C, and copies past an expert's
capacity are dropped (their combine weight is 0), as in GShard / Switch. The
experts then run as one batched product over (E, C) slots, so the FLOPs are
the active compute, not E/K times it. The Switch load-balancing loss comes
back beside the output.

Expert weights are stacked (E, d, f) / (E, f, d), as the reference keeps them
(and (L, E, …) in a stacked decoder), so GaLore sees L·E slabs a leaf.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _init_normal


def init_moe(gen, cfg, dtype, lead=()):
    """{"router": (D, E) f32, "gate"/"up": (E, D, F), "down": (E, F, D)},
    each with the leading dims `lead`. The router stays f32 whatever the
    model's dtype, as in the reference."""
    lead = tuple(lead)
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {
        "router": _init_normal(gen, lead + (D, E), torch.float32, fan_in=D),
        "gate": _init_normal(gen, lead + (E, D, Fd), dtype, fan_in=D),
        "up": _init_normal(gen, lead + (E, D, Fd), dtype, fan_in=D),
        "down": _init_normal(gen, lead + (E, Fd, D), dtype, fan_in=Fd),
    }


def capacity_for(cfg, seq: int) -> int:
    per_expert = seq * cfg.experts_per_token / cfg.n_experts
    return max(1, int(per_expert * cfg.capacity_factor))


class _Permute(torch.autograd.Function):
    """Batched permutation as a gather with a gather adjoint (no scatter):

        y[b, i] = x[b, idx_fwd[b, i]] · scale_fwd[b, i]
        dx[b, j] = dy[b, idx_bwd[b, j]] · scale_bwd[b, j]

    The caller supplies exact inverse index / scale pairs (a dropped copy or
    an empty slot has scale 0). Autograd's own adjoint of a gather is a
    scatter-add, whose order of additions is not fixed on CUDA; the gather
    adjoint is deterministic and is the reference's."""

    @staticmethod
    def forward(ctx, x, idx_fwd, idx_bwd, scale_fwd, scale_bwd):
        ctx.save_for_backward(idx_bwd, scale_bwd)
        return _gather_rows(x, idx_fwd) * scale_fwd[..., None]

    @staticmethod
    def backward(ctx, dy):
        idx_bwd, scale_bwd = ctx.saved_tensors
        return _gather_rows(dy, idx_bwd) * scale_bwd[..., None], None, None, None, None


def _gather_rows(x, idx):
    """x (B, N, D), idx (B, M) -> (B, M, D): x[b, idx[b, i]]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def apply_moe(cfg, p, x):
    """x (B, S, D) -> (y (B, S, D) in x's dtype, aux_loss 0-d f32)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    C = capacity_for(cfg, S)
    T = S * K
    dev = x.device

    router_logits = x.float() @ p["router"]
    probs = torch.softmax(router_logits, dim=-1)  # (B, S, E)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)  # descending, as lax.top_k
    if K > 1:
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # the Switch load-balancing loss
    me = probs.mean(dim=(0, 1))  # (E,)
    ce = F.one_hot(expert_idx, E).float().sum(dim=2).mean(dim=(0, 1))  # tokens per expert
    aux_loss = E * (me * ce).sum() * cfg.router_aux_coef

    # routing: integer index algebra only, no gradient flows here
    with torch.no_grad():
        flat_ids = expert_idx.reshape(B, T)  # copy t = s*K + k
        order = torch.argsort(flat_ids, dim=1, stable=True)  # sorted position -> copy
        sorted_ids = torch.gather(flat_ids, 1, order)
        counts = F.one_hot(flat_ids, E).sum(dim=1)  # (B, E)
        offsets = torch.cumsum(counts, dim=1) - counts  # exclusive cumsum
        pos_in_expert = (torch.arange(T, device=dev)[None, :]
                         - torch.gather(offsets, 1, sorted_ids))
        keep_sorted = pos_in_expert < C
        # the capacity slot of each sorted position (a dropped one parks at 0)
        slot_sorted = torch.where(keep_sorted, sorted_ids * C + pos_in_expert,
                                  torch.zeros_like(pos_in_expert))
        inv_order = torch.argsort(order, dim=1)  # copy -> sorted position
        slot_of_copy = torch.gather(slot_sorted, 1, inv_order)  # (B, T)
        keep_of_copy = torch.gather(keep_sorted, 1, inv_order)
        # slot -> copy: slot (e, c) holds sorted position offsets[e] + c
        ec = torch.arange(E * C, device=dev)
        expert_of = (ec // C)[None, :].expand(B, -1)
        s_idx = torch.gather(offsets, 1, expert_of) + (ec % C)[None, :]
        slot_filled = (ec % C)[None, :] < torch.gather(counts, 1, expert_of)
        copy_of_slot = torch.gather(order, 1, s_idx.clamp(0, T - 1))  # (B, E*C)
        fill = slot_filled.to(x.dtype)
        keepf = keep_of_copy.to(x.dtype)

    # dispatch: each token to its K copies, the copies to their slots
    x_copies = torch.repeat_interleave(x, K, dim=1) if K > 1 else x  # (B, T, D)
    h = _Permute.apply(x_copies, copy_of_slot, slot_of_copy, fill, keepf).reshape(B, E, C, D)

    # the experts' SwiGLU
    gate_h = F.silu(torch.einsum("becd,edf->becf", h, p["gate"]))
    up_h = torch.einsum("becd,edf->becf", h, p["up"])
    y = torch.einsum("becf,efd->becd", gate_h * up_h, p["down"])  # (B, E, C, D)

    # combine: each copy's expert output, weighted by its gate, summed over K
    tok = _Permute.apply(y.reshape(B, E * C, D), slot_of_copy, copy_of_slot, keepf.to(y.dtype),
                         fill.to(y.dtype))  # (B, T, D)
    out = torch.einsum("bskd,bsk->bsd", tok.reshape(B, S, K, D), gate_vals.to(y.dtype))
    return out.to(x.dtype), aux_loss
