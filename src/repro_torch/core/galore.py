"""GaLore around Adam: gradient low-rank projection as a gradient transform
(port of repro/core/galore.py: ``galore`` with the in-step every-T refresh,
and the fp32 branches of ``_managed_adam_update``).

    R_t  = P_tᵀ G_t  (left, m ≤ n)  or  G_t P_t  (right)
    N_t  = Adam(R_t)                 compact moments live in r × n (or m × r)
    G̃_t = α P_t N_t  or  α N_t P_tᵀ

P_t is refreshed from an SVD of the current gradient at galore steps
0, T, 2T, … Non-matrix leaves and excluded paths (embeddings) get the same
Adam math at full shape. With ``fused=True`` each GaLore leaf runs one fused
kernel launch (kernels/ops.py); with ``fused=False`` it runs the composable
project → Adam → back-project sequence in plain torch (kernels/ref.py), the
numerics oracle.

State layout (the reference's, minus its unused PRNG key):
    {"step": int, "proj": tree of P (scalar placeholders on non-galore
     leaves), "inner": {"m": tree, "v": tree, "count": int32 tensor}}
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import GaLoreConfig
from repro_torch.core.subspace import DEFAULT_EXCLUDE, SubspaceManager, proj_shape, r_shape
from repro_torch.kernels import ops, ref
from repro_torch.optim.transform import GradientTransformation, _device_of
from repro_torch.utils import tree_leaves, tree_map, tree_unflatten_like


def galore(cfg: GaLoreConfig, *, b1: float, b2: float, eps: float, fused: bool = False,
           exclude=DEFAULT_EXCLUDE) -> GradientTransformation:
    """GaLore-Adam as a GradientTransformation. b1/b2/eps are Adam's; the
    transform owns the Adam math on every leaf (as the reference's managed
    path does), so its state has scale_by_adam's {m, v, count} layout."""
    mgr = SubspaceManager(cfg, exclude)

    def init(params):
        plans = mgr.plans(params)

        def zeros(shape, p):
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def moment(p, plan):
            return zeros(r_shape(p, plan) if plan.galore else p.shape, p)

        return {
            "step": 0,
            "proj": tree_map(lambda p, pl: zeros(proj_shape(p, pl) if pl.galore else (), p),
                             params, plans),
            "inner": {"m": tree_map(moment, params, plans), "v": tree_map(moment, params, plans),
                      "count": torch.zeros((), dtype=torch.int32, device=_device_of(params))},
        }

    def update(grads, state, params=None):
        plans = mgr.plans(grads)
        step = state["step"]
        proj = mgr.refresh_tree(grads, state["proj"], plans, step)
        updates, inner = _managed_adam_update(grads, proj, state["inner"], plans, cfg,
                                              b1, b2, eps, fused=fused)
        return updates, {"step": step + 1, "proj": proj, "inner": inner}

    return GradientTransformation(init, update)


def _managed_adam_update(grads, proj, inner_state, plans, cfg: GaLoreConfig,
                         b1: float, b2: float, eps: float, *, fused: bool):
    """One Adam step over every leaf; returns (updates, {m, v, count}).

    GaLore leaves run the side-matched fused kernel when `fused` (moments
    updated in place), else the composable composition; other leaves get the
    same bias-corrected Adam at full shape."""
    count = inner_state["count"] + 1

    def leaf(g, P, m, v, plan):
        if not plan.galore:
            out, m_t, v_t = ref.lowrank_adam_update(g, m, v, count, b1, b2, eps)
            return out.to(g.dtype), m_t, v_t
        left = plan.side == "left"
        if fused:
            fn = ops.galore_fused_adam_step if left else ops.galore_fused_adam_step_right
            return fn(P, g.contiguous(), m, v, count, b1=b1, b2=b2, eps=eps, alpha=cfg.scale)
        fn = ref.galore_fused_adam_step if left else ref.galore_fused_adam_step_right
        return fn(P, g, m, v, count, b1, b2, eps, cfg.scale)

    flat = [leaf(*xs) for xs in zip(tree_leaves(grads), tree_leaves(proj),
                                    tree_leaves(inner_state["m"]), tree_leaves(inner_state["v"]),
                                    tree_leaves(plans))]
    updates = tree_unflatten_like(grads, [t[0] for t in flat])
    new_m = tree_unflatten_like(grads, [t[1] for t in flat])
    new_v = tree_unflatten_like(grads, [t[2] for t in flat])
    return updates, {"m": new_m, "v": new_v, "count": count}
