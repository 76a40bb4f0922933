"""Adafactor (Shazeer & Stern 2018) with optional first-order momentum
(port of repro/optim/adafactor.py).

The second moment is rank-1 factored over the last two dims of every leaf
of ≥ 2 dims as stored (row and column running means; a stacked (L, d) norm
scale is factored across its layers, vr (L,) and vc (d,)); 1-D leaves keep a
full second moment. The paper's GaLore + Adafactor setting ("Adafactor with
first-order statistics") is beta1 > 0 here.

The reference's order and dtypes, kept exactly: β2 = 1 − count^−decay_power
in f32 from the int32 count; eps added to g², not to the denominator; the
update-RMS clip over each whole leaf (stacked layers together), on the
device (no host read); then the f32 momentum on the clipped update; then
the cast to g's dtype.

State layout (the reference's): {"v": tree of {"vr", "vc"} | {"v"},
"count": int32, "m": tree (only with beta1)}, all f32.
"""
from __future__ import annotations

import math

import torch

from repro_torch.optim.transform import GradientTransformation, _device_of
from repro_torch.utils import flatten_up_to, tree_leaves, tree_map, tree_unflatten_like


def _rms(x):
    return torch.sqrt(x.square().mean() + 1e-30)


def _factored(p) -> bool:
    return p.ndim >= 2


def scale_by_adafactor(beta1: float | None = 0.9, decay_power: float = 0.8,
                       clip_threshold: float = 1.0, eps: float = 1e-30) -> GradientTransformation:
    def init(params):
        def per_leaf(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], **f32),  # row stats (last dim reduced)
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": torch.zeros(p.shape, **f32)}

        state = {"v": tree_map(per_leaf, params),
                 "count": torch.zeros((), dtype=torch.int32, device=_device_of(params))}
        if beta1 is not None:
            state["m"] = tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
        return state

    def update(grads, state, params=None):
        count = state["count"] + 1
        beta2 = 1.0 - count.float() ** (-decay_power)

        def per_leaf(g, v):
            g32 = g.float()
            g2 = g32.square() + eps
            if _factored(g):
                vr = beta2 * v["vr"] + (1 - beta2) * g2.mean(-1)
                vc = beta2 * v["vc"] + (1 - beta2) * g2.mean(-2)
                denom_r = vr / vr.mean(-1, keepdim=True)
                u = g32 / (denom_r.sqrt()[..., None] * vc.sqrt()[..., None, :])
                new_v = {"vr": vr, "vc": vc}
            else:
                vf = beta2 * v["v"] + (1 - beta2) * g2
                u, new_v = g32 / vf.sqrt(), {"v": vf}
            # update-RMS clipping (Adafactor's d = 1), over the whole leaf
            return u / torch.clamp(_rms(u) / clip_threshold, min=1.0), new_v

        pairs = [per_leaf(g, v) for g, v in zip(tree_leaves(grads),
                                                flatten_up_to(grads, state["v"]))]
        updates = tree_unflatten_like(grads, [u for u, _ in pairs])
        new_state = {"v": tree_unflatten_like(grads, [v for _, v in pairs]), "count": count}
        if beta1 is not None:
            m = tree_map(lambda m_, u: beta1 * m_ + (1 - beta1) * u, state["m"], updates)
            updates = m
            new_state["m"] = m
        updates = tree_map(lambda u, g: u.to(g.dtype), updates, grads)
        return updates, new_state

    return GradientTransformation(init, update)


def adafactor_state_bytes(params, beta1: float | None = 0.9) -> int:
    """Analytic bytes of scale_by_adafactor's statistics over `params` (any
    tree of tensors or shapes' holders; the int32 count left out): f32 m,
    4 B a parameter with beta1; f32 v, 4 B × (rows + columns) for a leaf of
    ≥ 2 dims (rows: all but the last dim, columns: all but the second to
    last), 4 B a parameter for a 1-D leaf."""
    total = 0
    for p in tree_leaves(params):
        shape = tuple(p.shape)
        n = math.prod(shape)
        if len(shape) >= 2:
            total += 4 * (math.prod(shape[:-1]) + math.prod(shape[:-2] + shape[-1:]))
        else:
            total += 4 * n
        if beta1 is not None:
            total += 4 * n
    return total
