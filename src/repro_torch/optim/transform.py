"""Minimal optax-style gradient-transformation core (port of repro/optim/transform.py).

A GradientTransformation is (init, update):
    state            = init(params)
    updates, state   = update(grads, state, params)
`apply_updates(params, updates)` adds them. Composition is via `chain`. The op
order and dtype promotions are the reference's: a bf16 leaf times an f32
scalar is computed in f32, as JAX promotes it, before any cast back.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils import tree_leaves, tree_map, tree_map_with_path


class GradientTransformation(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init, update)


def identity() -> GradientTransformation:
    return GradientTransformation(lambda p: (), lambda g, s, p=None: (g, s))


def scale(factor: float) -> GradientTransformation:
    return GradientTransformation(lambda p: (),
                                  lambda g, s, p=None: (tree_map(lambda x: x * factor, g), s))


def _device_of(tree) -> torch.device:
    return tree_leaves(tree)[0].device


def scale_by_schedule(schedule: Callable[[torch.Tensor], torch.Tensor]) -> GradientTransformation:
    """updates * schedule(count), count kept as an int32 tensor on the params'
    device so the step needs no host sync."""

    def init(params):
        return {"count": torch.zeros((), dtype=torch.int32, device=_device_of(params))}

    def update(grads, state, params=None):
        count = state["count"] + 1
        s = schedule(count)
        return tree_map(lambda x: x.float() * s, grads), {"count": count}

    return GradientTransformation(init, update)


def clip_factor(grads, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / (global norm + 1e-9)), 0-d f32 on the device. Each
    leaf is squared in its own f32 copy (one temporary a leaf, not two)."""
    gnorm = torch.sqrt(sum(x.to(torch.float32, copy=True).square_().sum()
                           for x in tree_leaves(grads)))
    return torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def update(grads, state, params=None):
        factor = clip_factor(grads, max_norm)
        return tree_map(lambda x: (x.float() * factor).to(x.dtype), grads), state

    return GradientTransformation(lambda p: (), update)


def clip_in_place(grads, max_norm: float):
    """clip_by_global_norm's arithmetic written into `grads` itself, a
    leading slab at a time: the same values, without a second gradient tree
    or a full-leaf f32 copy beside the first (a stacked MoE expert leaf is
    billions of elements). Returns `grads`."""
    factor = clip_factor(grads, max_norm)
    for x in tree_leaves(grads):
        for slab in (x.unbind(0) if x.ndim > 2 else (x,)):
            slab.copy_((slab.float() * factor).to(slab.dtype))
    return grads


def add_decayed_weights(weight_decay: float, mask=None) -> GradientTransformation:
    """AdamW-style decoupled weight decay: update += wd * param, on every
    leaf or, with `mask` (a predicate on the leaf's dotted path), on the
    leaves it accepts."""

    def update(grads, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs params")
        if weight_decay == 0.0:
            return grads, state

        def add(path, g, p):
            if mask is not None and not mask(path):
                return g
            return g + weight_decay * p.to(g.dtype)

        return tree_map_with_path(add, grads, params), state

    return GradientTransformation(lambda p: (), update)


def trace(momentum: float, nesterov: bool = False) -> GradientTransformation:
    """Heavy-ball momentum (SGD with momentum): an f32 trace m = μ·m + g per
    leaf; the update (m, or μ·m + g with `nesterov`) is cast to g's dtype."""

    def init(params):
        return tree_zeros_like_f32(params)

    def update(grads, state, params=None):
        new_state = tree_map(lambda m, g: momentum * m + g.float(), state, grads)
        if nesterov:
            out = tree_map(lambda m, g: (momentum * m + g.float()).to(g.dtype), new_state, grads)
        else:
            out = tree_map(lambda m, g: m.to(g.dtype), new_state, grads)
        return out, new_state

    return GradientTransformation(init, update)


@torch.no_grad()
def apply_updates(params, updates):
    """params += updates, in place, each update cast to its parameter's dtype
    first (the reference's ``(p + u.astype(p.dtype)).astype(p.dtype)``).
    Returns `params`."""
    tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)
    return params


def tree_zeros_like_f32(tree):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device), tree)
