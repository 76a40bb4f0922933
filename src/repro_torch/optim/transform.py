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

from repro_torch.utils import tree_leaves, tree_map


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


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def update(grads, state, params=None):
        gnorm = torch.sqrt(sum(x.float().square().sum() for x in tree_leaves(grads)))
        factor = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
        return tree_map(lambda x: (x.float() * factor).to(x.dtype), grads), state

    return GradientTransformation(lambda p: (), update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    """AdamW-style decoupled weight decay: update += wd * param."""

    def update(grads, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs params")
        if weight_decay == 0.0:
            return grads, state
        return tree_map(lambda g, p: g + weight_decay * p.to(g.dtype), grads, params), state

    return GradientTransformation(lambda p: (), update)


@torch.no_grad()
def apply_updates(params, updates):
    """params += updates, in place, each update cast to its parameter's dtype
    first (the reference's ``(p + u.astype(p.dtype)).astype(p.dtype)``).
    Returns `params`."""
    tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)
    return params
