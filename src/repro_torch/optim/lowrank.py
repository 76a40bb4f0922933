"""The paper's low-rank weight baselines (Table 2): LoRA, ReLoRA and naive
low-rank factorisation (port of repro/optim/lowrank.py).

LoRA:    W_eff = W0 + (alpha/r)·B A, train (A, B), W0 frozen.
ReLoRA:  LoRA + a periodic merge of s·BA into W0 with the adaptors (and the
         optimizer's state) reset.
LowRank: W = s·B A trained from scratch (Kamalakara et al., 2022), W0 unused.

A parameter-space wrapper: ``init_adaptors`` chooses the adapted leaves (≥ 2
dims, no excluded path, min(m, n) > r) and ``merge`` materialises the
effective weights for the unchanged forward pass, so gradients flow only
into the adaptors. A is drawn from a ``torch.Generator`` (torch cannot
reproduce ``jax.random.normal``; tests hand the reference's A across through
``bridge.py``), B starts at 0.

These methods train no GaLore state and have no launcher flag, as in the
reference, whose launcher has none either: its training loop for them is
``benchmarks/table2_methods.py::_train_lowrank`` (Adam on the adaptors, a
constant −lr, a fresh Adam state at each ReLoRA merge). The port writes that
loop where it runs it, with this module, ``models/model.loss_fn`` and
``optim/adam.scale_by_adam``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.utils import tree_leaves, tree_map_with_path, tree_unflatten_like

DEFAULT_EXCLUDE = ("embed", "dec_pos", "norm", "ln", "bias", "router", "A_log", "dt_bias", "D")


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 32.0
    mode: str = "lora"  # lora | relora | lowrank
    merge_freq: int = 0  # relora merge period


def _adapted(path: str, leaf, rank: int) -> bool:
    if not isinstance(leaf, torch.Tensor) or leaf.ndim < 2:
        return False
    if any(e in path for e in DEFAULT_EXCLUDE):
        return False
    return min(leaf.shape[-2], leaf.shape[-1]) > rank


def _is_adaptor(x) -> bool:
    return isinstance(x, dict) and set(x) == {"A", "B"}


def init_adaptors(params, cfg: LoraConfig, generator: torch.Generator):
    """Adaptor tree mirroring params: {"A": (…, r, n) ~ N(0, 1/r), "B":
    (…, m, r) zeros} f32 on each adapted leaf's device, both requiring
    grad, and a 0-d f32 zero on every other leaf. A is drawn from
    `generator`, leaf by leaf in flatten order (the generator must live on
    the params' device)."""

    def per_leaf(path, p):
        if not _adapted(path, p, cfg.rank):
            return torch.zeros((), dtype=torch.float32, device=p.device)
        lead, (m, n) = tuple(p.shape[:-2]), tuple(p.shape[-2:])
        A = torch.randn(lead + (cfg.rank, n), generator=generator, dtype=torch.float32,
                        device=p.device) * (cfg.rank ** -0.5)
        B = torch.zeros(lead + (m, cfg.rank), dtype=torch.float32, device=p.device)
        return {"A": A.requires_grad_(True), "B": B.requires_grad_(True)}

    return tree_map_with_path(per_leaf, params)


def _over_adaptors(fn, params, adaptors):
    """fn(p, adaptor) on every adapted leaf; other leaves of params as they
    are."""
    if isinstance(params, dict):
        return {k: _over_adaptors(fn, params[k], adaptors[k]) for k in sorted(params)}
    if isinstance(params, (list, tuple)):
        return type(params)(_over_adaptors(fn, p, a) for p, a in zip(params, adaptors))
    return fn(params, adaptors) if _is_adaptor(adaptors) else params


def _delta(a, s: float):
    return s * (a["B"] @ a["A"])  # f32


def merge(params, adaptors, cfg: LoraConfig):
    """Effective weights: W0 (detached; unused in lowrank mode) + s·BA, the
    sum in f32 and cast to W's dtype, as the reference casts it. The f32
    delta of a leaf is freed before the next leaf's is made."""
    s = cfg.alpha / cfg.rank

    def per_leaf(p, a):
        if cfg.mode == "lowrank":
            return _delta(a, s).to(p.dtype)
        return (p.detach() + _delta(a, s)).to(p.dtype)

    return _over_adaptors(per_leaf, params, adaptors)


@torch.no_grad()
def relora_merge(params, adaptors, cfg: LoraConfig, generator: torch.Generator):
    """Fold s·BA into W0 (cast to W's dtype) and re-initialise the adaptors
    from `generator` (the ReLoRA reset). Returns (params', adaptors'); the
    folded weights are new tensors that keep the old ones' requires_grad."""
    s = cfg.alpha / cfg.rank

    def fold(p, a):
        return (p.detach() + _delta(a, s)).to(p.dtype).requires_grad_(p.requires_grad)

    new_params = _over_adaptors(fold, params, adaptors)
    return new_params, init_adaptors(new_params, cfg, generator)


def adaptor_param_count(adaptors) -> int:
    """Elements of every adaptor matrix (leaves of ≥ 2 dims)."""
    return sum(math.prod(t.shape) for t in tree_leaves(adaptors) if t.ndim >= 2)


def adaptor_grads(loss, adaptors):
    """d loss / d adaptors as a tree shaped like `adaptors`: A's and B's
    gradients, and a 0-d zero on each placeholder (as ``jax.grad`` gives
    the reference's placeholders)."""
    leaves = tree_leaves(adaptors)
    grads = iter(torch.autograd.grad(loss, [t for t in leaves if t.ndim >= 2]))
    return tree_unflatten_like(adaptors, [next(grads) if t.ndim >= 2 else torch.zeros_like(t)
                                          for t in leaves])
