"""Per-leaf GaLore plans and the every-T refresh (port of the global-rank,
unstaggered part of repro/core/subspace.py, with its poison-proof refresh:
``tree_all_finite``, ``projector_or_fallback`` and the ``guard_refresh``
gate).

A leaf projects iff it is at least 2-D, its path names no excluded module,
and min(m, n) > max(rank, min_dim); it projects on the left (R = PᵀG) iff
m ≤ n, else on the right (R = GP). Every plan shares the config's rank and
period T, and every leaf refreshes at galore steps 0, T, 2T, … (the
reference's schedule with its stagger off). Each plan also carries the
leaf's storage modes, resolved once from ``GaLoreConfig.quant`` against the
leaf's full element count: ``moments`` (fp32 | int8) and ``proj_store``
(fp32 | bf16 | int4).

Under ``GaLoreConfig.guard_refresh`` a gradient with a non-finite element
makes the whole refresh a no-op (every projector kept; each leaf retries at
its next due step), and an SVD that fails — a non-finite P, or a
``torch.linalg.LinAlgError`` — falls back to the randomized projector. The
reference decides both inside its program; the port reads each verdict on
the host, only at a step where some leaf is due.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import GaLoreConfig
from repro_torch.core.projector import compute_projector, sketch_generator, store_projector
from repro_torch.utils import (
    flatten_up_to,
    tree_leaves,
    tree_leaves_with_path,
    tree_unflatten_like,
)

DEFAULT_EXCLUDE = ("embed", "dec_pos")


@dataclasses.dataclass(frozen=True)
class SubspacePlan:
    """Per-leaf subspace decision."""

    galore: bool
    side: str = "left"  # "left": R = P^T G ; "right": R = G P
    rank: int = 0  # projection rank (0 for non-galore leaves)
    refresh_period: int = 0  # T
    moments: str = "fp32"  # "fp32" | "int8": Adam M/V storage (compact or full-shape)
    proj_store: str = "fp32"  # "fp32" | "bf16" | "int4": persistent P storage


def moment_quant_axis(plan: SubspacePlan) -> int:
    """Blocked axis of an int8 moment leaf: the fused kernel's swept axis for
    galore leaves (last on the left, second-to-last on the right), the last
    axis for full-shape passthrough leaves."""
    if not plan.galore:
        return -1
    return -1 if plan.side == "left" else -2


def proj_shape(p, plan: SubspacePlan) -> tuple:
    """Shape of the leaf's projector P (kept dim × plan.rank)."""
    m, n = p.shape[-2], p.shape[-1]
    return tuple(p.shape[:-2]) + ((m if plan.side == "left" else n), plan.rank)


def r_shape(p, plan: SubspacePlan) -> tuple:
    """Shape of the leaf's compact (projected) gradient / moments."""
    m, n = p.shape[-2], p.shape[-1]
    if plan.side == "left":
        return tuple(p.shape[:-2]) + (plan.rank, n)
    return tuple(p.shape[:-2]) + (m, plan.rank)


def tree_all_finite(tree) -> torch.Tensor:
    """0-d bool tensor: every element of every float leaf is finite."""
    checks = [torch.isfinite(x).all() for x in tree_leaves(tree)
              if isinstance(x, torch.Tensor) and x.is_floating_point()]
    if not checks:
        return torch.tensor(True)
    return torch.stack(checks).all()


def projector_or_fallback(P_primary, G_in, rank: int, generator, power_iters: int):
    """P_primary when it is there and finite, else the randomized projector
    of G_in (an SVD that fails to converge returns NaN or raises; without
    this a single failure would poison P until the next refresh)."""
    if P_primary is not None and bool(torch.isfinite(P_primary).all()):
        return P_primary
    return compute_projector(G_in, rank, method="randomized", generator=generator,
                             power_iters=power_iters)


def compute_leaf_projector(g, plan: SubspacePlan, cfg: GaLoreConfig, key=None, step: int = 0):
    """Top-rank subspace of one leaf's gradient; right leaves project Gᵀ. The
    randomized methods (and the guarded SVD's fallback) draw their sketch
    from ``sketch_generator(key, step)``, the same for every leaf, as the
    reference folds one key for every leaf."""
    G_in = g if plan.side == "left" else g.transpose(-1, -2)
    gen = sketch_generator(key, step)
    if not (cfg.guard_refresh and cfg.projector == "svd"):
        return compute_projector(G_in, plan.rank, method=cfg.projector, generator=gen,
                                 power_iters=cfg.power_iters)
    try:
        P = compute_projector(G_in, plan.rank)
    except torch.linalg.LinAlgError:
        P = None
    return projector_or_fallback(P, G_in, plan.rank, gen, cfg.power_iters)


class SubspaceManager:
    """Computes per-leaf SubspacePlans and drives the refresh."""

    def __init__(self, cfg: GaLoreConfig, exclude=DEFAULT_EXCLUDE):
        self.cfg = cfg
        self.exclude = exclude

    def plans(self, params):
        """Tree of SubspacePlan mirroring `params`."""
        cfg = self.cfg
        out = []
        for path, p in tree_leaves_with_path(params):
            # the min_quant_size floor is held against the weight's size,
            # not the compact moment's (quant/policy.py)
            moments, proj_store = cfg.quant.resolve(path, math.prod(p.shape))
            if p.ndim < 2 or any(e in path for e in self.exclude):
                out.append(SubspacePlan(False, moments=moments))
                continue
            m, n = p.shape[-2], p.shape[-1]
            if min(m, n) <= max(cfg.rank, cfg.min_dim):
                out.append(SubspacePlan(False, moments=moments))
                continue
            out.append(SubspacePlan(True, "left" if m <= n else "right",
                                    rank=cfg.rank, refresh_period=cfg.update_freq,
                                    moments=moments, proj_store=proj_store))
        return tree_unflatten_like(params, out)

    @staticmethod
    def leaf_due(plan: SubspacePlan, step: int) -> bool:
        """Whether a galore leaf refreshes at galore step `step`."""
        return step % plan.refresh_period == 0

    def refresh_tree(self, grads, proj, plans, step: int, key=None):
        """New projector tree: the due leaves recomputed from `grads` and
        stored in their plan's form (fp32, bf16 or a packed int4 qstate).
        `key` (the galore state's uint32[2]) seeds the randomized sketches.

        With ``quant.lazy_refresh`` an int4 leaf whose new codes equal the
        stored ones keeps its stored state, scales included (Q-GaLore: the
        refresh did not move the projector at 4-bit resolution). With
        ``guard_refresh`` a non-finite gradient keeps every projector."""
        lazy = self.cfg.quant.lazy_refresh
        flat_plans = tree_leaves(plans)
        if (self.cfg.guard_refresh
                and any(pl.galore and self.leaf_due(pl, step) for pl in flat_plans)
                and not bool(tree_all_finite(grads))):
            return proj

        def refresh(g, P, plan):
            if not (plan.galore and self.leaf_due(plan, step)):
                return P
            new = store_projector(compute_leaf_projector(g, plan, self.cfg, key, step),
                                  plan.proj_store)
            if lazy and plan.proj_store == "int4" and torch.equal(new["q"], P["q"]):
                return P
            return new

        out = [refresh(g, P, plan) for g, P, plan in zip(
            tree_leaves(grads), flatten_up_to(grads, proj), flat_plans)]
        return tree_unflatten_like(grads, out)
