"""Per-leaf GaLore plans and the every-T refresh (port of the global-rank,
unstaggered part of repro/core/subspace.py).

A leaf projects iff it is at least 2-D, its path names no excluded module,
and min(m, n) > max(rank, min_dim); it projects on the left (R = PᵀG) iff
m ≤ n, else on the right (R = GP). Every plan shares the config's rank and
period T, and every leaf refreshes at galore steps 0, T, 2T, … (the
reference's schedule with its stagger off).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import GaLoreConfig
from repro_torch.core.projector import compute_projector
from repro_torch.utils import tree_leaves_with_path, tree_unflatten_like

DEFAULT_EXCLUDE = ("embed", "dec_pos")


@dataclasses.dataclass(frozen=True)
class SubspacePlan:
    """Per-leaf subspace decision."""

    galore: bool
    side: str = "left"  # "left": R = P^T G ; "right": R = G P
    rank: int = 0  # projection rank (0 for non-galore leaves)
    refresh_period: int = 0  # T


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


def compute_leaf_projector(g, plan: SubspacePlan, cfg: GaLoreConfig):
    """Top-rank subspace of one leaf's gradient; right leaves project Gᵀ."""
    G_in = g if plan.side == "left" else g.transpose(-1, -2)
    return compute_projector(G_in, plan.rank, method=cfg.projector)


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
            if p.ndim < 2 or any(e in path for e in self.exclude):
                out.append(SubspacePlan(False))
                continue
            m, n = p.shape[-2], p.shape[-1]
            if min(m, n) <= max(cfg.rank, cfg.min_dim):
                out.append(SubspacePlan(False))
                continue
            out.append(SubspacePlan(True, "left" if m <= n else "right",
                                    rank=cfg.rank, refresh_period=cfg.update_freq))
        return tree_unflatten_like(params, out)

    @staticmethod
    def leaf_due(plan: SubspacePlan, step: int) -> bool:
        """Whether a galore leaf refreshes at galore step `step`."""
        return step % plan.refresh_period == 0

    def refresh_tree(self, grads, proj, plans, step: int):
        """New projector tree: the due leaves recomputed from `grads`."""
        flat_g = [g for _, g in tree_leaves_with_path(grads)]
        flat_p = [P for _, P in tree_leaves_with_path(proj)]
        flat_plan = [pl for _, pl in tree_leaves_with_path(plans)]
        out = [
            compute_leaf_projector(g, plan, self.cfg)
            if plan.galore and self.leaf_due(plan, step) else P
            for g, P, plan in zip(flat_g, flat_p, flat_plan)
        ]
        return tree_unflatten_like(proj, out)
