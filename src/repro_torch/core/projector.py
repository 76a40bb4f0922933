"""Projector computation for GaLore: top-r singular subspace of the gradient
(port of the ``svd`` method of repro/core/projector.py).

``torch.linalg.svd`` and ``jnp.linalg.svd`` may choose different column
signs. GaLore's update αP·N̂(PᵀG) does not change when a column of P flips,
so callers compare updates, losses and ``subspace_overlap``, never P entry
by entry.
"""
from __future__ import annotations

import torch


def compute_projector(G: torch.Tensor, rank: int, *, method: str = "svd") -> torch.Tensor:
    """G (..., m, n) -> P (..., m, rank) f32, the top-`rank` left singular
    vectors of G in f32; leading (stacked-layer) dims are batched."""
    if method != "svd":
        raise NotImplementedError(f"projector method {method!r} is not ported yet")
    U, _, _ = torch.linalg.svd(G.float(), full_matrices=False)
    return U[..., :rank].contiguous()


def subspace_overlap(P: torch.Tensor, P_ref: torch.Tensor) -> torch.Tensor:
    """Mean squared principal cosine between two column subspaces (1.0 = same),
    per leading batch element."""
    M = P_ref.float().transpose(-1, -2) @ P.float()
    s = torch.linalg.svdvals(M)
    return s.square().mean(dim=-1)
