"""Projector computation for GaLore: top-r singular subspace of the gradient
(port of the ``svd`` method of repro/core/projector.py), and the projector's
persistent storage forms (fp32, bf16, packed int4).

``torch.linalg.svd`` and ``jnp.linalg.svd`` may choose different column
signs. GaLore's update αP·N̂(PᵀG) does not change when a column of P flips,
so callers compare updates, losses and ``subspace_overlap``, never P entry
by entry.
"""
from __future__ import annotations

import torch

from repro_torch.quant import codec


def compute_projector(G: torch.Tensor, rank: int, *, method: str = "svd") -> torch.Tensor:
    """G (..., m, n) -> P (..., m, rank) f32, the top-`rank` left singular
    vectors of G in f32; leading (stacked-layer) dims are batched."""
    if method != "svd":
        raise NotImplementedError(f"projector method {method!r} is not ported yet")
    U, _, _ = torch.linalg.svd(G.float(), full_matrices=False)
    return U[..., :rank].contiguous()


# Projector storage. The persistent copy of P between refreshes is fp32, bf16,
# or packed INT4 in the axis-blocked layout the fused kernel reads directly
# (quant/codec.py::quantize4_axis); consumers read it through
# `read_projector`, so an f32 P exists only transiently.


def store_projector(P: torch.Tensor, mode: str = "fp32"):
    """f32 projector -> its persistent storage form (tensor or int4 qstate)."""
    if mode == "fp32":
        return P.to(torch.float32)
    if mode == "bf16":
        return P.to(torch.bfloat16)
    if mode == "int4":
        return codec.quant4_axis_state(P)
    raise ValueError(f"unknown projector storage mode {mode!r}")


def read_projector(stored, shape=None) -> torch.Tensor:
    """Dequant-on-read: storage form -> f32 P (`shape` required for int4).
    Reads the axis-blocked int4 layout that `store_projector` writes; the
    reference's legacy flat layout (old checkpoints) is not ported."""
    if codec.is_axis4_qstate(stored):
        if shape is None:
            raise ValueError("an int4 projector read needs the logical shape")
        return codec.dequant4_axis_state(stored, shape)
    if codec.is_qstate(stored):
        raise NotImplementedError("the flat int4 projector layout is not ported")
    return stored.to(torch.float32)


def init_projector_state(shape, mode: str = "fp32", device=None):
    """Zeros in the requested storage form (int4 zeros round-trip exactly)."""
    return store_projector(torch.zeros(shape, dtype=torch.float32, device=device), mode)


def subspace_overlap(P: torch.Tensor, P_ref: torch.Tensor) -> torch.Tensor:
    """Mean squared principal cosine between two column subspaces (1.0 = same),
    per leading batch element."""
    M = P_ref.float().transpose(-1, -2) @ P.float()
    s = torch.linalg.svdvals(M)
    return s.square().mean(dim=-1)
