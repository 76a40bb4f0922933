"""Public kernel API of the port (counterpart of repro/kernels/ops.py).

Each kernel wrapper dispatches on the device of its tensors — the plain
version for CPU tensors, the Hopper kernel for CUDA tensors. The fp32 emit
steps ``galore_fused_adam_step[_right]`` route each leaf as the reference
does (repro/kernels/ops.py:60-105): where the reference's ``fits_vmem``
holds, one launch of the fused kernel; elsewhere (at llama_7b width, every
leaf at r ≥ 512) the tiled projections around a plain Adam update,
``galore_project`` → ``lowrank_adam_update`` → ``galore_project_back``, with
an int4 P dequantized first. The adam8 and ``*_apply_step*`` forms launch
their kernels at every rank: where their shape fails ``fits_vmem`` the
reference runs only plain jnp (ops.py:127-130, :161-163), so no TPU kernel is
replaced there, and the port's streaming kernels compute the same function.
Every GaLore step takes P either as f32 or as the packed int4 qstate. The
``*_apply_step*`` forms update the weight in place instead of returning G̃.
``adam8bit_step`` is the flat 8-bit Adam update of a whole leaf; ``rmsnorm``
is the counterpart of the reference's ``ops.rmsnorm``, which no model calls.
"""
from repro_torch.kernels import galore_fused
from repro_torch.kernels.adam8bit_update import adam8bit_update
from repro_torch.kernels.galore_fused import (
    fits_vmem,
    galore_fused_adam8_apply_step,
    galore_fused_adam8_apply_step_right,
    galore_fused_adam8_step,
    galore_fused_adam8_step_right,
    galore_fused_adam_apply_step,
    galore_fused_adam_apply_step_right,
)
from repro_torch.kernels.galore_project import galore_project, galore_project_back
from repro_torch.kernels.ref import _p_plain, lowrank_adam_update
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.quant import codec

__all__ = ["adam8bit_step", "galore_fused_adam8_apply_step",
           "galore_fused_adam8_apply_step_right", "galore_fused_adam8_step",
           "galore_fused_adam8_step_right", "galore_fused_adam_apply_step",
           "galore_fused_adam_apply_step_right", "galore_fused_adam_step",
           "galore_fused_adam_step_right", "galore_project", "galore_project_back",
           "lowrank_adam_update", "reset_launch_counts", "rmsnorm"]


# fused dequant → Adam → requant of one leaf on the flat (nb, 256) blocks of
# its moments (the leaf in any shape, or its (nb, 256) block view)
adam8bit_step = adam8bit_update


def _p_rank(P) -> int:
    """Rank of a projector given as an f32 tensor or a packed int4 qstate."""
    return (P["q"] if codec.is_qstate(P) else P).shape[-1]


def galore_fused_adam_step(P, G, M, V, count, *, b1=0.9, b2=0.999, eps=1e-8, alpha=1.0):
    """Left-side GaLore-Adam leaf step, routed as the reference routes it:
    the fused kernel (galore_fused.galore_fused_adam_step) where ``fits_vmem``
    holds, else R = galore_project(P, G) → Adam → G̃ = galore_project_back(P,
    N̂, α). Arguments and result as the fused wrapper's: M and V updated in
    place, G̃ (..., m, n) f32 returned."""
    m, n = G.shape[-2:]
    if fits_vmem(m, _p_rank(P), n, G.element_size()):
        return galore_fused.galore_fused_adam_step(P, G, M, V, count, b1=b1, b2=b2, eps=eps,
                                                   alpha=alpha)
    P = _p_plain(P, m).contiguous()  # an int4 P's dequant may be a view of its padded rows
    N, M_t, V_t = lowrank_adam_update(galore_project(P, G), M, V, count, b1, b2, eps)
    M.copy_(M_t)
    V.copy_(V_t)
    return galore_project_back(P, N, alpha), M, V


def galore_fused_adam_step_right(P, G, M, V, count, *, b1=0.9, b2=0.999, eps=1e-8, alpha=1.0):
    """Right-side GaLore-Adam leaf step (P (..., n, r), M/V (..., m, r)),
    routed as the reference routes it: the fused kernel where ``fits_vmem``
    holds, else the tiled projections on swapped views — R = Pᵀ Gᵀ (G read
    transposed), Adam on Mᵀ/Vᵀ, G̃ᵀ = α P N̂ written transposed — so that no
    transposed copy of G or G̃ is made. M and V updated in place."""
    m, n = G.shape[-2:]
    if fits_vmem(n, _p_rank(P), m, G.element_size()):
        return galore_fused.galore_fused_adam_step_right(P, G, M, V, count, b1=b1, b2=b2,
                                                         eps=eps, alpha=alpha)
    P = _p_plain(P, n).contiguous()
    Mt, Vt = M.transpose(-1, -2), V.transpose(-1, -2)
    N, M_t, V_t = lowrank_adam_update(galore_project(P, G, transpose_g=True), Mt, Vt, count,
                                      b1, b2, eps)
    Mt.copy_(M_t)
    Vt.copy_(V_t)
    return galore_project_back(P, N.contiguous(), alpha, transpose_out=True), M, V


def reset_launch_counts() -> None:
    """Zero every kernel wrapper's launch counts."""
    galore_fused.reset_launch_counts()
    for fn in (adam8bit_update, galore_project, galore_project_back, rmsnorm):
        fn.launches = 0
