"""Public kernel API of the port (counterpart of repro/kernels/ops.py).

Each kernel wrapper dispatches on the device of its tensors — the plain
version for CPU tensors, the Hopper kernel for CUDA tensors. Every GaLore
step form routes each leaf as the reference does (repro/kernels/ops.py:
60-215), by the reference's ``fits_vmem`` on (kept side, rank, swept side,
G's itemsize): where it holds, one launch of the fused kernel; where it fails
(at llama_7b width, every leaf at r ≥ 512)
- the fp32 emit step ``galore_fused_adam_step[_right]`` composes the tiled
  projections around a plain Adam update, ``galore_project`` →
  ``lowrank_adam_update`` → ``galore_project_back``, with an int4 P
  dequantized first (the reference's B4/B5 fallback);
- the adam8 and ``*_apply_step*`` forms run their plain step (kernels/ref.py,
  ``torch.matmul`` and elementwise work, on CUDA tensors too) on the
  dequantized P, updating moments, codes and W in place as the kernels do:
  the reference runs plain jnp there, no Pallas kernel, so no kernel of the
  port is launched and none is counted. This is a route to the plain step on
  CUDA tensors chosen by size alone: ``fits_vmem`` is the TPU's VMEM budget,
  not a limit of the card, and the port takes it only because the reference
  runs plain jnp at those sizes. At r = 1024 the plain step is the faster of
  the two on the card (PERF.md §7); a kernel for this route is queued in
  ROADMAP Queue B.
Every GaLore step takes P either as f32 or as the packed int4 qstate. The
``*_apply_step*`` forms update the weight in place instead of returning G̃.
``adam8bit_step`` is the flat 8-bit Adam update of a whole leaf; ``rmsnorm``
is the counterpart of the reference's ``ops.rmsnorm``, which no model calls.
"""
from repro_torch.kernels import galore_fused
from repro_torch.kernels.adam8bit_update import adam8bit_update
from repro_torch.kernels.galore_fused import (
    _plain8_in_place,
    _plain_apply_in_place,
    fits_vmem,
)
from repro_torch.kernels.galore_project import galore_project, galore_project_back
from repro_torch.kernels.ref import _p_plain, lowrank_adam_update
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.quant import codec

__all__ = ["adam8bit_step", "galore_fused_adam8_apply_step", "launch_counts",
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


def _fits(P, G, right: bool, route_rank=None) -> bool:
    """The reference's dispatch predicate for this leaf: kept side, rank,
    swept side and G's itemsize. `route_rank` (GaLore-ZeRO, where P is one
    rank block) is the whole leaf's rank, which the route is decided at."""
    m, n = G.shape[-2:]
    kept, swept = (n, m) if right else (m, n)
    return fits_vmem(kept, route_rank or _p_rank(P), swept, G.element_size())


def _p_f32(P, G, right: bool):
    """The f32 P of the plain route: an int4 P dequantized along its kept side."""
    return _p_plain(P, G.shape[-1] if right else G.shape[-2])


def galore_fused_adam_step(P, G, M, V, count, *, b1=0.9, b2=0.999, eps=1e-8, alpha=1.0,
                           route_rank=None):
    """Left-side GaLore-Adam leaf step, routed as the reference routes it:
    the fused kernel (galore_fused.galore_fused_adam_step) where ``fits_vmem``
    holds, else R = galore_project(P, G) → Adam → G̃ = galore_project_back(P,
    N̂, α). Arguments and result as the fused wrapper's: M and V updated in
    place, G̃ (..., m, n) f32 returned. `route_rank` as ``_fits``'s."""
    if _fits(P, G, False, route_rank):
        return galore_fused.galore_fused_adam_step(P, G, M, V, count, b1=b1, b2=b2, eps=eps,
                                                   alpha=alpha)
    P = _p_f32(P, G, False).contiguous()  # an int4 P's dequant may be a view of its padded rows
    N, M_t, V_t = lowrank_adam_update(galore_project(P, G), M, V, count, b1, b2, eps)
    M.copy_(M_t)
    V.copy_(V_t)
    return galore_project_back(P, N, alpha), M, V


def galore_fused_adam_step_right(P, G, M, V, count, *, b1=0.9, b2=0.999, eps=1e-8, alpha=1.0,
                                 route_rank=None):
    """Right-side GaLore-Adam leaf step (P (..., n, r), M/V (..., m, r)),
    routed as the reference routes it: the fused kernel where ``fits_vmem``
    holds, else the tiled projections on swapped views — R = Pᵀ Gᵀ (G read
    transposed), Adam on Mᵀ/Vᵀ, G̃ᵀ = α P N̂ written transposed — so that no
    transposed copy of G or G̃ is made. M and V updated in place."""
    if _fits(P, G, True, route_rank):
        return galore_fused.galore_fused_adam_step_right(P, G, M, V, count, b1=b1, b2=b2,
                                                         eps=eps, alpha=alpha)
    P = _p_f32(P, G, True).contiguous()
    Mt, Vt = M.transpose(-1, -2), V.transpose(-1, -2)
    N, M_t, V_t = lowrank_adam_update(galore_project(P, G, transpose_g=True), Mt, Vt, count,
                                      b1, b2, eps)
    Mt.copy_(M_t)
    Vt.copy_(V_t)
    return galore_project_back(P, N.contiguous(), alpha, transpose_out=True), M, V


def _adam8(right, P, G, Mq, Ms, Vq, Vs, count, b1, b2, eps, alpha, stochastic, route_rank):
    name = "galore_fused_adam8_step" + ("_right" if right else "")
    if _fits(P, G, right, route_rank):
        return getattr(galore_fused, name)(P, G, Mq, Ms, Vq, Vs, count, b1=b1, b2=b2, eps=eps,
                                           alpha=alpha, stochastic=stochastic)
    return _plain8_in_place(getattr(galore_fused, name + "_plain"), _p_f32(P, G, right), G, Mq,
                            Ms, Vq, Vs, count, b1, b2, eps, alpha, stochastic)


def galore_fused_adam8_step(P, G, Mq, Ms, Vq, Vs, count, *, b1=0.9, b2=0.999, eps=1e-8,
                            alpha=1.0, stochastic=False, route_rank=None):
    """Left-side int8-moment leaf step, routed as the reference routes it: the
    int8 kernel where ``fits_vmem`` holds, else the plain step. Arguments and
    result as galore_fused.galore_fused_adam8_step's: codes and scales
    updated in place, G̃ (..., m, n) f32 returned."""
    return _adam8(False, P, G, Mq, Ms, Vq, Vs, count, b1, b2, eps, alpha, stochastic, route_rank)


def galore_fused_adam8_step_right(P, G, Mq, Ms, Vq, Vs, count, *, b1=0.9, b2=0.999, eps=1e-8,
                                  alpha=1.0, stochastic=False, route_rank=None):
    """Right-side int8-moment leaf step (codes (..., m, r), blocks along m),
    routed as the reference routes it."""
    return _adam8(True, P, G, Mq, Ms, Vq, Vs, count, b1, b2, eps, alpha, stochastic, route_rank)


def _apply(kernel, plain, right, P, G, W, moments, count, route_rank=None, **kw):
    if _fits(P, G, right, route_rank):
        return kernel(P, G, W, *moments, count, **kw)
    return _plain_apply_in_place(plain, _p_f32(P, G, right), G, W, moments, count, **kw)


def galore_fused_adam_apply_step(P, G, W, M, V, count, *, eta, b1=0.9, b2=0.999, eps=1e-8,
                                 alpha=1.0, wd=0.0, route_rank=None):
    """Left-side fp32-moment step with the weight update folded in, routed as
    the reference routes it: the apply kernel where ``fits_vmem`` holds, else
    the plain step. W, M and V updated in place; returns (W', M', V')."""
    return _apply(galore_fused.galore_fused_adam_apply_step,
                  galore_fused.galore_fused_adam_apply_step_plain, False, P, G, W, (M, V), count,
                  eta=eta, b1=b1, b2=b2, eps=eps, alpha=alpha, wd=wd, route_rank=route_rank)


def galore_fused_adam_apply_step_right(P, G, W, M, V, count, *, eta, b1=0.9, b2=0.999,
                                       eps=1e-8, alpha=1.0, wd=0.0, route_rank=None):
    """Right-side fp32-moment apply step, routed as the reference routes it."""
    return _apply(galore_fused.galore_fused_adam_apply_step_right,
                  galore_fused.galore_fused_adam_apply_step_right_plain, True, P, G, W, (M, V),
                  count, eta=eta, b1=b1, b2=b2, eps=eps, alpha=alpha, wd=wd,
                  route_rank=route_rank)


def galore_fused_adam8_apply_step(P, G, W, Mq, Ms, Vq, Vs, count, *, eta, b1=0.9, b2=0.999,
                                  eps=1e-8, alpha=1.0, wd=0.0, stochastic=False, route_rank=None):
    """Left-side int8-moment apply step, routed as the reference routes it.
    W, codes and scales updated in place; returns (W', Mq', Ms', Vq', Vs')."""
    return _apply(galore_fused.galore_fused_adam8_apply_step,
                  galore_fused.galore_fused_adam8_apply_step_plain, False, P, G, W,
                  (Mq, Ms, Vq, Vs), count, eta=eta, b1=b1, b2=b2, eps=eps, alpha=alpha, wd=wd,
                  stochastic=stochastic, route_rank=route_rank)


def galore_fused_adam8_apply_step_right(P, G, W, Mq, Ms, Vq, Vs, count, *, eta, b1=0.9,
                                        b2=0.999, eps=1e-8, alpha=1.0, wd=0.0, stochastic=False,
                                        route_rank=None):
    """Right-side int8-moment apply step, routed as the reference routes it."""
    return _apply(galore_fused.galore_fused_adam8_apply_step_right,
                  galore_fused.galore_fused_adam8_apply_step_right_plain, True, P, G, W,
                  (Mq, Ms, Vq, Vs), count, eta=eta, b1=b1, b2=b2, eps=eps, alpha=alpha, wd=wd,
                  stochastic=stochastic, route_rank=route_rank)


def launch_counts() -> dict:
    """Every kernel wrapper's launches since the last reset, by wrapper name;
    "<name>.int4" the fp32-moment forms' launches on an int4 P, and
    "<name>.thread_copy" the launches that copied their operands by the
    threads (a run's report, launch/train.py)."""
    out = {}
    for fn in galore_fused.WRAPPERS + (adam8bit_update, galore_project, galore_project_back,
                                       rmsnorm):
        out[fn.__name__] = fn.launches
        for attr in ("launches_int4", "launches_thread_copy"):
            if hasattr(fn, attr):
                out[fn.__name__ + "." + attr.removeprefix("launches_")] = getattr(fn, attr)
    return out


def reset_launch_counts() -> None:
    """Zero every kernel wrapper's launch counts."""
    galore_fused.reset_launch_counts()
    for fn in (adam8bit_update, galore_project, galore_project_back, rmsnorm):
        fn.launches = 0
    galore_project.launches_thread_copy = galore_project_back.launches_thread_copy = 0
