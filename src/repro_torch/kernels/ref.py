"""Plain PyTorch versions of the kernels (port of repro/kernels/ref.py): the
tiled projections R = PᵀG and G̃ = α P N, the GaLore-Adam leaf steps — the
fp32-moment step and the int8-moment step, each in its emit form (returns G̃)
and its weight-apply form (returns W' = W + η(G̃ + wd·W) in W's dtype), P f32
or a packed int4 qstate — the flat 8-bit Adam update on (nb, 256) blocks, and
RMSNorm.

They are the numerical ground truth for the Hopper kernels in
``csrc/galore_epilogue.cu``, ``csrc/galore_project.cu`` and ``csrc/rmsnorm.cu``,
and what the kernel wrappers run on CPU tensors. Pure functions: they return
new weights and moments (or codes and scales) and leave their inputs
untouched.
"""
from __future__ import annotations

import torch

from repro_torch.quant import codec
from repro_torch.quant.codec import dequantize_blocks, quantize_blocks  # noqa: F401


def galore_project(P, G):
    """R = Pᵀ G.  P (..., m, r), G (..., m, n) -> (..., r, n) f32."""
    return P.float().transpose(-1, -2) @ G.float()


def galore_project_back(P, N, alpha: float):
    """G̃ = α · P N.  P (..., m, r), N (..., r, n) -> (..., m, n) f32."""
    return alpha * (P.float() @ N.float())


def galore_project_right(P, G):
    """R = G P.  P (..., n, r), G (..., m, n) -> (..., m, r) f32."""
    return G.float() @ P.float()


def galore_project_back_right(P, N, alpha: float):
    """G̃ = α · N Pᵀ.  P (..., n, r), N (..., m, r) -> (..., m, n) f32."""
    return alpha * (N.float() @ P.float().transpose(-1, -2))


def lowrank_adam_update(R, M, V, count, b1=0.9, b2=0.999, eps=1e-8):
    """Adam moment update + bias-corrected normalized step, in f32.

    R, M, V same shape; count an int tensor (the step number, ≥ 1).
    Returns (N_t, M_t, V_t)."""
    R = R.float()
    M_t = b1 * M + (1 - b1) * R
    V_t = b2 * V + (1 - b2) * R.square()
    t = torch.as_tensor(count).float()
    c1 = 1 - b1 ** t
    c2 = 1 - b2 ** t
    N_t = (M_t / c1) / (torch.sqrt(V_t / c2) + eps)
    return N_t, M_t, V_t


def _p_plain(P, short: int):
    """f32 P from either an f32 tensor or a packed int4 qstate."""
    if codec.is_qstate(P):
        return codec.dequantize4_axis(P["q"], P["scale"], short)
    return P


def galore_fused_adam_step(P, G, M, V, count, b1=0.9, b2=0.999, eps=1e-8, alpha=1.0):
    """Left-side leaf update: R = PᵀG → Adam → G̃ = α P N̂.

    P (..., m, r) f32 or a packed int4 qstate, G (..., m, n), M/V (..., r, n)
    f32. Returns (G̃ f32, M_t, V_t)."""
    P = _p_plain(P, G.shape[-2])
    N_t, M_t, V_t = lowrank_adam_update(galore_project(P, G), M, V, count, b1, b2, eps)
    return galore_project_back(P, N_t, alpha), M_t, V_t


def galore_fused_adam_step_right(P, G, M, V, count, b1=0.9, b2=0.999, eps=1e-8, alpha=1.0):
    """Right-side leaf update: R = G P → Adam → G̃ = α N̂ Pᵀ.

    P (..., n, r) f32 or a packed int4 qstate, G (..., m, n), M/V (..., m, r)
    f32. Returns (G̃ f32, M_t, V_t)."""
    P = _p_plain(P, G.shape[-1])
    N_t, M_t, V_t = lowrank_adam_update(galore_project_right(P, G), M, V, count, b1, b2, eps)
    return galore_project_back_right(P, N_t, alpha), M_t, V_t


def _adam8(R, Mq, Ms, Vq, Vs, count, b1, b2, eps, stochastic, axis):
    """dequant M/V → Adam on R → requant, blocks along `axis`."""
    m = codec.dequantize_axis(Mq, Ms, axis=axis, signed=True)
    v = codec.dequantize_axis(Vq, Vs, axis=axis, signed=False)
    N_t, M_t, V_t = lowrank_adam_update(R, m, v, count, b1, b2, eps)
    mq, ms = codec.quantize_axis(M_t, axis=axis, signed=True, stochastic=stochastic,
                                 count=count, salt=codec.SR_SALT_M)
    vq, vs = codec.quantize_axis(V_t, axis=axis, signed=False, stochastic=stochastic,
                                 count=count, salt=codec.SR_SALT_V)
    return N_t, (mq, ms, vq, vs)


def galore_fused_adam8_step(P, G, Mq, Ms, Vq, Vs, count, b1=0.9, b2=0.999, eps=1e-8,
                            alpha=1.0, stochastic=False):
    """Left-side leaf update with int8 moments: R = PᵀG → dequant M/V → Adam →
    requant → G̃ = α P N̂.

    P (..., m, r) f32 or a packed int4 qstate; G (..., m, n); codes Mq/Vq
    (..., r, n) u8 and scales Ms/Vs (..., r, ⌈n/128⌉) f32, blocks along n.
    Returns (G̃ f32, Mq', Ms', Vq', Vs')."""
    P = _p_plain(P, G.shape[-2])
    N_t, q = _adam8(galore_project(P, G), Mq, Ms, Vq, Vs, count, b1, b2, eps, stochastic, -1)
    return (galore_project_back(P, N_t, alpha),) + q


def galore_fused_adam8_step_right(P, G, Mq, Ms, Vq, Vs, count, b1=0.9, b2=0.999, eps=1e-8,
                                  alpha=1.0, stochastic=False):
    """Right-side leaf update with int8 moments: R = G P → … → G̃ = α N̂ Pᵀ.

    P (..., n, r) f32 or a packed int4 qstate; codes (..., m, r), scales
    (..., ⌈m/128⌉, r), blocks along m. Returns (G̃ f32, Mq', Ms', Vq', Vs')."""
    P = _p_plain(P, G.shape[-1])
    N_t, q = _adam8(galore_project_right(P, G), Mq, Ms, Vq, Vs, count, b1, b2, eps,
                    stochastic, -2)
    return (galore_project_back_right(P, N_t, alpha),) + q


def apply_weight(W, gt, eta, wd: float):
    """W' = W + η·(G̃ + wd·W), in f32 in this order, then cast to W's dtype."""
    w32 = W.float()
    return (w32 + eta * (gt + wd * w32)).to(W.dtype)


def galore_fused_adam_apply_step(P, G, W, M, V, count, b1=0.9, b2=0.999, eps=1e-8, alpha=1.0,
                                 eta=-1e-3, wd=0.0):
    """Weight-apply leaf update: the emit step followed by the chain's decay
    and learning-rate application, W' = W + η·(α P N̂ + wd·W) (η = -lr).
    Returns (W', M_t, V_t)."""
    gt, M_t, V_t = galore_fused_adam_step(P, G, M, V, count, b1, b2, eps, alpha)
    return apply_weight(W, gt, eta, wd), M_t, V_t


def galore_fused_adam_apply_step_right(P, G, W, M, V, count, b1=0.9, b2=0.999, eps=1e-8,
                                       alpha=1.0, eta=-1e-3, wd=0.0):
    gt, M_t, V_t = galore_fused_adam_step_right(P, G, M, V, count, b1, b2, eps, alpha)
    return apply_weight(W, gt, eta, wd), M_t, V_t


def galore_fused_adam8_apply_step(P, G, W, Mq, Ms, Vq, Vs, count, b1=0.9, b2=0.999, eps=1e-8,
                                  alpha=1.0, eta=-1e-3, wd=0.0, stochastic=False):
    """int8 moments and the weight apply. Returns (W', Mq', Ms', Vq', Vs')."""
    out = galore_fused_adam8_step(P, G, Mq, Ms, Vq, Vs, count, b1, b2, eps, alpha,
                                  stochastic=stochastic)
    return (apply_weight(W, out[0], eta, wd),) + out[1:]


def galore_fused_adam8_apply_step_right(P, G, W, Mq, Ms, Vq, Vs, count, b1=0.9, b2=0.999,
                                        eps=1e-8, alpha=1.0, eta=-1e-3, wd=0.0,
                                        stochastic=False):
    out = galore_fused_adam8_step_right(P, G, Mq, Ms, Vq, Vs, count, b1, b2, eps, alpha,
                                        stochastic=stochastic)
    return (apply_weight(W, out[0], eta, wd),) + out[1:]


def adam8bit_update(g_blocks, m_codes, m_scale, v_codes, v_scale, count, book_signed,
                    book_unsigned, b1=0.9, b2=0.999, eps=1e-8, numel=None):
    """One 8-bit Adam step on (nb, BLOCK) blocks: dequant m, v → Adam in f32 →
    requant m, v. Returns (update f32 (nb, BLOCK), m_codes', m_scale',
    v_codes', v_scale').

    With `numel`, elements past it (the zero-padded tail of a ragged leaf)
    have their moments zeroed before the requant, as the Pallas kernel's
    `valid` mask does; the update there is 0."""
    m = dequantize_blocks(m_codes, m_scale, book_signed)
    v = dequantize_blocks(v_codes, v_scale, book_unsigned)
    upd, m, v = lowrank_adam_update(g_blocks, m, v, count, b1, b2, eps)
    if numel is not None and numel < g_blocks.numel():
        valid = (torch.arange(g_blocks.numel(), device=g_blocks.device) < numel).view(
            g_blocks.shape)
        m, v, upd = (torch.where(valid, x, 0.0) for x in (m, v, upd))
    m_codes, m_scale = quantize_blocks(m, book_signed)
    v_codes, v_scale = quantize_blocks(v, book_unsigned)
    return upd, m_codes, m_scale, v_codes, v_scale


def rmsnorm(x, scale, eps: float = 1e-6):
    """x · rsqrt(mean(x²) + ε) · scale over the last dim, in f32, cast back to
    x's dtype.  x (..., d), scale (d,)."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)
