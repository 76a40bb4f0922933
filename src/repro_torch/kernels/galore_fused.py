"""Fused GaLore-Adam leaf step: wrappers around the Hopper kernels of
``csrc/galore_fused.cu`` (the port of the Pallas kernels in
repro/kernels/galore_fused.py, ``galore_fused_adam_step`` and
``galore_fused_adam_step_right``).

One launch per (possibly stacked) leaf computes R = PᵀG → Adam → G̃ = α P N̂
(left) or R = G P → Adam → G̃ = α N̂ Pᵀ (right). On CPU tensors a wrapper runs
the plain PyTorch version (kernels/ref.py); on CUDA tensors it checks device,
dtype, shape and contiguity and launches the kernel, or raises. There is no
fallback from a CUDA tensor to the plain version, and no shape is refused for
being too large for on-chip memory: the kernel streams P through shared
memory, so r = 1024 runs like r = 128.

Each wrapper counts its launches in ``<wrapper>.launches`` (a plain integer,
incremented only where the kernel is launched).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref

# the plain versions, beside the kernels they hold to account
galore_fused_adam_step_plain = ref.galore_fused_adam_step
galore_fused_adam_step_right_plain = ref.galore_fused_adam_step_right

_SOURCE = "galore_fused"
_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,   # P, G, g_bf16
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # M, V, count
    ctypes.c_void_p,                                  # out
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # L, m, r, n
    ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,  # b1, b2, eps, alpha
    ctypes.c_void_p,                                  # stream
]


def _entry(symbol: str):
    fn = getattr(build.load(_SOURCE), symbol)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(P, G, M, V, count, p_shape, mv_shape):
    dev = G.device
    for name, t in (("P", P), ("G", G), ("M", M), ("V", V), ("count", count)):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} is on {t.device}; every input must be on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if P.dtype != torch.float32 or M.dtype != torch.float32 or V.dtype != torch.float32:
        raise TypeError(f"P, M and V must be float32, got {P.dtype}, {M.dtype}, {V.dtype}")
    if G.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"G must be float32 or bfloat16, got {G.dtype}")
    if count.dtype != torch.int32 or count.numel() != 1:
        raise TypeError(f"count must be one int32, got {count.dtype} of {count.numel()}")
    if tuple(P.shape) != p_shape or tuple(M.shape) != mv_shape or tuple(V.shape) != mv_shape:
        raise ValueError(f"shapes P {tuple(P.shape)}, M {tuple(M.shape)}, V {tuple(V.shape)} "
                         f"do not match G {tuple(G.shape)}: want P {p_shape}, M/V {mv_shape}")


def _launch(symbol, P, G, M, V, count, b1, b2, eps, alpha, r):
    m, n = G.shape[-2:]
    L = math.prod(G.shape[:-2])
    out = torch.empty(G.shape, dtype=torch.float32, device=G.device)
    with torch.cuda.device(G.device):
        err = _entry(symbol)(
            P.data_ptr(), G.data_ptr(), int(G.dtype == torch.bfloat16), M.data_ptr(),
            V.data_ptr(), count.data_ptr(), out.data_ptr(), L, m, r, n, b1, b2, eps, alpha,
            torch.cuda.current_stream(G.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} failed to launch: cudaError_t {err} "
                           f"(G {tuple(G.shape)}, r={r})")
    return out


def _plain_in_place(plain, P, G, M, V, count, b1, b2, eps, alpha):
    out, M_t, V_t = plain(P, G, M, V, count, b1, b2, eps, alpha)
    M.copy_(M_t)
    V.copy_(V_t)
    return out, M, V


def galore_fused_adam_step(P, G, M, V, count, *, b1=0.9, b2=0.999, eps=1e-8, alpha=1.0):
    """Fused left-side GaLore-Adam step (leaves with m ≤ n).

    P (..., m, r) f32, G (..., m, n) f32 or bf16, M/V (..., r, n) f32, count an
    int32 tensor holding the step number. Leading dims (stacked layers) run in
    one launch. Returns (G̃ (..., m, n) f32, M', V'), where M' and V' ARE the
    passed M and V, updated in place (as the Pallas kernel's aliasing does).
    """
    if G.device.type == "cpu":
        return _plain_in_place(galore_fused_adam_step_plain, P, G, M, V, count, b1, b2, eps, alpha)
    m, n = G.shape[-2:]
    r = P.shape[-1]
    lead = tuple(G.shape[:-2])
    _check(P, G, M, V, count, lead + (m, r), lead + (r, n))
    out = _launch("galore_fused_adam_left", P, G, M, V, count, b1, b2, eps, alpha, r)
    galore_fused_adam_step.launches += 1
    return out, M, V


def galore_fused_adam_step_right(P, G, M, V, count, *, b1=0.9, b2=0.999, eps=1e-8, alpha=1.0):
    """Fused right-side GaLore-Adam step (leaves with m > n).

    P (..., n, r) f32, G (..., m, n) f32 or bf16, M/V (..., m, r) f32, count an
    int32 tensor. Returns (G̃ (..., m, n) f32, M', V'), with M and V updated
    in place.
    """
    if G.device.type == "cpu":
        return _plain_in_place(galore_fused_adam_step_right_plain, P, G, M, V, count,
                               b1, b2, eps, alpha)
    m, n = G.shape[-2:]
    r = P.shape[-1]
    lead = tuple(G.shape[:-2])
    _check(P, G, M, V, count, lead + (n, r), lead + (m, r))
    out = _launch("galore_fused_adam_right", P, G, M, V, count, b1, b2, eps, alpha, r)
    galore_fused_adam_step_right.launches += 1
    return out, M, V


galore_fused_adam_step.launches = 0
galore_fused_adam_step_right.launches = 0


def reset_launch_counts() -> None:
    galore_fused_adam_step.launches = 0
    galore_fused_adam_step_right.launches = 0
