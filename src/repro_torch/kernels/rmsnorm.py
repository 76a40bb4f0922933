"""RMSNorm: the wrapper around the Hopper kernel of ``csrc/rmsnorm.cu`` (the
port of repro/kernels/rmsnorm.py: ``rmsnorm``).

    rmsnorm(x, scale, eps)   x · rsqrt(mean(x²) + ε) · scale over the last dim,
                             in f32, cast to x's dtype.  x (..., d) f32 or bf16,
                             scale (d,) f32 or bf16, d ≤ 8192

It is the counterpart of ``repro.kernels.ops.rmsnorm``; as in the reference,
the models do not call it (they normalise with the plain
``models/layers.py::apply_norm``). On CPU tensors (all of them) the wrapper
runs the plain version (``rmsnorm_plain``, kernels/ref.py); on CUDA tensors it
checks device, dtype, shape and contiguity and launches the kernel, or raises.
``rmsnorm.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref

MAX_D = 8192  # the kernel keeps a row in the registers of at most 8 warps
_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,  # x, x_bf16, scale, s_bf16
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,               # out, rows, d
    ctypes.c_double, ctypes.c_void_p,                               # eps, stream
]
_DTYPES = (torch.float32, torch.bfloat16)

rmsnorm_plain = ref.rmsnorm


def rmsnorm(x, scale, eps: float = 1e-6):
    """x (..., d), scale (d,) -> x's shape and dtype."""
    if x.device.type == "cpu" and scale.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    d = x.shape[-1]
    for name, t in (("x", x), ("scale", scale)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} is on {t.device}; every input must be on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if tuple(scale.shape) != (d,):
        raise ValueError(f"scale has shape {tuple(scale.shape)}; with x {tuple(x.shape)} it "
                         f"must be ({d},)")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"the kernel takes rows of 1 to {MAX_D} values, got {d}")
    rows = math.prod(x.shape[:-1])
    out = torch.empty_like(x)
    if rows == 0:
        return out
    with torch.cuda.device(x.device):
        err = build.entry("rmsnorm", "rmsnorm", _ARGTYPES)(
            x.data_ptr(), int(x.dtype == torch.bfloat16), scale.data_ptr(),
            int(scale.dtype == torch.bfloat16), out.data_ptr(), rows, d, eps,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm failed to launch: cudaError_t {err} (x {tuple(x.shape)})")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
