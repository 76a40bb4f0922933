"""The tiled GaLore projections: wrappers around the Hopper kernels of
``csrc/galore_project.cu`` (the port of repro/kernels/galore_project.py:
``galore_project`` and ``galore_project_back``).

    galore_project(P, G)            R = Pᵀ G    P (..., m, r) f32, G (..., m, n)
                                                f32 or bf16 -> R (..., r, n) f32
    galore_project_back(P, N, α)    G̃ = α P N   P (..., m, r), N (..., r, n) f32
                                                -> G̃ (..., m, n) f32

Leading dims (stacked layers) run in one launch. The right-side leaf's
composite step contracts over swapaxes(G) and returns swapaxes(G̃)
(repro/kernels/ops.py:101-105): with ``transpose_g`` the kernel reads G stored
as (..., n, m) as its transpose, and with ``transpose_out`` it writes G̃
transposed, (..., n, m), so neither transpose is copied.

The kernels multiply on the tensor cores in split TF32 (each f32 operand as a
TF32 hi and lo part; three products, two with a bf16 G, summed in f32): within
1e-5·max|want| + 1e-5·|want| of the plain version, not bit for bit.

On CPU tensors (all of them) a wrapper runs its plain version (``*_plain``, from
kernels/ref.py); on CUDA tensors it checks device, dtype, shape and
contiguity and launches the kernel, or raises; on meta tensors (the dry
run's) it checks them and allocates its output, and launches nothing
(kernels/meta.py). ``<wrapper>.launches`` counts
the launches, and ``<wrapper>.launches_thread_copy`` those of them whose
operands the kernel copied by its threads instead of by the TMA (rows not a
multiple of 16 bytes, or a base not 16-byte aligned): a slower route that the
models' leaves do not take.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, meta, ref

_SOURCE = "galore_project"
_ARGTYPES_PROJECT = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # P, G, g_bf16, g_t
    ctypes.c_void_p,                                                # R
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,         # L, m, r, n
    ctypes.c_void_p,                                                # stream
]
_ARGTYPES_BACK = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # P, N, out, out_t
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,           # L, m, r, n
    ctypes.c_double, ctypes.c_void_p,                                 # alpha, stream
]


def galore_project_plain(P, G, transpose_g: bool = False):
    """R = Pᵀ G (or Pᵀ Gᵀ with `transpose_g`), f32."""
    return ref.galore_project(P, G.transpose(-1, -2) if transpose_g else G)


def galore_project_back_plain(P, N, alpha: float, transpose_out: bool = False):
    """G̃ = α P N in f32 (contiguous, transposed with `transpose_out`)."""
    out = ref.galore_project_back(P, N, alpha)
    return out.transpose(-1, -2).contiguous() if transpose_out else out


def _on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU: only then the plain version runs
    (a CPU tensor beside a CUDA one is refused by the check)."""
    return all(t.device.type == "cpu" for t in tensors)


def _check(tensors, lead):
    """Raise unless every (name, tensor, dtypes, shape) is on the first
    tensor's CUDA device, contiguous, of one of those dtypes and that shape."""
    dev = tensors[0][1].device
    for name, t, dtypes, shape in tensors:
        if not (t.is_cuda or t.is_meta) or t.device != dev:
            raise ValueError(f"{name} is on {t.device}; every input must be on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
        if tuple(t.shape) != lead + shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}; it must be {lead + shape}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _count(wrapper):
    """Count a launch of `wrapper`, and whether it copied by the threads."""
    wrapper.launches += 1
    wrapper.launches_thread_copy += build.entry(_SOURCE, "galore_project_last_copied", [])()


def galore_project(P, G, *, transpose_g: bool = False):
    """R = Pᵀ G.  P (..., m, r) f32; G (..., m, n) f32 or bf16, or with
    `transpose_g` G (..., n, m) read as its transpose. Returns R (..., r, n)
    f32."""
    if _on_cpu(P, G):
        return galore_project_plain(P, G, transpose_g)
    lead, (m, r) = tuple(P.shape[:-2]), P.shape[-2:]
    n = G.shape[-2] if transpose_g else G.shape[-1]
    _check((("P", P, (torch.float32,), (m, r)),
            ("G", G, (torch.float32, torch.bfloat16), (n, m) if transpose_g else (m, n))), lead)
    R = torch.empty(lead + (r, n), dtype=torch.float32, device=G.device)
    if G.is_meta:  # the dry run's shape-only launch (kernels/meta.py)
        meta.launch(galore_project, 2 * math.prod(lead) * m * r * n)
        return R
    with torch.cuda.device(G.device):
        err = build.entry(_SOURCE, "galore_project", _ARGTYPES_PROJECT)(
            P.data_ptr(), G.data_ptr(), int(G.dtype == torch.bfloat16), int(transpose_g),
            R.data_ptr(), math.prod(lead), m, r, n, _stream(G))
    if err != 0:
        raise RuntimeError(f"galore_project failed to launch: cudaError_t {err} "
                           f"(P {tuple(P.shape)}, G {tuple(G.shape)})")
    _count(galore_project)
    return R


def galore_project_back(P, N, alpha: float, *, transpose_out: bool = False):
    """G̃ = α P N.  P (..., m, r) f32, N (..., r, n) f32. Returns G̃ (..., m, n)
    f32, or with `transpose_out` its transpose (..., n, m), contiguous."""
    if _on_cpu(P, N):
        return galore_project_back_plain(P, N, alpha, transpose_out)
    lead, (m, r) = tuple(P.shape[:-2]), P.shape[-2:]
    n = N.shape[-1]
    _check((("P", P, (torch.float32,), (m, r)), ("N", N, (torch.float32,), (r, n))), lead)
    out = torch.empty(lead + ((n, m) if transpose_out else (m, n)), dtype=torch.float32,
                      device=N.device)
    if N.is_meta:
        meta.launch(galore_project_back, 2 * math.prod(lead) * m * r * n)
        return out
    with torch.cuda.device(N.device):
        err = build.entry(_SOURCE, "galore_project_back", _ARGTYPES_BACK)(
            P.data_ptr(), N.data_ptr(), out.data_ptr(), int(transpose_out), math.prod(lead), m,
            r, n, alpha, _stream(N))
    if err != 0:
        raise RuntimeError(f"galore_project_back failed to launch: cudaError_t {err} "
                           f"(P {tuple(P.shape)}, N {tuple(N.shape)})")
    _count(galore_project_back)
    return out


galore_project.launches = galore_project.launches_thread_copy = 0
galore_project_back.launches = galore_project_back.launches_thread_copy = 0
meta.register(galore_project, galore_project_back)
