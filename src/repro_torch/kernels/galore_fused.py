"""Fused GaLore-Adam leaf steps: wrappers around the Hopper kernel of
``csrc/galore_epilogue.cu`` (``lowrank_adam_kernel``, on the tensor cores:
the fp32-moment and int8-moment steps, each in its emit and its
weight-apply form), the port of the Pallas kernels in
repro/kernels/galore_fused.py (``galore_fused_adam_step``,
``galore_fused_adam_step_right``, and the int8-moment and weight-apply
variants of ``_fused_epilogue_call``, ``galore_fused_adam8_step[_right]``,
``galore_fused_adam_apply_step[_right]`` and
``galore_fused_adam8_apply_step[_right]``).

One launch per (possibly stacked) leaf computes R = PᵀG → Adam → G̃ = α P N̂
(left) or R = G P → Adam → G̃ = α N̂ Pᵀ (right); the adam8 forms keep M and V
as int8 codes with per-128-block scales, dequantized and requantized in the
kernel. Every form takes P either as f32 or as a packed int4 qstate, which the
kernel decodes in registers (no f32 P is made). The apply forms
write no G̃: they update the weight in place, W ← W + η(G̃ + wd·W), with η
(= -lr of the step) a one-element f32 tensor on the device. On CPU tensors
a wrapper runs the plain PyTorch version (kernels/ref.py) and writes the
weight and moments back in place; on CUDA tensors it checks device, dtype,
shape and contiguity and launches the kernel, or raises. There is no fallback
from a CUDA tensor to the plain version. The kernel streams P through shared
memory, so every wrapper takes any rank. Which leaves reach the wrappers is
decided one level up, in kernels/ops.py, by ``fits_vmem`` below: the
reference's dispatch predicate, copied so that the same leaves take the same
route as in the reference (at llama_7b width, r ≤ 256 here; r ≥ 512 through
the tiled projections of kernels/galore_project.py for the fp32 emit step,
and the plain step for the int8-moment and apply forms).

Each wrapper counts its launches in ``<wrapper>.launches`` (a plain integer,
incremented only where the kernel is launched). The fp32-moment wrappers
count the launches on an int4 P apart, in ``<wrapper>.launches_int4``. The
kernel copies G and P by the TMA, or by its threads what the TMA cannot
describe (a row not a multiple of 16 bytes, or a base not 16-byte aligned: a
slower route; G alone where only G's rows defeat it, else both); each of the
eight wrappers (``WRAPPERS_TMA``, all of ``WRAPPERS``) counts the launches
that copied by the threads in ``<wrapper>.launches_thread_copy``, and
``epilogue_last_cluster()`` says how many CTAs a thread-block cluster the
last launch took.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref
from repro_torch.quant import codec

# the plain versions, beside the kernels they hold to account
galore_fused_adam_step_plain = ref.galore_fused_adam_step
galore_fused_adam_step_right_plain = ref.galore_fused_adam_step_right
galore_fused_adam8_step_plain = ref.galore_fused_adam8_step
galore_fused_adam8_step_right_plain = ref.galore_fused_adam8_step_right
galore_fused_adam_apply_step_plain = ref.galore_fused_adam_apply_step
galore_fused_adam_apply_step_right_plain = ref.galore_fused_adam_apply_step_right
galore_fused_adam8_apply_step_plain = ref.galore_fused_adam8_apply_step
galore_fused_adam8_apply_step_right_plain = ref.galore_fused_adam8_apply_step_right

# The reference's routing rule (repro/kernels/galore_fused.py:104-129,
# `_pick_bn` and `fits_vmem`): its fused kernel holds all of P resident in a
# TPU core's VMEM beside two double-buffered column tiles, and the dispatch
# sends a leaf whose P and smallest tiles exceed the budget to the tiled
# projections instead. It is kept here as the route's predicate only: it
# says nothing of the H100, whose kernels stream P through shared memory at
# any rank.
DEFAULT_BN = 512
VMEM_BUDGET = 12 * 1024 * 1024


def fits_vmem(m: int, r: int, n: int, g_itemsize: int) -> bool:
    """True where the reference routes a leaf (kept side m, rank r, swept
    side n, G's itemsize) through its fused kernel, False where it composes
    the tiled projections: the reference's predicate, its column-tile search
    included, not a limit of the card."""
    p_bytes = m * r * 4
    tile_bytes = lambda bn: 2 * (m * bn * g_itemsize + 4 * r * bn * 4 + m * bn * 4)  # noqa: E731
    bn = min(DEFAULT_BN, n)
    while p_bytes + tile_bytes(bn) > VMEM_BUDGET and bn > 128:
        bn //= 2
    return p_bytes + tile_bytes(min(bn, 128)) <= VMEM_BUDGET


_SOURCE = "galore_epilogue"
_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # P, Pq, Ps, p_int4
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,   # books, G, g_bf16
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # M, V, count
    ctypes.c_void_p,                                  # out
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # L, m, r, n
    ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,  # b1, b2, eps, alpha
    ctypes.c_void_p,                                  # stream
]

_ARGTYPES_APPLY = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # P, Pq, Ps, p_int4
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,   # books, G, g_bf16
    ctypes.c_void_p, ctypes.c_int,                    # W, w_bf16
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # M, V, count
    ctypes.c_void_p, ctypes.c_double, ctypes.c_void_p,  # eta, wd, nhat
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # L, m, r, n
    ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,  # b1, b2, eps, alpha
    ctypes.c_void_p,                                  # stream
]
_ARGTYPES8 = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # P, Pq, Ps, p_int4
    ctypes.c_void_p, ctypes.c_int,                    # G, g_bf16
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # Mq, Ms, Vq, Vs
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # count, books, out
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # L, m, r, n
    ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,  # b1, b2, eps, alpha
    ctypes.c_int, ctypes.c_void_p,                    # stochastic, stream
]
_ARGTYPES8_APPLY = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # P, Pq, Ps, p_int4
    ctypes.c_void_p, ctypes.c_int,                    # G, g_bf16
    ctypes.c_void_p, ctypes.c_int,                    # W, w_bf16
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # Mq, Ms, Vq, Vs
    ctypes.c_void_p, ctypes.c_void_p,                 # count, books
    ctypes.c_void_p, ctypes.c_double, ctypes.c_void_p,  # eta, wd, nhat
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # L, m, r, n
    ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,  # b1, b2, eps, alpha
    ctypes.c_int, ctypes.c_void_p,                    # stochastic, stream
]


def _p_parts(P, kept: int, lead: tuple):
    """(p_int4, r, the projector's tensors as (name, tensor, dtype, shape))
    for an f32 P (..., kept, r) or a packed int4 qstate blocked along kept."""
    p_int4 = codec.is_qstate(P)
    r = (P["q"] if p_int4 else P).shape[-1]
    if not p_int4:
        return False, r, (("P", P, torch.float32, lead + (kept, r)),)
    nbp = -(-kept // codec.QBLOCK)
    return True, r, (("P codes", P["q"], torch.uint8, lead + (nbp * codec.QBLOCK // 2, r)),
                     ("P scales", P["scale"], torch.float32, lead + (nbp, r)))


def _p_ptrs(P):
    """(P, Pq, Ps) pointers as the kernels take them: an f32 P or an int4 P's
    codes and scales, the others null."""
    if codec.is_qstate(P):
        return None, P["q"].data_ptr(), P["scale"].data_ptr()
    return P.data_ptr(), None, None


def _check_inputs(G, count, want):
    """Raise unless G, count and `want` ((name, tensor, dtype, shape), …) are
    what a kernel takes: on G's CUDA device, contiguous, of those dtypes and
    shapes."""
    dev = G.device
    for name, t in (("G", G), ("count", count)) + tuple((w[0], w[1]) for w in want):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} is on {t.device}; every input must be on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if G.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"G must be float32 or bfloat16, got {G.dtype}")
    if count.dtype != torch.int32 or count.numel() != 1:
        raise TypeError(f"count must be one int32, got {count.dtype} of {count.numel()}")
    for name, t, dtype, shape in want:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}; with G {tuple(G.shape)} "
                             f"it must be {shape}")


def _check(P, G, M, V, count, right: bool):
    """Raise unless the fp32-moment kernel takes these tensors as they are;
    returns (p_int4, r)."""
    m, n = G.shape[-2:]
    lead = tuple(G.shape[:-2])
    p_int4, r, parts = _p_parts(P, n if right else m, lead)
    mv = lead + ((m, r) if right else (r, n))
    _check_inputs(G, count, parts + (("M", M, torch.float32, mv), ("V", V, torch.float32, mv)))
    return p_int4, r


def _count(fn, p_int4: bool = False):
    """Count a launch of galore_epilogue's GaLore kernel on its wrapper: in
    `launches_int4` for an fp32-moment form on an int4 P, else `launches`,
    and in `launches_thread_copy` where it copied G or P by the threads."""
    if p_int4:
        fn.launches_int4 += 1
    else:
        fn.launches += 1
    fn.launches_thread_copy += _thread_copied()


def _launch(symbol, right, P, G, M, V, count, b1, b2, eps, alpha):
    p_int4, r = _check(P, G, M, V, count, right)
    m, n = G.shape[-2:]
    L = math.prod(G.shape[:-2])
    out = torch.empty(G.shape, dtype=torch.float32, device=G.device)
    with torch.cuda.device(G.device):
        err = build.entry(_SOURCE, symbol, _ARGTYPES)(
            *_p_ptrs(P), int(p_int4), codec.device_codebooks(G.device).data_ptr(), G.data_ptr(),
            int(G.dtype == torch.bfloat16), M.data_ptr(), V.data_ptr(), count.data_ptr(),
            out.data_ptr(), L, m, r, n, b1, b2, eps, alpha,
            torch.cuda.current_stream(G.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} failed to launch: cudaError_t {err} "
                           f"(G {tuple(G.shape)}, r={r}, int4 P {p_int4})")
    return out, p_int4


def _plain_in_place(plain, P, G, M, V, count, b1, b2, eps, alpha):
    out, M_t, V_t = plain(P, G, M, V, count, b1, b2, eps, alpha)
    M.copy_(M_t)
    V.copy_(V_t)
    return out, M, V


def _check_w(G, W, eta):
    """Raise unless W and η are what an apply kernel takes."""
    if not W.is_cuda or W.device != G.device:
        raise ValueError(f"W is on {W.device}; every input must be on {G.device}")
    if not W.is_contiguous():
        raise ValueError("W must be contiguous")
    if W.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"W must be float32 or bfloat16, got {W.dtype}")
    if W.shape != G.shape:
        raise ValueError(f"W has shape {tuple(W.shape)}; it must be G's, {tuple(G.shape)}")
    if not isinstance(eta, torch.Tensor) or not eta.is_cuda or eta.device != G.device:
        raise ValueError(f"eta must be a tensor on {G.device}, so that no step syncs the host")
    if eta.dtype != torch.float32 or eta.numel() != 1:
        raise TypeError(f"eta must be one float32, got {eta.dtype} of {eta.numel()}")


def _nhat_scratch(moments, r: int):
    """The apply kernel keeps N̂ until the whole rank is contracted when it
    has more than one 128-row rank chunk: an f32 scratch of the moments'
    shape; None otherwise."""
    if r <= codec.QBLOCK:
        return None
    return torch.empty(moments.shape, dtype=torch.float32, device=moments.device)


def _launch_apply(symbol, right, P, G, W, M, V, count, b1, b2, eps, alpha, eta, wd):
    p_int4, r = _check(P, G, M, V, count, right)
    _check_w(G, W, eta)
    m, n = G.shape[-2:]
    L = math.prod(G.shape[:-2])
    nhat = _nhat_scratch(M, r)
    with torch.cuda.device(G.device):
        err = build.entry(_SOURCE, symbol, _ARGTYPES_APPLY)(
            *_p_ptrs(P), int(p_int4), codec.device_codebooks(G.device).data_ptr(), G.data_ptr(),
            int(G.dtype == torch.bfloat16), W.data_ptr(), int(W.dtype == torch.bfloat16),
            M.data_ptr(), V.data_ptr(), count.data_ptr(), eta.data_ptr(), wd,
            None if nhat is None else nhat.data_ptr(), L, m, r, n, b1, b2, eps, alpha,
            torch.cuda.current_stream(G.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} failed to launch: cudaError_t {err} "
                           f"(G {tuple(G.shape)}, r={r}, int4 P {p_int4})")
    return p_int4


def _plain_apply_in_place(plain, P, G, W, moments, count, **kw):
    W_t, *new = plain(P, G, W, *moments, count, **kw)
    for old, t in zip((W, *moments), (W_t, *new)):
        old.copy_(t)
    return (W, *moments)


def galore_fused_adam_apply_step(P, G, W, M, V, count, *, eta, b1=0.9, b2=0.999, eps=1e-8,
                                 alpha=1.0, wd=0.0):
    """The left-side fused step with the weight update folded in:
    W ← W + η·(α P N̂ + wd·W), in W's dtype, in place; no G̃ is written.

    P, G, M, V and count as for galore_fused_adam_step; W (..., m, n) f32 or
    bf16; η a one-element f32 tensor on the device (-lr of this step); wd a
    float. Returns (W', M', V'), each the passed tensor, updated in place."""
    if G.device.type == "cpu":
        return _plain_apply_in_place(galore_fused_adam_apply_step_plain, P, G, W, (M, V), count,
                                     b1=b1, b2=b2, eps=eps, alpha=alpha, eta=eta, wd=wd)
    p_int4 = _launch_apply("galore_fused_adam_apply_left", False, P, G, W, M, V, count, b1, b2,
                           eps, alpha, eta, wd)
    _count(galore_fused_adam_apply_step, p_int4)
    return W, M, V


def galore_fused_adam_apply_step_right(P, G, W, M, V, count, *, eta, b1=0.9, b2=0.999,
                                       eps=1e-8, alpha=1.0, wd=0.0):
    """The right-side fused step with the weight update folded in (P
    (..., n, r) f32 or a packed int4 qstate, M/V (..., m, r)). Returns
    (W', M', V'), in place."""
    if G.device.type == "cpu":
        return _plain_apply_in_place(galore_fused_adam_apply_step_right_plain, P, G, W, (M, V),
                                     count, b1=b1, b2=b2, eps=eps, alpha=alpha, eta=eta, wd=wd)
    p_int4 = _launch_apply("galore_fused_adam_apply_right", True, P, G, W, M, V, count, b1, b2,
                           eps, alpha, eta, wd)
    _count(galore_fused_adam_apply_step_right, p_int4)
    return W, M, V


def galore_fused_adam_step(P, G, M, V, count, *, b1=0.9, b2=0.999, eps=1e-8, alpha=1.0):
    """Fused left-side GaLore-Adam step (leaves with m ≤ n).

    P (..., m, r) f32 or a packed int4 qstate {"q": (..., m_pad/2, r) u8,
    "scale": (..., ⌈m/128⌉, r) f32}; G (..., m, n) f32 or bf16, M/V (..., r, n)
    f32, count an int32 tensor holding the step number. Leading dims (stacked
    layers) run in one launch. Returns (G̃ (..., m, n) f32, M', V'), where M'
    and V' ARE the passed M and V, updated in place (as the Pallas kernel's
    aliasing does).
    """
    if G.device.type == "cpu":
        return _plain_in_place(galore_fused_adam_step_plain, P, G, M, V, count, b1, b2, eps, alpha)
    out, p_int4 = _launch("galore_fused_adam_left", False, P, G, M, V, count, b1, b2, eps, alpha)
    _count(galore_fused_adam_step, p_int4)
    return out, M, V


def galore_fused_adam_step_right(P, G, M, V, count, *, b1=0.9, b2=0.999, eps=1e-8, alpha=1.0):
    """Fused right-side GaLore-Adam step (leaves with m > n).

    P (..., n, r) f32 or a packed int4 qstate blocked along n; G (..., m, n)
    f32 or bf16, M/V (..., m, r) f32, count an int32 tensor. Returns
    (G̃ (..., m, n) f32, M', V'), with M and V updated in place.
    """
    if G.device.type == "cpu":
        return _plain_in_place(galore_fused_adam_step_right_plain, P, G, M, V, count,
                               b1, b2, eps, alpha)
    out, p_int4 = _launch("galore_fused_adam_right", True, P, G, M, V, count, b1, b2, eps, alpha)
    _count(galore_fused_adam_step_right, p_int4)
    return out, M, V


def _check8(P, G, Mq, Ms, Vq, Vs, count, right: bool):
    """Raise unless the adam8 kernel takes these tensors as they are; returns
    (p_int4, r)."""
    m, n = G.shape[-2:]
    lead = tuple(G.shape[:-2])
    p_int4, r, parts = _p_parts(P, n if right else m, lead)
    nb = -(-(m if right else n) // codec.QBLOCK)
    mom, scale = (lead + (m, r), lead + (nb, r)) if right else (lead + (r, n), lead + (r, nb))
    _check_inputs(G, count, parts + (("Mq", Mq, torch.uint8, mom),
                                     ("Ms", Ms, torch.float32, scale),
                                     ("Vq", Vq, torch.uint8, mom),
                                     ("Vs", Vs, torch.float32, scale)))
    return p_int4, r


def _thread_copied() -> int:
    """1 where this thread's last launch of galore_epilogue's GaLore kernel
    copied G or P by the threads instead of by the TMA, else 0."""
    return build.entry(_SOURCE, "galore_epilogue_last_copied", [])()


def epilogue_last_cluster() -> int:
    """The CTAs a cluster (1, 2 or 4) of this thread's last launch of
    galore_epilogue's GaLore kernel: it spreads each 128-wide slab of the
    swept axis over them, sized on the host to the grid and the card."""
    return build.entry(_SOURCE, "galore_epilogue_last_cluster", [])()


def _launch8(symbol, right, P, G, Mq, Ms, Vq, Vs, count, b1, b2, eps, alpha, stochastic):
    p_int4, r = _check8(P, G, Mq, Ms, Vq, Vs, count, right)
    m, n = G.shape[-2:]
    L = math.prod(G.shape[:-2])
    out = torch.empty(G.shape, dtype=torch.float32, device=G.device)
    with torch.cuda.device(G.device):
        err = build.entry(_SOURCE, symbol, _ARGTYPES8)(
            *_p_ptrs(P), int(p_int4), G.data_ptr(), int(G.dtype == torch.bfloat16),
            Mq.data_ptr(), Ms.data_ptr(), Vq.data_ptr(), Vs.data_ptr(), count.data_ptr(),
            codec.device_codebooks(G.device).data_ptr(), out.data_ptr(), L, m, r, n, b1, b2,
            eps, alpha, int(stochastic), torch.cuda.current_stream(G.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} failed to launch: cudaError_t {err} "
                           f"(G {tuple(G.shape)}, r={r}, int4 P {p_int4})")
    return out


def _launch8_apply(symbol, right, P, G, W, Mq, Ms, Vq, Vs, count, b1, b2, eps, alpha, eta, wd,
                   stochastic):
    p_int4, r = _check8(P, G, Mq, Ms, Vq, Vs, count, right)
    _check_w(G, W, eta)
    m, n = G.shape[-2:]
    L = math.prod(G.shape[:-2])
    nhat = _nhat_scratch(Mq, r)
    with torch.cuda.device(G.device):
        err = build.entry(_SOURCE, symbol, _ARGTYPES8_APPLY)(
            *_p_ptrs(P), int(p_int4), G.data_ptr(), int(G.dtype == torch.bfloat16), W.data_ptr(),
            int(W.dtype == torch.bfloat16), Mq.data_ptr(), Ms.data_ptr(), Vq.data_ptr(),
            Vs.data_ptr(), count.data_ptr(), codec.device_codebooks(G.device).data_ptr(),
            eta.data_ptr(), wd, None if nhat is None else nhat.data_ptr(), L, m, r, n, b1, b2,
            eps, alpha,
            int(stochastic), torch.cuda.current_stream(G.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} failed to launch: cudaError_t {err} "
                           f"(G {tuple(G.shape)}, r={r}, int4 P {p_int4})")


def _plain8_in_place(plain, P, G, Mq, Ms, Vq, Vs, count, b1, b2, eps, alpha, stochastic):
    out, *new = plain(P, G, Mq, Ms, Vq, Vs, count, b1, b2, eps, alpha, stochastic=stochastic)
    for old, t in zip((Mq, Ms, Vq, Vs), new):
        old.copy_(t)
    return out, Mq, Ms, Vq, Vs


def galore_fused_adam8_step(P, G, Mq, Ms, Vq, Vs, count, *, b1=0.9, b2=0.999, eps=1e-8,
                            alpha=1.0, stochastic=False):
    """Fused left-side GaLore-Adam step with int8 moments (leaves with m ≤ n).

    P (..., m, r) f32 or a packed int4 qstate {"q": (..., m_pad/2, r) u8,
    "scale": (..., ⌈m/128⌉, r) f32}; G (..., m, n) f32 or bf16; codes Mq/Vq
    (..., r, n) u8 and scales Ms/Vs (..., r, ⌈n/128⌉) f32; count an int32
    tensor. With `stochastic` the requant rounds stochastically (Q-GaLore).
    Returns (G̃ (..., m, n) f32, Mq', Ms', Vq', Vs'), the last four the passed
    tensors, updated in place."""
    if G.device.type == "cpu":
        return _plain8_in_place(galore_fused_adam8_step_plain, P, G, Mq, Ms, Vq, Vs, count,
                                b1, b2, eps, alpha, stochastic)
    out = _launch8("galore_fused_adam8_left", False, P, G, Mq, Ms, Vq, Vs, count,
                   b1, b2, eps, alpha, stochastic)
    _count(galore_fused_adam8_step)
    return out, Mq, Ms, Vq, Vs


def galore_fused_adam8_step_right(P, G, Mq, Ms, Vq, Vs, count, *, b1=0.9, b2=0.999, eps=1e-8,
                                  alpha=1.0, stochastic=False):
    """Fused right-side GaLore-Adam step with int8 moments (leaves with m > n).

    P (..., n, r) f32 or a packed int4 qstate blocked along n; codes Mq/Vq
    (..., m, r) u8 and scales Ms/Vs (..., ⌈m/128⌉, r) f32 (blocks along m).
    Returns (G̃ (..., m, n) f32, Mq', Ms', Vq', Vs'), updated in place."""
    if G.device.type == "cpu":
        return _plain8_in_place(galore_fused_adam8_step_right_plain, P, G, Mq, Ms, Vq, Vs,
                                count, b1, b2, eps, alpha, stochastic)
    out = _launch8("galore_fused_adam8_right", True, P, G, Mq, Ms, Vq, Vs, count,
                   b1, b2, eps, alpha, stochastic)
    _count(galore_fused_adam8_step_right)
    return out, Mq, Ms, Vq, Vs


def galore_fused_adam8_apply_step(P, G, W, Mq, Ms, Vq, Vs, count, *, eta, b1=0.9, b2=0.999,
                                  eps=1e-8, alpha=1.0, wd=0.0, stochastic=False):
    """The left-side int8-moment step with the weight update folded in — the
    whole 8-bit GaLore leaf update in one launch: W ← W + η·(α P N̂ + wd·W)
    in place, codes and scales in place, P f32 or a packed int4 qstate.
    Returns (W', Mq', Ms', Vq', Vs'), each the passed tensor."""
    if G.device.type == "cpu":
        return _plain_apply_in_place(galore_fused_adam8_apply_step_plain, P, G, W,
                                     (Mq, Ms, Vq, Vs), count, b1=b1, b2=b2, eps=eps,
                                     alpha=alpha, eta=eta, wd=wd, stochastic=stochastic)
    _launch8_apply("galore_fused_adam8_apply_left", False, P, G, W, Mq, Ms, Vq, Vs, count,
                   b1, b2, eps, alpha, eta, wd, stochastic)
    _count(galore_fused_adam8_apply_step)
    return W, Mq, Ms, Vq, Vs


def galore_fused_adam8_apply_step_right(P, G, W, Mq, Ms, Vq, Vs, count, *, eta, b1=0.9,
                                        b2=0.999, eps=1e-8, alpha=1.0, wd=0.0, stochastic=False):
    """The right-side int8-moment step with the weight update folded in.
    Returns (W', Mq', Ms', Vq', Vs'), in place."""
    if G.device.type == "cpu":
        return _plain_apply_in_place(galore_fused_adam8_apply_step_right_plain, P, G, W,
                                     (Mq, Ms, Vq, Vs), count, b1=b1, b2=b2, eps=eps,
                                     alpha=alpha, eta=eta, wd=wd, stochastic=stochastic)
    _launch8_apply("galore_fused_adam8_apply_right", True, P, G, W, Mq, Ms, Vq, Vs, count,
                   b1, b2, eps, alpha, eta, wd, stochastic)
    _count(galore_fused_adam8_apply_step_right)
    return W, Mq, Ms, Vq, Vs


WRAPPERS = (galore_fused_adam_step, galore_fused_adam_step_right,
            galore_fused_adam8_step, galore_fused_adam8_step_right,
            galore_fused_adam_apply_step, galore_fused_adam_apply_step_right,
            galore_fused_adam8_apply_step, galore_fused_adam8_apply_step_right)
# the wrappers of galore_epilogue's GaLore kernel, which counts the launches
# that copied operands by the threads: all of them
WRAPPERS_TMA = WRAPPERS


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
        fn.launches_thread_copy = 0
    for fn in WRAPPERS[:2] + WRAPPERS[4:6]:  # the fp32-moment forms, int4 P
        fn.launches_int4 = 0


reset_launch_counts()
