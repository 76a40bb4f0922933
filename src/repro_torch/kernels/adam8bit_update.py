"""The flat 8-bit Adam update of one leaf: the wrapper around the Hopper kernel
``adam8bit_blocks_update`` of ``csrc/galore_epilogue.cu`` (the port of
repro/kernels/adam8bit_update.py, whose Pallas body is
``galore_fused.adam8bit_blocks_update``, the GaLore epilogue with
``project=False``).

    g (any shape, numel N) → dequant M, V (nb, 256) → Adam → requant M, V,
    update in g's dtype,  nb = ⌈N/256⌉

The moments are the flat INT8 codec's state (``quant/codec.py``: codes
(nb, 256) u8, one absmax per block), padded to whole blocks; g and the update
are not padded: the kernel masks the last block's tail. The kernel finds
each nearest code in the codec's bracket tables (``codec.device_code_tables``)
rather than by searching the midpoints. On CPU tensors the
wrapper runs the plain version (``adam8bit_update_plain``, the port of
``ref.adam8bit_update``) and writes codes and scales back in place; on CUDA
tensors it checks device, dtype, shape and contiguity and launches the
kernel, or raises. ``adam8bit_update.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.quant import codec

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,    # g, g_bf16, numel
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # Mq, Ms, Vq, Vs
    ctypes.c_void_p, ctypes.c_void_p,                    # count, books
    ctypes.c_void_p, ctypes.c_void_p,                    # bracket tables, update
    ctypes.c_double, ctypes.c_double, ctypes.c_double,   # b1, b2, eps
    ctypes.c_void_p,                                     # stream
]


def adam8bit_update_plain(g, m_codes, m_scale, v_codes, v_scale, count, b1=0.9, b2=0.999,
                          eps=1e-8):
    """The plain version: g zero-padded to (nb, 256) blocks, ref.adam8bit_update
    with the tail masked, the update cut back to g's shape and cast to its
    dtype. Pure: returns (update, m_codes', m_scale', v_codes', v_scale')."""
    n = g.numel()
    blocks = torch.nn.functional.pad(g.reshape(-1).float(), (0, m_codes.numel() - n))
    books = codec.device_codebooks(g.device)
    upd, *state = ref.adam8bit_update(blocks.view(m_codes.shape), m_codes, m_scale, v_codes,
                                      v_scale, count, books[:256], books[256:512], b1, b2, eps,
                                      numel=n)
    return (upd.reshape(-1)[:n].reshape(g.shape).to(g.dtype), *state)


def _check(g, m_codes, m_scale, v_codes, v_scale, count):
    nb = -(-g.numel() // codec.BLOCK)
    want = (("m codes", m_codes, torch.uint8, (nb, codec.BLOCK)),
            ("m scales", m_scale, torch.float32, (nb,)),
            ("v codes", v_codes, torch.uint8, (nb, codec.BLOCK)),
            ("v scales", v_scale, torch.float32, (nb,)))
    dev = g.device
    for name, t in (("g", g), ("count", count)) + tuple(w[:2] for w in want):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} is on {t.device}; every input must be on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"g must be float32 or bfloat16, got {g.dtype}")
    if g.numel() == 0:
        raise ValueError("g is empty")
    if count.dtype != torch.int32 or count.numel() != 1:
        raise TypeError(f"count must be one int32, got {count.dtype} of {count.numel()}")
    for name, t, dtype, shape in want:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}; for g of {g.numel()} "
                             f"elements it must be {shape}")


def adam8bit_update(g, m_codes, m_scale, v_codes, v_scale, count, *, b1=0.9, b2=0.999,
                    eps=1e-8):
    """One 8-bit Adam step of a leaf.

    g (any shape, f32 or bf16); codes (nb, 256) u8 and scales (nb,) f32 of
    M and V, nb = ⌈g.numel()/256⌉; count an int32 tensor holding the step
    number. Returns (update of g's shape and dtype, m_codes', m_scale',
    v_codes', v_scale'), the last four the passed tensors, updated in
    place."""
    moments = (m_codes, m_scale, v_codes, v_scale)
    if g.device.type == "cpu":
        upd, *new = adam8bit_update_plain(g, *moments, count, b1, b2, eps)
        for old, t in zip(moments, new):
            old.copy_(t)
        return (upd, *moments)
    _check(g, *moments, count)
    upd = torch.empty_like(g)
    with torch.cuda.device(g.device):
        err = build.entry("galore_epilogue", "adam8bit_blocks_update", _ARGTYPES)(
            g.data_ptr(), int(g.dtype == torch.bfloat16), g.numel(), m_codes.data_ptr(),
            m_scale.data_ptr(), v_codes.data_ptr(), v_scale.data_ptr(), count.data_ptr(),
            codec.device_codebooks(g.device).data_ptr(),
            codec.device_code_tables(g.device).data_ptr(), upd.data_ptr(), b1, b2, eps,
            torch.cuda.current_stream(g.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"adam8bit_blocks_update failed to launch: cudaError_t {err} "
                           f"(g {tuple(g.shape)} {g.dtype})")
    adam8bit_update.launches += 1
    return (upd, *moments)


adam8bit_update.launches = 0
