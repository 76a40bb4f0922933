"""Blockwise low-precision codecs for optimizer state (port of the flat INT8
and axis-blocked parts of repro/quant/codec.py, bit for bit).

  * Flat INT8 (``quantize`` / ``dequantize``, ``quant_state`` /
    ``dequant_state``): the dynamic-exponent codebook over ``BLOCK``-element
    blocks of the flattened array, one absmax each, the tail zero-padded —
    the state layout of the standalone 8-bit Adam (``optim/adam8bit.py``)
    and of its kernel (``kernels/adam8bit_update.py``), which finds each
    nearest code in the bracket tables of ``device_code_tables``.
  * Axis-blocked INT8 (``quantize_axis`` / ``dequantize_axis``): the dynamic-
    exponent codebook of Dettmers et al. (2022) over blocks of ``QBLOCK``
    elements along ONE trailing axis — the fused kernel's swept axis — so
    the dequant → Adam → requant epilogue never crosses a block boundary.
    Codes keep the logical shape; scales shrink the blocked axis by QBLOCK.
    Optional stochastic rounding (Q-GaLore) draws its coin from the
    counter hash ``sr_uniform`` of (ravel index, step count, salt), the
    index in the full leaf where the codec holds one rank's block of it.
  * Axis-blocked packed INT4 (``quantize4_axis`` / ``dequantize4_axis``): the
    projector storage the fused kernel reads directly — per-(block, column)
    absmax along the kept axis, the symmetric 15-level map of
    ``int4_codebook``, split-half packing (row i shares a byte with row
    i + m_pad/2).
  * Flat packed INT4 (``quantize4`` / ``dequantize4``, ``quant4_state`` /
    ``dequant4_state``): ``BLOCK``-element blocks of the flattened array,
    even positions in the low nibble — the projector layout of the
    reference's older checkpoints, which ``core/projector.py::read_projector``
    still reads.

The codebooks are the reference's numpy functions, copied, so both packages
decode through identical f32 tables. Every quantize path computes in f32 in
the reference's operation order; ragged tails are zero-padded before the
absmax.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

BLOCK = 256   # flat-codec block (bitsandbytes convention)
QBLOCK = 128  # axis-blocked codec block

# per-moment salts for the stochastic-rounding hash (distinct streams for M
# and V so the two moments of one element never share a coin flip)
SR_SALT_M = 0x5BD1E995
SR_SALT_V = 0xC2B2AE35

_U32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def dynamic_codebook(signed: bool = True) -> np.ndarray:
    """256 sorted codebook values in [-1, 1] (signed) or [0, 1] (unsigned).

    Dynamic-exponent map (Dettmers et al., 2022): sign × power-of-10
    exponent × linear fraction — dense near zero where Adam moments live.
    """
    total_bits = 8
    sign_bits = 1 if signed else 0
    non_sign_bits = total_bits - sign_bits
    max_exp_bits = non_sign_bits - 1  # reserve indicator bit layout
    data = [0.0]
    for e in range(max_exp_bits):
        frac_items = 2 ** (non_sign_bits - 1 - max_exp_bits + e + 1)
        boundaries = np.linspace(0.1, 1.0, frac_items + 1)
        means = (boundaries[:-1] + boundaries[1:]) / 2.0
        vals = (10.0 ** (-(max_exp_bits - 1) + e)) * means
        data += vals.tolist()
        if signed:
            data += (-vals).tolist()
    data.append(1.0)
    if signed:
        data.append(-1.0)
    arr = np.sort(np.unique(np.asarray(data, np.float32)))
    # pad/trim to exactly 256 by inserting midpoints of the largest gaps
    while arr.size < 256:
        gaps = np.diff(arr)
        i = int(np.argmax(gaps))
        arr = np.insert(arr, i + 1, (arr[i] + arr[i + 1]) / 2.0)
    if arr.size > 256:
        keep = np.linspace(0, arr.size - 1, 256).round().astype(int)
        arr = arr[keep]
    return arr.astype(np.float32)


@functools.lru_cache(maxsize=None)
def int4_codebook() -> np.ndarray:
    """16 values: symmetric linear q/7 for q in -7..7; code 15 aliases +1."""
    levels = [(q - 7) / 7.0 for q in range(15)] + [1.0]
    return np.asarray(levels, np.float32)


def _book(signed: bool, device) -> torch.Tensor:
    """The signed or unsigned codebook on `device`: a view of the per-device
    copy, so that a step on the card copies nothing from the host."""
    books = device_codebooks(torch.device(device))
    return books[:256] if signed else books[256:512]


def _mids(book: torch.Tensor) -> torch.Tensor:
    """Midpoints of neighbouring codes, computed as the reference does (f32)."""
    return (book[:-1] + book[1:]) / 2.0


@functools.lru_cache(maxsize=None)
def device_codebooks(device: torch.device) -> torch.Tensor:
    """The signed, unsigned and int4 codebooks (256 + 256 + 16 f32) in one
    tensor on `device`, made once per device: the kernels decode through
    these tables, the reference's own."""
    books = torch.cat([torch.from_numpy(dynamic_codebook(True)),
                       torch.from_numpy(dynamic_codebook(False)),
                       torch.from_numpy(int4_codebook())])
    return books.to(device)


# The bracket tables of the nearest-code rule, which the flat 8-bit Adam
# kernel reads in place of a binary search over the midpoints. A value's
# bucket is keyed by its f32 bits: the sign, the exponent clamped to
# [lo, hi] and the top `bits` mantissa bits (a lower exponent, ±0 among
# them, falls in the sign's first bucket, a higher one in its last). The
# entry is the count of midpoints below the bucket's lowest value, and no
# bucket holds more than one midpoint, so the code of x is
# entry + (mids[entry] < x): searchsorted(mids, x), bit for bit. The
# signed table has a bucket row for each sign, negatives after positives;
# the unsigned table has none for negatives, which take the first bucket
# (every unsigned midpoint is above 0, so their code is 0).
# (lowest exponent, highest exponent, mantissa bits), signed and unsigned;
# csrc/galore_epilogue.cu's Bracket<true> and Bracket<false> hold the same.
BRACKETS = {True: (107, 126, 6), False: (104, 126, 7)}


@functools.lru_cache(maxsize=None)
def bracket_table(signed: bool) -> np.ndarray:
    """The bracket table (uint8) of the signed or unsigned codebook's f32
    midpoints, formed as the kernels form them. Raises if a bucket would
    hold more than one midpoint."""
    lo, hi, bits = BRACKETS[signed]
    book = torch.from_numpy(dynamic_codebook(signed))
    mids = _mids(book)
    n = (hi - lo + 1) << bits
    mag = (torch.arange(n, dtype=torch.int64) + (lo << bits)) << (23 - bits)
    # each bucket's least and greatest magnitude (the clamped ends reach 0 and inf)
    least = mag.to(torch.int32).view(torch.float32).clone()
    most = (mag + (1 << (23 - bits)) - 1).to(torch.int32).view(torch.float32).clone()
    least[0], most[-1] = 0.0, float("inf")
    edges = [(least, most), (-most, -least)] if signed else [(least, most)]
    table, holds = [], []
    for low, high in edges:
        below = torch.searchsorted(mids, low.contiguous())
        table.append(below)
        holds.append(torch.searchsorted(mids, high.contiguous()) - below)
    if int(torch.cat(holds).max()) > 1:
        raise ValueError(f"a bracket bucket of the {'signed' if signed else 'unsigned'} book "
                         f"holds {int(torch.cat(holds).max())} midpoints")
    return torch.cat(table).to(torch.uint8).numpy()


@functools.lru_cache(maxsize=None)
def device_code_tables(device: torch.device) -> torch.Tensor:
    """The signed and unsigned bracket tables (uint8, signed first) in one
    tensor on `device`, made once per device: what the flat kernel reads."""
    tables = np.concatenate([bracket_table(True), bracket_table(False)])
    return torch.from_numpy(tables).to(device)


# ---------------------------------------------------------------------------
# Flat INT8 (blocks of the flattened array)
# ---------------------------------------------------------------------------


def _pad_to_blocks(x: torch.Tensor, block: int = BLOCK) -> tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, block), pad


def quantize_blocks(x_blocks: torch.Tensor, book: torch.Tensor):
    """x (nb, BLOCK) f32 -> (codes u8 (nb, BLOCK), absmax f32 (nb,)); `book`
    the sorted 256-entry codebook. The nearest code is searchsorted(mids, x):
    a value on a midpoint takes the lower code."""
    absmax = torch.amax(torch.abs(x_blocks), dim=1) + 1e-12
    normed = x_blocks / absmax[:, None]
    codes = torch.searchsorted(_mids(book), normed.contiguous(), out_int32=True)
    return codes.to(torch.uint8), absmax


def dequantize_blocks(codes: torch.Tensor, absmax: torch.Tensor, book: torch.Tensor):
    return book[codes.to(torch.int32)] * absmax[:, None]


def quantize(x: torch.Tensor, signed: bool = True):
    """x (any shape) -> (codes uint8 (nblocks, BLOCK), absmax (nblocks,) f32)."""
    blocks, _ = _pad_to_blocks(x.to(torch.float32))
    return quantize_blocks(blocks, _book(signed, x.device))


def dequantize(codes: torch.Tensor, absmax: torch.Tensor, shape, signed: bool = True):
    vals = dequantize_blocks(codes, absmax, _book(signed, codes.device))
    return vals.reshape(-1)[:math.prod(shape)].reshape(shape)


def quant_state(x: torch.Tensor, signed: bool = True) -> dict:
    codes, absmax = quantize(x, signed)
    return {"q": codes, "scale": absmax}


def dequant_state(st: dict, shape, signed: bool = True) -> torch.Tensor:
    return dequantize(st["q"], st["scale"], shape, signed)


# ---------------------------------------------------------------------------
# Flat INT4 (two codes a byte): the reference's legacy projector layout
# ---------------------------------------------------------------------------


def quantize4(x: torch.Tensor):
    """x (any shape) -> (packed uint8 (nblocks, BLOCK//2), absmax (nblocks,)).

    Even flat positions take the low nibble, odd ones the high nibble. Only
    checkpoints of the reference's older projector storage hold this layout;
    `store_projector` writes the axis-blocked one."""
    blocks, _ = _pad_to_blocks(x.to(torch.float32))
    absmax = torch.amax(torch.abs(blocks), dim=1) + 1e-12
    normed = blocks / absmax[:, None]
    q = torch.clamp(torch.round(normed * 7.0), -7, 7).to(torch.int32) + 7  # 0..14
    packed = (q[:, 0::2] | (q[:, 1::2] << 4)).to(torch.uint8)
    return packed, absmax


def dequantize4(packed: torch.Tensor, absmax: torch.Tensor, shape) -> torch.Tensor:
    book = device_codebooks(packed.device)[512:]
    p = packed.to(torch.int64)
    codes = torch.stack([p & 0xF, p >> 4], dim=-1).reshape(p.shape[0], -1)
    vals = book[codes] * absmax[:, None]
    return vals.reshape(-1)[:math.prod(shape)].reshape(shape)


def quant4_state(x: torch.Tensor) -> dict:
    packed, absmax = quantize4(x)
    return {"q": packed, "scale": absmax}


def dequant4_state(st: dict, shape) -> torch.Tensor:
    return dequantize4(st["q"], st["scale"], shape)


# ---------------------------------------------------------------------------
# Axis-blocked INT8 and INT4
# ---------------------------------------------------------------------------


def _blocked(x: torch.Tensor, axis: int, block: int):
    """Pad `axis` (non-negative) to a block multiple and split it into (nb, block)."""
    n = x.shape[axis]
    nb = -(-n // block)
    pad = nb * block - n
    if pad:
        widths = [0, 0] * (x.ndim - 1 - axis) + [0, pad]  # F.pad lists the last axis first
        x = torch.nn.functional.pad(x, widths)
    return x.reshape(x.shape[:axis] + (nb, block) + x.shape[axis + 1:]), nb


def sr_uniform(idx: torch.Tensor, count, salt: int) -> torch.Tensor:
    """Counter-based uniform in [0, 1) from (element index, step count, salt).

    The reference's uint32 hash (Knuth multiply + murmur-style finalizer),
    computed in int64 with the low 32 bits kept after every multiply and
    xor: a wrapped int64 product has the right low 32 bits, and a masked
    value is non-negative, so the shifts are the logical shifts of uint32.
    `idx` holds the ravel indices (any integer dtype, values < 2³² after
    masking); `count` an int or an integer tensor."""
    x = idx.to(torch.int64) & _U32
    cnt = torch.as_tensor(count, device=idx.device).to(torch.int64) & _U32
    x = (x * 2654435761) & _U32
    x = x ^ ((cnt * 0x9E3779B9) & _U32) ^ (salt & _U32)
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _U32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _U32
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * np.float32(1.0 / (1 << 24))


def _stochastic_codes(normed: torch.Tensor, book: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Stochastic codebook rounding: round up with prob = fractional position.

    ``searchsorted(book, x, right=True)`` is the reference's count of codes
    with book ≤ x."""
    ge = torch.searchsorted(book, normed.contiguous(), right=True, out_int32=True)
    lo = torch.clamp(ge - 1, 0, book.shape[0] - 2)
    lo_val = book[lo]
    step = book[lo + 1] - lo_val
    frac = torch.clamp((normed - lo_val) / step, 0.0, 1.0)
    return (lo + (u < frac).to(lo.dtype)).to(torch.uint8)


def ravel_index(shape, device, origin=None) -> torch.Tensor:
    """Each element's ravel index (int64, of `shape`): in `shape` itself, or,
    with `origin` = (dim, offset, full), in the full tensor of which this is
    the block along `dim` that starts at `offset`, that dim `full` long."""
    if origin is None:
        return torch.arange(math.prod(shape), dtype=torch.int64, device=device).reshape(shape)
    dim, offset, full = origin
    dim %= len(shape)
    if offset < 0 or offset + shape[dim] > full:
        raise ValueError(f"a block of {shape[dim]} at {offset} does not lie in {full}")
    idx, stride = torch.zeros((), dtype=torch.int64, device=device), 1
    for d in reversed(range(len(shape))):
        coord = torch.arange(shape[d], dtype=torch.int64, device=device) + (offset if d == dim else 0)
        idx = idx + (coord * stride).reshape((-1,) + (1,) * (len(shape) - 1 - d))
        stride *= full if d == dim else shape[d]
    return idx


def quantize_axis(x: torch.Tensor, *, axis: int = -1, block: int = QBLOCK, signed: bool = True,
                  stochastic: bool = False, count=None, salt: int = 0, origin=None):
    """Blockwise dynamic-INT8 along one trailing axis.

    x (..., n, ...) -> (codes uint8, same shape as x;
                        scales f32, `axis` shrunk to ceil(n/block)).
    Nearest rounding picks ``searchsorted(mids, x)``: the number of midpoints
    strictly below x. With ``stochastic=True`` codes round up with
    probability equal to the fractional position between the bracketing
    codes, keyed by ``sr_uniform`` of (ravel index, `count`, `salt`). Where x
    is one block of a larger leaf (a GaLore-ZeRO rank's), `origin` = (dim,
    offset, full) places it there (``ravel_index``), so that its coins, and
    its codes, are those of the full leaf's elements; nearest rounding
    ignores it."""
    axis = axis % x.ndim
    book = _book(signed, x.device)
    xf = x.to(torch.float32)
    blocks, _ = _blocked(xf, axis, block)
    absmax = torch.amax(torch.abs(blocks), dim=axis + 1) + 1e-12
    normed = blocks / absmax.unsqueeze(axis + 1)
    if stochastic:
        idx = ravel_index(tuple(xf.shape), x.device, origin)
        bidx, _ = _blocked(idx, axis, block)
        u = sr_uniform(bidx, 0 if count is None else count, salt)
        codes = _stochastic_codes(normed, book, u)
    else:
        codes = torch.searchsorted(_mids(book), normed.contiguous(), out_int32=True).to(torch.uint8)
    codes = codes.reshape(x.shape[:axis] + (-1,) + x.shape[axis + 1:])
    codes = codes.narrow(axis, 0, x.shape[axis]).contiguous()
    return codes, absmax


def dequantize_axis(codes: torch.Tensor, scales: torch.Tensor, *, axis: int = -1,
                    block: int = QBLOCK, signed: bool = True) -> torch.Tensor:
    axis = axis % codes.ndim
    vals = _book(signed, codes.device)[codes.to(torch.int32)]
    scale = torch.repeat_interleave(scales, block, dim=axis).narrow(axis, 0, codes.shape[axis])
    return vals * scale


def quant_axis_state(x: torch.Tensor, *, axis: int, signed: bool, block: int = QBLOCK,
                     stochastic: bool = False, count=None, salt: int = 0, origin=None) -> dict:
    codes, scales = quantize_axis(x, axis=axis, block=block, signed=signed,
                                  stochastic=stochastic, count=count, salt=salt, origin=origin)
    return {"q": codes, "scale": scales}


def dequant_axis_state(st: dict, *, axis: int, signed: bool, block: int = QBLOCK) -> torch.Tensor:
    return dequantize_axis(st["q"], st["scale"], axis=axis, block=block, signed=signed)


def quantize4_axis(x: torch.Tensor, *, block: int = QBLOCK):
    """Packed INT4 projector codec, blocked along the kept axis (-2).

    x (..., m, r) -> (packed uint8 (..., m_pad//2, r),
                      scales f32 (..., ceil(m/block), r)).
    Split-half packing: row i sits in the low nibble and row i + m_pad/2 in
    the high nibble of one byte. Padded rows quantize to code 7 (exact 0)."""
    blocks, nb = _blocked(x.to(torch.float32), x.ndim - 2, block)
    absmax = torch.amax(torch.abs(blocks), dim=-2) + 1e-12  # (..., nb, r)
    normed = blocks / absmax.unsqueeze(-2)
    q = torch.clamp(torch.round(normed * 7.0), -7, 7).to(torch.int32) + 7
    q = q.reshape(x.shape[:-2] + (nb * block, x.shape[-1]))
    half = (nb * block) // 2
    packed = (q[..., :half, :] | (q[..., half:, :] << 4)).to(torch.uint8)
    return packed, absmax


def dequantize4_axis(packed: torch.Tensor, scales: torch.Tensor, short: int, *,
                     block: int = QBLOCK) -> torch.Tensor:
    """Inverse of :func:`quantize4_axis`; `short` is the logical kept dim.

    Gather, concatenate, then one f32 multiply by the scale — the order the
    kernel uses, so both dequantize to the same bits."""
    book = device_codebooks(packed.device)[512:]  # the int4 codebook, no host copy
    p = packed.to(torch.int64)
    vals = torch.cat([book[p & 0xF], book[p >> 4]], dim=-2)
    nb = scales.shape[-2]
    blocks = vals.reshape(vals.shape[:-2] + (nb, block, vals.shape[-1]))
    full = (blocks * scales.unsqueeze(-2)).reshape(vals.shape)
    return full[..., :short, :]


def quant4_axis_state(x: torch.Tensor, *, block: int = QBLOCK) -> dict:
    packed, scales = quantize4_axis(x, block=block)
    return {"q": packed, "scale": scales}


def dequant4_axis_state(st: dict, shape, *, block: int = QBLOCK) -> torch.Tensor:
    return dequantize4_axis(st["q"], st["scale"], shape[-2], block=block)


def is_qstate(x) -> bool:
    """True for a quantized-leaf dict ({"q": codes, "scale": absmax})."""
    return isinstance(x, dict) and set(x.keys()) == {"q", "scale"}


def is_axis4_qstate(x) -> bool:
    """True for the axis-blocked packed-INT4 layout of quantize4_axis (codes
    and scales of equal rank; the flat layout has 2-D codes, 1-D scales)."""
    return is_qstate(x) and x["q"].ndim == x["scale"].ndim and x["q"].ndim >= 2
