// A packed int4 projector, decoded in registers by galore_epilogue.cu's
// GaLore kernel from the TMA's (or its threads') copies of the codes and
// scales, with `decode`.
//
// The layout is codec.quantize4_axis's (the reference's quant/codec.py): P
// (kept, r) blocked along the kept axis in blocks of 128 (QBLOCK), codes q
// (kept_pad/2, r) u8 and scales s (kept_pad/128, r) f32, kept_pad = 128 ⌈kept/128⌉.
// Row i < kept_pad/2 sits in the low nibble of byte row i, row i >= kept_pad/2
// in the high nibble of byte row i - kept_pad/2. A value is book4[nibble] *
// scale in one f32 multiply, the order of dequantize4_axis, so a decoded value
// is bitwise the host-dequantized P's; rows past the logical kept dim are never
// read.
#pragma once

#include <stdint.h>

namespace int4p {

constexpr int kStageW = 128;  // the int4 scale block

struct P4 {
  const uint8_t* q;
  const float* s;
  const float* book;  // the 16 int4 codes, in shared memory
  int rows, cols, half;
};

// One value from its code byte: the low nibble, or the high one (`hi`).
__device__ __forceinline__ float decode(const P4& p, unsigned byte, bool hi, float scale) {
  return __fmul_rn(p.book[hi ? (byte >> 4) : (byte & 0xFu)], scale);
}

}  // namespace int4p
