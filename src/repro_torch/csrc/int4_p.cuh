// A packed int4 projector, decoded while it is staged into shared memory.
// Included by galore_fused.cu (the fp32-moment kernels), whose stages have
// this geometry: kStageK rows of the contraction by kStageW = 128 output
// columns, a padded row stride of kStageS floats, filled by kStageThreads
// threads; and by galore_epilogue.cu (the int8-moment kernel), which decodes
// the TMA's copies of the codes in registers with `decode`.
//
// The layout is codec.quantize4_axis's (the reference's quant/codec.py): P
// (kept, r) blocked along the kept axis in blocks of 128 (QBLOCK), codes q
// (kept_pad/2, r) u8 and scales s (kept_pad/128, r) f32, kept_pad = 128 ⌈kept/128⌉.
// Row i < kept_pad/2 sits in the low nibble of byte row i, row i >= kept_pad/2
// in the high nibble of byte row i - kept_pad/2. A value is book4[nibble] *
// scale in one f32 multiply, the order of dequantize4_axis, so a staged value
// is bitwise the host-dequantized P's; rows past the logical kept dim are never
// read.
#pragma once

#include <stddef.h>
#include <stdint.h>

namespace int4p {

constexpr int kStageK = 32;
constexpr int kStageW = 128;  // also the int4 scale block
constexpr int kStageS = kStageW + 1;
constexpr int kStageThreads = 256;

struct P4 {
  const uint8_t* q;
  const float* s;
  const float* book;  // the 16 int4 codes, in shared memory
  int rows, cols, half;
};

// Leaf l of a stacked int4 P of logical shape (L, kept, r).
__device__ __forceinline__ P4 p4_leaf(const uint8_t* q, const float* s, const float* book,
                                      size_t l, int kept, int r) {
  const int kept_pad = (kept + kStageW - 1) / kStageW * kStageW;
  return P4{q + l * (size_t)(kept_pad / 2) * r, s + l * (size_t)(kept_pad / kStageW) * r, book,
            kept, r, kept_pad / 2};
}

constexpr int kStageN = kStageK * kStageW / kStageThreads;  // values a thread stages

// One value from its code byte: the low nibble, or the high one (`hi`).
__device__ __forceinline__ float decode(const P4& p, unsigned byte, bool hi, float scale) {
  return __fmul_rn(p.book[hi ? (byte >> 4) : (byte & 0xFu)], scale);
}

// Each staging issues a thread's code loads kBatch at a time (all of them by
// default) before it decodes any of the batch, so the loads are in flight
// together. A value past P's edge reads no byte: it
// takes code 7 (0x77 in both nibbles), whose book value is exactly 0, so it
// stages 0 * scale = +0, as the f32 staging stages 0.

// buf[kk][c] = P(k0 + kk, c0 + c): contraction along P's rows. Each thread
// stages one column c = tid % 128, rows kk = tid / 128 + 2i. The caller keeps
// k0 % kStageK == 0, so a stage lies in one scale block (and on one side of
// `half`, a multiple of 64): each thread loads its scale once.
template <int kBatch = kStageN>
__device__ __forceinline__ void stage_rows(float* buf, const P4& p, int k0, int c0, int tid) {
  const int c = tid % kStageW, col = c0 + c;
  const bool hi = k0 >= p.half;
  const bool col_ok = col < p.cols;
  const float sc = (col_ok && k0 < p.rows) ? p.s[(size_t)(k0 / kStageW) * p.cols + col] : 0.f;
  const size_t byte0 = (size_t)(hi ? k0 - p.half : k0) * p.cols + col;
#pragma unroll
  for (int i0 = 0; i0 < kStageN; i0 += kBatch) {
    unsigned b[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int kk = tid / kStageW + (kStageThreads / kStageW) * (i0 + i);
      b[i] = (col_ok && k0 + kk < p.rows) ? p.q[byte0 + (size_t)kk * p.cols] : 0x77u;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int kk = tid / kStageW + (kStageThreads / kStageW) * (i0 + i);
      buf[kk * kStageS + c] = decode(p, b[i], hi, sc);
    }
  }
}

// buf[kk][c] = P(c0 + c, k0 + kk): contraction along P's columns (the rank).
// Each thread stages one column k0 + kk, kk = tid % 32, rows c = tid / 32 + 8i.
// The caller keeps c0 % 128 == 0, so the stage's rows lie in one scale block.
template <int kBatch = kStageN>
__device__ __forceinline__ void stage_cols(float* buf, const P4& p, int c0, int k0, int tid) {
  const int kk = tid % kStageK, col = k0 + kk;
  const bool col_ok = col < p.cols;
  const float sc = (col_ok && c0 < p.rows) ? p.s[(size_t)(c0 / kStageW) * p.cols + col] : 0.f;
#pragma unroll
  for (int i0 = 0; i0 < kStageN; i0 += kBatch) {
    unsigned b[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int row = c0 + tid / kStageK + (kStageThreads / kStageK) * (i0 + i);
      b[i] = (col_ok && row < p.rows)
                 ? p.q[(size_t)(row >= p.half ? row - p.half : row) * p.cols + col]
                 : 0x77u;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int c = tid / kStageK + (kStageThreads / kStageK) * (i0 + i);
      buf[kk * kStageS + c] = decode(p, b[i], c0 + c >= p.half, sc);
    }
  }
}

}  // namespace int4p
