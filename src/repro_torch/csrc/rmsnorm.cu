// RMSNorm for Hopper (sm_90a): out = x · rsqrt(mean(x²) + eps) · scale.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/rmsnorm.py:
//   rmsnorm (_kernel) -> rmsnorm
// x (rows, d) f32 or bf16, scale (d,) f32 or bf16; the arithmetic in f32, the
// output in x's dtype, as the Pallas kernel computes it. No path of the
// reference reaches it (its models call the plain `apply_norm`); it is the
// counterpart of `repro.kernels.ops.rmsnorm`.
//
// What bounds it on an H100: bytes. A row of d values is read once and
// written once and takes ~3 operations a value; at the model's norm input
// (2048 rows x 4096, bf16) that is 33.6 MB, 0.010 ms at 3.35 TB/s, against
// 25 MFLOP. The first design gave each row a block of 256 threads: scalar
// 2-byte loads of x and of the scale at a stride of 256, a shared-memory
// reduction and a __syncthreads a row, 2048 blocks for 2048 rows, each
// reading the scale anew. It took 0.028 ms there against F.rms_norm's 0.018
// with one call between two events, host time included, and 0.0155 against
// 0.0144 by device time (H100 80GB HBM3, 700 W).
//
// Design: a row goes to a group of G warps, and a thread holds at most 32
// values of it (four 16-byte words of bf16, eight of f32) in registers,
// read once and written once with 16-byte loads and stores; neighbouring
// threads take neighbouring words. G is the least power of two whose 32·G
// threads cover d that way: up to 1024 values a warp, so 4096 takes four,
// 8192 eight. A thread also holds the scale of its columns, loaded once, as
// raw words. Thread blocks of 8 warps (8 / G rows at a time) walk the rows
// grid-stride, as many as the card holds at once, so each thread loads its
// scale once for all the rows it normalises; and each group loads its next
// row's words before it reduces and writes the current one, so a second
// row is in flight while the first waits on its sum. The sum of squares is
// reduced by warp shuffles, and for G > 1 across the group's warps through
// 8 floats of shared memory and one __syncthreads a row (double-buffered, so
// one barrier is enough); the warps of a group add the partials in one
// order, so every launch is deterministic. Registers set the split: 32
// values a thread in two row buffers and the scale fit in about 80
// registers in bf16 (three blocks an SM) and about 120 in f32 (two); twice
// as many values a thread would leave too few warps to keep the loads in
// flight. Rows that 16-byte words cannot cover (d not a multiple of the
// word's values, or x, scale or out not 16-byte aligned) take the same
// kernel's element-wise path: strided scalar loads, x read again for the
// output, the scale read where it is used. The word path issues about 80
// instructions a 16-byte word of bf16 (cuobjdump -sass of the sm_90a build:
// 647 for a thread's two rows of four words), ≈ 2.5 µs of issue at
// 2048 x 4096 against 10 µs of bytes: bytes still bound it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 8192;
constexpr int kLaneVals = 32;  // values of a row a thread holds

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// value q of a run of T held in 32-bit words (a bf16 is its f32's top half)
template <typename T>
__device__ __forceinline__ float value(const uint32_t* w, int q) {
  if constexpr (sizeof(T) == 2)
    return __uint_as_float(q % 2 ? w[q / 2] & 0xffff0000u : w[q / 2] << 16);
  else
    return __uint_as_float(w[q]);
}

// kN values of T from p into 32-bit words: one 8- or 16-byte load each 8 or 16 bytes
template <typename T, int kN>
__device__ __forceinline__ void load_words(const T* p, uint32_t* w) {
  constexpr int kRegs = kN * (int)sizeof(T) / 4;
  if constexpr (kRegs == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x, w[1] = v.y;
  } else {
#pragma unroll
    for (int j = 0; j < kRegs / 4; ++j) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[j];
      w[4 * j] = v.x, w[4 * j + 1] = v.y, w[4 * j + 2] = v.z, w[4 * j + 3] = v.w;
    }
  }
}

// one 16-byte word of out from 16 / sizeof(T) f32 values
__device__ __forceinline__ void store_word(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_word(__nv_bfloat16* p, const float* v) {
  uint32_t h[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    h[q] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * q])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * q + 1])) << 16);
  *reinterpret_cast<uint4*>(p) = make_uint4(h[0], h[1], h[2], h[3]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The sum of squares of a group's row (each thread's share in ss) -> the
// row's rsqrt(mean + eps); `part` is this row's half of the partials.
template <int G>
__device__ __forceinline__ float group_inv(float ss, int d, float eps, float* part, int slot,
                                           int warp, int lane) {
  ss = warp_sum(ss);
  if constexpr (G > 1) {
    if (lane == 0) part[warp] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int k = 0; k < G; ++k) ss += part[slot * G + k];
  }
  return rsqrtf(ss / (float)d + eps);
}

// The thread's words of `row` into w (none past the last row).
template <typename XT, int kWords, int kSpan>
__device__ __forceinline__ void load_row(const XT* x, uint32_t (*w)[4], long long row,
                                         long long rows, int d, int t) {
  constexpr int kV = 16 / (int)sizeof(XT);
  if (row >= rows) return;
  const size_t base = (size_t)row * d;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const int c = (t + j * kSpan) * kV;
    if (c < d) load_words<XT, kV>(x + base + c, w[j]);
  }
}

// Normalise the row held in w and write it; every thread of the block takes
// part, as the group's sum may need the barrier.
template <int G, typename XT, typename ST, int kWords, int kScaleRegs>
__device__ __forceinline__ void finish_row(const uint32_t (*w)[4],
                                           const uint32_t (*s)[kScaleRegs], XT* out,
                                           long long row, long long rows, int d, float eps,
                                           int t, float* part, int slot, int warp, int lane) {
  constexpr int kV = 16 / (int)sizeof(XT), kSpan = 32 * G;
  const bool live = row < rows;
  float ss = 0.f;
  if (live) {
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const int c = (t + j * kSpan) * kV;
      if (c < d) {
#pragma unroll
        for (int q = 0; q < kV; ++q) {
          const float v = value<XT>(w[j], q);
          ss = fmaf(v, v, ss);
        }
      }
    }
  }
  const float inv = group_inv<G>(ss, d, eps, part, slot, warp, lane);
  if (!live) return;
  const size_t base = (size_t)row * d;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const int c = (t + j * kSpan) * kV;
    if (c < d) {
      float o[kV];
#pragma unroll
      for (int q = 0; q < kV; ++q) o[q] = (value<XT>(w[j], q) * inv) * value<ST>(s[j], q);
      store_word(out + base + c, o);
    }
  }
}

// A row to each group of G warps; `words`: x, scale and out 16-byte aligned
// and d a multiple of a word's values, else the element-wise path.
template <int G, typename XT, typename ST>
__global__ void __launch_bounds__(kThreads, sizeof(XT) == 2 ? 3 : 2)
rmsnorm_kernel(const XT* __restrict__ x, const ST* __restrict__ scale, XT* __restrict__ out,
               long long rows, int d, float eps, int words) {
  constexpr int kV = 16 / (int)sizeof(XT);   // values a word of x
  constexpr int kWords = kLaneVals / kV;     // words of a row a thread holds
  constexpr int kSpan = 32 * G;              // threads of a row's group
  constexpr int kRowsPer = kWarps / G;
  constexpr int kScaleRegs = kV * (int)sizeof(ST) / 4;
  __shared__ float part[2][kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = warp / G;               // the block's row slot
  const int t = (warp % G) * 32 + lane;    // the thread's rank in its group
  const long long step = (long long)gridDim.x * kRowsPer;
  int it = 0;
  if (!words) {
    for (long long r0 = (long long)blockIdx.x * kRowsPer; r0 < rows; r0 += step, ++it) {
      const long long row = r0 + slot;
      const bool live = row < rows;
      const size_t base = (size_t)(live ? row : 0) * d;
      float ss = 0.f;
      if (live)
        for (int c = t; c < d; c += kSpan) {
          const float v = to_f32(x[base + c]);
          ss = fmaf(v, v, ss);
        }
      const float inv = group_inv<G>(ss, d, eps, part[it & 1], slot, warp, lane);
      if (live)
        for (int c = t; c < d; c += kSpan)
          store(out + base + c, (to_f32(x[base + c]) * inv) * to_f32(scale[c]));
    }
    return;
  }
  uint32_t s[kWords][kScaleRegs];  // the scale of the thread's words, raw
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const int c = (t + j * kSpan) * kV;
    if (c < d) load_words<ST, kV>(scale + c, s[j]);
  }
  // two row buffers: the next row's words load while the current one's sum
  // is formed and its output written (r0 is the same across the block)
  uint32_t wa[kWords][4], wb[kWords][4];
  long long r0 = (long long)blockIdx.x * kRowsPer;
  load_row<XT, kWords, kSpan>(x, wa, r0 + slot, rows, d, t);
  for (; r0 < rows; r0 += 2 * step) {
    load_row<XT, kWords, kSpan>(x, wb, r0 + step + slot, rows, d, t);
    finish_row<G, XT, ST, kWords, kScaleRegs>(wa, s, out, r0 + slot, rows, d, eps, t,
                                              part[it++ & 1], slot, warp, lane);
    if (r0 + step >= rows) break;
    load_row<XT, kWords, kSpan>(x, wa, r0 + 2 * step + slot, rows, d, t);
    finish_row<G, XT, ST, kWords, kScaleRegs>(wb, s, out, r0 + step + slot, rows, d, eps, t,
                                              part[it++ & 1], slot, warp, lane);
  }
}

template <int G, typename XT, typename ST>
int launch_group(const XT* x, const ST* scale, XT* out, long long rows, int d, float eps,
                 int words, cudaStream_t stream) {
  // the thread blocks the card holds at once, found at the first launch: the
  // grid walks the rows with no more, so each thread loads its scale once
  static const int fill = [] {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rmsnorm_kernel<G, XT, ST>,
                                                      kThreads, 0) != cudaSuccess || per_sm < 1)
      per_sm = 1;
    return per_sm * sms;
  }();
  constexpr int kRowsPer = kWarps / G;
  const long long want = (rows + kRowsPer - 1) / kRowsPer;
  const dim3 grid((unsigned)(want < fill ? want : fill));
  rmsnorm_kernel<G, XT, ST><<<grid, kThreads, 0, stream>>>(x, scale, out, rows, d, eps, words);
  return (int)cudaGetLastError();
}

template <typename XT, typename ST>
int launch(const void* x, const void* scale, void* out, long long rows, int d, double eps,
           void* stream) {
  constexpr int kV = 16 / (int)sizeof(XT);  // values a 16-byte word
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(scale) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int words = aligned && d % kV == 0;
  int G = 1;
  while (32 * G * kLaneVals < d) G *= 2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const XT* xp = static_cast<const XT*>(x);
  const ST* sp = static_cast<const ST*>(scale);
  XT* op = static_cast<XT*>(out);
  const float e = (float)eps;
  switch (G) {
    case 1: return launch_group<1>(xp, sp, op, rows, d, e, words, s);
    case 2: return launch_group<2>(xp, sp, op, rows, d, e, words, s);
    case 4: return launch_group<4>(xp, sp, op, rows, d, e, words, s);
    default: return launch_group<8>(xp, sp, op, rows, d, e, words, s);
  }
}

}  // namespace

// x (rows, d) f32 or bf16 (x_bf16 = 1), scale (d,) f32 or bf16 (s_bf16 = 1),
// out (rows, d) in x's dtype; all contiguous; 1 <= d <= 8192. Returns a
// cudaError_t (0 on success).
extern "C" int rmsnorm(const void* x, int x_bf16, const void* scale, int s_bf16, void* out,
                       long long rows, int d, double eps, void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || d <= 0 || d > kMaxD) return (int)cudaErrorInvalidValue;
  if (x_bf16)
    return s_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, d, eps, stream)
                  : launch<__nv_bfloat16, float>(x, scale, out, rows, d, eps, stream);
  return s_bf16 ? launch<float, __nv_bfloat16>(x, scale, out, rows, d, eps, stream)
                : launch<float, float>(x, scale, out, rows, d, eps, stream);
}
