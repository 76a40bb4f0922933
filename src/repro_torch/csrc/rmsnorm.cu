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
// 25 MFLOP.
//
// Design: one block of 256 threads a row (the Pallas kernel's 32-row tile
// becomes 32 blocks), so the row is read from device memory once: each thread
// keeps its kPer = ⌈d/256⌉ values (rounded up to a power of two, d <= 8192) in
// registers, its f32 sum of squares is reduced across the warp by shuffles and
// across the 8 warps through shared memory, and the normalised row is written
// from the registers. Consecutive threads take consecutive columns, so every
// load and store of a warp is contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 8192;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <int kPer, typename XT, typename ST>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const XT* __restrict__ x, const ST* __restrict__ scale, XT* __restrict__ out, int d,
               float eps) {
  __shared__ float part[kWarps];
  const size_t base = (size_t)blockIdx.x * d;
  const int tid = threadIdx.x;
  float v[kPer];
  float ss = 0.f;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int c = tid + e * kThreads;
    v[e] = c < d ? to_f32(x[base + c]) : 0.f;
    ss = fmaf(v[e], v[e], ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (tid % 32 == 0) part[tid / 32] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += part[w];
  const float inv = rsqrtf(total / (float)d + eps);
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int c = tid + e * kThreads;
    if (c < d) store(out + base + c, (v[e] * inv) * to_f32(scale[c]));
  }
}

template <typename XT, typename ST>
int launch(const void* x, const void* scale, void* out, long long rows, int d, double eps,
           void* stream) {
  const int per = (d + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)rows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const XT* xp = static_cast<const XT*>(x);
  const ST* sp = static_cast<const ST*>(scale);
  XT* op = static_cast<XT*>(out);
  const float e = (float)eps;
  if (per <= 1) rmsnorm_kernel<1, XT, ST><<<grid, kThreads, 0, s>>>(xp, sp, op, d, e);
  else if (per <= 2) rmsnorm_kernel<2, XT, ST><<<grid, kThreads, 0, s>>>(xp, sp, op, d, e);
  else if (per <= 4) rmsnorm_kernel<4, XT, ST><<<grid, kThreads, 0, s>>>(xp, sp, op, d, e);
  else if (per <= 8) rmsnorm_kernel<8, XT, ST><<<grid, kThreads, 0, s>>>(xp, sp, op, d, e);
  else if (per <= 16) rmsnorm_kernel<16, XT, ST><<<grid, kThreads, 0, s>>>(xp, sp, op, d, e);
  else rmsnorm_kernel<32, XT, ST><<<grid, kThreads, 0, s>>>(xp, sp, op, d, e);
  return (int)cudaGetLastError();
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
