// Fused GaLore-Adam leaf step for Hopper (sm_90a), one kernel per side.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/galore_fused.py:
//   galore_fused_adam_step        (_fused_kernel)       -> galore_fused_adam_left
//   galore_fused_adam_step_right  (_fused_right_kernel) -> galore_fused_adam_right
//
// Left side (m <= n), per stacked leaf l:
//   R  = Pᵀ G                         P (m, r) f32, G (m, n) f32 or bf16
//   M' = b1 M + (1-b1) R,  V' = b2 V + (1-b2) R²      M, V (r, n) f32, in place
//   N̂  = (M'/c1) / (sqrt(V'/c2) + eps),  c_i = 1 - b_i^count
//   G̃  = alpha P N̂                    (m, n) f32
// Right side (m > n) is the transpose: P (n, r), M/V (m, r), R = G P,
// G̃ = alpha N̂ Pᵀ. `count` is read from device memory, so no leaf forces a
// host sync; c1/c2 are computed here in f32 as the reference does.
//
// What bounds it on an H100. At the main path's largest left leaf
// (m, r, n) = (4096, 128, 11008) with bf16 G, one leaf moves at least
// G 90.2 MB + G̃ 180.4 MB + M/V read and written 22.5 MB + P 2.1 MB ≈ 295 MB
// (≈ 88 µs at 3.35 TB/s) but does 4·m·r·n = 23.1 GFLOP in its two
// contractions (≈ 345 µs at 67 TFLOP/s of f32 FMA). So the kernel is bound by
// arithmetic, not memory; tensor cores with a split-precision scheme that
// keeps f32 accuracy are the next step.
//
// Design. The Pallas kernel keeps all of P resident in VMEM; at m = 4096 that
// is 2 MB for r = 128 and 16 MB for r = 1024, far over the 227 KB of shared
// memory a Hopper block can use. Here P is streamed instead:
//   grid = (tiles of BN columns of the swept axis, L); 256 threads.
//   Phase 1: loop over the contraction axis in kBK-row chunks, staging a P
//            chunk and a G chunk in shared memory; a 16x16 thread grid keeps a
//            128 x BN tile of R in registers (8 x BN/16 per thread). For
//            r > 128 the loop repeats per 128 rows of R, re-reading G from L2.
//   Phase 2: Adam elementwise on the R tile, which lives in shared memory
//            (r x BN f32); M' and V' go back to device memory in place; N̂
//            replaces R in shared memory.
//   Phase 3: loop over the kept axis in 128-row chunks, re-staging P, and write
//            G̃ = alpha P N̂ for the tile (the right side transposes the tile
//            through shared memory so its stores stay coalesced).
// P is read twice per block; it is at most 16 MB and stays in the 50 MB L2.
// Ragged m, n and r are masked: staged values past an edge are zero, and
// stores past an edge are skipped. BN (64, 32 or 16) is chosen on the host so
// that the r x BN tile fits shared memory (r = 1024 -> BN = 32) and the grid
// covers the card. Contractions are plain f32 FMA in a fixed order; only the
// summation order differs from the plain PyTorch version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;   // a 16 x 16 thread grid
constexpr int kTR = 8;          // register-tile rows per thread
constexpr int kRC = 16 * kTR;   // 128: rows of one register tile
constexpr int kBK = 32;         // contraction depth staged per step
constexpr int kAS = kRC + 1;    // padded row stride of the A stage
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a Hopper block may use

__device__ __forceinline__ float load_f32(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

struct AdamCoef {
  float b1, omb1, b2, omb2, eps, c1, c2;
};

__device__ __forceinline__ AdamCoef adam_coef(float b1, float omb1, float b2, float omb2,
                                              float eps, const int* count) {
  const float t = static_cast<float>(*count);
  return {b1, omb1, b2, omb2, eps, 1.f - powf(b1, t), 1.f - powf(b2, t)};
}

// Updates m and v in place and returns N̂ for one element.
__device__ __forceinline__ float adam_elem(const AdamCoef& a, float r, float* m, float* v) {
  const float mn = a.b1 * *m + a.omb1 * r;
  const float vn = a.b2 * *v + a.omb2 * r * r;
  *m = mn;
  *v = vn;
  return (mn / a.c1) / (sqrtf(vn / a.c2) + a.eps);
}

// acc[i][j] += sum_kk A[kk][ty + 16 i] * B[kk][tx + 16 j] over one staged chunk.
// Within a warp the A reads are two-address broadcasts and the B reads 16
// consecutive words, so neither has bank conflicts.
template <int TN>
__device__ __forceinline__ void stage_fma(const float* __restrict__ A, const float* __restrict__ B,
                                          int bs, float (&acc)[kTR][TN], int tx, int ty) {
#pragma unroll 4
  for (int kk = 0; kk < kBK; ++kk) {
    float a[kTR], b[TN];
#pragma unroll
    for (int i = 0; i < kTR; ++i) a[i] = A[kk * kAS + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = B[kk * bs + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int TN>
__device__ __forceinline__ void zero_acc(float (&acc)[kTR][TN]) {
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// A[kk][c] <- P[k0 + kk][c0 + c] for a row-major (rows x cols) P: contraction
// over P's rows, output rows along P's columns (the rank axis).
__device__ __forceinline__ void stage_p_rows(float* As, const float* __restrict__ P, int rows,
                                             int cols, int k0, int c0, int tid) {
  const int c = tid % kRC;
#pragma unroll
  for (int i = 0; i < kBK * kRC / kThreads; ++i) {  // a fixed trip count unrolls: loads overlap
    const int kk = tid / kRC + (kThreads / kRC) * i;
    const int k = k0 + kk, col = c0 + c;
    As[kk * kAS + c] = (k < rows && col < cols) ? P[(size_t)k * cols + col] : 0.f;
  }
}

// A[kk][c] <- P[c0 + c][k0 + kk]: contraction over P's columns (the rank
// axis), output rows along P's rows.
__device__ __forceinline__ void stage_p_cols(float* As, const float* __restrict__ P, int rows,
                                             int cols, int c0, int k0, int tid) {
  const int kk = tid % kBK;
#pragma unroll
  for (int i = 0; i < kBK * kRC / kThreads; ++i) {
    const int c = tid / kBK + (kThreads / kBK) * i;
    const int row = c0 + c, k = k0 + kk;
    As[kk * kAS + c] = (row < rows && k < cols) ? P[(size_t)row * cols + k] : 0.f;
  }
}

template <int TN>
__device__ __forceinline__ void store_tile(float* Rs, int rs, int r0, const float (&acc)[kTR][TN],
                                           int tx, int ty) {
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) Rs[(r0 + ty + 16 * i) * rs + tx + 16 * j] = acc[i][j];
}

// Left side: one block per (column tile of n, stacked leaf l).
template <int TN, typename GT>
__global__ void __launch_bounds__(kThreads)
    galore_fused_left_kernel(const float* __restrict__ P, const GT* __restrict__ G,
                             float* __restrict__ M, float* __restrict__ V,
                             const int* __restrict__ count, float* __restrict__ out, int m, int r,
                             int n, float b1, float omb1, float b2, float omb2, float eps,
                             float alpha) {
  constexpr int BN = 16 * TN;
  constexpr int RS = BN + 1;  // padded stride of the R / N̂ tile and of the B stage
  extern __shared__ float smem[];
  const int r_pad = (r + kRC - 1) / kRC * kRC;
  float* Rs = smem;                       // r_pad x RS
  float* As = Rs + (size_t)r_pad * RS;    // kBK x kAS
  float* Bs = As + kBK * kAS;             // kBK x RS
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int c0 = blockIdx.x * BN;
  const size_t l = blockIdx.y;
  P += l * m * r;
  G += l * m * n;
  M += l * r * n;
  V += l * r * n;
  out += l * m * n;

  // Phase 1: R tile (r x BN) = Pᵀ G[:, c0:c0+BN], contraction over m.
  for (int rc0 = 0; rc0 < r_pad; rc0 += kRC) {
    float acc[kTR][TN];
    zero_acc(acc);
    for (int k0 = 0; k0 < m; k0 += kBK) {
      stage_p_rows(As, P, m, r, k0, rc0, tid);
#pragma unroll
      for (int i = 0; i < kBK * BN / kThreads; ++i) {
        const int kk = tid / BN + (kThreads / BN) * i, c = tid % BN;
        const int k = k0 + kk, col = c0 + c;
        Bs[kk * RS + c] = (k < m && col < n) ? load_f32(G, (size_t)k * n + col) : 0.f;
      }
      __syncthreads();
      stage_fma<TN>(As, Bs, RS, acc, tx, ty);
      __syncthreads();
    }
    store_tile(Rs, RS, rc0, acc, tx, ty);
  }
  __syncthreads();

  // Phase 2: Adam on the tile; M/V (r x n) rows are contiguous along n.
  const AdamCoef a = adam_coef(b1, omb1, b2, omb2, eps, count);
  for (int e = tid; e < r_pad * BN; e += kThreads) {
    const int rr = e / BN, c = e % BN, col = c0 + c;
    float nh = 0.f;
    if (rr < r && col < n) {
      const size_t off = (size_t)rr * n + col;
      float mv = M[off], vv = V[off];
      nh = adam_elem(a, Rs[rr * RS + c], &mv, &vv);
      M[off] = mv;
      V[off] = vv;
    }
    Rs[rr * RS + c] = nh;
  }
  __syncthreads();

  // Phase 3: G̃[m0:m0+128, c0:c0+BN] = alpha P[m0:m0+128, :] N̂, contraction over r.
  for (int m0 = 0; m0 < m; m0 += kRC) {
    float acc[kTR][TN];
    zero_acc(acc);
    for (int k0 = 0; k0 < r; k0 += kBK) {
      stage_p_cols(As, P, m, r, m0, k0, tid);
      __syncthreads();
      stage_fma<TN>(As, Rs + (size_t)k0 * RS, RS, acc, tx, ty);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int row = m0 + ty + 16 * i, col = c0 + tx + 16 * j;
        if (row < m && col < n) out[(size_t)row * n + col] = alpha * acc[i][j];
      }
  }
}

// Right side: one block per (row tile of m, stacked leaf l).
template <int TN, typename GT>
__global__ void __launch_bounds__(kThreads)
    galore_fused_right_kernel(const float* __restrict__ P, const GT* __restrict__ G,
                              float* __restrict__ M, float* __restrict__ V,
                              const int* __restrict__ count, float* __restrict__ out, int m, int r,
                              int n, float b1, float omb1, float b2, float omb2, float eps,
                              float alpha) {
  constexpr int BM = 16 * TN;
  constexpr int RS = BM + 1;
  extern __shared__ float smem[];
  const int r_pad = (r + kRC - 1) / kRC * kRC;
  float* Rs = smem;                       // r_pad x RS: the tile of Rᵀ, then N̂ᵀ
  float* As = Rs + (size_t)r_pad * RS;    // kBK x kAS
  float* Bs = As + kBK * kAS;             // kBK x RS
  float* Os = Bs + kBK * RS;              // BM x kAS: output transpose
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * BM;
  const size_t l = blockIdx.y;
  P += l * n * r;
  G += l * m * n;
  M += l * m * r;
  V += l * m * r;
  out += l * m * n;

  // Phase 1: Rᵀ tile (r x BM) = Pᵀ G[row0:row0+BM, :]ᵀ, contraction over n.
  for (int rc0 = 0; rc0 < r_pad; rc0 += kRC) {
    float acc[kTR][TN];
    zero_acc(acc);
    for (int k0 = 0; k0 < n; k0 += kBK) {
      stage_p_rows(As, P, n, r, k0, rc0, tid);
#pragma unroll
      for (int i = 0; i < kBK * BM / kThreads; ++i) {
        const int kk = tid % kBK, c = tid / kBK + (kThreads / kBK) * i;
        const int k = k0 + kk, row = row0 + c;
        Bs[kk * RS + c] = (row < m && k < n) ? load_f32(G, (size_t)row * n + k) : 0.f;
      }
      __syncthreads();
      stage_fma<TN>(As, Bs, RS, acc, tx, ty);
      __syncthreads();
    }
    store_tile(Rs, RS, rc0, acc, tx, ty);
  }
  __syncthreads();

  // Phase 2: Adam; M/V (m x r) rows are contiguous along r, so walk r fastest.
  const AdamCoef a = adam_coef(b1, omb1, b2, omb2, eps, count);
  for (int e = tid; e < BM * r_pad; e += kThreads) {
    const int c = e / r_pad, rr = e % r_pad, row = row0 + c;
    float nh = 0.f;
    if (rr < r && row < m) {
      const size_t off = (size_t)row * r + rr;
      float mv = M[off], vv = V[off];
      nh = adam_elem(a, Rs[rr * RS + c], &mv, &vv);
      M[off] = mv;
      V[off] = vv;
    }
    Rs[rr * RS + c] = nh;
  }
  __syncthreads();

  // Phase 3: G̃ᵀ[n0:n0+128, row0:row0+BM] = alpha P[n0:n0+128, :] N̂ᵀ, contraction over r.
  for (int n0 = 0; n0 < n; n0 += kRC) {
    float acc[kTR][TN];
    zero_acc(acc);
    for (int k0 = 0; k0 < r; k0 += kBK) {
      stage_p_cols(As, P, n, r, n0, k0, tid);
      __syncthreads();
      stage_fma<TN>(As, Rs + (size_t)k0 * RS, RS, acc, tx, ty);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) Os[(tx + 16 * j) * kAS + ty + 16 * i] = alpha * acc[i][j];
    __syncthreads();
    for (int e = tid; e < BM * kRC; e += kThreads) {
      const int j = e / kRC, i = e % kRC;
      const int row = row0 + j, col = n0 + i;
      if (row < m && col < n) out[(size_t)row * n + col] = Os[j * kAS + i];
    }
    __syncthreads();
  }
}

size_t smem_bytes(int tn, int r, bool right) {
  const size_t bn = 16 * tn, rs = bn + 1;
  const size_t r_pad = (size_t)(r + kRC - 1) / kRC * kRC;
  size_t words = r_pad * rs + (size_t)kBK * kAS + (size_t)kBK * rs;
  if (right) words += bn * kAS;
  return words * sizeof(float);
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return sms;
}

// Widest tile (TN 4, 2, 1 -> 64, 32, 16 columns) whose shared memory fits and
// whose grid still gives every SM a block; else the narrowest tile that fits.
// Returns 0 when no tile fits (r too large).
int pick_tn(int r, int swept, int L, bool right) {
  const int sms = sm_count();
  int fit = 0;
  for (int tn = 4; tn >= 1; tn /= 2) {
    if (smem_bytes(tn, r, right) > kMaxSmem) continue;
    fit = tn;
    const long blocks = (long)((swept + 16 * tn - 1) / (16 * tn)) * L;
    if (blocks >= sms) return tn;
  }
  return fit;
}

template <int TN, typename GT>
cudaError_t launch(bool right, const float* P, const void* G, float* M, float* V, const int* count,
                   float* out, int L, int m, int r, int n, double b1, double b2, double eps,
                   double alpha, cudaStream_t stream) {
  auto kern = right ? &galore_fused_right_kernel<TN, GT> : &galore_fused_left_kernel<TN, GT>;
  const size_t smem = smem_bytes(TN, r, right);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int swept = right ? m : n;
  const dim3 grid((swept + 16 * TN - 1) / (16 * TN), L);
  kern<<<grid, kThreads, smem, stream>>>(
      P, static_cast<const GT*>(G), M, V, count, out, m, r, n, (float)b1, (float)(1.0 - b1),
      (float)b2, (float)(1.0 - b2), (float)eps, (float)alpha);
  return cudaGetLastError();
}

template <typename GT>
cudaError_t dispatch(bool right, const float* P, const void* G, float* M, float* V,
                     const int* count, float* out, int L, int m, int r, int n, double b1,
                     double b2, double eps, double alpha, cudaStream_t stream) {
  if (L <= 0 || m <= 0 || r <= 0 || n <= 0 || L > 65535) return cudaErrorInvalidValue;
  switch (pick_tn(r, right ? m : n, L, right)) {
    case 4:
      return launch<4, GT>(right, P, G, M, V, count, out, L, m, r, n, b1, b2, eps, alpha, stream);
    case 2:
      return launch<2, GT>(right, P, G, M, V, count, out, L, m, r, n, b1, b2, eps, alpha, stream);
    case 1:
      return launch<1, GT>(right, P, G, M, V, count, out, L, m, r, n, b1, b2, eps, alpha, stream);
    default:
      return cudaErrorInvalidValue;  // the r x 16 tile does not fit shared memory
  }
}

int run(bool right, const float* P, const void* G, int g_bf16, float* M, float* V,
        const int* count, float* out, int L, int m, int r, int n, double b1, double b2,
        double eps, double alpha, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_bf16)
    return (int)dispatch<__nv_bfloat16>(right, P, G, M, V, count, out, L, m, r, n, b1, b2, eps,
                                        alpha, s);
  return (int)dispatch<float>(right, P, G, M, V, count, out, L, m, r, n, b1, b2, eps, alpha, s);
}

}  // namespace

// P (L, m, r) f32, G (L, m, n) f32 or bf16 (g_bf16 = 1), M/V (L, r, n) f32
// updated in place, count -> int32 on the device, out (L, m, n) f32; all
// contiguous. Returns a cudaError_t (0 on success).
extern "C" int galore_fused_adam_left(const float* P, const void* G, int g_bf16, float* M,
                                      float* V, const int* count, float* out, int L, int m, int r,
                                      int n, double b1, double b2, double eps, double alpha,
                                      void* stream) {
  return run(false, P, G, g_bf16, M, V, count, out, L, m, r, n, b1, b2, eps, alpha, stream);
}

// P (L, n, r) f32, G (L, m, n) f32 or bf16, M/V (L, m, r) f32 updated in
// place, count -> int32 on the device, out (L, m, n) f32; all contiguous.
extern "C" int galore_fused_adam_right(const float* P, const void* G, int g_bf16, float* M,
                                       float* V, const int* count, float* out, int L, int m, int r,
                                       int n, double b1, double b2, double eps, double alpha,
                                       void* stream) {
  return run(true, P, G, g_bf16, M, V, count, out, L, m, r, n, b1, b2, eps, alpha, stream);
}
