// Tiled GaLore projections for Hopper (sm_90a): R = Pᵀ G and G̃ = α P N.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/galore_project.py:
//   galore_project       (_project_kernel) -> galore_project
//   galore_project_back  (_back_kernel)    -> galore_project_back
// which the reference's fp32 fused emit step composes, around a plain Adam
// update, for leaves whose projector does not fit its fused kernel's VMEM
// budget (repro/kernels/ops.py:75-79 and :98-105; at llama_7b width every
// GaLore leaf at r >= 512).
//
// Per stacked leaf l (leading dims flattened into one grid axis, as the
// Pallas grid's axis 0):
//   galore_project:       R[l] = P[l]ᵀ G[l]      P (m, r) f32, G (m, n) f32 or
//                                                 bf16 -> R (r, n) f32
//   galore_project_back:  G̃[l] = α P[l] N[l]     P (m, r), N (r, n) f32 ->
//                                                 G̃ (m, n) f32, α applied in
//                                                 f32 after the accumulation
// The right-side leaf contracts over swapaxes(G) and returns swapaxes(G̃);
// `g_t` reads G stored transposed, (n, m), and `out_t` writes G̃ transposed,
// (n, m), so neither transpose is copied in device memory.
//
// What bounds it on an H100. At the paper's 7B rank, (m, r, n) =
// (4096, 1024, 11008) with L = 2, one launch does 2·L·m·r·n = 184.7 GFLOP
// (2.76 ms at 67 TFLOP/s of f32 FMA) and moves at most G 180 MB (bf16) +
// P 34 MB + R 90 MB (≈ 0.09 ms at 3.35 TB/s): arithmetic, by 30x. The f32
// accuracy the reference keeps (an f32 accumulator over f32 products) rules
// out a single TF32 or bf16 tensor-core pass; a split-precision (3xTF32)
// scheme on tensor cores is the way past the f32 FMA rate, left to a later
// change.
//
// Design: one generic batched SIMT GEMM, C = α A B with an f32 accumulator,
// templated on the storage order of A, B and C and on B's element type.
//   grid = (⌈N/128⌉, ⌈M/128⌉, L); 256 threads; a 128 x 128 tile of C a block,
//   an 8 x 8 register tile a thread (two 4-wide groups 64 apart in each
//   direction, so the warp's shared-memory reads are broadcasts or 16-byte
//   vectors without conflicts).
//   The contraction walks K in 16-deep steps through two shared-memory
//   buffers: the next step's tiles are loaded into registers while the
//   current one is multiplied, then stored to the other buffer, one barrier
//   a step. Tiles are kept k-major in shared memory whatever the storage
//   order in device memory; a transposed operand is transposed while staged.
//   Ragged M, N and K are masked: staged values past an edge are zero (the
//   Pallas kernels' `jnp.where(valid, ·, 0)`), stores past an edge skipped.
// Sums run in a fixed order (per thread over K), not the plain PyTorch
// version's; tolerance 1e-5·max|want| with TF32 off.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kBM = 128;       // rows of C a block
constexpr int kBN = 128;       // columns of C a block
constexpr int kBK = 16;        // contraction depth staged a step
constexpr int kLd = kBM + 4;   // padded row of a k-major stage (16-byte aligned)
constexpr int kPer = kBM * kBK / kThreads;  // 8 values of each operand a thread stages
static_assert(kBM == kBN, "the A and B stages share one geometry");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Stage value e (0..kPer) of this thread: its (k, i) inside a kBK x kBM tile.
// A k-major operand (stored with the contraction as rows) is read along its
// rows, so consecutive threads take consecutive i; an i-major one along k.
template <bool kKMajor>
__device__ __forceinline__ void stage_pos(int tid, int e, int& k, int& i) {
  if (kKMajor) {
    k = tid / kBM + e * (kThreads / kBM);
    i = tid % kBM;
  } else {
    k = tid % kBK;
    i = tid / kBK + e * (kThreads / kBK);
  }
}

// Load one operand's values of the step at k0 into registers: X is (K, D)
// row-major when kKMajor, else (D, K); tile columns start at d0; zero past
// the edges of D and K.
template <bool kKMajor, typename T>
__device__ __forceinline__ void load_stage(const T* __restrict__ X, int D, int K, int d0, int k0,
                                           int tid, float (&reg)[kPer]) {
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    int k, i;
    stage_pos<kKMajor>(tid, e, k, i);
    const int kk = k0 + k, dd = d0 + i;
    float v = 0.f;
    if (kk < K && dd < D) v = to_f32(X[kKMajor ? kk * D + dd : dd * K + kk]);
    reg[e] = v;
  }
}

template <bool kKMajor>
__device__ __forceinline__ void store_stage(float (*S)[kLd], int tid, const float (&reg)[kPer]) {
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    int k, i;
    stage_pos<kKMajor>(tid, e, k, i);
    S[k][i] = reg[e];
  }
}

// C[l] = alpha · A[l] B[l], A (M x K), B (K x N), f32 accumulate.
//   kAT: A stored (K, M) row-major, else (M, K);
//   kBT: B stored (N, K) row-major, else (K, N); BT its element type;
//   kCT: C stored (N, M) row-major, else (M, N).
// Element offsets inside one leaf are 32-bit (the host refuses larger leaves).
template <bool kAT, bool kBT, bool kCT, typename BT>
__global__ void __launch_bounds__(kThreads, 2)
gemm_kernel(const float* __restrict__ A, const BT* __restrict__ B, float* __restrict__ C, int M,
            int N, int K, float alpha) {
  __shared__ __align__(16) float As[2][kBK][kLd];
  __shared__ __align__(16) float Bs[2][kBK][kLd];
  const size_t l = blockIdx.z;
  A += l * M * K;
  B += l * K * N;
  C += l * M * N;
  const int i0 = blockIdx.y * kBM, j0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  // The thread's rows tr*4 + {0..3} and 64 + tr*4 + {0..3}, columns likewise
  // from tc. With C transposed the roles swap, so that the lanes of a warp
  // walk C's contiguous axis (i) when they store.
  const int tr = kCT ? tid % 16 : tid / 16;
  const int tc = kCT ? tid / 16 : tid % 16;

  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;

  float ra[kPer], rb[kPer];
  load_stage<kAT>(A, M, K, i0, 0, tid, ra);
  load_stage<!kBT>(B, N, K, j0, 0, tid, rb);
  store_stage<kAT>(As[0], tid, ra);
  store_stage<!kBT>(Bs[0], tid, rb);
  __syncthreads();

  const int steps = (K + kBK - 1) / kBK;
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < steps;
    if (more) {  // the next step's loads are in flight while this one multiplies
      load_stage<kAT>(A, M, K, i0, (s + 1) * kBK, tid, ra);
      load_stage<!kBT>(B, N, K, j0, (s + 1) * kBK, tid, rb);
    }
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][tr * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][k][64 + tr * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][k][tc * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][k][64 + tc * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    if (more) {
      store_stage<kAT>(As[cur ^ 1], tid, ra);
      store_stage<!kBT>(Bs[cur ^ 1], tid, rb);
    }
    __syncthreads();
  }

  // C = alpha · acc, four contiguous values a store where they are aligned
  // and inside the edge
  if (!kCT) {
    const bool vec = N % 4 == 0;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int i = i0 + (a / 4) * 64 + tr * 4 + a % 4;
      if (i >= M) continue;
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int j = j0 + g * 64 + tc * 4;
        float* dst = C + i * N + j;
        if (vec && j + 3 < N) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(alpha * acc[a][4 * g], alpha * acc[a][4 * g + 1],
                          alpha * acc[a][4 * g + 2], alpha * acc[a][4 * g + 3]);
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (j + b < N) dst[b] = alpha * acc[a][4 * g + b];
        }
      }
    }
  } else {
    const bool vec = M % 4 == 0;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int j = j0 + (b / 4) * 64 + tc * 4 + b % 4;
      if (j >= N) continue;
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int i = i0 + g * 64 + tr * 4;
        float* dst = C + j * M + i;
        if (vec && i + 3 < M) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(alpha * acc[4 * g][b], alpha * acc[4 * g + 1][b],
                          alpha * acc[4 * g + 2][b], alpha * acc[4 * g + 3][b]);
        } else {
#pragma unroll
          for (int a = 0; a < 4; ++a)
            if (i + a < M) dst[a] = alpha * acc[4 * g + a][b];
        }
      }
    }
  }
}

// Refuse shapes the grid or the 32-bit in-leaf offsets cannot hold.
bool valid(int L, int M, int N, int K) {
  if (L <= 0 || M <= 0 || N <= 0 || K <= 0 || L > 65535 || (M + kBM - 1) / kBM > 65535)
    return false;
  const long long lim = 1LL << 31;
  return (long long)M * K < lim && (long long)K * N < lim && (long long)M * N < lim;
}

template <bool kAT, bool kBT, bool kCT, typename BT>
int launch(const float* A, const void* B, float* C, int L, int M, int N, int K, double alpha,
           void* stream) {
  if (!valid(L, M, N, K)) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, L);
  gemm_kernel<kAT, kBT, kCT, BT><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      A, static_cast<const BT*>(B), C, M, N, K, (float)alpha);
  return (int)cudaGetLastError();
}

}  // namespace

// R[l] = P[l]ᵀ G[l]. P (L, m, r) f32; G (L, m, n) f32 or bf16 (g_bf16 = 1), or
// with g_t = 1 stored transposed as (L, n, m); R (L, r, n) f32. All contiguous.
// Returns a cudaError_t (0 on success).
extern "C" int galore_project(const float* P, const void* G, int g_bf16, int g_t, float* R, int L,
                              int m, int r, int n, void* stream) {
  // C = R (M = r, N = n), A = Pᵀ stored (K = m, M = r), B = G
  if (g_t)
    return g_bf16 ? launch<true, true, false, __nv_bfloat16>(P, G, R, L, r, n, m, 1.0, stream)
                  : launch<true, true, false, float>(P, G, R, L, r, n, m, 1.0, stream);
  return g_bf16 ? launch<true, false, false, __nv_bfloat16>(P, G, R, L, r, n, m, 1.0, stream)
                : launch<true, false, false, float>(P, G, R, L, r, n, m, 1.0, stream);
}

// out[l] = alpha · P[l] N[l]. P (L, m, r) f32, N (L, r, n) f32; out (L, m, n)
// f32, or with out_t = 1 written transposed as (L, n, m). All contiguous.
// Returns a cudaError_t (0 on success).
extern "C" int galore_project_back(const float* P, const float* N, float* out, int out_t, int L,
                                   int m, int r, int n, double alpha, void* stream) {
  // C = out (M = m, N = n), A = P stored (M, K = r), B = N stored (K, N)
  return out_t ? launch<false, false, true, float>(P, N, out, L, m, n, r, alpha, stream)
               : launch<false, false, false, float>(P, N, out, L, m, n, r, alpha, stream);
}
