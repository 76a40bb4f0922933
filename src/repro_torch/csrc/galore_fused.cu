// Fused GaLore-Adam leaf step for Hopper (sm_90a) in its emit form (writes
// G̃), one kernel per side; SIMT, f32 FMA.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/galore_fused.py:
//   galore_fused_adam_step        (_fused_kernel)       -> galore_fused_adam_left
//   galore_fused_adam_step_right  (_fused_right_kernel) -> galore_fused_adam_right
// each with P either f32 or the packed int4 qstate (the fp32-moment emit
// variants of `_fused_epilogue_call` with quant_p, reached through the same
// two functions when P is a qstate). The weight-apply forms with fp32
// moments (`galore_fused_adam_apply_step[_right]`) are galore_epilogue.cu's
// lowrank_adam_kernel, on the tensor cores.
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
// keeps f32 accuracy are the next step (galore_epilogue.cu's kernel has it).
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
// An int4 P (a template parameter, p_int4 = 1) is decoded while it is staged
// (int4_p.cuh, a stage's 16 code loads a thread issued before any is decoded),
// book4[nibble] * scale in f32: bitwise the host-dequantized P,
// so a launch on the packed P gives exactly what a launch on its dequantized
// f32 form gives, and no f32 P is made on the device.
// Ragged m, n and r are masked: staged values past an edge are zero, and
// stores past an edge are skipped. BN (64, 32 or 16) is chosen on the host so
// that the r x BN tile fits shared memory (r = 1024 -> BN = 32) and the grid
// covers the card. Contractions are plain f32 FMA in a fixed order; only the
// summation order differs from the plain PyTorch version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

#include "int4_p.cuh"

namespace {

using int4p::P4;

constexpr int kThreads = 256;   // a 16 x 16 thread grid
constexpr int kTR = 8;          // register-tile rows per thread
constexpr int kRC = 16 * kTR;   // 128: rows of one register tile
constexpr int kBK = 32;         // contraction depth staged per step
constexpr int kAS = kRC + 1;    // padded row stride of the A stage
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a Hopper block may use
constexpr int kBook4 = 512;     // offset of the 16 int4 codes in the wrapper's codebook table
static_assert(kBK == int4p::kStageK && kRC == int4p::kStageW && kAS == int4p::kStageS &&
                  kThreads == int4p::kStageThreads,
              "the int4 P stages of int4_p.cuh assume this kernel's stage geometry");

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

// G̃ (L, m, n) f32. Passed in a struct: with it the emit kernels compile to
// the instructions they had when the struct also carried the weight-apply
// form's W, η and wd (cuobjdump -sass, up to the offsets of the parameters
// after it), so their results are unchanged.
struct Out {
  void* p;
};

// The projector as the wrapper passes it: f32, or packed int4 codes, scales
// and the codebook table (whose 16 int4 codes a block copies to shared memory).
struct PArg {
  const float* f;       // f32 P (L, kept, r), or null
  const uint8_t* q;     // int4 P: codes (L, kept_pad/2, r)
  const float* s;       // int4 P: scales (L, ⌈kept/128⌉, r)
  const float* books;   // int4 P: the codebook table, int4 codes at kBook4
};

// An f32 P of one leaf, row-major (rows x cols).
struct PF {
  const float* p;
  int rows, cols;
};

// A[kk][c] <- P[k0 + kk][c0 + c]: contraction over P's rows, output rows
// along P's columns (the rank axis). (The int4 overload is in int4_p.cuh.)
__device__ __forceinline__ void stage_rows(float* As, const PF& P, int k0, int c0, int tid) {
  const int c = tid % kRC;
#pragma unroll
  for (int i = 0; i < kBK * kRC / kThreads; ++i) {  // a fixed trip count unrolls: loads overlap
    const int kk = tid / kRC + (kThreads / kRC) * i;
    const int k = k0 + kk, col = c0 + c;
    As[kk * kAS + c] = (k < P.rows && col < P.cols) ? P.p[(size_t)k * P.cols + col] : 0.f;
  }
}

// A[kk][c] <- P[c0 + c][k0 + kk]: contraction over P's columns (the rank
// axis), output rows along P's rows.
__device__ __forceinline__ void stage_cols(float* As, const PF& P, int c0, int k0, int tid) {
  const int kk = tid % kBK;
#pragma unroll
  for (int i = 0; i < kBK * kRC / kThreads; ++i) {
    const int c = tid / kBK + (kThreads / kBK) * i;
    const int row = c0 + c, k = k0 + kk;
    As[kk * kAS + c] = (row < P.rows && k < P.cols) ? P.p[(size_t)row * P.cols + k] : 0.f;
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
template <int TN, typename GT, bool kP4>
__global__ void __launch_bounds__(kThreads)
    galore_fused_left_kernel(const PArg p, const GT* __restrict__ G,
                             float* __restrict__ M, float* __restrict__ V,
                             const int* __restrict__ count, const Out o, int m, int r, int n,
                             float b1, float omb1, float b2, float omb2, float eps, float alpha) {
  constexpr int BN = 16 * TN;
  constexpr int RS = BN + 1;  // padded stride of the R / N̂ tile and of the B stage
  extern __shared__ float smem[];
  const int r_pad = (r + kRC - 1) / kRC * kRC;
  float* Rs = smem;                       // r_pad x RS
  float* As = Rs + (size_t)r_pad * RS;    // kBK x kAS
  float* Bs = As + kBK * kAS;             // kBK x RS
  float* book4 = Bs + kBK * RS;           // 16: the int4 codes
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int c0 = blockIdx.x * BN;
  const size_t l = blockIdx.y;
  if (kP4) {
    if (tid < 16) book4[tid] = p.books[kBook4 + tid];
    __syncthreads();
  }
  const PF Pf{kP4 ? nullptr : p.f + l * m * r, m, r};
  const P4 Pi = kP4 ? int4p::p4_leaf(p.q, p.s, book4, l, m, r) : P4{};
  G += l * m * n;
  M += l * r * n;
  V += l * r * n;
  float* out = static_cast<float*>(o.p) + l * m * n;

  // Phase 1: R tile (r x BN) = Pᵀ G[:, c0:c0+BN], contraction over m.
  for (int rc0 = 0; rc0 < r_pad; rc0 += kRC) {
    float acc[kTR][TN];
    zero_acc(acc);
    for (int k0 = 0; k0 < m; k0 += kBK) {
      if (kP4) stage_rows(As, Pi, k0, rc0, tid);
      else stage_rows(As, Pf, k0, rc0, tid);
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
      if (kP4) stage_cols(As, Pi, m0, k0, tid);
      else stage_cols(As, Pf, m0, k0, tid);
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
template <int TN, typename GT, bool kP4>
__global__ void __launch_bounds__(kThreads)
    galore_fused_right_kernel(const PArg p, const GT* __restrict__ G,
                              float* __restrict__ M, float* __restrict__ V,
                              const int* __restrict__ count, const Out o, int m, int r, int n,
                              float b1, float omb1, float b2, float omb2, float eps, float alpha) {
  constexpr int BM = 16 * TN;
  constexpr int RS = BM + 1;
  extern __shared__ float smem[];
  const int r_pad = (r + kRC - 1) / kRC * kRC;
  float* Rs = smem;                       // r_pad x RS: the tile of Rᵀ, then N̂ᵀ
  float* As = Rs + (size_t)r_pad * RS;    // kBK x kAS
  float* Bs = As + kBK * kAS;             // kBK x RS
  float* Os = Bs + kBK * RS;              // BM x kAS: output transpose
  float* book4 = Os + BM * kAS;           // 16: the int4 codes
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * BM;
  const size_t l = blockIdx.y;
  if (kP4) {
    if (tid < 16) book4[tid] = p.books[kBook4 + tid];
    __syncthreads();
  }
  const PF Pf{kP4 ? nullptr : p.f + l * n * r, n, r};
  const P4 Pi = kP4 ? int4p::p4_leaf(p.q, p.s, book4, l, n, r) : P4{};
  G += l * m * n;
  M += l * m * r;
  V += l * m * r;
  float* out = static_cast<float*>(o.p) + l * m * n;

  // Phase 1: Rᵀ tile (r x BM) = Pᵀ G[row0:row0+BM, :]ᵀ, contraction over n.
  for (int rc0 = 0; rc0 < r_pad; rc0 += kRC) {
    float acc[kTR][TN];
    zero_acc(acc);
    for (int k0 = 0; k0 < n; k0 += kBK) {
      if (kP4) stage_rows(As, Pi, k0, rc0, tid);
      else stage_rows(As, Pf, k0, rc0, tid);
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
      if (kP4) stage_cols(As, Pi, n0, k0, tid);
      else stage_cols(As, Pf, n0, k0, tid);
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
  return (words + 16) * sizeof(float);  // + the 16 int4 codes
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

// The arguments every launch shares.
struct Step {
  PArg p;
  const void* G;
  float *M, *V;
  const int* count;
  float* out;
  int L, m, r, n;
  double b1, b2, eps, alpha;
  cudaStream_t stream;
};

template <int TN, typename GT, bool kP4>
cudaError_t launch(bool right, const Step& s) {
  auto kern = right ? &galore_fused_right_kernel<TN, GT, kP4>
                    : &galore_fused_left_kernel<TN, GT, kP4>;
  const size_t smem = smem_bytes(TN, s.r, right);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  // the shared-memory opt-in, once per instance, side and device (devices
  // 0-31), to the most that any rank may ask (pick_tn keeps every launch
  // within it)
  static std::atomic<unsigned> opted_in[2];
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if ((opted_in[right].load() & bit) == 0 || bit == 0) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != cudaSuccess) return err;
    opted_in[right].fetch_or(bit);
  }
  const int swept = right ? s.m : s.n;
  const dim3 grid((swept + 16 * TN - 1) / (16 * TN), s.L);
  kern<<<grid, kThreads, smem, s.stream>>>(
      s.p, static_cast<const GT*>(s.G), s.M, s.V, s.count, Out{s.out}, s.m, s.r, s.n, (float)s.b1,
      (float)(1.0 - s.b1), (float)s.b2, (float)(1.0 - s.b2), (float)s.eps, (float)s.alpha);
  return cudaGetLastError();
}

template <typename GT, bool kP4>
cudaError_t dispatch(bool right, const Step& s) {
  if (s.L <= 0 || s.m <= 0 || s.r <= 0 || s.n <= 0 || s.L > 65535) return cudaErrorInvalidValue;
  switch (pick_tn(s.r, right ? s.m : s.n, s.L, right)) {
    case 4: return launch<4, GT, kP4>(right, s);
    case 2: return launch<2, GT, kP4>(right, s);
    case 1: return launch<1, GT, kP4>(right, s);
    default: return cudaErrorInvalidValue;  // the r x 16 tile does not fit shared memory
  }
}

int run(bool right, int p_int4, int g_bf16, const Step& s) {
  if (p_int4)
    return (int)(g_bf16 ? dispatch<__nv_bfloat16, true>(right, s)
                        : dispatch<float, true>(right, s));
  return (int)(g_bf16 ? dispatch<__nv_bfloat16, false>(right, s)
                      : dispatch<float, false>(right, s));
}

}  // namespace

// P: f32 (L, m, r) when p_int4 = 0, else Pq (L, m_pad/2, r) u8 codes and Ps
// (L, ⌈m/128⌉, r) f32 scales (m_pad = 128·⌈m/128⌉, codec.quantize4_axis's
// layout), with books -> the wrapper's 528-float codebook table (the int4 codes
// at 512; unused for an f32 P). G (L, m, n) f32 or bf16 (g_bf16 = 1), M/V
// (L, r, n) f32 updated in place, count -> int32 on the device, out (L, m, n)
// f32; all contiguous. Returns a cudaError_t (0 on success).
extern "C" int galore_fused_adam_left(const float* P, const uint8_t* Pq, const float* Ps,
                                      int p_int4, const float* books, const void* G, int g_bf16,
                                      float* M, float* V, const int* count, float* out, int L,
                                      int m, int r, int n, double b1, double b2, double eps,
                                      double alpha, void* stream) {
  const Step s{PArg{P, Pq, Ps, books}, G, M, V, count, out, L, m, r, n, b1, b2, eps, alpha,
               static_cast<cudaStream_t>(stream)};
  return run(false, p_int4, g_bf16, s);
}

// P: f32 (L, n, r), or Pq (L, n_pad/2, r) and Ps (L, ⌈n/128⌉, r); G (L, m, n)
// f32 or bf16; M/V (L, m, r) f32 updated in place; the rest as on the left.
extern "C" int galore_fused_adam_right(const float* P, const uint8_t* Pq, const float* Ps,
                                       int p_int4, const float* books, const void* G, int g_bf16,
                                       float* M, float* V, const int* count, float* out, int L,
                                       int m, int r, int n, double b1, double b2, double eps,
                                       double alpha, void* stream) {
  const Step s{PArg{P, Pq, Ps, books}, G, M, V, count, out, L, m, r, n, b1, b2, eps, alpha,
               static_cast<cudaStream_t>(stream)};
  return run(true, p_int4, g_bf16, s);
}
