// Fused GaLore-Adam leaf step with int8 moments for Hopper (sm_90a): one
// kernel, a left and a right form, P either f32 or packed int4, emitting G̃
// or folding it into the weight. After adam8_kernel, the same dequant →
// Adam → requant without the projection: the flat 8-bit Adam update
// (adam8bit_blocks_update), described there.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/galore_fused.py
// `_fused_epilogue_call` (body `_epilogue_kernel`) in its int8-moment variants,
// reached through `galore_fused_adam8_step` / `galore_fused_adam8_step_right`
// and, with `apply_w`, `galore_fused_adam8_apply_step[_right]`, with
// `quant_p` (a packed int4 P) or an f32 P:
//   galore_fused_adam8_left   R = Pᵀ G   (P (m, r), moments (r, n), blocks along n)
//   galore_fused_adam8_right  R = G P    (P (n, r), moments (m, r), blocks along m)
//   galore_fused_adam8_apply_left / _right: the same, then W' = W + eta (G̃ + wd W)
//     in place of writing G̃ (W f32 or bf16, eta on the device)
// then, per element of R:
//   M = book_s[Mq] * Ms,  V = book_u[Vq] * Vs          (dequant, f32)
//   M' = b1 M + (1-b1) R,  V' = b2 V + (1-b2) R²        (0 past the long dim)
//   N̂ = (M'/c1) / (sqrt(V'/c2) + eps),  c_i = 1 - b_i^count
//   absmax over each 128-block of the swept axis, + 1e-12
//   Mq', Vq' = nearest code of M'/absmax (or stochastic rounding), in place
//   G̃ = alpha P N̂ (left) or alpha N̂ Pᵀ (right), f32
// Codes and scales are updated in place, as the Pallas aliasing does; the
// wrapper allocates only G̃.
//
// What bounds it on an H100. At the main path's largest left leaf,
// (L, m, r, n) = (2, 4096, 128, 11008) with bf16 G and int4 P, one launch
// moves G 180 MB + G̃ 361 MB + codes and scales read and written 11 MB + P
// 0.6 MB ≈ 553 MB (0.165 ms at 3.35 TB/s) and does 4·L·m·r·n = 46.2 GFLOP in
// its two contractions (0.69 ms of f32 FMA at 67 TFLOP/s). It is bound by
// operations, 0.69 ms, like the fp32 kernel of galore_fused.cu.
//
// Design. A quantization block is 128 elements of the swept axis, and its
// absmax needs all of them, so one thread block owns exactly 128 swept
// positions of one stacked leaf: grid = (⌈swept/128⌉, L), 256 threads as a
// 16 x 16 grid with an 8 x 8 register tile each (a 128 x 128 tile); a grid
// larger than the SM count is compiled for two blocks per SM. Rows of R
// on the left (columns on the right) quantize independently, so the block
// walks the rank in chunks of 128 and, per chunk:
//   1. R_c (128 x 128) = the chunk's contraction, P and G staged through
//      shared memory 32 deep (P is streamed, never resident, as in
//      galore_fused.cu); R_c lands in a 66 KB shared tile.
//   2. dequant → Adam → absmax → requant on the tile; N̂ replaces R_c.
//   3. G̃ for the block's 128 swept positions: alpha P_c N̂_c, accumulated in
//      the block's own output tile (written on the first chunk, added on
//      later ones; only this block touches those elements, so no atomics).
// Shared memory is therefore 105 KB whatever r is: r = 1024 is eight chunks
// through the same kernel, at the cost of re-reading the output tile from L2
// seven times; no shape is refused for size. (The other design, N̂ in a
// scratch tensor and a second pass, would move r·n more f32 through memory
// at every r.)
// The apply form cannot accumulate into W: W' must be formed once, from the
// whole of G̃, with the wd W term and the rounding to W's dtype applied once.
// With one rank chunk (r <= 128, the main path) step 3 applies W directly,
// with explicitly rounded operations in the plain version's order, so W' is
// bitwise the plain version's wherever G̃ is. With more chunks each chunk's
// N̂_c goes to a compact f32 scratch (L, r, n) / (L, m, r) that the wrapper
// allocates, and a last pass over the block's swept positions contracts the
// full rank from it and applies W. W's dtype is a template parameter; each W
// tile is asked of L2 when its contraction starts, and a row's W loads are
// all issued before its stores.
// The requant follows the codec (quant/codec.py), not the Pallas body: the
// nearest code is searchsorted(mids, x), the number of midpoints strictly
// below x, found by binary search over the 255 midpoints in shared memory;
// the stochastic coin is sr_uniform(ravel index, count, salt) in uint32. The
// elementwise math uses explicitly rounded f32 operations in the codec's
// order (no FMA contraction), so for equal R the codes are the plain
// version's bit for bit; only the contractions' summation order differs.
// An int4 P is decoded while staging (int4_p.cuh), book4[nibble] * scale in
// f32, the order of dequantize4_axis, so it is bitwise the host-dequantized P;
// rows past the logical kept dim are never read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "int4_p.cuh"

namespace {

using int4p::P4;

constexpr int kThreads = 256;  // 16 x 16 thread grid, 8 warps
constexpr int kT = 128;        // tile edge: one quantization block, one rank chunk
constexpr int kTR = 8;         // register tile per thread: kTR x kTR
constexpr int kBK = 32;        // contraction depth staged per step
constexpr int kS = kT + 1;     // padded row stride of every shared tile
constexpr int kBooks = 256 + 256 + 16;  // book_s | book_u | book4, from the wrapper
constexpr uint32_t kSaltM = 0x5BD1E995u;
constexpr uint32_t kSaltV = 0xC2B2AE35u;
// An int4 P's codes are decoded as they arrive (int4_p.cuh's kBatch = 1): this
// kernel runs two blocks an SM at 128 registers, and holding a stage's codes
// in registers before decoding them measured slower here at the main shapes
// (it is faster in galore_fused.cu, which is not capped).
constexpr int kP4Batch = 1;
static_assert(kBK == int4p::kStageK && kT == int4p::kStageW && kS == int4p::kStageS &&
                  kThreads == int4p::kStageThreads,
              "the int4 P stages of int4_p.cuh assume this kernel's stage geometry");

// shared layout, in floats
constexpr int kOffT = 0;
constexpr int kOffA = kOffT + kT * kS;
constexpr int kOffB = kOffA + kBK * kS;
constexpr int kOffBookS = kOffB + kBK * kS;
constexpr int kOffBookU = kOffBookS + 256;
constexpr int kOffMidS = kOffBookU + 256;
constexpr int kOffMidU = kOffMidS + 256;
constexpr int kOffBook4 = kOffMidU + 256;
constexpr int kOffRed = kOffBook4 + 16;  // 4 x 128 partial absmax (right side)
constexpr int kSmemFloats = kOffRed + 4 * kT;
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;

struct Args {
  const float* P;      // f32 P (L, kept, r), or null with an int4 P
  const uint8_t* Pq;   // int4 P: packed codes (L, kept_pad/2, r)
  const float* Ps;     // int4 P: scales (L, ⌈kept/128⌉, r)
  const void* G;       // (L, m, n) f32 or bf16
  uint8_t* Mq;         // codes, left (L, r, n), right (L, m, r); in place
  float* Ms;           // scales, left (L, r, ⌈n/128⌉), right (L, ⌈m/128⌉, r); in place
  uint8_t* Vq;
  float* Vs;
  const int* count;    // the step number, on the device
  const float* books;  // kBooks floats: signed, unsigned and int4 codebooks
  float* out;          // emit: G̃ (L, m, n) f32
  void* W;             // apply: W (L, m, n) f32 or bf16, in place
  int w_bf16;
  const float* eta;    // apply: -lr of this step, on the device
  float wd;            // apply: decoupled weight decay
  float* nhat;         // apply with r > 128: N̂ scratch, the moments' shape
  int m, r, n;
  int stochastic;
  float b1, omb1, b2, omb2, eps, alpha;
};

__device__ __forceinline__ float load_g(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_g(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// A row-major (rows, cols) matrix of one leaf; zero outside.
template <typename GT>
struct Mat {
  const GT* p;
  int rows, cols;
  __device__ __forceinline__ float at(int row, int col) const {
    return (row < rows && col < cols) ? load_g(p, (size_t)row * cols + col) : 0.f;
  }
};

// The N̂ scratch of one leaf, read back by the block that wrote it (through
// L2, after a barrier); zero outside.
struct Scratch {
  const float* p;
  int rows, cols;
  __device__ __forceinline__ float at(int row, int col) const {
    return (row < rows && col < cols) ? __ldcg(p + (size_t)row * cols + col) : 0.f;
  }
};

__device__ __forceinline__ void store_w(float* W, size_t i, float v) { W[i] = v; }
__device__ __forceinline__ void store_w(__nv_bfloat16* W, size_t i, float v) {
  W[i] = __float2bfloat16_rn(v);
}

// Ask L2 for rows [r0, r0 + nr) x columns [c0, c0 + nc) of the row-major
// (rows x cols) W at `base`, clipped to its edges, one 128-byte line per thread
// and step. Issued when a tile's contraction starts, so that the tile's W is
// in L2 by the time its stores read it.
template <typename WT>
__device__ __forceinline__ void prefetch_w(const WT* W, size_t base, int rows, int cols, int r0,
                                           int nr, int c0, int nc, int tid, int nthreads) {
  constexpr int esz = sizeof(WT), per_line = 128 / esz;
  const int lines = (nc + per_line - 1) / per_line;
  for (int e = tid; e < nr * lines; e += nthreads) {
    const int row = r0 + e / lines, col = c0 + (e % lines) * per_line;
    if (row < rows && col < cols)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(W + base + (size_t)row * cols + col));
  }
}

// W'[row][c0 + 16 j] = W + eta (alpha acc[j] + wd W) for one row of a thread's
// 8 x 8 tile, each operation rounded, in the plain version's order; W is f32
// or bf16 (WT), rounded to nearest once. The row's 8 loads are issued before
// any store: a store to W would order every later load behind it.
template <typename WT>
__device__ __forceinline__ void apply_row(const Args& a, size_t o0, int row, int c0,
                                          const float (&acc)[kTR], float eta) {
  WT* const W = static_cast<WT*>(a.W);
  float w[kTR];
#pragma unroll
  for (int j = 0; j < kTR; ++j) {
    const int col = c0 + 16 * j;
    w[j] = (row < a.m && col < a.n) ? load_g(W, o0 + (size_t)row * a.n + col) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kTR; ++j) {
    const int col = c0 + 16 * j;
    const float g = __fmul_rn(a.alpha, acc[j]);
    if (row < a.m && col < a.n)
      store_w(W, o0 + (size_t)row * a.n + col,
              __fadd_rn(w[j], __fmul_rn(eta, __fadd_rn(g, __fmul_rn(a.wd, w[j])))));
  }
}

// buf[kk][c] = src(k0 + kk, c0 + c): contraction along the source's rows.
// Each thread stages one column c, rows kk = tid / 128 + 2i; the loop has a
// fixed trip count, so it unrolls and its 16 loads are in flight together.
template <class Src>
__device__ __forceinline__ void stage_rows(float* buf, const Src& src, int k0, int c0, int tid) {
  const int c = tid % kT;
#pragma unroll
  for (int i = 0; i < kBK * kT / kThreads; ++i) {
    const int kk = tid / kT + (kThreads / kT) * i;
    buf[kk * kS + c] = src.at(k0 + kk, c0 + c);
  }
}

// buf[kk][c] = src(c0 + c, k0 + kk): contraction along the source's columns.
// Each thread stages one kk, c = tid / 32 + 8i.
template <class Src>
__device__ __forceinline__ void stage_cols(float* buf, const Src& src, int c0, int k0, int tid) {
  const int kk = tid % kBK;
#pragma unroll
  for (int i = 0; i < kBK * kT / kThreads; ++i) {
    const int c = tid / kBK + (kThreads / kBK) * i;
    buf[kk * kS + c] = src.at(c0 + c, k0 + kk);
  }
}

// acc[a][b] += sum_kk A(kk, ty + 16a) * B(kk, tx + 16b), A(k, i) = A[k*ak + i*ai],
// B(k, j) = B[k*bk + j*bj]. Within a warp the A reads touch two addresses and
// the B reads 16 distinct banks, so neither has bank conflicts.
__device__ __forceinline__ void tile_fma(const float* __restrict__ A, int ak, int ai,
                                         const float* __restrict__ B, int bk, int bj,
                                         float (&acc)[kTR][kTR], int tx, int ty) {
#pragma unroll 2
  for (int kk = 0; kk < kBK; ++kk) {
    float a[kTR], b[kTR];
#pragma unroll
    for (int i = 0; i < kTR; ++i) a[i] = A[kk * ak + (ty + 16 * i) * ai];
#pragma unroll
    for (int j = 0; j < kTR; ++j) b[j] = B[kk * bk + (tx + 16 * j) * bj];
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < kTR; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[kTR][kTR]) {
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int j = 0; j < kTR; ++j) acc[i][j] = 0.f;
}

// Counter-based uniform in [0, 1): codec.sr_uniform, bit for bit.
__device__ __forceinline__ float sr_uniform(uint32_t idx, uint32_t cnt, uint32_t salt) {
  uint32_t x = idx * 2654435761u;
  x = x ^ (cnt * 0x9E3779B9u) ^ salt;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return (float)(x >> 8) * (1.0f / 16777216.0f);
}

// Number of entries of the sorted table t[0..len) that are < x (strict) or
// <= x (inclusive): searchsorted left / right.
template <bool kInclusive>
__device__ __forceinline__ int search(const float* t, int len, float x) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const bool below = kInclusive ? (t[mid] <= x) : (t[mid] < x);
    if (below) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The code of one moment value, given its block's absmax (codec order).
__device__ __forceinline__ uint8_t requant(float x, float absmax, const float* book,
                                           const float* mids, bool stochastic, uint32_t idx,
                                           uint32_t cnt, uint32_t salt) {
  const float normed = __fdiv_rn(x, absmax);
  if (!stochastic) return (uint8_t)search<false>(mids, 255, normed);
  const int ge = search<true>(book, 256, normed);
  const int lo = min(max(ge - 1, 0), 254);
  const float lo_val = book[lo];
  const float step = __fsub_rn(book[lo + 1], lo_val);
  const float frac = fminf(fmaxf(__fdiv_rn(__fsub_rn(normed, lo_val), step), 0.f), 1.f);
  return (uint8_t)(lo + (sr_uniform(idx, cnt, salt) < frac ? 1 : 0));
}

struct Coef {
  float b1, omb1, b2, omb2, eps, c1, c2;
};

// M', V' of one element from its old codes and R (f32, rounded per operation
// in the order of the plain version).
__device__ __forceinline__ void adam_moments(const Coef& k, float m_old, float v_old, float r,
                                             float* mn, float* vn) {
  *mn = __fadd_rn(__fmul_rn(k.b1, m_old), __fmul_rn(k.omb1, r));
  *vn = __fadd_rn(__fmul_rn(k.b2, v_old), __fmul_rn(k.omb2, __fmul_rn(r, r)));
}

__device__ __forceinline__ float adam_step(const Coef& k, float mn, float vn) {
  return __fdiv_rn(__fdiv_rn(mn, k.c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(vn, k.c2)), k.eps));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// kMinBlocks = 2 caps registers at 128 a thread so that two blocks share an
// SM; the host picks it only for grids larger than one block per SM.
template <bool kRight, bool kP4, typename GT, int kMinBlocks, bool kApply, typename WT>
__global__ void __launch_bounds__(kThreads, kMinBlocks) adam8_kernel(const Args a) {
  extern __shared__ float smem[];
  float* T = smem + kOffT;  // R_c, then N̂_c: left [rank][swept], right [swept][rank]
  float* As = smem + kOffA;
  float* Bs = smem + kOffB;
  float* book_s = smem + kOffBookS;
  float* book_u = smem + kOffBookU;
  float* mids_s = smem + kOffMidS;
  float* mids_u = smem + kOffMidU;
  float* book4 = smem + kOffBook4;
  float* red = smem + kOffRed;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int m = a.m, r = a.r, n = a.n;
  const size_t l = blockIdx.y;
  const int blk = blockIdx.x;    // the block's quantization block of the swept axis
  const int s0 = blk * kT;       // its first swept position
  const int kept = kRight ? n : m;
  const int swept = kRight ? m : n;
  const int nb = (swept + kT - 1) / kT;

  for (int i = tid; i < kBooks; i += kThreads) {
    const float v = a.books[i];
    if (i < 256) book_s[i] = v;
    else if (i < 512) book_u[i - 256] = v;
    else book4[i - 512] = v;
  }
  __syncthreads();
  for (int i = tid; i < 255; i += kThreads) {
    mids_s[i] = __fdiv_rn(__fadd_rn(book_s[i], book_s[i + 1]), 2.f);
    mids_u[i] = __fdiv_rn(__fadd_rn(book_u[i], book_u[i + 1]), 2.f);
  }

  // this leaf's operands
  const Mat<float> Pf{kP4 ? nullptr : a.P + l * kept * r, kept, r};
  const P4 Pi = kP4 ? int4p::p4_leaf(a.Pq, a.Ps, book4, l, kept, r) : P4{};
  const Mat<GT> Gm{static_cast<const GT*>(a.G) + l * m * n, m, n};
  const size_t mom0 = l * (kRight ? (size_t)m * r : (size_t)r * n);
  const size_t sc0 = l * (kRight ? (size_t)nb * r : (size_t)r * nb);
  const size_t o0 = l * m * n;  // this leaf's first element of G̃ or W
  const WT* const Wp = static_cast<const WT*>(a.W);  // apply: W (prefetched)
  const int cnt = *a.count;
  const float t = (float)cnt;
  const Coef k{a.b1, a.omb1, a.b2, a.omb2, a.eps, 1.f - powf(a.b1, t), 1.f - powf(a.b2, t)};
  const bool sr = a.stochastic != 0;
  const float eta = kApply ? *a.eta : 0.f;
  const bool keep_nhat = kApply && r > kT;  // W waits for the whole rank
  __syncthreads();

  for (int rc0 = 0; rc0 < r; rc0 += kT) {
    // 1. R_c into T
    float acc[kTR][kTR];
    zero_acc(acc);
    if (!kRight) {  // R_c[i][j] = sum_k P[k][rc0+i] G[k][s0+j], k over m
      for (int k0 = 0; k0 < m; k0 += kBK) {
        if (kP4) int4p::stage_rows<kP4Batch>(As, Pi, k0, rc0, tid);
        else stage_rows(As, Pf, k0, rc0, tid);
        stage_rows(Bs, Gm, k0, s0, tid);
        __syncthreads();
        tile_fma(As, kS, 1, Bs, kS, 1, acc, tx, ty);
        __syncthreads();
      }
    } else {  // R_c[i][j] = sum_k G[s0+i][k] P[k][rc0+j], k over n
      for (int k0 = 0; k0 < n; k0 += kBK) {
        stage_cols(As, Gm, s0, k0, tid);
        if (kP4) int4p::stage_rows<kP4Batch>(Bs, Pi, k0, rc0, tid);
        else stage_rows(Bs, Pf, k0, rc0, tid);
        __syncthreads();
        tile_fma(As, kS, 1, Bs, kS, 1, acc, tx, ty);
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < kTR; ++j) T[(ty + 16 * i) * kS + tx + 16 * j] = acc[i][j];
    __syncthreads();

    // 2. dequant -> Adam -> requant; N̂_c replaces R_c (0 outside the leaf)
    if (!kRight) {
      // a warp per rank row (its quantization block is the row's 128
      // columns), a lane per 4 columns
      for (int i = warp; i < kT; i += kThreads / 32) {
        const int rr = rc0 + i;
        const bool row_ok = rr < r;
        const size_t srow = sc0 + (size_t)rr * nb + blk;
        const float sm = row_ok ? a.Ms[srow] : 0.f, sv = row_ok ? a.Vs[srow] : 0.f;
        float mn[4], vn[4], am = 0.f, av = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = lane + 32 * q, col = s0 + j;
          mn[q] = vn[q] = 0.f;
          if (row_ok && col < n) {
            const size_t off = mom0 + (size_t)rr * n + col;
            adam_moments(k, __fmul_rn(book_s[a.Mq[off]], sm), __fmul_rn(book_u[a.Vq[off]], sv),
                         T[i * kS + j], &mn[q], &vn[q]);
          }
          am = fmaxf(am, fabsf(mn[q]));
          av = fmaxf(av, fabsf(vn[q]));
        }
        am = __fadd_rn(warp_max(am), 1e-12f);
        av = __fadd_rn(warp_max(av), 1e-12f);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = lane + 32 * q, col = s0 + j;
          float nh = 0.f;
          if (row_ok && col < n) {
            const size_t off = mom0 + (size_t)rr * n + col;
            const uint32_t idx = (uint32_t)off;  // ravel index in (L, r, n), mod 2^32
            a.Mq[off] = requant(mn[q], am, book_s, mids_s, sr, idx, (uint32_t)cnt, kSaltM);
            a.Vq[off] = requant(vn[q], av, book_u, mids_u, sr, idx, (uint32_t)cnt, kSaltV);
            nh = adam_step(k, mn[q], vn[q]);
          }
          T[i * kS + j] = nh;
        }
        if (row_ok && lane == 0) {
          a.Ms[srow] = am;
          a.Vs[srow] = av;
        }
      }
    } else {
      // a thread per (rank column, half of the 128 rows): the column's
      // quantization block is its 128 rows; the halves' absmax meet in `red`.
      // Pass 1 finds the absmax, pass 2 recomputes M', V' and requantizes.
      const int j = tid % kT, h = tid / kT;
      const int rk = rc0 + j;
      const bool col_ok = rk < r;
      const size_t scol = sc0 + (size_t)blk * r + rk;
      const float sm = col_ok ? a.Ms[scol] : 0.f, sv = col_ok ? a.Vs[scol] : 0.f;
      float am = 0.f, av = 0.f;
      for (int i = h * (kT / 2); i < (h + 1) * (kT / 2); ++i) {
        const int row = s0 + i;
        if (col_ok && row < m) {
          const size_t off = mom0 + (size_t)row * r + rk;
          float mn, vn;
          adam_moments(k, __fmul_rn(book_s[a.Mq[off]], sm), __fmul_rn(book_u[a.Vq[off]], sv),
                       T[i * kS + j], &mn, &vn);
          am = fmaxf(am, fabsf(mn));
          av = fmaxf(av, fabsf(vn));
        }
      }
      red[h * kT + j] = am;
      red[(2 + h) * kT + j] = av;
      __syncthreads();
      am = __fadd_rn(fmaxf(red[j], red[kT + j]), 1e-12f);
      av = __fadd_rn(fmaxf(red[2 * kT + j], red[3 * kT + j]), 1e-12f);
      for (int i = h * (kT / 2); i < (h + 1) * (kT / 2); ++i) {
        const int row = s0 + i;
        float nh = 0.f;
        if (col_ok && row < m) {
          const size_t off = mom0 + (size_t)row * r + rk;
          float mn, vn;
          adam_moments(k, __fmul_rn(book_s[a.Mq[off]], sm), __fmul_rn(book_u[a.Vq[off]], sv),
                       T[i * kS + j], &mn, &vn);
          const uint32_t idx = (uint32_t)off;  // ravel index in (L, m, r), mod 2^32
          a.Mq[off] = requant(mn, am, book_s, mids_s, sr, idx, (uint32_t)cnt, kSaltM);
          a.Vq[off] = requant(vn, av, book_u, mids_u, sr, idx, (uint32_t)cnt, kSaltV);
          nh = adam_step(k, mn, vn);
        }
        T[i * kS + j] = nh;
      }
      if (col_ok && h == 0) {
        a.Ms[scol] = am;
        a.Vs[scol] = av;
      }
    }
    __syncthreads();

    // 3. G̃ for the block's swept positions, accumulated over rank chunks;
    // or W' from the one chunk; or N̂_c kept for the last pass
    const int kn = min(kT, r - rc0);
    if (keep_nhat) {
      for (int e = tid; e < kT * kT; e += kThreads) {
        const int i = e / kT, j = e % kT;
        if (!kRight && rc0 + i < r && s0 + j < n)
          a.nhat[mom0 + (size_t)(rc0 + i) * n + s0 + j] = T[i * kS + j];
        if (kRight && s0 + i < m && rc0 + j < r)
          a.nhat[mom0 + (size_t)(s0 + i) * r + rc0 + j] = T[i * kS + j];
      }
    } else if (!kRight) {  // out[m0+i][s0+j] (+)= alpha sum_k P[m0+i][rc0+k] N̂[k][j]
      for (int m0 = 0; m0 < m; m0 += kT) {
        zero_acc(acc);
        if (kApply) prefetch_w(Wp, o0, m, n, m0, kT, s0, kT, tid, kThreads);
        for (int k0 = 0; k0 < kn; k0 += kBK) {
          if (kP4) int4p::stage_cols<kP4Batch>(As, Pi, m0, rc0 + k0, tid);
          else stage_cols(As, Pf, m0, rc0 + k0, tid);
          __syncthreads();
          tile_fma(As, kS, 1, T + k0 * kS, kS, 1, acc, tx, ty);
          __syncthreads();
        }
        if (kApply) {
#pragma unroll
          for (int i = 0; i < kTR; ++i) apply_row<WT>(a, o0, m0 + ty + 16 * i, s0 + tx, acc[i], eta);
          continue;
        }
#pragma unroll
        for (int i = 0; i < kTR; ++i)
#pragma unroll
          for (int j = 0; j < kTR; ++j) {
            const int row = m0 + ty + 16 * i, col = s0 + tx + 16 * j;
            if (row < m && col < n) {
              float* o = a.out + o0 + (size_t)row * n + col;
              const float v = a.alpha * acc[i][j];
              *o = rc0 == 0 ? v : *o + v;
            }
          }
      }
    } else {  // out[s0+i][n0+j] (+)= alpha sum_k N̂[i][k] P[n0+j][rc0+k]
      for (int n0 = 0; n0 < n; n0 += kT) {
        zero_acc(acc);
        if (kApply) prefetch_w(Wp, o0, m, n, s0, kT, n0, kT, tid, kThreads);
        for (int k0 = 0; k0 < kn; k0 += kBK) {
          if (kP4) int4p::stage_cols<kP4Batch>(Bs, Pi, n0, rc0 + k0, tid);
          else stage_cols(Bs, Pf, n0, rc0 + k0, tid);
          __syncthreads();
          tile_fma(T + k0, 1, kS, Bs, kS, 1, acc, tx, ty);
          __syncthreads();
        }
        if (kApply) {
#pragma unroll
          for (int i = 0; i < kTR; ++i) apply_row<WT>(a, o0, s0 + ty + 16 * i, n0 + tx, acc[i], eta);
          continue;
        }
#pragma unroll
        for (int i = 0; i < kTR; ++i)
#pragma unroll
          for (int j = 0; j < kTR; ++j) {
            const int row = s0 + ty + 16 * i, col = n0 + tx + 16 * j;
            if (row < m && col < n) {
              float* o = a.out + o0 + (size_t)row * n + col;
              const float v = a.alpha * acc[i][j];
              *o = rc0 == 0 ? v : *o + v;
            }
          }
      }
    }
    __syncthreads();  // T is rewritten by the next chunk
  }
  if (!keep_nhat) return;

  // 4. (apply, r > 128) G̃ over the whole rank from the N̂ scratch, into W
  const Scratch Nm{a.nhat + mom0, kRight ? m : r, kRight ? r : n};
  float acc[kTR][kTR];
  if (!kRight) {  // W[m0+i][s0+j] <- alpha sum_k P[m0+i][k] N̂[k][s0+j]
    for (int m0 = 0; m0 < m; m0 += kT) {
      zero_acc(acc);
      prefetch_w(Wp, o0, m, n, m0, kT, s0, kT, tid, kThreads);
      for (int k0 = 0; k0 < r; k0 += kBK) {
        if (kP4) int4p::stage_cols<kP4Batch>(As, Pi, m0, k0, tid);
        else stage_cols(As, Pf, m0, k0, tid);
        stage_rows(Bs, Nm, k0, s0, tid);
        __syncthreads();
        tile_fma(As, kS, 1, Bs, kS, 1, acc, tx, ty);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < kTR; ++i) apply_row<WT>(a, o0, m0 + ty + 16 * i, s0 + tx, acc[i], eta);
    }
  } else {  // W[s0+i][n0+j] <- alpha sum_k N̂[s0+i][k] P[n0+j][k]
    for (int n0 = 0; n0 < n; n0 += kT) {
      zero_acc(acc);
      prefetch_w(Wp, o0, m, n, s0, kT, n0, kT, tid, kThreads);
      for (int k0 = 0; k0 < r; k0 += kBK) {
        stage_cols(As, Nm, s0, k0, tid);
        if (kP4) int4p::stage_cols<kP4Batch>(Bs, Pi, n0, k0, tid);
        else stage_cols(Bs, Pf, n0, k0, tid);
        __syncthreads();
        tile_fma(As, kS, 1, Bs, kS, 1, acc, tx, ty);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < kTR; ++i) apply_row<WT>(a, o0, s0 + ty + 16 * i, n0 + tx, acc[i], eta);
    }
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return sms;
}

// ---------------------------------------------------------------------------
// The flat 8-bit Adam update (the paper's 8-bit Adam baseline)
// ---------------------------------------------------------------------------
// Replaces `adam8bit_blocks_update` of src/repro/kernels/galore_fused.py (the
// same `_fused_epilogue_call` with project=False: R = G, one quantization
// block per 256 elements of the flattened leaf), reached through
// kernels/adam8bit_update.py and ops.adam8bit_step. Per element of block b:
//   M = book_s[Mq] * Ms[b],  V = book_u[Vq] * Vs[b]      (dequant, f32)
//   M' = b1 M + (1-b1) g,  V' = b2 V + (1-b2) g²          (0 past numel)
//   update = (M'/c1) / (sqrt(V'/c2) + eps), in g's dtype  (none past numel)
//   Ms'[b] = max |M'| over the block + 1e-12, Mq' = searchsorted(mids, M'/Ms')
// with the codec's nearest-code rule and explicitly rounded f32 operations in
// the plain version's order, as in adam8_kernel: for equal inputs codes,
// scales and the update are the plain version's bit for bit. The state is
// padded to whole blocks as the codec pads it; g and the update are not: the
// last block's tail is masked.
//
// What bounds it on an H100: bytes. An element moves g (2 B in bf16), its two
// codes read and written (4 B) and the update (2 B), 8 B, against ~35 f32
// operations: a (2, 4096, 11008) leaf moves 0.73 GB (0.217 ms at 3.35 TB/s).
// What holds it below that rate is its instruction count, not its loads: two
// IEEE divisions and an 8-step binary search a moment, and a square root, an
// element (16-byte vector loads and stores measured no faster).
// Design: one warp per 256-element block, a lane per 8 elements at a stride
// of 32 (each load instruction covers 32 consecutive elements), the absmax by
// a shuffle reduction; 8 warps a block walk the leaf's blocks grid-stride, so
// each thread block loads the codebooks into shared memory once.
constexpr int kFlat = 256;  // optim/quant8.BLOCK
constexpr int kFlatPerLane = kFlat / 32;

template <typename GT>
__global__ void __launch_bounds__(kThreads)
    adam8bit_flat_kernel(const GT* __restrict__ g, long long numel, long long nb,
                         uint8_t* __restrict__ mq, float* __restrict__ ms, uint8_t* __restrict__ vq,
                         float* __restrict__ vs, const int* __restrict__ count,
                         const float* __restrict__ books, GT* __restrict__ upd, float b1,
                         float omb1, float b2, float omb2, float eps) {
  __shared__ float book_s[256], book_u[256], mids_s[256], mids_u[256];
  const int tid = threadIdx.x, lane = tid % 32;
  for (int i = tid; i < 512; i += kThreads) {
    if (i < 256) book_s[i] = books[i];
    else book_u[i - 256] = books[i];
  }
  __syncthreads();
  for (int i = tid; i < 255; i += kThreads) {
    mids_s[i] = __fdiv_rn(__fadd_rn(book_s[i], book_s[i + 1]), 2.f);
    mids_u[i] = __fdiv_rn(__fadd_rn(book_u[i], book_u[i + 1]), 2.f);
  }
  const float t = (float)*count;
  const Coef k{b1, omb1, b2, omb2, eps, 1.f - powf(b1, t), 1.f - powf(b2, t)};
  __syncthreads();

  const long long warps = (long long)gridDim.x * (kThreads / 32);
  for (long long b = (long long)blockIdx.x * (kThreads / 32) + tid / 32; b < nb; b += warps) {
    const size_t base = (size_t)b * kFlat;
    const float sm = ms[b], sv = vs[b];
    float mn[kFlatPerLane], vn[kFlatPerLane], am = 0.f, av = 0.f;
#pragma unroll
    for (int q = 0; q < kFlatPerLane; ++q) {
      const size_t i = base + lane + 32 * q;
      mn[q] = vn[q] = 0.f;
      if ((long long)i < numel)
        adam_moments(k, __fmul_rn(book_s[mq[i]], sm), __fmul_rn(book_u[vq[i]], sv),
                     load_g(g, i), &mn[q], &vn[q]);
      am = fmaxf(am, fabsf(mn[q]));
      av = fmaxf(av, fabsf(vn[q]));
    }
    am = __fadd_rn(warp_max(am), 1e-12f);
    av = __fadd_rn(warp_max(av), 1e-12f);
#pragma unroll
    for (int q = 0; q < kFlatPerLane; ++q) {
      const size_t i = base + lane + 32 * q;
      mq[i] = requant(mn[q], am, book_s, mids_s, false, 0, 0, 0);
      vq[i] = requant(vn[q], av, book_u, mids_u, false, 0, 0, 0);
      if ((long long)i < numel) store_w(upd, i, adam_step(k, mn[q], vn[q]));
    }
    if (lane == 0) {
      ms[b] = am;
      vs[b] = av;
    }
  }
}

template <typename GT>
cudaError_t launch_flat(const void* g, long long numel, uint8_t* mq, float* ms, uint8_t* vq,
                        float* vs, const int* count, const float* books, void* upd, double b1,
                        double b2, double eps, cudaStream_t stream) {
  const long long nb = (numel + kFlat - 1) / kFlat;
  const long long per_block = kThreads / 32;
  // eight 256-thread blocks fill an SM; more than that wave only re-loads the books
  const long long want = (nb + per_block - 1) / per_block, fill = 8LL * sm_count();
  const long long blocks = want < fill ? want : fill;
  adam8bit_flat_kernel<GT><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const GT*>(g), numel, nb, mq, ms, vq, vs, count, books, static_cast<GT*>(upd),
      (float)b1, (float)(1.0 - b1), (float)b2, (float)(1.0 - b2), (float)eps);
  return cudaGetLastError();
}

template <bool kRight, bool kP4, typename GT, int kMinBlocks, bool kApply, typename WT>
cudaError_t launch_with(const Args& a, const dim3& grid, cudaStream_t stream) {
  auto kern = &adam8_kernel<kRight, kP4, GT, kMinBlocks, kApply, WT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

// One block per SM (up to 255 registers a thread) while the grid fits in one
// wave; two per SM (128 registers) when it does not, so that e.g. the 172
// blocks of a (2, 4096, 128, 11008) leaf run in one wave instead of two.
template <bool kRight, bool kP4, typename GT, bool kApply, typename WT>
cudaError_t launch(const Args& a, int L, cudaStream_t stream) {
  const int swept = kRight ? a.m : a.n;
  const dim3 grid((swept + kT - 1) / kT, L);
  if ((long)grid.x * grid.y > sm_count())
    return launch_with<kRight, kP4, GT, 2, kApply, WT>(a, grid, stream);
  return launch_with<kRight, kP4, GT, 1, kApply, WT>(a, grid, stream);
}

template <bool kRight, bool kApply, typename WT>
cudaError_t dispatch(const Args& a, int p_int4, int g_bf16, int L, cudaStream_t s) {
  if (L <= 0 || a.m <= 0 || a.r <= 0 || a.n <= 0 || L > 65535) return cudaErrorInvalidValue;
  if (kApply && a.r > kT && a.nhat == nullptr) return cudaErrorInvalidValue;
  if (p_int4) {
    return g_bf16 ? launch<kRight, true, __nv_bfloat16, kApply, WT>(a, L, s)
                  : launch<kRight, true, float, kApply, WT>(a, L, s);
  }
  return g_bf16 ? launch<kRight, false, __nv_bfloat16, kApply, WT>(a, L, s)
                : launch<kRight, false, float, kApply, WT>(a, L, s);
}

template <bool kRight>
cudaError_t dispatch_w(bool apply, const Args& a, int p_int4, int g_bf16, int L, cudaStream_t s) {
  if (!apply) return dispatch<kRight, false, float>(a, p_int4, g_bf16, L, s);
  if (a.w_bf16) return dispatch<kRight, true, __nv_bfloat16>(a, p_int4, g_bf16, L, s);
  return dispatch<kRight, true, float>(a, p_int4, g_bf16, L, s);
}

int run(bool right, bool apply, const Args& a, int p_int4, int g_bf16, int L, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(right ? dispatch_w<true>(apply, a, p_int4, g_bf16, L, s)
                     : dispatch_w<false>(apply, a, p_int4, g_bf16, L, s));
}

Args make_args(const float* P, const uint8_t* Pq, const float* Ps, const void* G, uint8_t* Mq,
               float* Ms, uint8_t* Vq, float* Vs, const int* count, const float* books,
               float* out, void* W, int w_bf16, const float* eta, double wd, float* nhat, int m,
               int r, int n, double b1, double b2, double eps, double alpha, int stochastic) {
  return Args{P, Pq, Ps, G, Mq, Ms, Vq, Vs, count, books, out, W, w_bf16, eta, (float)wd, nhat,
              m, r, n, stochastic, (float)b1, (float)(1.0 - b1), (float)b2, (float)(1.0 - b2),
              (float)eps, (float)alpha};
}

}  // namespace

// P: f32 (L, m, r) when p_int4 = 0, else Pq (L, m_pad/2, r) u8 codes and Ps
// (L, ⌈m/128⌉, r) f32 scales (m_pad = 128·⌈m/128⌉); G (L, m, n) f32 or bf16
// (g_bf16 = 1); Mq/Vq (L, r, n) u8 and Ms/Vs (L, r, ⌈n/128⌉) f32, updated in
// place; count -> int32 on the device; books -> 528 f32 (signed, unsigned and
// int4 codebooks); out (L, m, n) f32. All contiguous. Returns a cudaError_t.
extern "C" int galore_fused_adam8_left(const float* P, const uint8_t* Pq, const float* Ps,
                                       int p_int4, const void* G, int g_bf16, uint8_t* Mq,
                                       float* Ms, uint8_t* Vq, float* Vs, const int* count,
                                       const float* books, float* out, int L, int m, int r, int n,
                                       double b1, double b2, double eps, double alpha,
                                       int stochastic, void* stream) {
  const Args a = make_args(P, Pq, Ps, G, Mq, Ms, Vq, Vs, count, books, out, nullptr, 0, nullptr,
                           0.0, nullptr, m, r, n, b1, b2, eps, alpha, stochastic);
  return run(false, false, a, p_int4, g_bf16, L, stream);
}

// P: f32 (L, n, r), or Pq (L, n_pad/2, r) and Ps (L, ⌈n/128⌉, r); G (L, m, n);
// Mq/Vq (L, m, r) u8 and Ms/Vs (L, ⌈m/128⌉, r) f32, in place; the rest as on
// the left.
extern "C" int galore_fused_adam8_right(const float* P, const uint8_t* Pq, const float* Ps,
                                        int p_int4, const void* G, int g_bf16, uint8_t* Mq,
                                        float* Ms, uint8_t* Vq, float* Vs, const int* count,
                                        const float* books, float* out, int L, int m, int r, int n,
                                        double b1, double b2, double eps, double alpha,
                                        int stochastic, void* stream) {
  const Args a = make_args(P, Pq, Ps, G, Mq, Ms, Vq, Vs, count, books, out, nullptr, 0, nullptr,
                           0.0, nullptr, m, r, n, b1, b2, eps, alpha, stochastic);
  return run(true, false, a, p_int4, g_bf16, L, stream);
}

// The apply forms: as above, with W (L, m, n) f32 or bf16 (w_bf16 = 1) updated
// in place to W + eta (G̃ + wd W) instead of writing G̃; eta -> one f32 on the
// device; nhat -> f32 scratch of the moments' shape ((L, r, n) left, (L, m, r)
// right), needed only when r > 128 (null otherwise).
extern "C" int galore_fused_adam8_apply_left(const float* P, const uint8_t* Pq, const float* Ps,
                                             int p_int4, const void* G, int g_bf16, void* W,
                                             int w_bf16, uint8_t* Mq, float* Ms, uint8_t* Vq,
                                             float* Vs, const int* count, const float* books,
                                             const float* eta, double wd, float* nhat, int L,
                                             int m, int r, int n, double b1, double b2,
                                             double eps, double alpha, int stochastic,
                                             void* stream) {
  const Args a = make_args(P, Pq, Ps, G, Mq, Ms, Vq, Vs, count, books, nullptr, W, w_bf16, eta,
                           wd, nhat, m, r, n, b1, b2, eps, alpha, stochastic);
  return run(false, true, a, p_int4, g_bf16, L, stream);
}

extern "C" int galore_fused_adam8_apply_right(const float* P, const uint8_t* Pq, const float* Ps,
                                              int p_int4, const void* G, int g_bf16, void* W,
                                              int w_bf16, uint8_t* Mq, float* Ms, uint8_t* Vq,
                                              float* Vs, const int* count, const float* books,
                                              const float* eta, double wd, float* nhat, int L,
                                              int m, int r, int n, double b1, double b2,
                                              double eps, double alpha, int stochastic,
                                              void* stream) {
  const Args a = make_args(P, Pq, Ps, G, Mq, Ms, Vq, Vs, count, books, nullptr, W, w_bf16, eta,
                           wd, nhat, m, r, n, b1, b2, eps, alpha, stochastic);
  return run(true, true, a, p_int4, g_bf16, L, stream);
}

// The flat 8-bit Adam update of one leaf: g (numel elements) f32 or bf16
// (g_bf16 = 1); Mq/Vq (nb, 256) u8 and Ms/Vs (nb,) f32, nb = ⌈numel/256⌉,
// updated in place; count -> int32 on the device; books -> the 528-float
// codebook table (only the signed and unsigned tables are read); upd (numel
// elements) in g's dtype. All contiguous. Returns a cudaError_t.
extern "C" int adam8bit_blocks_update(const void* g, int g_bf16, long long numel, uint8_t* Mq,
                                      float* Ms, uint8_t* Vq, float* Vs, const int* count,
                                      const float* books, void* upd, double b1, double b2,
                                      double eps, void* stream) {
  if (numel <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(g_bf16 ? launch_flat<__nv_bfloat16>(g, numel, Mq, Ms, Vq, Vs, count, books, upd,
                                                  b1, b2, eps, s)
                      : launch_flat<float>(g, numel, Mq, Ms, Vq, Vs, count, books, upd, b1, b2,
                                           eps, s));
}
