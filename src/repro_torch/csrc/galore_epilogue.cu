// Fused GaLore-Adam leaf step for Hopper (sm_90a): one kernel,
// lowrank_adam_kernel, a left and a right form, P either f32 or packed int4,
// with its moments in one of two stores, int8 codes with per-block scales or
// f32 M and V, each either emitting G̃ or folding it into the weight. After
// it, the same dequant → Adam → requant without the projection: the flat
// 8-bit Adam update (adam8bit_blocks_update), described there.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/galore_fused.py, each
// with `quant_p` (a packed int4 P) or an f32 P:
//   galore_fused_adam_left / _right (fp32 moments, emit): `galore_fused_adam_step`
//     (:169, pallas_call :208; int4 P :184) and `galore_fused_adam_step_right`
//     (:268, :308; int4 P :284)
//   galore_fused_adam8_left / _right (int8 moments, emit) and
//   galore_fused_adam8_apply_left / _right (int8, apply): `_fused_epilogue_call`
//     (body `_epilogue_kernel`) through `galore_fused_adam8_step[_right]` and,
//     with `apply_w`, `galore_fused_adam8_apply_step[_right]`
//   galore_fused_adam_apply_left / _right (fp32 moments, apply): the same call
//     through `galore_fused_adam_apply_step[_right]` (:714/:727)
// where the left form has R = Pᵀ G (P (m, r), moments (r, n), blocks along n)
// and the right one R = G P (P (n, r), moments (m, r), blocks along m), and
// the apply forms write W' = W + eta (G̃ + wd W) in place of G̃ (W f32 or
// bf16, eta on the device). Then, per element of R:
//   int8:  M = book_s[Mq] * Ms,  V = book_u[Vq] * Vs    (dequant, f32)
//   f32:   M, V as stored
//   M' = b1 M + (1-b1) R,  V' = b2 V + (1-b2) R²        (0 past the long dim)
//   N̂ = (M'/c1) / (sqrt(V'/c2) + eps),  c_i = 1 - b_i^count
//   int8:  absmax over each 128-block of the swept axis, + 1e-12;
//          Mq', Vq' = nearest code of M'/absmax (or stochastic rounding)
//   f32:   M', V' stored
//   G̃ = alpha P N̂ (left) or alpha N̂ Pᵀ (right), f32
// The moments are updated in place, as the Pallas aliasing does; the wrapper
// allocates only G̃ (and, for the apply form with r > 128, the N̂ scratch
// below). c1 and c2 come from powf of the count read on the device.
//
// What bounds it on an H100. At the main path's largest left leaf,
// (L, m, r, n) = (2, 4096, 128, 11008) with bf16 G, one launch does 4·L·m·r·n
// = 46.2 GFLOP in its two contractions: 0.69 ms on the f32 FMA pipes at 67
// TFLOP/s, 0.23 ms as split TF32 on the tensor cores (R in two passes with a
// bf16 G, G̃ in three, at 495 TFLOP/s). It moves G 180 MB and G̃ 361 MB
// (emit) or W 180 MB read and written (bf16 apply), P 0.6 MB (int4) or 4 MB
// (f32), and the moments read and written: 11 MB as int8 codes and scales,
// 45 MB in f32. The fp32 emit form is the heaviest, ≈ 590 MB (0.18 ms at
// 3.35 TB/s). Operations bound every form, on the tensor cores.
//
// Design: one formulation for both sides. The right leaf is the left one on
// swapped views: Rᵀ = Pᵀ Gᵀ (G read transposed: K-major) and G̃ᵀ = α P N̂ᵀ
// (written transposed), so an R tile is always (rank x swept) and a rank row
// of it is one quantization block; only the moments' indexing differs
// (right: (L, m, r), scales (L, ⌈m/128⌉, r)).
//   A quantization block's absmax needs all 128 of its swept positions, so a
//   slab of 128 swept positions of one stacked leaf is one unit of work,
//   spread over a thread-block cluster of C ∈ {1, 2, 4} CTAs (256 threads,
//   two warpgroups, one CTA an SM), C chosen on the host from the number of
//   slabs and the clusters the card holds at once, so that e.g. the 64
//   slabs of the 4096 x 4096 leaves fill the card. The f32 store needs no
//   block-wide value, but takes the same unit: the contractions are the same.
//   Per rank chunk of 128:
//   1. Partial R_c = P_cᵀ G_slab over the CTA's 1/C of the kept axis: split
//      TF32 on wgmma.m64n128k8, P the register operand (an f32 P split in
//      registers; an int4 P's codes and scales copied in by the TMA and
//      decoded in registers, int4_p.cuh's operation, so the value is
//      bitwise the host-dequantized P's), G the shared-memory operand (TMA
//      boxes into an mbarrier ring, split into K-major swizzled hi/lo tiles;
//      a bf16 G is exact in TF32: two passes). Each 32-deep stage goes into a
//      fresh wgmma accumulator that FADD adds into an f32 register one, the
//      rule that holds the tiled projections' gate over K = 4096.
//   2. The partials meet in the CTAs' shared memory: each CTA owns 128/C
//      rank rows and sums them from every CTA of the cluster over
//      distributed shared memory (mapa + ld.shared::cluster), in CTA order,
//      so two launches are bitwise equal.
//   3. The moment update on the owned rows, in shared memory, with
//      explicitly rounded f32 operations in the plain version's order
//      (below): dequant → Adam → absmax → requant, or Adam alone; only the
//      owner writes a row's moments. N̂ replaces R.
//   4. Each CTA splits N̂_c once into K-major hi/lo tiles, its own rows from
//      its shared memory and the others from their owners' over
//      distributed shared memory, and computes the G̃ tiles of its 1/C of
//      the kept axis: P's kept tile the register operand (a TMA ring in the
//      freed R tile, split, or decoded and split, in registers), N̂ the
//      shared-memory one, three passes, α applied after the accumulation.
//      The emit form writes f32 G̃ (added to the earlier chunks' for
//      r > 128); the apply form W' = W + η(αacc + wd·W) in the plain
//      version's operation order, a bf16 W tile brought in and written back
//      by the TMA through shared memory (an f32 W, or one the TMA cannot
//      describe, through L2 prefetches and registers).
// Shared memory (≤ 227 KB) holds the R/N̂ tile (64 KB; contraction 2's ring
// once N̂ is split) and one region reused by the phases: contraction 1's
// ring and split stages, the epilogue's codebooks, N̂'s hi/lo tiles (128 KB)
// and the W tile (32 KB).
// With r > 128 each chunk re-reads the CTA's share of G_slab (through L2:
// the slab does not fit in shared memory at any model's width), and the
// emit form re-reads and re-writes its G̃ tiles. The apply form cannot add
// into W: W' is formed once, from the whole of G̃. There each chunk's N̂_c
// goes to a compact f32 scratch (L, r, n) / (L, m, r) that the wrapper
// allocates, and a last pass contracts the whole rank from it (splitting
// N̂ again from L2 for every kept tile) and applies W.
// The requant follows the codec (quant/codec.py), not the Pallas body: the
// nearest code is searchsorted(mids, x), the number of midpoints strictly
// below x, found by binary search over the 255 midpoints in shared memory;
// the stochastic coin is sr_uniform(ravel index, count, salt) in uint32,
// the index in the full leaf: a launch on one rank block of a leaf whose rank
// is split (GaLore-ZeRO) is told the block's first rank row sr_off and the
// full rank sr_full (0 and r for a whole leaf), so that its coins are the
// whole-leaf launch's on the same elements. The
// elementwise math uses explicitly rounded f32 operations in the codec's
// and ref.lowrank_adam_update's order (no FMA contraction), so for equal R
// the codes (or M', V') are the plain version's bit for bit; only the
// contractions' summation order differs. W' is bitwise ref.apply_weight of
// the kernel's own G̃, which a launch on W = 0 (f32), η = 1, wd = 0 reads out.
// An operand the TMA cannot describe (rows not a multiple of 16 bytes, or a
// base not 16-byte aligned) is copied by the threads into the same layouts:
// a G of odd bf16 rows alone, leaving P on the TMA; a P (or an int4 P's
// codes or scales) with G, as both share contraction 1's stages.
// galore_epilogue_last_copied reports a launch that copied either, so that
// the wrappers count those launches.

#include <cuda.h>  // CUtensorMap (types only: libcuda is not linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

#include "int4_p.cuh"
#include "tf32_wgmma.cuh"

namespace {

using int4p::P4;
using namespace tf32w;

constexpr int kT = 128;  // a quantization block, a rank chunk, a kept tile
constexpr uint32_t kSaltM = 0x5BD1E995u;
constexpr uint32_t kSaltV = 0xC2B2AE35u;
static_assert(kT == kBM && kT == int4p::kStageW, "one tile edge throughout");

struct Args {
  const float* P;      // f32 P (L, kept, r), or null with an int4 P
  const uint8_t* Pq;   // int4 P: packed codes (L, kept_pad/2, r)
  const float* Ps;     // int4 P: scales (L, ⌈kept/128⌉, r)
  const void* G;       // (L, m, n) f32 or bf16
  uint8_t* Mq;         // codes, left (L, r, n), right (L, m, r); in place
  float* Ms;           // scales, left (L, r, ⌈n/128⌉), right (L, ⌈m/128⌉, r); in place
  uint8_t* Vq;
  float* Vs;
  float* M;            // f32 moments, left (L, r, n), right (L, m, r); in place
  float* V;
  const int* count;    // the step number, on the device
  const float* books;  // 528 floats: signed, unsigned and int4 codebooks
  float* out;          // emit: G̃ (L, m, n) f32
  void* W;             // apply: W (L, m, n) f32 or bf16, in place
  int apply;
  int w_bf16;
  int w_tma;           // apply, bf16 W: its tiles go through shared memory by the TMA
  int g_tma;           // G's boxes come by the TMA (else the threads copy them); needs p_tma
  int p_tma;           // P's (or its codes' and scales') boxes come by the TMA
  const float* eta;    // apply: -lr of this step, on the device
  float wd;            // apply: decoupled weight decay
  float* nhat;         // apply with r > 128: N̂ scratch, the moments' shape
  int m, r, n;
  int stochastic;
  int sr_off, sr_full;  // the rank block's origin in the full leaf (0, r: whole)
  float b1, omb1, b2, omb2, eps, alpha;
};

// The TMA maps of one launch: G; an f32 P as contraction 1's A (Pᵀ, 32
// ranks by 32 kept rows a box) and contraction 2's (its kept tile, 32 ranks
// by 128 rows); or an int4 P's codes and scales, each in both boxes;
// and a bf16 W in boxes of 64 columns by 128 rows.
struct Maps {
  CUtensorMap g, pa, pb, qa, qb, sa, sb, w;
};

__device__ __forceinline__ float load_g(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_g(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ void store_w(float* W, size_t i, float v) { W[i] = v; }
__device__ __forceinline__ void store_w(__nv_bfloat16* W, size_t i, float v) {
  W[i] = __float2bfloat16_rn(v);
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

// ---- thread-block clusters and distributed shared memory ----
__device__ __forceinline__ int cluster_rank() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(v));
  return static_cast<int>(v);
}
__device__ __forceinline__ int cluster_size() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(v));
  return static_cast<int>(v);
}
// Every thread of every CTA of the cluster arrives and waits; the shared-
// and global-memory writes before it are visible to the cluster after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The shared::cluster address of this CTA's shared address `addr` in CTA `rank`.
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
  uint32_t v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(v) : "r"(addr), "r"(rank));
  return v;
}
__device__ __forceinline__ float ld_peer(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// Offset (floats) of (rank row i, swept column j) in the 128 x 128 tile T:
// rows of 128 floats, the low five bits of j permuted by i, so that 32 rows
// at one column (the right-side epilogue, the split of N̂ into contraction
// 2's tiles) and the accumulator stores (8 rows by 4 column pairs) each hit
// 32 distinct banks, as do 32 columns of one row.
__device__ __forceinline__ int tix(int i, int j) {
  return i * kT + (j ^ (((i & 3) << 3) | ((i >> 2) & 7)));
}

// Byte offset of (row, col) in a 128 x 128 bf16 tile held as two TMA boxes
// of 64 columns (128-byte rows, the 128-byte swizzle): the apply form's W.
__device__ __forceinline__ int wix(int row, int col) {
  return (col >> 6) * (kT * 128) + row * 128 + ((((col & 63) >> 3) ^ (row & 7)) << 4) +
         (col & 7) * 2;
}

// TMA store of the box at (c0, c1, c2) of `map` from shared memory at src,
// in this thread's bulk group; the group's commit and its waits.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {  // the stores have read shared memory
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {  // the stores are complete
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Shared memory of one kernel form, in bytes from a 1024-aligned base:
//   T       the 128 x 128 f32 tile: partial R, then R, then N̂ (tix layout);
//           then contraction 2's raw ring of P's kept-tile stages (f32, or
//           int4 codes 4 KB and scales 128 B)
//   X       one region, reused: contraction 1's two split stages of G and
//           its raw ring (G's box, then P's: f32, or int4 codes 4 KB and
//           scales 512 B); the epilogue's codebooks, midpoints and absmax
//           partials; contraction 2's N̂ as four 32-deep K-major stages of
//           hi and lo (128 KB), and the bf16 W tile of the apply form (two
//           TMA boxes of 64 columns, 32 KB)
//   book4   the 16 int4 codes, for the whole launch
//   bars    one mbarrier a raw slot of each ring, and one for the W tile
template <typename GT, bool kP4>
struct Layout {
  static constexpr bool kSplitG = sizeof(GT) == 4;  // a bf16 G is exact in TF32
  static constexpr int kTBytes = kT * kT * 4;
  static constexpr int kStage1 = (kSplitG ? 2 : 1) * kTile * 4;
  static constexpr int kRawG = kBM * kBK * static_cast<int>(sizeof(GT));
  static constexpr int kRawP1 = kP4 ? 5 * 1024 : kBM * kBK * 4;
  static constexpr int kSlot1 = kRawG + kRawP1;
  static constexpr int kStage2 = 2 * kTile * 4;  // one 32-deep stage of N̂, hi and lo
  static constexpr int kSlot2 = kP4 ? 5 * 1024 : kBM * kBK * 4;
  static constexpr int kBudgetX = 232448 - 1024 - kTBytes - 64 - 128;
  static constexpr int kFit1 = (kBudgetX - 2 * kStage1) / kSlot1;
  static constexpr int kWTile = kT * kT * 2;
  static constexpr int kFit2 = kTBytes / kSlot2;
  static constexpr int kRaw1 = kFit1 > 5 ? 5 : kFit1;
  static constexpr int kRaw2 = kFit2 > 5 ? 5 : kFit2;
  static constexpr int kX1 = 2 * kStage1 + kRaw1 * kSlot1;
  static constexpr int kOffW = 4 * kStage2;  // in X
  static constexpr int kX2 = kOffW + kWTile;
  static constexpr int kEpi = (4 * 256 + 2 * 256) * 4;  // books, mids, absmax partials
  static constexpr int kX = kX1 > kX2 ? (kX1 > kEpi ? kX1 : kEpi) : (kX2 > kEpi ? kX2 : kEpi);
  static constexpr int kOffX = kTBytes;
  static constexpr int kOffBook4 = kOffX + kX;
  static constexpr int kOffBars = kOffBook4 + 64;
  static constexpr int kBars = kRaw1 + kRaw2 + 1;
  static constexpr int kBytes = kOffBars + 8 * kBars + 1024;
  static_assert(kRaw1 >= 3 && kRaw2 >= 3, "each raw ring needs three slots");
  static_assert(kOffW % 1024 == 0, "the W tile's swizzle needs a 1024-aligned base");
  static_assert(kBytes <= 232448, "over the shared-memory opt-in maximum");
  static_assert(kX2 <= kBudgetX, "N̂'s tiles and the W tile exceed the shared region");
};

// Contraction 1's int4 stage copied by the threads: codes of kept rows
// k0 .. k0+31 (byte rows k0, or k0 - half for the high nibbles) by ranks
// rc0 .. rc0+127 in the TMA's 128-byte swizzle, then the 128 scales of kept
// block k0/128; zero past the rank.
__device__ __forceinline__ void fill_codes_a(uint8_t* raw, const P4& p, int k0, int rc0,
                                             int tid) {
  const int brow = k0 >= p.half ? k0 - p.half : k0;
  for (int e = tid; e < kBK * kT; e += kThreads) {
    const int kk = e / kT, i = e % kT, c = rc0 + i;
    raw[kk * 128 + ((((i >> 4) ^ kk) & 7) << 4) + (i & 15)] =
        c < p.cols ? p.q[(size_t)(brow + kk) * p.cols + c] : 0;
  }
  float* sc = reinterpret_cast<float*>(raw + 4096);
  for (int i = tid; i < kT; i += kThreads)
    sc[i] = rc0 + i < p.cols ? p.s[(size_t)(k0 / kT) * p.cols + rc0 + i] : 0.f;
}

// Contraction 2's int4 stage copied by the threads: codes of the 128 kept
// rows m0.. (two boxes of 64 rows, each on one side of `half`) by ranks
// kg .. kg+31, 32 bytes a row, then the 32 scales of kept block m0/128.
__device__ __forceinline__ void fill_codes_b(uint8_t* raw, const P4& p, int m0, int kg, int tid) {
  for (int e = tid; e < kT * kBK; e += kThreads) {
    const int d = e / kBK, k = e % kBK, row = m0 + d, c = kg + k;
    const int brow = row >= p.half ? row - p.half : row;
    raw[d * kBK + k] = c < p.cols ? p.q[(size_t)brow * p.cols + c] : 0;
  }
  float* sc = reinterpret_cast<float*>(raw + 4096);
  for (int i = tid; i < kBK; i += kThreads)
    sc[i] = kg + i < p.cols ? p.s[(size_t)(m0 / kT) * p.cols + kg + i] : 0.f;
}

// kQ8: the moments as int8 codes and scales (else f32 M and V)
template <bool kRight, bool kP4, bool kQ8, typename GT>
__global__ void __launch_bounds__(kThreads, 1)
    lowrank_adam_kernel(const __grid_constant__ Maps maps, const Args a) {
  using S = Layout<GT, kP4>;
  using OpG = Operand<kRight, GT>;     // contraction 1's B: the G slab (kept x swept)
  using OpPa = Operand<false, float>;  // contraction 1's A: Pᵀ of an f32 P stored (kept, r)
  using OpPb = Operand<true, float>;   // contraction 2's A: a kept tile of P, K-major
  constexpr bool kSplitG = S::kSplitG;
  extern __shared__ uint8_t smem_raw[];
  // the swizzles are functions of address bits, so tiles start 1024-aligned
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* T = reinterpret_cast<float*>(smem);
  uint8_t* X = smem + S::kOffX;
  float* book4 = reinterpret_cast<float*>(smem + S::kOffBook4);
  auto bar = [&](int i) { return smem_u32(smem + S::kOffBars + 8 * i); };

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int C = cluster_size(), cr = cluster_rank();
  const int m = a.m, r = a.r, n = a.n;
  const int kept = kRight ? n : m, swept = kRight ? m : n;
  const int l = blockIdx.y;
  const int blk = blockIdx.x / C, s0 = blk * kT;  // the slab: a quantization block of swept
  const int nb = (swept + kT - 1) / kT;
  const int kept_pad = (kept + kT - 1) / kT * kT, half = kept_pad / 2;
  const int nr = kT / C, row0 = cr * nr;  // the rank rows of the tile this CTA requantizes
  // wgmma fragments: accumulator rows f_row (+ 8), columns 2·f_col + 8b (+ 1);
  // A rows f_row (+ 8), columns f_col (+ 4) of each 8-deep k-step
  const int f_row = (tid >> 7) * 64 + 16 * ((tid >> 5) & 3) + ((tid & 31) >> 2);
  const int f_col = tid & 3;

  if (tid < 16) book4[tid] = a.books[512 + tid];
  if (tid == 0) {
    for (int i = 0; i < S::kBars; ++i) mbar_init(bar(i));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this leaf's operands
  const float* Pf = kP4 ? nullptr : a.P + (size_t)l * kept * r;
  const P4 p4{kP4 ? a.Pq + (size_t)l * half * r : nullptr,
              kP4 ? a.Ps + (size_t)l * (kept_pad / kT) * r : nullptr, book4, kept, r, half};
  const GT* Gl = static_cast<const GT*>(a.G) + (size_t)l * m * n;
  const size_t mom0 = (size_t)l * r * swept;
  const size_t sc0 = (size_t)l * r * nb;
  const size_t o0 = (size_t)l * m * n;  // this leaf's first element of G̃ or W
  const int cnt = *a.count;
  const float t = (float)cnt;
  const Coef co{a.b1, a.omb1, a.b2, a.omb2, a.eps, 1.f - powf(a.b1, t), 1.f - powf(a.b2, t)};
  const bool sr = a.stochastic != 0;
  const bool apply = a.apply != 0;
  const float eta = apply ? *a.eta : 0.f;
  const bool keep_nhat = apply && r > kT;  // W waits for the whole rank

  float acc[64];
  uint32_t a_hi[4 * (kBK / 8)], a_lo[4 * (kBK / 8)];
  int q1 = 0, q2 = 0;  // stages through each raw ring so far: slot and mbarrier phase
  int nw = 0;          // W tiles through shared memory so far: the W mbarrier's phase

  auto split_a = [&](int kk, int j, float x) {
    const float h = tf32_rna(x);
    a_hi[4 * kk + j] = __float_as_uint(h);
    a_lo[4 * kk + j] = __float_as_uint(tf32_rna(x - h));
  };
  // One 32-deep stage: part = A B in split TF32 (small terms first; B's lo
  // pass only with split_b: a bf16 G is exact in TF32), then acc += part;
  // B's k-step advances 8 f32 = 32 bytes (2 in the descriptor's 16-byte
  // units) inside the swizzled rows. `next` runs while the tensor cores do
  // (contraction 1 splits its next stage of G there).
  auto mma_stage = [&](const float* b_tile, bool split_b, auto next) {
    float part[64];  // live only inside the stage: its first wgmma overwrites it
    const uint64_t b_hi = desc_sw128(smem_u32(b_tile));
    const uint64_t b_lo = desc_sw128(smem_u32(b_tile + kTile));
    reg_fence(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) wgmma_tf32_ra(part, a_lo + 4 * kk, b_hi + 2 * kk, kk > 0);
    if (split_b) {
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) wgmma_tf32_ra(part, a_hi + 4 * kk, b_lo + 2 * kk, 1);
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) wgmma_tf32_ra(part, a_hi + 4 * kk, b_hi + 2 * kk, 1);
    wgmma_commit();
    next();
    wgmma_wait_all();
    reg_fence(part);
#pragma unroll
    for (int i = 0; i < 4 * (kBK / 8); ++i)  // the fragments stay live until the wgmmas end
      asm volatile("" : "+r"(a_hi[i]), "+r"(a_lo[i])::"memory");
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
    fence_async_smem();
    __syncthreads();
  };

  // N̂ (rank rows k of the chunk, swept columns j) split into contraction
  // 2's K-major hi/lo stages in X: stage k/32, row j, column k%32. A warp
  // takes 32 consecutive k at one j, so its reads of T (tix) and its stores
  // (swz) are conflict-free.
  auto put_b = [&](int k, int j, float x) {
    float* hi = reinterpret_cast<float*>(X + (k >> 5) * S::kStage2);
    const float h = tf32_rna(x);
    hi[swz(j, k & 31)] = h;
    hi[kTile + swz(j, k & 31)] = tf32_rna(x - h);
  };
  // N̂_c's tiles from the cluster's T: rows this CTA owns from its own, the
  // others from their owners' over distributed shared memory.
  auto build_b = [&]() {
    uint32_t base[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) base[p] = p < C ? peer_addr(smem_u32(T), p) : 0;
#pragma unroll 8
    for (int u = 0; u < kT * kT / kThreads; ++u) {
      const int e = tid + kThreads * u, k = e % kT, j = e / kT, owner = k / nr;
      float x;
      if (owner == cr) {
        x = T[tix(k, j)];
      } else {
        uint32_t src = base[0];
#pragma unroll
        for (int p = 1; p < 4; ++p)
          if (p == owner) src = base[p];
        x = ld_peer(src + 4 * tix(k, j));
      }
      put_b(k, j, x);
    }
  };

  // ---- contraction 2: G̃ tiles = α P N̂ over the rank [kbase, kbase + Kc)
  // for this CTA's kept tiles (cr, cr + C, ...): P's kept tile the register
  // operand (stages through a TMA ring in T, split in registers), N̂ the
  // shared-memory one (its K-major hi/lo stages in X). Resident: build_b
  // made N̂_c's stages. From the scratch: they are rebuilt from it for every
  // 128 of the rank of every tile. `first`: the emit form writes G̃;
  // otherwise it adds to it.
  auto contraction2 = [&](int kbase, int Kc, bool scratch, bool first) {
    const int ntile = (kept + kT - 1) / kT;
    const int nmine = cr < ntile ? (ntile - cr + C - 1) / C : 0;
    const int nk = (Kc + kBK - 1) / kBK, nq = nmine * nk;
    auto raw = [&](int q) { return smem + ((q2 + q) % S::kRaw2) * S::kSlot2; };
    auto tile_m0 = [&](int q) { return (cr + C * (q / nk)) * kT; };
    auto issue = [&](int q) {  // the P stage q into its raw slot (nothing past the end)
      if (q >= nq) return;
      const int m0 = tile_m0(q), kg = kbase + (q % nk) * kBK;
      uint8_t* dst = raw(q);
      if (a.p_tma) {
        if (tid == 0) {
          const uint32_t b = bar(S::kRaw1 + (q2 + q) % S::kRaw2);
          if (kP4) {
            mbar_expect(b, 4096 + 128);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = m0 + 64 * h;
              tma_load(smem_u32(dst + 2048 * h), &maps.qb, kg, row >= half ? row - half : row, l,
                       b);
            }
            tma_load(smem_u32(dst + 4096), &maps.sb, kg, m0 / kT, l, b);
          } else {
            mbar_expect(b, S::kSlot2);
            OpPb::tma(&maps.pb, dst, m0, kg, l, b);
          }
        }
      } else if (kP4) {
        fill_codes_b(dst, p4, m0, kg, tid);
      } else {
        OpPb::fill(Pf, kept, r, m0, kg, tid, dst);
      }
    };
    auto rebuild = [&](int c) {  // N̂'s stages of rank rows kbase + 128c .. from the scratch
#pragma unroll 8
      for (int u = 0; u < kT * kT / kThreads; ++u) {
        const int e = tid + kThreads * u;
        const int k = kRight ? e % kT : e / kT, j = kRight ? e / kT : e % kT;
        const int rk = kbase + kT * c + k, sw = s0 + j;
        float x = 0.f;
        if (rk < r && sw < swept)
          x = __ldcg(a.nhat + mom0 + (kRight ? (size_t)sw * r + rk : (size_t)rk * n + sw));
        put_b(k, j, x);
      }
    };
    // P's fragments of stage q (kept row i, rank k), split into registers: an
    // f32 P from the K-major box; an int4 P decoded from its codes (rows
    // 0-63 and 64-127 each on one side of `half`) and the rank's scales
    auto load_a = [&](int q) {
      const int ks = q % nk;
      if (scratch && ks % 4 == 0) {
        rebuild(ks / 4);
        fence_async_smem();
        __syncthreads();
      }
      if (a.p_tma) mbar_wait(bar(S::kRaw1 + (q2 + q) % S::kRaw2), ((q2 + q) / S::kRaw2) & 1);
      const uint8_t* src = raw(q);
      if (kP4) {
        const int m0 = tile_m0(q);
        const bool hn = (f_row < 64 ? m0 : m0 + 64) >= half;  // f_row, f_row + 8: one box
        const float* sc = reinterpret_cast<const float*>(src + 4096);
#pragma unroll
        for (int kk = 0; kk < kBK / 8; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = f_row + 8 * (j & 1), k = 8 * kk + f_col + 4 * (j >> 1);
            split_a(kk, j, int4p::decode(p4, src[i * kBK + k], hn, sc[k]));
          }
      } else {
#pragma unroll
        for (int kk = 0; kk < kBK / 8; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            split_a(kk, j, *reinterpret_cast<const float*>(
                               src + OpPb::raw_elem(f_row + 8 * (j & 1),
                                                    8 * kk + f_col + 4 * (j >> 1))));
      }
    };
    const bool w_smem = apply && a.w_tma;
    uint8_t* Ws = X + S::kOffW;
    const uint32_t bar_w = bar(S::kRaw1 + S::kRaw2);
    auto load_w = [&](int m0) {  // the bf16 W tile of kept tile m0 into Ws
      if (tid != 0) return;
      bulk_wait_read();  // the last tile's W' has left Ws
      mbar_expect(bar_w, S::kWTile);
#pragma unroll
      for (int b = 0; b < 2; ++b)
        tma_load(smem_u32(Ws + b * kT * 128), &maps.w, (kRight ? m0 : s0) + 64 * b,
                 kRight ? s0 : m0, l, bar_w);
    };
    // the tile's G̃ (or W') from acc: element q of the accumulator is kept
    // m0 + f_row + 8·((q/2)%2), swept s0 + 2·f_col + 8·(q/4) + q%2
    auto store = [&](int m0) {
      if (w_smem) {
        // W' = W + eta (alpha acc + wd W) in place in Ws (as below), then the
        // TMA writes the tile back; what lies past the leaf is not written
        mbar_wait(bar_w, nw & 1);
        ++nw;
#pragma unroll
        for (int q = 0; q < 64; ++q) {
          const int kp = f_row + 8 * ((q >> 1) & 1), sw = 2 * f_col + 8 * (q >> 2) + (q & 1);
          __nv_bfloat16* wp =
              reinterpret_cast<__nv_bfloat16*>(Ws + (kRight ? wix(sw, kp) : wix(kp, sw)));
          const float w = __bfloat162float(*wp);
          const float g = __fmul_rn(a.alpha, acc[q]);
          *wp = __float2bfloat16_rn(
              __fadd_rn(w, __fmul_rn(eta, __fadd_rn(g, __fmul_rn(a.wd, w)))));
        }
        fence_async_smem();
        __syncthreads();
        if (tid == 0) {
#pragma unroll
          for (int b = 0; b < 2; ++b)
            tma_store(&maps.w, smem_u32(Ws + b * kT * 128), (kRight ? m0 : s0) + 64 * b,
                      kRight ? s0 : m0, l);
          bulk_commit();
        }
        return;
      }
      auto index = [&](int q, bool& ok) {
        const int kp = m0 + f_row + 8 * ((q >> 1) & 1);
        const int sw = s0 + 2 * f_col + 8 * (q >> 2) + (q & 1);
        ok = sw < swept && kp < kept;
        return o0 + (kRight ? (size_t)sw * n + kp : (size_t)kp * n + sw);
      };
      if (!apply) {
        // on the left, accumulator elements q and q + 1 are neighbours in G̃
        const bool pairs = !kRight && first && n % 2 == 0;
#pragma unroll
        for (int q = 0; q < 64; q += 2) {
          bool ok0, ok1;
          const size_t o0_ = index(q, ok0), o1_ = index(q + 1, ok1);
          const float v0 = __fmul_rn(a.alpha, acc[q]), v1 = __fmul_rn(a.alpha, acc[q + 1]);
          if (pairs && ok1) {
            *reinterpret_cast<float2*>(a.out + o0_) = make_float2(v0, v1);
            continue;
          }
          if (ok0) a.out[o0_] = first ? v0 : __fadd_rn(a.out[o0_], v0);
          if (ok1) a.out[o1_] = first ? v1 : __fadd_rn(a.out[o1_], v1);
        }
        return;
      }
      // W' = W + eta (alpha acc + wd W), each operation rounded, in the plain
      // version's order; a batch's W loads are issued before its stores (a
      // store to W would order every later load behind it)
#pragma unroll
      for (int q0 = 0; q0 < 64; q0 += 32) {
        float w[32];
#pragma unroll
        for (int q = 0; q < 32; ++q) {
          bool ok;
          const size_t o = index(q0 + q, ok);
          w[q] = !ok ? 0.f
                 : a.w_bf16 ? load_g(static_cast<const __nv_bfloat16*>(a.W), o)
                            : load_g(static_cast<const float*>(a.W), o);
        }
#pragma unroll
        for (int q = 0; q < 32; ++q) {
          bool ok;
          const size_t o = index(q0 + q, ok);
          const float g = __fmul_rn(a.alpha, acc[q0 + q]);
          const float v = __fadd_rn(w[q], __fmul_rn(eta, __fadd_rn(g, __fmul_rn(a.wd, w[q]))));
          if (!ok) continue;
          if (a.w_bf16) store_w(static_cast<__nv_bfloat16*>(a.W), o, v);
          else store_w(static_cast<float*>(a.W), o, v);
        }
      }
    };

    // Ask L2 for the W tile of kept tile m0 (rows m0.. by columns s0.. on the
    // left, rows s0.. by columns m0.. on the right), one 128-byte line a
    // thread and step, when its contraction starts: its epilogue's loads
    // then find W in L2.
    auto prefetch_w = [&](int m0) {
      const int esz = a.w_bf16 ? 2 : 4, per_line = 128 / esz, lines = kT / per_line;
      const int r0 = kRight ? s0 : m0, c0 = kRight ? m0 : s0;
      const char* W = static_cast<const char*>(a.W);
      for (int e = tid; e < kT * lines; e += kThreads) {
        const int row = r0 + e / lines, col = c0 + (e % lines) * per_line;
        if (row < m && col < n)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(W + (o0 + (size_t)row * n + col) * esz));
      }
    };

#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    if (nq > 0) {
      if (apply && !w_smem) prefetch_w(tile_m0(0));
      for (int q = 0; q < S::kRaw2 - 1; ++q) issue(q);
      __syncthreads();  // the threads' copies of stage 0, when they made them
      for (int q = 0; q < nq; ++q) {
        // its slot held stage q - 1, read two barriers ago; threads' copies
        // of stage q + 1 were made at least one barrier ago (kRaw2 >= 3)
        issue(q + S::kRaw2 - 1);
        if (w_smem && q % nk == (nk > 1 ? 1 : 0)) load_w(tile_m0(q));
        if (apply && !w_smem && q % nk == 0 && q + nk < nq) prefetch_w(tile_m0(q + nk));
        load_a(q);
        mma_stage(reinterpret_cast<const float*>(X + ((q % nk) % 4) * S::kStage2), true, [] {});
        if ((q + 1) % nk == 0) {
          store(tile_m0(q));
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[i] = 0.f;
        }
      }
    }
    q2 += nq;
    if (w_smem && tid == 0) bulk_wait();  // Ws stays in use until the stores end
  };

  const int steps1 = (kept + kBK - 1) / kBK;
  const int k_lo = cr * steps1 / C, n1 = (cr + 1) * steps1 / C - k_lo;
  for (int rc0 = 0; rc0 < r; rc0 += kT) {
    // ---- 1. partial R_c = P_cᵀ G_slab over kept stages [k_lo, k_lo + n1)
    auto raw = [&](int st) { return X + 2 * S::kStage1 + ((q1 + st) % S::kRaw1) * S::kSlot1; };
    auto issue = [&](int st) {  // stage st: G's box, then P's (nothing past the end)
      if (st >= n1) return;
      uint8_t* dst = raw(st);
      uint8_t* dp = dst + S::kRawG;
      const int k0 = (k_lo + st) * kBK;
      if (a.p_tma) {
        if (tid == 0) {
          const uint32_t b = bar((q1 + st) % S::kRaw1);
          mbar_expect(b, (a.g_tma ? S::kRawG : 0) + (kP4 ? 4096 + 512 : S::kRawP1));
          if (a.g_tma) OpG::tma(&maps.g, dst, s0, k0, l, b);
          if (kP4) {
            tma_load(smem_u32(dp), &maps.qa, rc0, k0 >= half ? k0 - half : k0, l, b);
            tma_load(smem_u32(dp + 4096), &maps.sa, rc0, k0 / kT, l, b);
          } else {
            OpPa::tma(&maps.pa, dp, rc0, k0, l, b);
          }
        }
        if (!a.g_tma) OpG::fill(Gl, swept, kept, s0, k0, tid, dst);
      } else {
        OpG::fill(Gl, swept, kept, s0, k0, tid, dst);
        if (kP4) fill_codes_a(dp, p4, k0, rc0, tid);
        else OpPa::fill(Pf, r, kept, rc0, k0, tid, dp);
      }
    };
    auto split = [&](int st) {  // G of stage st into split stage st % 2
      if (a.p_tma) mbar_wait(bar((q1 + st) % S::kRaw1), ((q1 + st) / S::kRaw1) & 1);
      float* hi = reinterpret_cast<float*>(X + (st & 1) * S::kStage1);
      OpG::template split<kSplitG>(raw(st), hi, hi + kTile, tid);
    };
    auto load_a = [&](int st) {  // Pᵀ's fragments of stage st (landed), split into registers
      const uint8_t* dp = raw(st) + S::kRawG;
      if (kP4) {  // rank row i, kept k: code byte (k, i) of the swizzled box, scale of row i
        const bool hn = (k_lo + st) * kBK >= half;
        const float* sc = reinterpret_cast<const float*>(dp + 4096);
        const float s_a = sc[f_row], s_b = sc[f_row + 8];
#pragma unroll
        for (int kk = 0; kk < kBK / 8; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = f_row + 8 * (j & 1), k = 8 * kk + f_col + 4 * (j >> 1);
            const unsigned byte = dp[k * 128 + ((((i >> 4) ^ k) & 7) << 4) + (i & 15)];
            split_a(kk, j, int4p::decode(p4, byte, hn, (j & 1) ? s_b : s_a));
          }
      } else {
#pragma unroll
        for (int kk = 0; kk < kBK / 8; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            split_a(kk, j, *reinterpret_cast<const float*>(
                               dp + OpPa::raw_elem(f_row + 8 * (j & 1),
                                                   8 * kk + f_col + 4 * (j >> 1))));
      }
    };
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    if (n1 > 0) {
      for (int st = 0; st < S::kRaw1 - 1; ++st) issue(st);
      __syncthreads();  // the threads' copies of stage 0, when they made them
      split(0);
      fence_async_smem();
      __syncthreads();
      for (int s = 0; s < n1; ++s) {
        issue(s + S::kRaw1 - 1);
        load_a(s);
        mma_stage(reinterpret_cast<const float*>(X + (s & 1) * S::kStage1), kSplitG, [&] {
          if (s + 1 < n1) split(s + 1);
        });
      }
    }
    q1 += n1;
#pragma unroll
    for (int q = 0; q < 64; ++q)
      T[tix(f_row + 8 * ((q >> 1) & 1), 2 * f_col + 8 * (q >> 2) + (q & 1))] = acc[q];
    cluster_sync();  // every CTA's partial R_c is in its T

    // ---- 2. R_c's owned rows: the partials summed in CTA order
    if (C > 1) {
      constexpr int kMax = kT * kT / 2 / kThreads;  // owned elements a thread, C = 2
      const int per = kT * kT / C / kThreads;
      uint32_t base[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) base[p] = p < C ? peer_addr(smem_u32(T), p) : 0;
      float sum[kMax];
#pragma unroll
      for (int u = 0; u < kMax; ++u) {
        if (u >= per) break;
        const int e = tid + kThreads * u;
        const uint32_t off = 4 * tix(row0 + e / kT, e % kT);
        float s = ld_peer(base[0] + off);
#pragma unroll
        for (int p = 1; p < 4; ++p)
          if (p < C) s += ld_peer(base[p] + off);
        sum[u] = s;
      }
      cluster_sync();  // every CTA has read what it needs of the others' partials
#pragma unroll
      for (int u = 0; u < kMax; ++u) {
        if (u >= per) break;
        const int e = tid + kThreads * u;
        T[tix(row0 + e / kT, e % kT)] = sum[u];
      }
    }
    // the int8 store's codebooks and midpoints, in X (contraction 1's ring
    // is drained)
    float* book_s = reinterpret_cast<float*>(X);
    float* book_u = book_s + 256;
    float* mids_s = book_s + 512;
    float* mids_u = book_s + 768;
    float* red = book_s + 1024;  // 2 x 8 warps x 32 absmax partials (right side)
    if (kQ8) {
      for (int i = tid; i < 512; i += kThreads) book_s[i] = a.books[i];
      __syncthreads();
      for (int i = tid; i < 255; i += kThreads) {
        mids_s[i] = __fdiv_rn(__fadd_rn(book_s[i], book_s[i + 1]), 2.f);
        mids_u[i] = __fdiv_rn(__fadd_rn(book_u[i], book_u[i + 1]), 2.f);
      }
    }
    __syncthreads();  // the owned rows of R_c (and the midpoints) are in place

    // ---- 3. the moment update on the owned rows; N̂ replaces R (0 outside
    // the leaf); with keep_nhat N̂ also goes to the scratch
    if constexpr (!kQ8) {
      // f32 M and V in place. A warp takes 32 swept columns of one rank row
      // on the left (M's rows run along n), 32 rank rows at one swept
      // position on the right (along r): 128 contiguous bytes either way.
      // Each thread loads a batch's moments before it updates any.
      constexpr int kB = 8;
      const int per = nr * kT / kThreads;  // 64, 32 or 16: whole batches
      for (int u0 = 0; u0 < per; u0 += kB) {
        int ti[kB];
        size_t off[kB];
        float mo[kB], vo[kB];
#pragma unroll
        for (int b = 0; b < kB; ++b) {
          const int u = tid + kThreads * (u0 + b);
          const int i = row0 + (kRight ? u % 32 + 32 * (u / (32 * kT)) : u / kT);
          const int j = kRight ? u / 32 % kT : u % kT;
          const int rk = rc0 + i, sw = s0 + j;
          ti[b] = tix(i, j);
          off[b] = rk < r && sw < swept
                       ? mom0 + (kRight ? (size_t)sw * r + rk : (size_t)rk * n + sw)
                       : ~(size_t)0;
          mo[b] = off[b] != ~(size_t)0 ? a.M[off[b]] : 0.f;
          vo[b] = off[b] != ~(size_t)0 ? a.V[off[b]] : 0.f;
        }
#pragma unroll
        for (int b = 0; b < kB; ++b) {
          float nh = 0.f;
          if (off[b] != ~(size_t)0) {
            float mn, vn;
            adam_moments(co, mo[b], vo[b], T[ti[b]], &mn, &vn);
            a.M[off[b]] = mn;
            a.V[off[b]] = vn;
            nh = adam_step(co, mn, vn);
            if (keep_nhat) a.nhat[off[b]] = nh;
          }
          T[ti[b]] = nh;
        }
      }
    } else if (!kRight) {
      // a warp per rank row (its quantization block is the row's 128
      // columns), a lane per 4 columns
      for (int ii = warp; ii < nr; ii += kThreads / 32) {
        const int i = row0 + ii, rr = rc0 + i;
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
            adam_moments(co, __fmul_rn(book_s[a.Mq[off]], sm), __fmul_rn(book_u[a.Vq[off]], sv),
                         T[tix(i, j)], &mn[q], &vn[q]);
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
            // ravel index in the full (L, sr_full, n) leaf, mod 2^32
            const uint32_t idx = (uint32_t)(((size_t)l * a.sr_full + a.sr_off + rr) * n + col);
            a.Mq[off] = requant(mn[q], am, book_s, mids_s, sr, idx, (uint32_t)cnt, kSaltM);
            a.Vq[off] = requant(vn[q], av, book_u, mids_u, sr, idx, (uint32_t)cnt, kSaltV);
            nh = adam_step(co, mn[q], vn[q]);
            if (keep_nhat) a.nhat[off] = nh;
          }
          T[tix(i, j)] = nh;
        }
        if (row_ok && lane == 0) {
          a.Ms[srow] = am;
          a.Vs[srow] = av;
        }
      }
    } else {
      // a lane per rank row (the codes are rank-contiguous), warps of a
      // group of 32 rows splitting the 128 swept positions; the absmax
      // partials meet in `red`. Pass 1 finds the absmax, pass 2 recomputes
      // M', V' and requantizes.
      const int wpg = (kThreads / 32) / (nr / 32), span = kT / wpg;
      const int grp = warp / wpg, wi = warp % wpg;
      const int i = row0 + 32 * grp + lane, rk = rc0 + i;
      const bool col_ok = rk < r;
      const size_t scol = sc0 + (size_t)blk * r + rk;
      const float sm = col_ok ? a.Ms[scol] : 0.f, sv = col_ok ? a.Vs[scol] : 0.f;
      float am = 0.f, av = 0.f;
      for (int j = wi * span; j < (wi + 1) * span; ++j) {
        const int row = s0 + j;
        if (col_ok && row < m) {
          const size_t off = mom0 + (size_t)row * r + rk;
          float mn, vn;
          adam_moments(co, __fmul_rn(book_s[a.Mq[off]], sm), __fmul_rn(book_u[a.Vq[off]], sv),
                       T[tix(i, j)], &mn, &vn);
          am = fmaxf(am, fabsf(mn));
          av = fmaxf(av, fabsf(vn));
        }
      }
      red[warp * 32 + lane] = am;
      red[256 + warp * 32 + lane] = av;
      __syncthreads();
      am = av = 0.f;
      for (int w = 0; w < wpg; ++w) {
        am = fmaxf(am, red[(grp * wpg + w) * 32 + lane]);
        av = fmaxf(av, red[256 + (grp * wpg + w) * 32 + lane]);
      }
      am = __fadd_rn(am, 1e-12f);
      av = __fadd_rn(av, 1e-12f);
      for (int j = wi * span; j < (wi + 1) * span; ++j) {
        const int row = s0 + j;
        float nh = 0.f;
        if (col_ok && row < m) {
          const size_t off = mom0 + (size_t)row * r + rk;
          float mn, vn;
          adam_moments(co, __fmul_rn(book_s[a.Mq[off]], sm), __fmul_rn(book_u[a.Vq[off]], sv),
                       T[tix(i, j)], &mn, &vn);
          // ravel index in the full (L, m, sr_full) leaf, mod 2^32
          const uint32_t idx = (uint32_t)(((size_t)l * m + row) * a.sr_full + a.sr_off + rk);
          a.Mq[off] = requant(mn, am, book_s, mids_s, sr, idx, (uint32_t)cnt, kSaltM);
          a.Vq[off] = requant(vn, av, book_u, mids_u, sr, idx, (uint32_t)cnt, kSaltV);
          nh = adam_step(co, mn, vn);
          if (keep_nhat) a.nhat[off] = nh;
        }
        T[tix(i, j)] = nh;
      }
      if (col_ok && wi == 0) {
        a.Ms[scol] = am;
        a.Vs[scol] = av;
      }
    }
    fence_async_smem();  // X held the codebooks; the TMA writes there next
    if (keep_nhat) {  // G̃ waits for the whole rank: the last pass below
      __syncthreads();
      continue;
    }
    cluster_sync();  // every CTA's N̂_c rows are in its T

    // ---- 4. N̂_c's hi/lo stages from the cluster, then this CTA's G̃ tiles
    build_b();
    fence_async_smem();  // the tensor cores read the stages; the TMA writes T next
    cluster_sync();      // no CTA reads this one's T again this chunk
    contraction2(rc0, min(kT, r - rc0), false, rc0 == 0);
  }
  if (keep_nhat) {
    cluster_sync();  // every CTA's N̂ rows of every chunk are in the scratch
    contraction2(0, r, true, true);
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
// Replaces `adam8bit_blocks_update` of src/repro/kernels/galore_fused.py:762
// (the same `_fused_epilogue_call`, pallas_call :676, with project=False:
// R = G, one quantization block per 256 elements of the flattened leaf),
// reached through kernels/adam8bit_update.py and ops.adam8bit_step. Per
// element of block b:
//   M = book_s[Mq] * Ms[b],  V = book_u[Vq] * Vs[b]      (dequant, f32)
//   M' = b1 M + (1-b1) g,  V' = b2 V + (1-b2) g²          (0 past numel)
//   update = (M'/c1) / (sqrt(V'/c2) + eps), in g's dtype  (none past numel)
//   Ms'[b] = max |M'| over the block + 1e-12, Mq' = searchsorted(mids, M'/Ms')
// with the codec's nearest-code rule and explicitly rounded f32 operations in
// the plain version's order, as in lowrank_adam_kernel: for equal inputs codes,
// scales and the update are the plain version's bit for bit. The state is
// padded to whole blocks as the codec pads it; g and the update are not: the
// last block's tail is masked.
//
// What bounds it on an H100: bytes. An element moves g (2 B in bf16), its two
// codes read and written (4 B) and the update (2 B), 8 B, against ~35 f32
// operations: the (32000, 4096) embedding leaf moves 1.06 GB, 0.315 ms at
// 3.35 TB/s. The first design (a lane per 8 elements at a stride of 32, the
// nearest code by an 8-step binary search over the 255 midpoints in shared
// memory) issued about 170 instructions an element, some 100 of them the
// two searches' dependent shared-memory loads at data-dependent,
// bank-conflicting addresses, beside five IEEE divisions, a square root and
// six 1- or 2-byte memory instructions. Issue time, not bytes, set its pace:
// 1.444 ms at the embedding leaf, 22 % of the bound (H100 80GB HBM3, 700 W).
// Design:
//  - The nearest code from a bracket table (codec.bracket_table, built on the
//    host, 5.5 KB in shared memory beside the books and the midpoints): one
//    byte load keyed on the f32 bits of x/absmax (sign, clamped exponent, top
//    mantissa bits) gives the count of midpoints below x's bucket, and one
//    comparison with the next midpoint ends it, as no bucket holds two. The
//    same strict comparisons against the same f32 midpoints: the code is
//    searchsorted(mids, x) bit for bit.
//  - A lane owns 8 consecutive elements of its warp's 256-element block: one
//    16-byte load of a bf16 g (two of an f32 g), one 8-byte load and one
//    8-byte store of each moment's codes, one 16-byte store of a bf16 update;
//    a warp's load of g covers 512 contiguous bytes. Where g or the update is
//    not 16-byte aligned, the codes not 8-byte aligned, or numel cuts a
//    lane's 8 elements, that lane takes the element path of the same kernel;
//    the word path carries no per-element test.
//  - The IEEE divisions and the square root stay: they are what keeps the
//    update and the codes the plain version's bit for bit.
//  - 8 warps a thread block walk the leaf's blocks grid-stride, as many
//    thread blocks as the card holds at once, so each loads the books and
//    the tables once.
// The word path issues 121 instructions an element (cuobjdump -sass of the
// bf16 instance built for sm_90a: 969 for a lane's 8 elements). 50 of them
// are the five divisions (10 each: MUFU.RCP, five FFMA, FCHK, a branch and
// its convergence pair), 9 the square root and 26 the two table lookups. At
// 4 warp instructions a clock on each of 132 SMs that is ≈ 0.5 ms of issue
// at the embedding leaf, against 0.315 ms of bytes: issue still bounds it.
constexpr int kFlat = 256;  // optim/quant8.BLOCK: a warp's block
constexpr int kFlatThreads = 256;
constexpr int kFlatPerLane = kFlat / 32;  // consecutive elements a lane owns

// codec.BRACKETS: the exponents [lo, hi] and the mantissa bits of a bucket's
// key, for the signed (M) and the unsigned (V) codebook
template <bool kSigned>
struct Bracket;
template <>
struct Bracket<true> { static constexpr int lo = 107, hi = 126, bits = 6; };
template <>
struct Bracket<false> { static constexpr int lo = 104, hi = 126, bits = 7; };
template <bool kSigned>
constexpr int bracket_len() {
  return (Bracket<kSigned>::hi - Bracket<kSigned>::lo + 1) << Bracket<kSigned>::bits;
}
constexpr int kTableS = 2 * bracket_len<true>();  // a row of buckets for each sign
constexpr int kTables = kTableS + bracket_len<false>();
static_assert(kTables % 16 == 0, "the tables load in 16-byte words");

// searchsorted(mids, x): the count of midpoints strictly below x, from x's
// bucket in `table` and one comparison; mids[255] is +inf.
template <bool kSigned>
__device__ __forceinline__ uint8_t bracket_code(float x, const uint8_t* table, const float* mids) {
  using B = Bracket<kSigned>;
  constexpr uint32_t kFirst = B::lo << B::bits, kLast = ((B::hi + 1) << B::bits) - 1;
  const uint32_t u = __float_as_uint(x);
  // the unsigned book's midpoints are all above 0: a negative x takes bucket 0
  const uint32_t mag = (!kSigned && (u >> 31)) ? 0u : (u & 0x7fffffffu);
  uint32_t key = min(max(mag >> (23 - B::bits), kFirst), kLast) - kFirst;
  if (kSigned) key += (u >> 31) * (kLast + 1 - kFirst);
  const int below = table[key];
  return (uint8_t)(below + (mids[below] < x ? 1 : 0));
}

// 8 consecutive elements of g from i, as f32 (a bf16 is its f32's top half)
__device__ __forceinline__ void load8(const __nv_bfloat16* g, size_t i, float* v) {
  const uint4 w = *reinterpret_cast<const uint4*>(g + i);
  const uint32_t h[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[2 * q] = __uint_as_float(h[q] << 16);
    v[2 * q + 1] = __uint_as_float(h[q] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const float* g, size_t i, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(g + i);
  const float4 b = *reinterpret_cast<const float4*>(g + i + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, size_t i, const float* v) {
  uint32_t h[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    h[q] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * q])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * q + 1])) << 16);
  *reinterpret_cast<uint4*>(p + i) = make_uint4(h[0], h[1], h[2], h[3]);
}
__device__ __forceinline__ void store8(float* p, size_t i, const float* v) {
  *reinterpret_cast<float4*>(p + i) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + i + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// 8 codes from i, one 8-byte word
__device__ __forceinline__ void load_codes(const uint8_t* c, size_t i, uint8_t* out) {
  const uint2 w = *reinterpret_cast<const uint2*>(c + i);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    out[q] = (uint8_t)(w.x >> (8 * q));
    out[q + 4] = (uint8_t)(w.y >> (8 * q));
  }
}
__device__ __forceinline__ void store_codes(uint8_t* c, size_t i, const uint8_t* v) {
  uint2 w = make_uint2(0u, 0u);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    w.x |= (uint32_t)v[q] << (8 * q);
    w.y |= (uint32_t)v[q + 4] << (8 * q);
  }
  *reinterpret_cast<uint2*>(c + i) = w;
}

template <typename GT>
__global__ void __launch_bounds__(kFlatThreads, 4)
    adam8bit_flat_kernel(const GT* __restrict__ g, long long numel, long long nb,
                         uint8_t* __restrict__ mq, float* __restrict__ ms, uint8_t* __restrict__ vq,
                         float* __restrict__ vs, const int* __restrict__ count,
                         const float* __restrict__ books, const uint8_t* __restrict__ tables,
                         GT* __restrict__ upd, float b1, float omb1, float b2, float omb2,
                         float eps) {
  __shared__ float book_s[256], book_u[256], mids_s[256], mids_u[256];
  __shared__ __align__(16) uint8_t table_s[kTables];
  const int tid = threadIdx.x, lane = tid % 32;
  for (int i = tid; i < 512; i += kFlatThreads) {
    if (i < 256) book_s[i] = books[i];
    else book_u[i - 256] = books[i];
  }
  for (int i = tid; i < kTables / 16; i += kFlatThreads)
    reinterpret_cast<uint4*>(table_s)[i] = reinterpret_cast<const uint4*>(tables)[i];
  __syncthreads();
  for (int i = tid; i < 256; i += kFlatThreads) {
    mids_s[i] = i < 255 ? __fdiv_rn(__fadd_rn(book_s[i], book_s[i + 1]), 2.f) : INFINITY;
    mids_u[i] = i < 255 ? __fdiv_rn(__fadd_rn(book_u[i], book_u[i + 1]), 2.f) : INFINITY;
  }
  const float t = (float)*count;
  const Coef k{b1, omb1, b2, omb2, eps, 1.f - powf(b1, t), 1.f - powf(b2, t)};
  __syncthreads();

  // whole-word loads and stores need their words' alignment
  const uintptr_t g_at = reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(upd);
  const uintptr_t code_at = reinterpret_cast<uintptr_t>(mq) | reinterpret_cast<uintptr_t>(vq);
  const bool g_words = (g_at & 15) == 0, code_words = (code_at & 7) == 0;
  const long long warps = (long long)gridDim.x * (kFlatThreads / 32);
  for (long long b = (long long)blockIdx.x * (kFlatThreads / 32) + tid / 32; b < nb; b += warps) {
    const long long i0 = b * kFlat + lane * kFlatPerLane;
    // whole words: no element of the lane's 8 past numel, every word aligned
    const bool words = g_words && code_words && i0 + kFlatPerLane <= numel;
    const float sm = ms[b], sv = vs[b];
    float mn[kFlatPerLane], vn[kFlatPerLane];
    if (words) {
      float gv[kFlatPerLane];
      uint8_t cm[kFlatPerLane], cv[kFlatPerLane];
      load8(g, i0, gv);
      load_codes(mq, i0, cm);
      load_codes(vq, i0, cv);
#pragma unroll
      for (int q = 0; q < kFlatPerLane; ++q)
        adam_moments(k, __fmul_rn(book_s[cm[q]], sm), __fmul_rn(book_u[cv[q]], sv), gv[q], &mn[q],
                     &vn[q]);
    } else {
#pragma unroll
      for (int q = 0; q < kFlatPerLane; ++q) {
        mn[q] = vn[q] = 0.f;
        if (i0 + q < numel)
          adam_moments(k, __fmul_rn(book_s[mq[i0 + q]], sm), __fmul_rn(book_u[vq[i0 + q]], sv),
                       load_g(g, i0 + q), &mn[q], &vn[q]);
      }
    }
    float am = 0.f, av = 0.f;
#pragma unroll
    for (int q = 0; q < kFlatPerLane; ++q) {
      am = fmaxf(am, fabsf(mn[q]));
      av = fmaxf(av, fabsf(vn[q]));
    }
    am = __fadd_rn(warp_max(am), 1e-12f);
    av = __fadd_rn(warp_max(av), 1e-12f);
    uint8_t cm[kFlatPerLane], cv[kFlatPerLane];
    float u[kFlatPerLane];
#pragma unroll
    for (int q = 0; q < kFlatPerLane; ++q) {
      cm[q] = bracket_code<true>(__fdiv_rn(mn[q], am), table_s, mids_s);
      cv[q] = bracket_code<false>(__fdiv_rn(vn[q], av), table_s + kTableS, mids_u);
      u[q] = adam_step(k, mn[q], vn[q]);
    }
    if (words) {
      store_codes(mq, i0, cm);
      store_codes(vq, i0, cv);
      store8(upd, i0, u);
    } else {
      // the codes are padded to whole blocks: only the update stops at numel
#pragma unroll
      for (int q = 0; q < kFlatPerLane; ++q) {
        mq[i0 + q] = cm[q];
        vq[i0 + q] = cv[q];
        if (i0 + q < numel) store_w(upd, i0 + q, u[q]);
      }
    }
    if (lane == 0) {
      ms[b] = am;
      vs[b] = av;
    }
  }
}

template <typename GT>
cudaError_t launch_flat(const void* g, long long numel, uint8_t* mq, float* ms, uint8_t* vq,
                        float* vs, const int* count, const float* books, const uint8_t* tables,
                        void* upd, double b1, double b2, double eps, cudaStream_t stream) {
  // the thread blocks the card holds at once (found once a process): more
  // would only load the tables again
  static const int per_sm = [] {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, adam8bit_flat_kernel<GT>, kFlatThreads,
                                                      0) != cudaSuccess || n < 1)
      n = 1;
    return n;
  }();
  const long long nb = (numel + kFlat - 1) / kFlat;
  const long long per_block = kFlatThreads / 32;
  const long long want = (nb + per_block - 1) / per_block, fill = (long long)per_sm * sm_count();
  const long long blocks = want < fill ? want : fill;
  adam8bit_flat_kernel<GT><<<(unsigned)blocks, kFlatThreads, 0, stream>>>(
      static_cast<const GT*>(g), numel, nb, mq, ms, vq, vs, count, books, tables,
      static_cast<GT*>(upd), (float)b1, (float)(1.0 - b1), (float)b2, (float)(1.0 - b2),
      (float)eps);
  return cudaGetLastError();
}

// 1 where this host thread's last launch of lowrank_adam_kernel copied an
// operand by the threads instead of by the TMA, else 0; and the CTAs a
// cluster it took.
thread_local int last_copied = 0;
thread_local int last_cluster = 0;

// The clusters of C CTAs of `kernel` that the card holds at once (0 where
// the occupancy query fails).
template <typename K>
int active_clusters(K kernel, int C, int bytes) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int count = 0;
  if (cudaOccupancyMaxActiveClusters(&count, (const void*)kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();  // clear it: this launch goes on without the cluster size
    return 0;
  }
  return count;
}

template <bool kRight, bool kP4, bool kQ8, typename GT>
cudaError_t launch(Args a, int L, cudaStream_t stream) {
  using S = Layout<GT, kP4>;
  auto kernel = lowrank_adam_kernel<kRight, kP4, kQ8, GT>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  // the shared-memory opt-in and the occupancy of each cluster size, once
  // per instance and device (devices 0-31)
  static std::atomic<unsigned> opted_in{0};
  static std::atomic<int> active[3][32];
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if ((opted_in.load() & bit) == 0 || bit == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
    if (err != cudaSuccess) return err;
    if (bit != 0)
      for (int ci = 0; ci < 3; ++ci) active[ci][dev].store(active_clusters(kernel, 1 << ci, S::kBytes));
    opted_in.fetch_or(bit);
  }

  const int kept = kRight ? a.n : a.m, swept = kRight ? a.m : a.n, r = a.r;
  const int kept_pad = (kept + kT - 1) / kT * kT;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  const cudaError_t eg = make_map<kRight, GT>(&maps.g, a.G, swept, kept, L);
  cudaError_t e[4];
  int ne = 0;
  if (kP4) {
    e[ne++] = make_map_3d(&maps.qa, a.Pq, 1, r, kept_pad / 2, L, kT, kBK, true);
    e[ne++] = make_map_3d(&maps.qb, a.Pq, 1, r, kept_pad / 2, L, kBK, 64, false);
    e[ne++] = make_map_3d(&maps.sa, a.Ps, 4, r, kept_pad / kT, L, kT, 1, false);
    e[ne++] = make_map_3d(&maps.sb, a.Ps, 4, r, kept_pad / kT, L, kBK, 1, false);
  } else {
    e[ne++] = make_map<false, float>(&maps.pa, a.P, r, kept, L);
    e[ne++] = make_map<true, float>(&maps.pb, a.P, kept, r, L);
  }
  // P with its scales by the TMA where it can describe them, and then G too
  // where it can describe G; what it cannot, the threads copy
  if (eg != cudaSuccess && eg != cudaErrorNotSupported) return eg;
  a.p_tma = 1;
  for (int i = 0; i < ne; ++i) {
    if (e[i] == cudaErrorNotSupported) a.p_tma = 0;
    else if (e[i] != cudaSuccess) return e[i];
  }
  a.g_tma = a.p_tma && eg == cudaSuccess;
  // a bf16 W goes through shared memory by the TMA where it can describe W
  if (a.apply && a.w_bf16) {
    const cudaError_t ew = make_map_3d(&maps.w, a.W, 2, a.n, a.m, L, 64, kT, true);
    if (ew != cudaSuccess && ew != cudaErrorNotSupported) return ew;
    a.w_tma = ew == cudaSuccess;
  }
  // the threads' element offsets inside one leaf are 32-bit
  if ((!a.g_tma && (long long)a.m * a.n >= (1LL << 31)) ||
      (!a.p_tma && (long long)kept * r >= (1LL << 31)))
    return cudaErrorInvalidValue;

  // The cluster size: the fewest waves of slabs per CTA's share of a slab,
  // each CTA of a cluster doing 1/C of the contractions and the epilogue;
  // a cluster beyond one CTA pays ~5 % for the exchange of partial sums and
  // N̂. A CTA needs one 32-deep stage of the kept axis at least.
  const int nslab = (swept + kT - 1) / kT, steps1 = (kept + kBK - 1) / kBK;
  const long long items = (long long)nslab * L;
  int C = 1;
  double best = 1e300;
  for (int ci = 0; ci < 3; ++ci) {
    const int c = 1 << ci;
    const int act = bit != 0 ? active[ci][dev].load() : (ci == 0 ? 1 : 0);
    if (act <= 0 || (c > 1 && steps1 < c)) continue;
    const double waves = (double)((items + act - 1) / act);
    const double cost = waves / c * (c > 1 ? 1.05 : 1.0);
    if (cost < best) {
      best = cost;
      C = c;
    }
  }
  if ((long long)nslab * C > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  last_copied = !a.g_tma;
  last_cluster = C;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(nslab * C), (unsigned)L, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = S::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, maps, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kRight, bool kQ8>
cudaError_t dispatch(const Args& a, int p_int4, int g_bf16, int L, cudaStream_t s) {
  if (L <= 0 || a.m <= 0 || a.r <= 0 || a.n <= 0 || L > 65535) return cudaErrorInvalidValue;
  if (a.apply && a.r > kT && a.nhat == nullptr) return cudaErrorInvalidValue;
  if (a.sr_off < 0 || a.sr_off + a.r > a.sr_full) return cudaErrorInvalidValue;
  if (p_int4) {
    return g_bf16 ? launch<kRight, true, kQ8, __nv_bfloat16>(a, L, s)
                  : launch<kRight, true, kQ8, float>(a, L, s);
  }
  return g_bf16 ? launch<kRight, false, kQ8, __nv_bfloat16>(a, L, s)
                : launch<kRight, false, kQ8, float>(a, L, s);
}

// q8: the moments are int8 codes and scales (Mq .. Vs), else f32 (M, V)
int run(bool right, bool q8, const Args& a, int p_int4, int g_bf16, int L, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q8)
    return (int)(right ? dispatch<true, true>(a, p_int4, g_bf16, L, s)
                       : dispatch<false, true>(a, p_int4, g_bf16, L, s));
  return (int)(right ? dispatch<true, false>(a, p_int4, g_bf16, L, s)
                     : dispatch<false, false>(a, p_int4, g_bf16, L, s));
}

Args make_args(const float* P, const uint8_t* Pq, const float* Ps, const void* G, uint8_t* Mq,
               float* Ms, uint8_t* Vq, float* Vs, float* M, float* V, const int* count,
               const float* books, float* out, void* W, int apply, int w_bf16, const float* eta,
               double wd, float* nhat, int m, int r, int n, double b1, double b2, double eps,
               double alpha, int stochastic, int sr_off = 0, int sr_full = 0) {
  return Args{P, Pq, Ps, G, Mq, Ms, Vq, Vs, M, V, count, books, out, W, apply, w_bf16, 0, 0, 0,
              eta, (float)wd, nhat, m, r, n, stochastic, sr_off, sr_full > 0 ? sr_full : r,
              (float)b1, (float)(1.0 - b1), (float)b2, (float)(1.0 - b2), (float)eps,
              (float)alpha};
}

}  // namespace

// P: f32 (L, m, r) when p_int4 = 0, else Pq (L, m_pad/2, r) u8 codes and Ps
// (L, ⌈m/128⌉, r) f32 scales (m_pad = 128·⌈m/128⌉); G (L, m, n) f32 or bf16
// (g_bf16 = 1); Mq/Vq (L, r, n) u8 and Ms/Vs (L, r, ⌈n/128⌉) f32, updated in
// place; count -> int32 on the device; books -> 528 f32 (signed, unsigned and
// int4 codebooks); out (L, m, n) f32. All contiguous. With stochastic = 1 the
// requant's coins are keyed on the full leaf of rank sr_full whose rank rows
// sr_off … sr_off + r − 1 this launch holds (0 and r, or sr_full = 0: the
// whole leaf). Returns a cudaError_t.
extern "C" int galore_fused_adam8_left(const float* P, const uint8_t* Pq, const float* Ps,
                                       int p_int4, const void* G, int g_bf16, uint8_t* Mq,
                                       float* Ms, uint8_t* Vq, float* Vs, const int* count,
                                       const float* books, float* out, int L, int m, int r, int n,
                                       double b1, double b2, double eps, double alpha,
                                       int stochastic, int sr_off, int sr_full, void* stream) {
  const Args a = make_args(P, Pq, Ps, G, Mq, Ms, Vq, Vs, nullptr, nullptr, count, books, out,
                           nullptr, 0, 0, nullptr, 0.0, nullptr, m, r, n, b1, b2, eps, alpha,
                           stochastic, sr_off, sr_full);
  return run(false, true, a, p_int4, g_bf16, L, stream);
}

// P: f32 (L, n, r), or Pq (L, n_pad/2, r) and Ps (L, ⌈n/128⌉, r); G (L, m, n);
// Mq/Vq (L, m, r) u8 and Ms/Vs (L, ⌈m/128⌉, r) f32, in place; the rest as on
// the left.
extern "C" int galore_fused_adam8_right(const float* P, const uint8_t* Pq, const float* Ps,
                                        int p_int4, const void* G, int g_bf16, uint8_t* Mq,
                                        float* Ms, uint8_t* Vq, float* Vs, const int* count,
                                        const float* books, float* out, int L, int m, int r, int n,
                                        double b1, double b2, double eps, double alpha,
                                        int stochastic, int sr_off, int sr_full, void* stream) {
  const Args a = make_args(P, Pq, Ps, G, Mq, Ms, Vq, Vs, nullptr, nullptr, count, books, out,
                           nullptr, 0, 0, nullptr, 0.0, nullptr, m, r, n, b1, b2, eps, alpha,
                           stochastic, sr_off, sr_full);
  return run(true, true, a, p_int4, g_bf16, L, stream);
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
                                             int sr_off, int sr_full, void* stream) {
  const Args a = make_args(P, Pq, Ps, G, Mq, Ms, Vq, Vs, nullptr, nullptr, count, books,
                           nullptr, W, 1, w_bf16, eta, wd, nhat, m, r, n, b1, b2, eps, alpha,
                           stochastic, sr_off, sr_full);
  return run(false, true, a, p_int4, g_bf16, L, stream);
}

extern "C" int galore_fused_adam8_apply_right(const float* P, const uint8_t* Pq, const float* Ps,
                                              int p_int4, const void* G, int g_bf16, void* W,
                                              int w_bf16, uint8_t* Mq, float* Ms, uint8_t* Vq,
                                              float* Vs, const int* count, const float* books,
                                              const float* eta, double wd, float* nhat, int L,
                                              int m, int r, int n, double b1, double b2,
                                              double eps, double alpha, int stochastic,
                                              int sr_off, int sr_full, void* stream) {
  const Args a = make_args(P, Pq, Ps, G, Mq, Ms, Vq, Vs, nullptr, nullptr, count, books,
                           nullptr, W, 1, w_bf16, eta, wd, nhat, m, r, n, b1, b2, eps, alpha,
                           stochastic, sr_off, sr_full);
  return run(true, true, a, p_int4, g_bf16, L, stream);
}

// The fp32-moment apply forms: P, Pq, Ps, p_int4 and books as above; G (L,
// m, n) f32 or bf16; W (L, m, n) f32 or bf16 (w_bf16 = 1) updated in place to
// W + eta (G̃ + wd W); M/V f32, left (L, r, n), right (L, m, r), updated in
// place; count -> int32 and eta -> one f32 on the device; nhat -> f32
// scratch of the moments' shape, needed only when r > 128 (null otherwise).
extern "C" int galore_fused_adam_apply_left(const float* P, const uint8_t* Pq, const float* Ps,
                                            int p_int4, const float* books, const void* G,
                                            int g_bf16, void* W, int w_bf16, float* M, float* V,
                                            const int* count, const float* eta, double wd,
                                            float* nhat, int L, int m, int r, int n, double b1,
                                            double b2, double eps, double alpha, void* stream) {
  const Args a = make_args(P, Pq, Ps, G, nullptr, nullptr, nullptr, nullptr, M, V, count, books,
                           nullptr, W, 1, w_bf16, eta, wd, nhat, m, r, n, b1, b2, eps, alpha, 0);
  return run(false, false, a, p_int4, g_bf16, L, stream);
}

extern "C" int galore_fused_adam_apply_right(const float* P, const uint8_t* Pq, const float* Ps,
                                             int p_int4, const float* books, const void* G,
                                             int g_bf16, void* W, int w_bf16, float* M, float* V,
                                             const int* count, const float* eta, double wd,
                                             float* nhat, int L, int m, int r, int n, double b1,
                                             double b2, double eps, double alpha, void* stream) {
  const Args a = make_args(P, Pq, Ps, G, nullptr, nullptr, nullptr, nullptr, M, V, count, books,
                           nullptr, W, 1, w_bf16, eta, wd, nhat, m, r, n, b1, b2, eps, alpha, 0);
  return run(true, false, a, p_int4, g_bf16, L, stream);
}

// The fp32-moment emit forms: P, Pq, Ps, p_int4 and books as above; G (L, m,
// n) f32 or bf16 (g_bf16 = 1); M/V f32, left (L, r, n), right (L, m, r),
// updated in place; count -> int32 on the device; out (L, m, n) f32, G̃.
extern "C" int galore_fused_adam_left(const float* P, const uint8_t* Pq, const float* Ps,
                                      int p_int4, const float* books, const void* G, int g_bf16,
                                      float* M, float* V, const int* count, float* out, int L,
                                      int m, int r, int n, double b1, double b2, double eps,
                                      double alpha, void* stream) {
  const Args a = make_args(P, Pq, Ps, G, nullptr, nullptr, nullptr, nullptr, M, V, count, books,
                           out, nullptr, 0, 0, nullptr, 0.0, nullptr, m, r, n, b1, b2, eps, alpha,
                           0);
  return run(false, false, a, p_int4, g_bf16, L, stream);
}

extern "C" int galore_fused_adam_right(const float* P, const uint8_t* Pq, const float* Ps,
                                       int p_int4, const float* books, const void* G, int g_bf16,
                                       float* M, float* V, const int* count, float* out, int L,
                                       int m, int r, int n, double b1, double b2, double eps,
                                       double alpha, void* stream) {
  const Args a = make_args(P, Pq, Ps, G, nullptr, nullptr, nullptr, nullptr, M, V, count, books,
                           out, nullptr, 0, 0, nullptr, 0.0, nullptr, m, r, n, b1, b2, eps, alpha,
                           0);
  return run(true, false, a, p_int4, g_bf16, L, stream);
}

// 1 where the calling thread's last launch of the eight GaLore entry points
// above copied G or P by the threads (its rows not a multiple of 16 bytes, or
// its base not 16-byte aligned), 0 where the TMA copied both.
extern "C" int galore_epilogue_last_copied() { return last_copied; }

// The CTAs a cluster (1, 2 or 4) of the calling thread's last launch of the
// eight GaLore entry points.
extern "C" int galore_epilogue_last_cluster() { return last_cluster; }

// The flat 8-bit Adam update of one leaf: g (numel elements) f32 or bf16
// (g_bf16 = 1); Mq/Vq (nb, 256) u8 and Ms/Vs (nb,) f32, nb = ⌈numel/256⌉,
// updated in place; count -> int32 on the device; books -> the 528-float
// codebook table (only the signed and unsigned tables are read); tables ->
// the bracket tables (codec.device_code_tables: kTables bytes, signed first,
// 16-byte aligned); upd (numel elements) in g's dtype. All contiguous.
// Returns a cudaError_t.
extern "C" int adam8bit_blocks_update(const void* g, int g_bf16, long long numel, uint8_t* Mq,
                                      float* Ms, uint8_t* Vq, float* Vs, const int* count,
                                      const float* books, const uint8_t* tables, void* upd,
                                      double b1, double b2, double eps, void* stream) {
  if (numel <= 0 || (reinterpret_cast<uintptr_t>(tables) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(g_bf16 ? launch_flat<__nv_bfloat16>(g, numel, Mq, Ms, Vq, Vs, count, books,
                                                  tables, upd, b1, b2, eps, s)
                      : launch_flat<float>(g, numel, Mq, Ms, Vq, Vs, count, books, tables, upd,
                                           b1, b2, eps, s));
}
