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
// and moves at most G 180 MB (bf16) + P 34 MB + R 90 MB (≈ 0.09 ms at
// 3.35 TB/s): arithmetic. On the f32 FMA pipes that is 2.76 ms at 67
// TFLOP/s; the reference keeps f32 accuracy (an f32 accumulator over f32
// products), which a single TF32 tensor-core pass does not.
//
// Accuracy: split TF32 (3xTF32). Each f32 operand x is split in registers
// into x_hi = rna_tf32(x) and x_lo = rna_tf32(x - x_hi); the tensor cores
// multiply TF32 exactly into f32, and A_hi·B_lo + A_lo·B_hi + A_hi·B_hi
// (the lo·lo term dropped, ~2^-22 relative) recovers an f32-accurate
// product: three passes, 3 · 2·L·m·r·n / 495 TFLOP/s = 1.12 ms at the shape
// above. A bf16 G is exact in TF32 (8 significant bits against 11), so B4
// with a bf16 G takes two passes, A_lo·G + A_hi·G (0.75 ms).
// The tensor cores' own f32 accumulation does not round to nearest at every
// add: accumulating all of K = 4096 inside the wgmma accumulator missed the
// gate on an H100. So each 32-deep k-tile (all passes, 8 or 12 MMAs) goes
// into a fresh wgmma accumulator, which is then added into a separate f32
// register accumulator with FADD (within a third of the gate on an H100,
// chip_smoke.py::check_project).
//
// Design: one batched GEMM template, C = α A B, A (M x K) f32, B (K x N) f32
// or bf16, templated on each operand's storage order and on C's.
//   grid = (⌈M/128⌉, ⌈N/128⌉, L), M-tiles fastest, so that the blocks in
//   flight share one B column tile and walk A (P, 16 MB a layer at r = 1024)
//   in L2; 256 threads = two warpgroups, each owning 64 rows of the 128 x
//   128 output tile, one wgmma.m64n128k8.f32.tf32.tf32 per pass and 8-deep
//   k-step, A from registers, B from shared memory.
//   Loads: the Tensor Memory Accelerator copies each 32-deep stage of A and
//   B, whole 128-byte lines in the operand's own storage order, into a ring
//   of 5 raw slots, completion signalled on one mbarrier a slot, so the
//   copies of the next stages are in flight while a stage is split and
//   multiplied. A copy past an edge of the operand is zero-filled by the
//   hardware (the Pallas kernels' `jnp.where(valid, ·, 0)`). Per-thread 16-
//   byte loads, whose lanes must follow the split's conflict-free maps, read
//   only 16 or 32 bytes a row and held the kernel to the L2's request rate.
//   Split: wgmma reads a 32-bit operand from shared memory only K-major, and
//   the hi/lo split passes through registers anyway. B: the threads read the
//   raw slot in 16-byte chunks, split the values and store hi and lo into
//   K-major tiles (a row of 32 k values = 128 bytes, its 16-byte chunks
//   swizzled by row % 8: the wgmma descriptor's 128-byte swizzle); two such
//   stages, the next one split while the current one multiplies, one
//   barrier a stage. A: each thread reads its own wgmma fragment values
//   from the raw slot and splits them into registers, so A needs no split
//   tile and the tensor cores read only B from shared memory. Raw slots are
//   laid out with the TMA's own swizzle, and the lane-to-element maps are
//   chosen, so that the 16-byte reads and the stores do not conflict on
//   shared-memory banks.
//   One block an SM (≤ 227 KB of shared memory, ≤ 255 registers).
//   An operand the TMA cannot describe (its rows not a multiple of 16 bytes,
//   or not 16-byte aligned) is copied element by element by the threads
//   into the same raw layout, stages ahead, behind the same barriers. That
//   route is slower; the wrappers count its launches (launches_thread_copy),
//   and no leaf of the models takes it.
// Sums run in another order than the plain PyTorch version's (cuBLAS SGEMM
// with TF32 off); tolerance 1e-5·max|want| + 1e-5·|want|.
// The split, the operand layouts, the TMA and wgmma wrappers live in
// tf32_wgmma.cuh, shared with the int8-moment kernel of galore_epilogue.cu.

#include <cuda.h>  // CUtensorMap and its enums (types only: libcuda is not linked)
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

#include "tf32_wgmma.cuh"

namespace {

using namespace tf32w;

// Shared memory of one kernel form: two split stages of B (B hi and, for an
// f32 B, B lo; A is split into registers), the raw ring (as many slots as
// fit, at most 5), and one mbarrier a raw slot.
template <typename BT>
struct Smem {
  static constexpr bool kSplitB = sizeof(BT) == 4;  // a bf16 B is exact in TF32
  static constexpr int kStage = (kSplitB ? 2 : 1) * kTile * 4;
  static constexpr int kRawSlot = Operand<true, float>::kRawBytes + Operand<true, BT>::kRawBytes;
  static constexpr int kBudget = 232448 - 1024 - 64;  // the opt-in maximum, less slack and bars
  static constexpr int kFit = (kBudget - 2 * kStage) / kRawSlot;
  static constexpr int kRaw = kFit > 5 ? 5 : kFit;
  static constexpr int kBars = 2 * kStage + kRaw * kRawSlot;  // offset of the mbarriers
  static constexpr int kBytes = kBars + 8 * kRaw + 1024;
  static_assert(kRaw >= 3, "the raw ring needs three slots");
};

// C[l] = alpha · A[l] B[l], A (M x K) f32, B (K x N) f32 or bf16 (BT).
//   kAK: A stored (M, K) row-major (K-major), else (K, M);
//   kBKm: B stored (N, K) row-major (K-major), else (K, N);
//   kCT: C stored (N, M) row-major, else (M, N).
// With use_tma, map_a and map_b describe A and B as 3-d tensors (contiguous
// axis, other axis, leaf); otherwise the threads copy the stages.
// Element offsets inside one leaf are 32-bit (the host refuses larger leaves).
template <bool kAK, bool kBKm, bool kCT, typename BT>
__global__ void __launch_bounds__(kThreads, 1)
gemm_tf32x3_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b, const float* __restrict__ A,
                   const BT* __restrict__ B, float* __restrict__ C, int M, int N, int K,
                   float alpha, int use_tma) {
  using OpA = Operand<kAK, float>;
  using OpB = Operand<kBKm, BT>;
  using S = Smem<BT>;
  constexpr bool kSplitB = S::kSplitB;
  constexpr int kRaw = S::kRaw;
  extern __shared__ uint8_t smem_raw[];
  // the swizzles are functions of address bits, so tiles start 1024-aligned
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  auto part_of = [&](int st, int which) {  // split stage st: B hi (, B lo)
    return reinterpret_cast<float*>(smem + st * S::kStage) + which * kTile;
  };
  auto raw_a = [&](int slot) { return smem + 2 * S::kStage + slot * S::kRawSlot; };
  auto raw_b = [&](int slot) { return raw_a(slot) + OpA::kRawBytes; };
  auto bar = [&](int slot) { return smem_u32(smem + S::kBars + 8 * slot); };

  const int l = blockIdx.z;
  A += static_cast<size_t>(l) * M * K;
  B += static_cast<size_t>(l) * K * N;
  C += static_cast<size_t>(l) * M * N;
  const int i0 = blockIdx.x * kBM, j0 = blockIdx.y * kBN;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int steps = (K + kBK - 1) / kBK;

  if (tid == 0) {
    for (int slot = 0; slot < kRaw; ++slot) mbar_init(bar(slot));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto issue = [&](int st) {  // stage st into raw slot st % kRaw (nothing past the end)
    if (st >= steps) return;
    const int slot = st % kRaw;
    if (use_tma) {
      if (tid == 0) {
        mbar_expect(bar(slot), S::kRawSlot);
        OpA::tma(&map_a, raw_a(slot), i0, st * kBK, l, bar(slot));
        OpB::tma(&map_b, raw_b(slot), j0, st * kBK, l, bar(slot));
      }
    } else {
      OpA::fill(A, M, K, i0, st * kBK, tid, raw_a(slot));
      OpB::fill(B, N, K, j0, st * kBK, tid, raw_b(slot));
    }
  };
  auto split = [&](int st) {  // B of raw stage st into split stage st % 2
    const int slot = st % kRaw;
    if (use_tma) mbar_wait(bar(slot), (st / kRaw) & 1);
    OpB::template split<kSplitB>(raw_b(slot), part_of(st & 1, 0), part_of(st & 1, 1), tid);
  };
  // A of raw stage st (landed: its slot's barrier was waited on when B was
  // split), split into this thread's register fragments: k-step kk's four
  // values at a_hi/a_lo[4·kk ..], rows lane/4 (+ 8) of the warp's 16, columns
  // lane%4 (+ 4). Each thread reads 16 single values a stage.
  uint32_t a_hi[4 * (kBK / 8)], a_lo[4 * (kBK / 8)];
  const int a_row = wg * 64 + ((tid >> 5) & 3) * 16 + ((tid & 31) >> 2), a_col = tid & 3;
  auto load_a = [&](int st) {
    const uint8_t* raw = raw_a(st % kRaw);
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = *reinterpret_cast<const float*>(
            raw + OpA::raw_elem(a_row + 8 * (j & 1), 8 * kk + a_col + 4 * (j >> 1)));
        const float h = tf32_rna(x);
        a_hi[4 * kk + j] = __float_as_uint(h);
        a_lo[4 * kk + j] = __float_as_uint(tf32_rna(x - h));
      }
  };

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;

  for (int st = 0; st < kRaw - 1; ++st) issue(st);
  __syncthreads();  // the threads' copies of stage 0, when they made them
  split(0);
  fence_async_smem();
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    // its slot held stage s - 1, split two barriers ago; threads' copies of
    // stage s + 1 were made at least one barrier ago (kRaw >= 3)
    issue(s + kRaw - 1);
    load_a(s);
    const uint64_t b_hi = desc_sw128(smem_u32(part_of(cur, 0)));
    const uint64_t b_lo = desc_sw128(smem_u32(part_of(cur, 1)));
    reg_fence(part);
    wgmma_fence();
    // small terms first; B's k-step advances 8 f32 = 32 bytes (2 in the
    // descriptor's 16-byte units) inside the swizzled rows
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk)
      wgmma_tf32_ra(part, a_lo + 4 * kk, b_hi + 2 * kk, kk > 0);
    if (kSplitB) {
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) wgmma_tf32_ra(part, a_hi + 4 * kk, b_lo + 2 * kk, 1);
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) wgmma_tf32_ra(part, a_hi + 4 * kk, b_hi + 2 * kk, 1);
    wgmma_commit();
    if (s + 1 < steps) split(s + 1);  // into the other split stage, freed by the last barrier
    wgmma_wait_all();
    reg_fence(part);
#pragma unroll
    for (int i = 0; i < 4 * (kBK / 8); ++i)  // the fragments stay live until the wgmmas end
      asm volatile("" : "+r"(a_hi[i]), "+r"(a_lo[i])::"memory");
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
    fence_async_smem();
    __syncthreads();
  }

  // C = alpha · acc. wgmma's accumulator layout: thread t of the warpgroup
  // holds rows 16·(t/32) + (t%32)/4 (+ 8), columns 8·(i/4) + 2·(t%4) + i%2.
  const int t = tid & 127, row0 = i0 + wg * 64 + 16 * (t >> 5) + ((t & 31) >> 2);
  const int col0 = j0 + 2 * (t & 3);
  if (!kCT) {
    const bool vec = (N % 2 == 0) && ((reinterpret_cast<uintptr_t>(C) & 7) == 0);
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int row = row0 + 8 * ((i >> 1) & 1), col = col0 + 8 * (i >> 2);
      if (row >= M) continue;
      float* dst = C + row * N + col;
      if (vec && col + 1 < N) {
        *reinterpret_cast<float2*>(dst) = make_float2(alpha * acc[i], alpha * acc[i + 1]);
      } else {
        if (col < N) dst[0] = alpha * acc[i];
        if (col + 1 < N) dst[1] = alpha * acc[i + 1];
      }
    }
  } else {  // lanes t%4 alike store 8 consecutive rows: 32 contiguous bytes
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int row = row0 + 8 * ((i >> 1) & 1), col = col0 + 8 * (i >> 2) + (i & 1);
      if (row < M && col < N) C[col * M + row] = alpha * acc[i];
    }
  }
}

// Refuse shapes the grid or the 32-bit in-leaf offsets cannot hold.
bool valid(int L, int M, int N, int K) {
  if (L <= 0 || M <= 0 || N <= 0 || K <= 0 || L > 65535 || (N + kBN - 1) / kBN > 65535)
    return false;
  const long long lim = 1LL << 31;
  return (long long)M * K < lim && (long long)K * N < lim && (long long)M * N < lim;
}

// 1 where this host thread's last launch copied its operands by the threads
// instead of by the TMA, else 0
thread_local int last_copied = 0;

template <bool kAK, bool kBKm, bool kCT, typename BT>
int launch(const float* A, const void* B, float* C, int L, int M, int N, int K, double alpha,
           void* stream) {
  if (!valid(L, M, N, K)) return (int)cudaErrorInvalidValue;
  auto kernel = gemm_tf32x3_kernel<kAK, kBKm, kCT, BT>;
  constexpr int kBytes = Smem<BT>::kBytes;
  // the shared-memory opt-in, once per instance and device (devices 0-31)
  static std::atomic<unsigned> opted_in{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if ((opted_in.load() & bit) == 0 || bit == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (err != cudaSuccess) return (int)err;
    opted_in.fetch_or(bit);
  }
  CUtensorMap map_a{}, map_b{};
  const cudaError_t ea = make_map<kAK, float>(&map_a, A, M, K, L);
  const cudaError_t eb = make_map<kBKm, BT>(&map_b, B, N, K, L);
  for (cudaError_t e : {ea, eb})
    if (e != cudaSuccess && e != cudaErrorNotSupported) return (int)e;
  // both operands by TMA, or both by the threads
  const int use_tma = ea == cudaSuccess && eb == cudaSuccess;
  last_copied = !use_tma;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, L);
  kernel<<<grid, kThreads, kBytes, static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, A, static_cast<const BT*>(B), C, M, N, K, (float)alpha, use_tma);
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
    return g_bf16 ? launch<false, true, false, __nv_bfloat16>(P, G, R, L, r, n, m, 1.0, stream)
                  : launch<false, true, false, float>(P, G, R, L, r, n, m, 1.0, stream);
  return g_bf16 ? launch<false, false, false, __nv_bfloat16>(P, G, R, L, r, n, m, 1.0, stream)
                : launch<false, false, false, float>(P, G, R, L, r, n, m, 1.0, stream);
}

// 1 where the last galore_project or galore_project_back launch of the
// calling thread copied its operands by the threads (an operand's rows not a
// multiple of 16 bytes, or its base not 16-byte aligned), 0 where the TMA
// copied them.
extern "C" int galore_project_last_copied() { return last_copied; }

// out[l] = alpha · P[l] N[l]. P (L, m, r) f32, N (L, r, n) f32; out (L, m, n)
// f32, or with out_t = 1 written transposed as (L, n, m). All contiguous.
// Returns a cudaError_t (0 on success).
extern "C" int galore_project_back(const float* P, const float* N, float* out, int out_t, int L,
                                   int m, int r, int n, double alpha, void* stream) {
  // C = out (M = m, N = n), A = P stored (M, K = r), B = N stored (K, N)
  return out_t ? launch<true, false, true, float>(P, N, out, L, m, n, r, alpha, stream)
               : launch<true, false, false, float>(P, N, out, L, m, n, r, alpha, stream);
}
