// Split-TF32 products on Hopper's tensor cores, fed by the TMA: the pieces
// shared by the tiled projections (galore_project.cu) and the int8-moment
// GaLore kernel (galore_epilogue.cu).
//
// Both multiply 128-row by 128-column tiles over 32-deep stages with two
// warpgroups (256 threads), one wgmma.m64n128k8.f32.tf32.tf32 per pass and
// 8-deep k-step: A (64 rows a warpgroup) from registers, B (8 x 128) from a
// K-major shared-memory tile with the 128-byte swizzle. An f32 operand x is
// split into x_hi = rna_tf32(x) and x_lo = rna_tf32(x - x_hi); the tensor
// cores multiply TF32 exactly into f32, and A_lo·B_hi + A_hi·B_lo + A_hi·B_hi
// recovers an f32-accurate product (a bf16 operand is exact in TF32: two
// passes). Stages arrive by TMA boxes of whole 128-byte lines in the
// operand's own storage order ("raw" slots, one mbarrier each); an operand
// the TMA cannot describe is copied by the threads into the same layout.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: libcuda is not linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace tf32w {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kBM = 128;       // rows of C a block
constexpr int kBN = 128;       // columns of C a block
constexpr int kBK = 32;        // contraction depth a stage: one 128-byte row of f32
constexpr int kTile = kBM * kBK;  // floats of one split part (hi or lo)
static_assert(kBM == kBN, "the A and B tiles share one geometry");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Offset (floats) of (row, k) in a K-major split tile: 32 k values a row,
// the row's 16-byte chunks permuted by row % 8 (the 128-byte swizzle).
__device__ __forceinline__ int swz(int row, int k) {
  return row * kBK + ((((k >> 2) ^ row) & 7) << 2) + (k & 3);
}

// Shared-memory matrix descriptor of a K-major tile with the 128-byte
// swizzle: 8-row groups 1024 bytes apart (SBO); LBO unused for this layout.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// order the threads' shared-memory accesses before the async proxy's (the
// tensor cores' reads of the split tiles, the TMA's writes of a raw slot)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keep the compiler from moving register reads or writes across a wgmma
__device__ __forceinline__ void reg_fence(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// TMA copy of the box at (c0, c1, c2) of `map` into shared memory at dst,
// completing `bytes` of the transaction on the mbarrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// d (+)= A B for one 8-deep k-step, A (64 x 8) from registers — this
// thread's 4 values of its warp's 16 x 8 slice: rows lane/4 and lane/4 + 8,
// columns lane%4 and lane%4 + 4, as TF32 bit patterns — and B (8 x 128)
// K-major in shared memory; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_ra(float (&d)[64], const uint32_t* a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <int kBytes>
struct BitsOf;
template <>
struct BitsOf<4> {
  using type = uint32_t;
};
template <>
struct BitsOf<2> {
  using type = uint16_t;
};

// One operand's 128 x 32 stage: logical rows d (M for A, N for B) and depth
// k; stored K-major ((D, K) row-major, k contiguous) or not ((K, D), d
// contiguous), elements of type T; a 16-byte chunk holds kVec elements
// along the contiguous axis.
//
// Raw slot (the TMA's boxes, as the hardware writes them):
//   not K-major: boxes of 128 bytes of d by 32 k (32 f32 or 64 bf16 of d),
//     4 or 2 of them; in a box, row k holds its 8 chunks permuted by k % 8
//     (the TMA's 128-byte swizzle);
//   K-major, f32: one box, row d = 32 k = 128 bytes, chunks permuted by
//     d % 8 (which is already the split tiles' layout);
//   K-major, bf16: one box, row d = 32 k = 64 bytes, no swizzle.
// Split (of B; A is read value by value into its wgmma fragments): each
// thread reads kLoads chunks, at (warp w, lane, c = kLoads·w + e):
//   not K-major, f32:  d = 8·(c/2) + 4·(lane/16), k = 16·(c%2) + lane%16
//   not K-major, bf16: d = 8·c,                   k = lane
//   K-major, f32:      d = 4·c + lane/8,  k = 4·(lane%8)
//   K-major, bf16:     d = 8·c + lane/4,  k = 8·(lane%4)
// so that 8 lanes reading one 128-byte phase, and the 32 lanes storing
// one value each into the split tile, hit distinct banks.
template <bool kKMajor, typename T>
struct Operand {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kLoads = kBM * kBK / kVec / kThreads;
  static constexpr int kRawBytes = kBM * kBK * static_cast<int>(sizeof(T));  // one raw slot
  static constexpr int kBoxD = kKMajor ? kBM : 128 / static_cast<int>(sizeof(T));
  static constexpr int kBoxes = kBM / kBoxD;

  __device__ __forceinline__ static void pos(int tid, int e, int& d, int& k) {
    const int lane = tid & 31, c = (tid >> 5) * kLoads + e;
    if (kKMajor) {
      d = c * (kVec == 4 ? 4 : 8) + (kVec == 4 ? lane >> 3 : lane >> 2);
      k = kVec * (kVec == 4 ? lane & 7 : lane & 3);
    } else if (kVec == 4) {
      d = 8 * (c >> 1) + 4 * (lane >> 4);
      k = 16 * (c & 1) + (lane & 15);
    } else {
      d = 8 * c;
      k = lane;
    }
  }

  // Byte offset in the raw slot of the chunk that starts at (d, k).
  __device__ __forceinline__ static int raw_off(int d, int k) {
    if (!kKMajor) {
      const int q = (d % kBoxD) / kVec;
      return (d / kBoxD) * (kBK * 128) + k * 128 + ((q ^ (k & 7)) << 4);
    }
    if (sizeof(T) == 4) return d * 128 + (((k >> 2) ^ d) & 7) * 16;
    return d * 64 + (k >> 3) * 16;
  }

  // Byte offset in the raw slot of the element (d, k).
  __device__ __forceinline__ static int raw_elem(int d, int k) {
    return kKMajor ? raw_off(d, k & ~(kVec - 1)) + (k % kVec) * static_cast<int>(sizeof(T))
                   : raw_off(d & ~(kVec - 1), k) + (d % kVec) * static_cast<int>(sizeof(T));
  }

  // TMA copies of the stage at (d0, k0) of leaf l.
  __device__ __forceinline__ static void tma(const CUtensorMap* map, uint8_t* raw, int d0, int k0,
                                             int l, uint32_t bar) {
#pragma unroll
    for (int b = 0; b < kBoxes; ++b) {
      if (kKMajor)
        tma_load(smem_u32(raw), map, k0, d0, l, bar);
      else
        tma_load(smem_u32(raw + b * kBK * 128), map, d0 + b * kBoxD, k0, l, bar);
    }
  }

  // The same stage copied by the threads, element by element (as raw bits),
  // into the same layout; zero past the edges of X (D rows, depth K).
  __device__ __forceinline__ static void fill(const T* __restrict__ X, int D, int K, int d0,
                                              int k0, int tid, uint8_t* raw) {
    using Bits = typename BitsOf<sizeof(T)>::type;
    const Bits* Xb = reinterpret_cast<const Bits*>(X);
#pragma unroll 4
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int d = kKMajor ? i / kBK : i % kBM, k = kKMajor ? i % kBK : i / kBM;
      const int gd = d0 + d, gk = k0 + k;
      *reinterpret_cast<Bits*>(raw + raw_elem(d, k)) =
          (gd < D && gk < K) ? Xb[kKMajor ? gd * K + gk : gk * D + gd] : Bits(0);
    }
  }

  // Split the thread's raw chunks into the K-major tiles: the TF32 hi part,
  // and with kSplit the lo part (a bf16 value is exact in TF32: hi only).
  template <bool kSplit>
  __device__ __forceinline__ static void split(const uint8_t* raw, float* hi, float* lo,
                                               int tid) {
#pragma unroll
    for (int e = 0; e < kLoads; ++e) {
      int d, k;
      pos(tid, e, d, k);
      const uint4 r = *reinterpret_cast<const uint4*>(raw + raw_off(d, k));
      const T* v = reinterpret_cast<const T*>(&r);
      if (kKMajor) {  // kVec consecutive k: whole 16-byte chunks of one row
#pragma unroll
        for (int q = 0; q < kVec / 4; ++q) {
          float h[4], l[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float x = to_f32(v[4 * q + i]);
            h[i] = kSplit ? tf32_rna(x) : x;
            l[i] = kSplit ? tf32_rna(x - h[i]) : 0.f;
          }
          const int off = swz(d, k + 4 * q);
          *reinterpret_cast<float4*>(hi + off) = make_float4(h[0], h[1], h[2], h[3]);
          if (kSplit) *reinterpret_cast<float4*>(lo + off) = make_float4(l[0], l[1], l[2], l[3]);
        }
      } else {  // kVec consecutive rows at one k
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float x = to_f32(v[i]);
          const int off = swz(d + i, k);
          if (kSplit) {
            const float h = tf32_rna(x);
            hi[off] = h;
            lo[off] = tf32_rna(x - h);
          } else {
            hi[off] = x;
          }
        }
      }
    }
  }
};

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched through the runtime's entry-point lookup
// (libcuda is not linked); null where it is unavailable.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The 3-d map (inner extent, outer extent, L) of a contiguous tensor of
// `esize`-byte elements (u8, bf16 or f32), copied in boxes of (box_inner,
// box_outer, 1), with the 128-byte swizzle or none. Returns cudaSuccess,
// cudaErrorNotSupported where the TMA cannot describe the tensor (rows not a
// multiple of 16 bytes, or X not 16-byte aligned: the caller's threads copy
// it instead), or an error where encoding fails for a tensor it should
// describe.
inline cudaError_t make_map_3d(CUtensorMap* map, const void* X, int esize, long long inner,
                               long long outer, int L, int box_inner, int box_outer,
                               bool swizzle) {
  if ((inner * esize) % 16 != 0 || (reinterpret_cast<uintptr_t>(X) & 15) != 0)
    return cudaErrorNotSupported;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorInitializationError;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer),
                              static_cast<cuuint64_t>(L)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(inner * esize),
                                 static_cast<cuuint64_t>(inner * outer * esize)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUtensorMapDataType type = esize == 4   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  return encode(map, type, 3, const_cast<void*>(X), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// The map of an operand stored as a contiguous (L, outer, inner) tensor,
// (contiguous axis, other axis, leaf), with the box Operand<kKMajor, T>
// copies: D rows of depth K (see make_map_3d for the result).
template <bool kKMajor, typename T>
cudaError_t make_map(CUtensorMap* map, const void* X, int D, int K, int L) {
  using Op = Operand<kKMajor, T>;
  return make_map_3d(map, X, sizeof(T), kKMajor ? K : D, kKMajor ? D : K, L,
                     kKMajor ? kBK : Op::kBoxD, kKMajor ? Op::kBoxD : kBK,
                     !(kKMajor && sizeof(T) == 2));
}

}  // namespace tf32w
