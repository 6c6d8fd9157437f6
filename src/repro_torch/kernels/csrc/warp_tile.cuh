// Warp-level building blocks shared by the kernels: one warp's tile
// product (score_ce, the f32 flash_attention), and the bf16 tensor-core
// pieces at the end of this file (ldmatrix, mma.sync, cp.async), which the
// bf16 flash_attention, flash_decode and mla_decode kernels are built from.
//
// acc += A · Bᵀ, where A is 16 rows × K and B is (8·N8) rows × K, both
// row-major in shared memory with leading dimensions lda and ldb (elements).
// The result stays in registers in the accumulator layout of mma.sync m16n8:
// lane (g = lane / 4, t = lane % 4) holds, for n-tile j,
//     acc[j][0..1] = C[g    ][8j + 2t + {0, 1}]
//     acc[j][2..3] = C[g + 8][8j + 2t + {0, 1}]
// so the kernels' epilogues (masking, online softmax) are written once for
// both element types.
//
// bf16: tensor cores, mma.sync.m16n8k16 with f32 accumulation. Products of
//       bf16 values are exact in f32, so this matches an f32 product of the
//       upcast inputs up to summation order. Needs K % 16 == 0, even lda/ldb.
// f32:  f32 FMAs on the CUDA cores in the same layout (Hopper's tensor cores
//       take f32 only as TF32, which keeps ~3 decimal digits).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace repro_torch {

constexpr float kNegInf = -1e30f;  // masking constant of the TPU kernels
constexpr float kLog2e = 1.4426950408889634f;

template <int N8, int K>
__device__ __forceinline__ void warp_tile_mma(const __nv_bfloat16* A, int lda,
                                              const __nv_bfloat16* B, int ldb,
                                              float (&acc)[N8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    const __nv_bfloat16* a = A + g * lda + k0 + 2 * t;
    const uint32_t a0 = *reinterpret_cast<const uint32_t*>(a);
    const uint32_t a1 = *reinterpret_cast<const uint32_t*>(a + 8 * lda);
    const uint32_t a2 = *reinterpret_cast<const uint32_t*>(a + 8);
    const uint32_t a3 = *reinterpret_cast<const uint32_t*>(a + 8 * lda + 8);
#pragma unroll
    for (int j = 0; j < N8; ++j) {
      const __nv_bfloat16* b = B + (8 * j + g) * ldb + k0 + 2 * t;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(b);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(b + 8);
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
}

template <int N8, int K>
__device__ __forceinline__ void warp_tile_mma(const float* A, int lda,
                                              const float* B, int ldb,
                                              float (&acc)[N8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = A[g * lda + k];
    const float a1 = A[(g + 8) * lda + k];
#pragma unroll
    for (int j = 0; j < N8; ++j) {
      const float b0 = B[(8 * j + 2 * t) * ldb + k];
      const float b1 = B[(8 * j + 2 * t + 1) * ldb + k];
      acc[j][0] = fmaf(a0, b0, acc[j][0]);
      acc[j][1] = fmaf(a0, b1, acc[j][1]);
      acc[j][2] = fmaf(a1, b0, acc[j][2]);
      acc[j][3] = fmaf(a1, b1, acc[j][3]);
    }
  }
}

// Copies rows [row0, row0 + ROWS) × columns [k0, k0 + KC) of a row-major
// matrix (nrows × ncols, leading dimension ld) into shared memory (leading
// dimension lds), 16 bytes a thread, zero-filling rows and columns outside
// the matrix. Needs ncols, ld and k0 to be multiples of 16 / sizeof(T).
template <typename T, int ROWS, int KC, int NTHREADS>
__device__ __forceinline__ void load_tile(T* dst, int lds, const T* src,
                                          long long ld, int row0, int nrows,
                                          int k0, int ncols) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = KC / VEC;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += NTHREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows && k0 + c < ncols)
      v = *reinterpret_cast<const uint4*>(src + (row0 + r) * ld + k0 + c);
    *reinterpret_cast<uint4*>(dst + r * lds + c) = v;
  }
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Max and sum across the four lanes (t = 0..3) that share a row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// -- bf16 tensor-core pieces ----------------------------------------------------
//
// mma.sync m16n8k16 (bf16 in, f32 accumulate). Lane (g = lane / 4, t = lane % 4)
// holds A rows g and g + 8, B column g and the accumulator as above. A's
// four registers: a[0] = A[g][2t, 2t+1], a[1] = A[g+8][2t, 2t+1],
// a[2] = A[g][2t+8, 2t+9], a[3] = A[g+8][2t+8, 2t+9], the lower column in the
// low half. So the accumulators of two n8 tiles j, j+1, packed to bf16
// pairwise, are the A operand of a product whose depth runs over those 16
// columns: a = {pack(c[j][0..1]), pack(c[j][2..3]), pack(c[j+1][0..1]),
// pack(c[j+1][2..3])}.

// ldmatrix: each lane gives the shared address of one 16-byte row; .x4 loads
// four 8x8 b16 matrices, matrix i from the rows addressed by lanes 8i..8i+7,
// into r[i] (.trans: transposed). Rows padded by 16 bytes keep the eight rows
// of a matrix on distinct banks.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit: ex2.approx.ftz, about 2 ulp; a result
// below 2^-126 flushes to 0, and 2^-inf is 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to bf16 in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Ldmatrix lane addresses into a row-major bf16 tile of leading dimension ld
// (elements), for the B operand of two n8 tiles at once:
//  - b_rows: B's n index runs over the tile's rows, its depth over columns
//    (K in Q·Kᵀ). ldmatrix_x4(b, tile + b_rows(ld) + 16·ld·pair + 16·kstep)
//    gives b[0], b[1] of n tile 2·pair and b[2], b[3] of n tile 2·pair + 1.
//  - b_cols: B's depth runs over the tile's rows, its n index over columns
//    (V in P·V). ldmatrix_x4_trans(b, tile + b_cols(ld) + 16·ld·kstep + 8·n)
//    gives b[0], b[1] of n tile n and b[2], b[3] of n tile n + 1.
//  - a_rows: the A operand, 16 rows × 16 columns:
//    ldmatrix_x4(a, tile + a_rows(ld) + 16·kstep).
__device__ __forceinline__ int b_rows(int ld) {
  const int lane = threadIdx.x & 31;
  return (8 * (lane >> 4) + (lane & 7)) * ld + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int b_cols(int ld) {
  const int lane = threadIdx.x & 31;
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
}
__device__ __forceinline__ int a_rows(int ld) {
  const int lane = threadIdx.x & 31;
  return (lane & 15) * ld + (lane >> 4) * 8;
}

// cp.async of 16 bytes from global to shared memory, cached in L2 only,
// with an L2 prefetch of the 128-byte line around src (the kernels read
// whole lines: one DRAM request a line, not one per 16 bytes); bytes = 0
// zero-fills the destination and reads nothing. A thread's copies since its
// last commit form one group; cp_async_wait<N> waits until at most N of its
// committed groups are in flight. Other threads see the data after a
// barrier (__syncwarp or __syncthreads) that follows the wait.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

}  // namespace repro_torch
