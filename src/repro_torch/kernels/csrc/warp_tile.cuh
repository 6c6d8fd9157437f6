// One warp's tile product, shared by the score_ce and flash_attention kernels.
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

}  // namespace repro_torch
