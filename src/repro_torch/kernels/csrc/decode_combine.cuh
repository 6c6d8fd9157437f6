// The exact log-sum-exp combine of split-KV decode partitions, shared by
// flash_decode.cu and mla_decode.cu.
//
// Replaces the jnp combine_partials of src/repro/kernels/flash_decode.py.
// Each partition s of a (batch row, head) left an output normalised by its
// own softmax sum, o_part[(bh·splits + s)·HD + d], and its log-sum-exp
// lse_part[bh·splits + s], -1e30 when the partition was empty. The combine
// weights partition s by exp(lse_s - max lse), an lse of -1e30 by exactly
// 0, so a row whose partitions are all empty combines to 0.
//
// One block per (batch row, head), one thread per output element: HD
// threads (64, 112, 128 or 256 for GQA heads, 512 for the MLA latent). No
// thread exchanges values with another (no shuffles), so a block need not
// be a whole number of warps: at 112 it is three and a half.
#pragma once

#include <cuda_runtime.h>

#include "warp_tile.cuh"

namespace repro_torch {

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
decode_combine(const float* __restrict__ o_part, const float* __restrict__ lse_part,
               T* __restrict__ out, int splits) {
  const long long bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* lse = lse_part + bh * splits;
  float M = kNegInf;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, lse[s]);
  float den = 0.f, o = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float w = lse[s] > 0.5f * kNegInf ? expf(lse[s] - M) : 0.f;
    den += w;
    o = fmaf(o_part[(bh * splits + s) * HD + d], w, o);
  }
  out[bh * HD + d] = from_f32<T>(o / fmaxf(den, 1e-30f));
}

}  // namespace repro_torch
