// flash_decode: split-KV one-token GQA decode attention, plus the exact
// log-sum-exp combine of the partitions.
//
// Replaces the TPU kernel flash_decode in src/repro/kernels/flash_decode.py
// (Pallas body _kernel) and its jnp combine_partials.
//
// What bounds it on the H100: bytes. One query token per head against a
// long cache does 4·hd operations per (head, cached row) and reads 2·hd
// values per (kv-head, cached row): at qwen2-7b's serve shape (B = 16,
// H = 28, Hkv = 4, hd = 128, L = 32768, bf16) one call reads 1.07 GB of K
// and V, 0.32 ms at 3.35 TB/s, against 7.5 GFLOP (under 0.01 ms). The cache
// must be read once, and by enough blocks to keep the memory busy.
//
// Design: the partial kernel runs one block per (split, kv-head and group
// of up to 8 query heads, batch row). The G query heads that share a
// kv-head are handled together, so each K and V row is read from device
// memory once for all of them. The live rows [lo, hi) (the wrapper folds
// kv_len, q_pos and the window into that range) are cut into `splits`
// equal partitions; each block walks its partition with an online softmax.
// Lanes split a row's head dim, 16 bytes each, so a K or V row is one
// coalesced read by 8 to 32 lanes, and a warp holds 1 to 4 rows at once;
// each lane keeps its slice of every query head and of every accumulator
// in registers. After the walk the block's row slots are merged in shared
// memory into one normalised partial output and its log-sum-exp per head,
// as the TPU kernel emits them: an empty partition gets lse = -1e30. The
// combine kernel (decode_combine.cuh, shared with mla_decode.cu) then
// weights each partition by exp(lse - max lse), a -1e30 lse by exactly 0,
// and writes the output in q's dtype.
//
// Unlike the TPU kernel nothing is padded: G is not rounded up to 8 rows
// and L not to 128; the ragged edge is masked here. Scores, softmax sums
// and accumulators are f32; bf16 inputs are widened exactly. This first
// version has no cp.async, TMA or tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "decode_combine.cuh"
#include "warp_tile.cuh"

using namespace repro_torch;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

// The 16 bytes a lane loads, widened to f32.
template <typename T, int VEC>
__device__ __forceinline__ void widen(const uint4& u, float (&out)[VEC]) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int x = 0; x < VEC; ++x) out[x] = to_f32<T>(e[x]);
}

// T: element type; HD: head dim; GT: query heads handled by one block.
template <typename T, int HD, int GT>
struct Shape {
  static constexpr int VEC = 16 / (int)sizeof(T);   // elements per lane
  static constexpr int LPR = HD / VEC;              // lanes per row
  static constexpr int RPW = 32 / LPR;              // rows a warp holds at once
  static constexpr int SLOTS = kWarps * RPW;        // row slots of the block
  static constexpr int ROWS = GT >= 8 ? 2 : 4;      // rows per slot per step
};

template <typename T, int HD, int GT>
__global__ void __launch_bounds__(kThreads)
flash_decode_partial(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, float* __restrict__ o_part,
                     float* __restrict__ lse_part, long long q_b, long long q_h,
                     long long k_b, long long k_l, long long k_h, long long v_b,
                     long long v_l, long long v_h, int H, int Hkv, int groups,
                     int lo, int hi, int per, int splits, float scale) {
  using S = Shape<T, HD, GT>;
  constexpr int VEC = S::VEC, LPR = S::LPR, SLOTS = S::SLOTS, ROWS = S::ROWS;
  __shared__ float sm_m[SLOTS][GT];
  __shared__ float sm_l[SLOTS][GT];
  __shared__ __align__(16) float sm_acc[SLOTS][GT][HD];

  const int split = blockIdx.x, b = blockIdx.z;
  const int hk = blockIdx.y / groups, G = H / Hkv;
  const int g0 = (blockIdx.y % groups) * GT;
  const int gn = min(GT, G - g0);                    // live query heads of this block
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = warp * S::RPW + lane / LPR;
  const int c = (lane % LPR) * VEC;                  // this lane's slice of the head dim
  const int row_begin = lo + split * per;
  const int row_end = min(row_begin + per, hi);

  float qr[GT][VEC], acc[GT][VEC], m[GT], l[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int x = 0; x < VEC; ++x) acc[g][x] = 0.f, qr[g][x] = 0.f;
    if (g < gn) {
      const uint4 u = *reinterpret_cast<const uint4*>(q + b * q_b + (hk * G + g0 + g) * q_h + c);
      widen<T, VEC>(u, qr[g]);
    }
  }

  const T* kb = k + b * k_b + hk * k_h + c;
  const T* vb = v + b * v_b + hk * v_h + c;
  // The loop bound is uniform over the block, so every lane reaches every
  // shuffle; rows at or past row_end are masked.
  for (int base = row_begin; base < row_end; base += SLOTS * ROWS) {
    uint4 kr[ROWS], vr[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int j = base + r * SLOTS + slot;
      kr[r] = vr[r] = make_uint4(0u, 0u, 0u, 0u);
      if (j < row_end) {
        kr[r] = *reinterpret_cast<const uint4*>(kb + j * k_l);
        vr[r] = *reinterpret_cast<const uint4*>(vb + j * v_l);
      }
    }
    float s[ROWS][GT];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float kf[VEC];
      widen<T, VEC>(kr[r], kf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float d = 0.f;
#pragma unroll
        for (int x = 0; x < VEC; ++x) d = fmaf(qr[g][x], kf[x], d);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
        s[r][g] = base + r * SLOTS + slot < row_end ? d * scale : -INFINITY;
      }
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = s[0][g];
#pragma unroll
      for (int r = 1; r < ROWS; ++r) mx = fmaxf(mx, s[r][g]);
      // m never drops below -1e30, so a masked score's exp(-inf - m) is exactly 0
      const float mn = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - mn);
      l[g] *= alpha;
#pragma unroll
      for (int x = 0; x < VEC; ++x) acc[g][x] *= alpha;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float p = expf(s[r][g] - mn);
        float vf[VEC];
        widen<T, VEC>(vr[r], vf);
        l[g] += p;
#pragma unroll
        for (int x = 0; x < VEC; ++x) acc[g][x] = fmaf(p, vf[x], acc[g][x]);
      }
      m[g] = mn;
    }
  }

  // Merge the row slots: one (m, l, acc) per query head.
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (lane % LPR == 0) {
      sm_m[slot][g] = m[g];
      sm_l[slot][g] = l[g];
    }
#pragma unroll
    for (int x = 0; x < VEC; ++x) sm_acc[slot][g][c + x] = acc[g][x];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < gn * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    float M = kNegInf;
    for (int t = 0; t < SLOTS; ++t) M = fmaxf(M, sm_m[t][g]);
    float L = 0.f, O = 0.f;
    for (int t = 0; t < SLOTS; ++t) {
      const float w = expf(sm_m[t][g] - M);
      L = fmaf(sm_l[t][g], w, L);
      O = fmaf(sm_acc[t][g][d], w, O);
    }
    const float den = fmaxf(L, 1e-30f);
    const long long row = ((long long)b * H + hk * G + g0 + g) * splits + split;
    o_part[row * HD + d] = O / den;
    if (d == 0) lse_part[row] = L > 0.f ? M + logf(den) : kNegInf;
  }
}

template <typename T, int HD, int GT>
int launch(const void* q, const void* k, const void* v, float* o_part, float* lse,
           void* out, const long long* st, int B, int H, int Hkv, int lo, int hi, int per,
           int splits, float scale, cudaStream_t stream) {
  const int G = H / Hkv, groups = (G + GT - 1) / GT;
  const dim3 grid(splits, Hkv * groups, B);
  flash_decode_partial<T, HD, GT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), o_part,
      lse, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], H, Hkv, groups, lo, hi,
      per, splits, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine<T, HD><<<B * H, HD, 0, stream>>>(o_part, lse, static_cast<T*>(out), splits);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int dispatch_g(int g_tile, const void* q, const void* k, const void* v, float* o_part,
               float* lse, void* out, const long long* st, int B, int H, int Hkv, int lo,
               int hi, int per, int splits, float scale, cudaStream_t s) {
  switch (g_tile) {
    case 1: return launch<T, HD, 1>(q, k, v, o_part, lse, out, st, B, H, Hkv, lo, hi, per, splits, scale, s);
    case 2: return launch<T, HD, 2>(q, k, v, o_part, lse, out, st, B, H, Hkv, lo, hi, per, splits, scale, s);
    case 4: return launch<T, HD, 4>(q, k, v, o_part, lse, out, st, B, H, Hkv, lo, hi, per, splits, scale, s);
    case 8: return launch<T, HD, 8>(q, k, v, o_part, lse, out, st, B, H, Hkv, lo, hi, per, splits, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q: (B, H, hd) with strides (q_b, q_h); k, v: (B, L, Hkv, hd) with strides
// (b, l, h); hd contiguous everywhere, strides in elements. Rows [lo, hi)
// are live; partition s holds rows [lo + s·per, min(lo + (s+1)·per, hi)).
// o_part (B, H, splits, hd) and lse (B, H, splits) are f32 scratch; out is
// (B, H, hd) contiguous in q's dtype. g_tile ∈ {1, 2, 4, 8} query heads per
// block. Returns cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for a head dim or g_tile without a template.
extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, void* o_part, void* lse, void* out,
    long long q_b, long long q_h, long long k_b, long long k_l, long long k_h,
    long long v_b, long long v_l, long long v_h, int B, int H, int Hkv, int lo, int hi,
    int per, int splits, int head_dim, int is_bf16, int g_tile, float scale, void* stream) {
  const long long st[8] = {q_b, q_h, k_b, k_l, k_h, v_b, v_l, v_h};
  float* op = static_cast<float*>(o_part);
  float* ls = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return is_bf16 ? dispatch_g<__nv_bfloat16, 64>(g_tile, q, k, v, op, ls, out, st, B, H, Hkv, lo, hi, per, splits, scale, s)
                   : dispatch_g<float, 64>(g_tile, q, k, v, op, ls, out, st, B, H, Hkv, lo, hi, per, splits, scale, s);
  if (head_dim == 128)
    return is_bf16 ? dispatch_g<__nv_bfloat16, 128>(g_tile, q, k, v, op, ls, out, st, B, H, Hkv, lo, hi, per, splits, scale, s)
                   : dispatch_g<float, 128>(g_tile, q, k, v, op, ls, out, st, B, H, Hkv, lo, hi, per, splits, scale, s);
  return (int)cudaErrorInvalidValue;
}
