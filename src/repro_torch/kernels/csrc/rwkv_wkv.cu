// rwkv6_wkv: the RWKV6 (Finch) WKV recurrence.
//
// Replaces the TPU kernel rwkv6_wkv in src/repro/kernels/rwkv_wkv.py
// (Pallas body _kernel), the fused twin of the chunked scan in
// src/repro/models/ssm.py.
//
// Per head, with key dim i and value dim j:
//     y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//     S[i][j] <- exp(logw_t[i]) S[i][j] + k_t[i] v_t[j]
//
// What bounds it on the H100: bytes. At the Prompt Bank's shapes (B = 16,
// H = 64, hd = 64, bf16 r/k/v, f32 logw and y) one call moves 14 bytes per
// (token, head, channel): 0.47 GB at 513 positions, 0.146 ms at 3.35 TB/s.
// The recurrence's own work, 4·hd² f32 operations per token and head (8.6
// GFLOP at 513 positions, 0.13 ms at the CUDA cores' 67 TFLOP/s), is as
// large as that bound, so the sequential form cannot reach it; the chunked
// form moves the hd² work per token onto the tensor cores.
//
// bf16 r/k/v: the chunked form of the TPU kernel, on mma.sync, in
// sub-chunks of C = 16 tokens. With w = e^{logw}, b_t = sum_{m<t} logw_m
// and c_t = b_t + logw_t from the sub-chunk's start:
//   y_t  = (r_t ⊙ e^{b_t}) · S                        inter: 16×64 · 64×64
//        + sum_{s<=t} A[t][s] v_s                     intra: 16×16 · 16×64
//   A[t][s] = sum_i r_t[i] k_s[i] prod_{s<m<t} w_m[i]  (s < t)
//   A[t][t] = sum_i r_t[i] u[i] k_t[i]
//   S'   = diag(e^{c_15}) S + (k ⊙ e^{c_15 - c})ᵀ · v  update: 64×16 · 16×64
// e^{b_t} and e^{c_15 - c_t} are at most 1, whatever the decay. Below the
// diagonal A is the product (r ⊙ e^{b}) · (k ⊙ e^{-c})ᵀ (16×64 · 64×16)
// when e^{-c_15} <= e^{60} in every channel: its factors, and the entries
// above the diagonal that it drops, stay inside f32's range. Past that
// guard (a step of -55, as phase 2 draws, passes it in two tokens) the
// sub-chunk computes A element by element in f32, a running product of w
// per key, as the TPU kernel's exp(min(b_t - c_s, 0)) does. Every decay
// factor is a running product of w (an exponential of a long f32 sum would
// err by |sum|·2^-24). The products run on the tensor cores in TF32
// (mma.sync m16n8k8) with f32 operands split in two, x = hi + lo, both
// TF32: three products where both sides are f32 (hi·hi + hi·lo + lo·hi:
// inter and scores), two where one side is v, which bf16 represents exactly
// in TF32 (intra and update). That keeps each within about 2^-20 of an f32
// product.
//
// One block of 4 warps per (batch, head): 1024 blocks at the scoring shape.
// Warp w owns value columns [16w, 16w + 16): the state's columns are
// independent, so its 64×16 slice of S stays in registers for the whole
// sequence, as the accumulator of the update product; laid out as Sᵀ, the
// same registers are the A operand of the inter product (the depth order of
// that product is permuted to match, and r ⊙ e^{b} is read in the same
// order). Per sub-chunk the block
//   (1) waits for its raw r, k, v, logw (bf16, f32) in shared memory and
//       starts the cp.async copies of the next sub-chunk (rows past T are
//       zero-filled, so a short last sub-chunk is a no-op there: logw = 0,
//       k = v = 0);
//   (2) computes, one thread per channel and half of the tokens, w and the
//       decay factors as running products, r ⊙ e^{b} and the keys (split),
//       and e^{c_15};
//   (3) computes the diagonal of A, or, in a steep sub-chunk, all of A,
//       one thread per (key s, group of 8 channels), the groups' partial
//       sums reduce-scattered with warp shuffles;
//   (4) runs, per warp, the inter product and the scores in one pass over
//       the channels (a steep sub-chunk takes step (3)'s scores instead),
//       the intra product and the state update, and stores y in the
//       model's (B, T, H, hd) layout.
// r, k, v and logw are read in place through their strides (rows that are
// not 16-byte multiples apart are copied element by element instead of by
// cp.async). A null state starts from 0.
//
// f32 r/k/v keep the sequential kernel: one block of hd threads per
// (batch, head), thread j holding column j of the state in registers; every
// 16 tokens the block stages r, k, exp(logw), r·u·k and v in shared memory
// and each thread reads them as broadcasts, four keys at a time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_tile.cuh"

using namespace repro_torch;

namespace {

struct Strides { long long b, h, t; };   // in elements; hd is contiguous

constexpr int HD = 64;           // the head dim both kernels are written for

// -- f32: the sequential recurrence -----------------------------------------------

constexpr int kChunk = 16;   // tokens staged in shared memory per barrier

__global__ void __launch_bounds__(HD)
rwkv6_wkv_seq(const float* __restrict__ r, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ logw,
              const float* __restrict__ u, const float* __restrict__ s0,
              float* __restrict__ y, float* __restrict__ s_out,
              Strides sr, Strides sk, Strides sv, Strides sw, Strides sy, int H, int T) {
  __shared__ __align__(16) float c_r[kChunk][HD];
  __shared__ __align__(16) float c_k[kChunk][HD];
  __shared__ __align__(16) float c_w[kChunk][HD];   // exp(logw)
  __shared__ __align__(16) float c_a[kChunk][HD];   // r · u · k
  __shared__ float c_v[kChunk][HD];

  const int bh = blockIdx.x, b = bh / H, h = bh % H, j = threadIdx.x;
  const float uj = u[h * HD + j];
  const float* rb = r + b * sr.b + h * sr.h + j;
  const float* kb = k + b * sk.b + h * sk.h + j;
  const float* vb = v + b * sv.b + h * sv.h + j;
  const float* wb = logw + b * sw.b + h * sw.h + j;
  float* yb = y + b * sy.b + h * sy.h + j;

  float S[HD];   // column j of the state: S[i] = state[i][j]
  const long long sbase = (long long)bh * HD * HD + j;
#pragma unroll
  for (int i = 0; i < HD; ++i) S[i] = s0 ? s0[sbase + (long long)i * HD] : 0.f;

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int n = min(kChunk, T - t0);
    __syncthreads();   // the previous chunk is consumed
    for (int tt = 0; tt < n; ++tt) {
      const long long t = t0 + tt;
      const float rj = rb[t * sr.t], kj = kb[t * sk.t];
      c_r[tt][j] = rj;
      c_k[tt][j] = kj;
      c_w[tt][j] = expf(wb[t * sw.t]);
      c_a[tt][j] = rj * uj * kj;
      c_v[tt][j] = vb[t * sv.t];
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = c_v[tt][j];
      float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f, a = 0.f;
#pragma unroll
      for (int i = 0; i < HD; i += 4) {
        const float4 rr = *reinterpret_cast<const float4*>(&c_r[tt][i]);
        const float4 kk = *reinterpret_cast<const float4*>(&c_k[tt][i]);
        const float4 ww = *reinterpret_cast<const float4*>(&c_w[tt][i]);
        const float4 aa = *reinterpret_cast<const float4*>(&c_a[tt][i]);
        y0 = fmaf(rr.x, S[i], y0);
        y1 = fmaf(rr.y, S[i + 1], y1);
        y2 = fmaf(rr.z, S[i + 2], y2);
        y3 = fmaf(rr.w, S[i + 3], y3);
        a += (aa.x + aa.y) + (aa.z + aa.w);
        S[i] = fmaf(ww.x, S[i], kk.x * vj);
        S[i + 1] = fmaf(ww.y, S[i + 1], kk.y * vj);
        S[i + 2] = fmaf(ww.z, S[i + 2], kk.z * vj);
        S[i + 3] = fmaf(ww.w, S[i + 3], kk.w * vj);
      }
      yb[(t0 + tt) * sy.t] = ((y0 + y1) + (y2 + y3)) + a * vj;
    }
  }
#pragma unroll
  for (int i = 0; i < HD; ++i) s_out[sbase + (long long)i * HD] = S[i];
}

// -- bf16: the chunked form on the tensor cores -------------------------------------

constexpr int kSub = 16;         // tokens per sub-chunk
constexpr int kWarps = 4;        // warp w owns value columns [16w, 16w + 16)
constexpr int kThreads = 32 * kWarps;
// Padded leading dimensions (32-bit words) that keep each fragment load on
// distinct banks: float2 loads of 4 rows need ld ≡ 8 (mod 32), scalar loads
// of rows 2t need 2·ld ≡ 8 (mod 32).
constexpr int kLdR = 72, kLdK = 68;
// A sub-chunk in which some channel decays below e^{-60} (e^{c_15} <
// kMinDecay) computes its scores element by element; otherwise as a product
// with factors up to e^{60} (its dropped entries above the diagonal stay
// below about e^{60}·|r||k|·64).
constexpr float kMinDecay = 8.75651076e-27f;   // e^{-60}

struct SubChunkSmem {
  __nv_bfloat16 r[2][kSub][HD], k[2][kSub][HD], v[2][kSub][HD];   // raw, double buffered
  float lw[2][kSub][HD];   // logw, overwritten in (2) by w = e^{logw}
  uint32_t rt_hi[kSub][kLdR], rt_lo[kSub][kLdR];   // r ⊙ e^{b}, TF32 hi and lo
  uint32_t kt_hi[kSub][kLdK], kt_lo[kSub][kLdK];   // k ⊙ e^{-c} or k ⊙ e^{c_15 - c}, see (2)
  float a[kSub][kSub + 1];                         // A[t][s] of a steep sub-chunk
  float ec[HD];                                    // e^{c_15}
  float kscale[HD];                                // e^{c_15} or 1, see (2)
  float diag[kSub];                                // A[t][t]
  float xprod[2][HD];                              // the two halves' products of w
};

// x = hi + lo: hi is x truncated to TF32 (its top 19 bits), lo = x - hi is
// exact in f32 and is passed whole, the tensor core reading its top 19 bits;
// so |x - hi - lo'| <= 2^-20 |x|. (Rounding both halves with cvt.rna would
// gain one bit at three instructions more per split.)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// Starts the copies of sub-chunk [t0, t0 + 16) into buffer `buf`: r, k, v
// 128 bytes a row, logw 256, 16 bytes a copy; rows past T are zero-filled.
// With `vec` false (a stride that is not a multiple of 16 bytes) the rows
// are copied element by element instead.
__device__ __forceinline__ void load_sub_chunk(SubChunkSmem& sm, int buf,
                                               const __nv_bfloat16* rb,
                                               const __nv_bfloat16* kb,
                                               const __nv_bfloat16* vb, const float* wb,
                                               Strides sr, Strides sk, Strides sv, Strides sw,
                                               int t0, int T, bool vec) {
  const int tid = threadIdx.x;
  {  // bf16 arrays: 16 rows × 8 copies
    const int row = tid >> 3, c = (tid & 7) * 8;
    const bool live = t0 + row < T;
    const long long t = live ? t0 + row : 0;
    const __nv_bfloat16* src[3] = {rb + t * sr.t + c, kb + t * sk.t + c, vb + t * sv.t + c};
    __nv_bfloat16* dst[3] = {&sm.r[buf][row][c], &sm.k[buf][row][c], &sm.v[buf][row][c]};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      if (vec) {
        cp_async_16(dst[a], src[a], live ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[a][e] = live ? src[a][e] : __float2bfloat16(0.f);
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {   // logw: 16 rows × 16 copies
    const int idx = tid + half * kThreads, row = idx >> 4, c = (idx & 15) * 4;
    const bool live = t0 + row < T;
    const float* src = wb + (live ? t0 + row : 0) * sw.t + c;
    float* dst = &sm.lw[buf][row][c];
    if (vec) {
      cp_async_16(dst, src, live ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = live ? src[e] : 0.f;
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads, 4)
rwkv6_wkv_chunked(const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const float* __restrict__ logw,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  float* __restrict__ y, float* __restrict__ s_out,
                  Strides sr, Strides sk, Strides sv, Strides sw, Strides sy, int H, int T,
                  bool vec) {
  __shared__ __align__(16) SubChunkSmem sm;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int col0 = warp * 16;   // this warp's value columns
  const __nv_bfloat16* rb = r + b * sr.b + h * sr.h;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;
  const float* wb = logw + b * sw.b + h * sw.h;
  float* yb = y + b * sy.b + h * sy.h;

  // Sᵀ in the accumulator layout of m16n8: st[n][e] = S[i][j] with
  // j = col0 + g + 8·(e >> 1), i = 8n + 2·t4 + (e & 1).
  float st[8][4];
  const long long sbase = (long long)bh * HD * HD;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 8 * n + 2 * t4 + (e & 1), j = col0 + g + 8 * (e >> 1);
      st[n][e] = s0 ? s0[sbase + i * HD + j] : 0.f;
    }

  // per-thread constants of steps (2) and (3)
  // (2): a channel per lane, warps 2c and 2c + 1 the two token halves of
  // channels [32c, 32c + 32) (consecutive lanes on consecutive banks)
  const int ch = (tid & 31) | ((tid >> 6) << 5), hf = (tid >> 5) & 1;
  const int ks = tid >> 3, dg = (tid & 7) * 8;        // (3): key, first channel of the group
  const float* ug = u + h * HD + dg;                  // (3): this group's bonus

  const int n_sub = (T + kSub - 1) / kSub;
  load_sub_chunk(sm, 0, rb, kb, vb, wb, sr, sk, sv, sw, 0, T, vec);
  for (int sc = 0; sc < n_sub; ++sc) {
    const int buf = sc & 1, t0 = sc * kSub;
    cp_async_wait<0>();
    __syncthreads();   // (1) raw data in; the previous sub-chunk's products are done
    if (sc + 1 < n_sub)
      load_sub_chunk(sm, buf ^ 1, rb, kb, vb, wb, sr, sk, sv, sw, t0 + kSub, T, vec);

    int steep = 0;
    {  // (2) decays, one thread per (channel, half of the tokens). Every
       // factor is a running product of w = e^{logw} (an exponential of a
       // long f32 sum would err by |sum|·2^-24): e^{b_t} = prod_{m<t} w_m,
       // e^{c_15 - c_t} = prod_{m>t} w_m, e^{c_15} = prod w (the halves'
       // products swapped through shared memory), e^{-c_t} = e^{c_15 - c_t}
       // / e^{c_15}.
      float wv[8], prod = 1.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int t = 8 * hf + q;
        wv[q] = expf(sm.lw[buf][t][ch]);
        sm.lw[buf][t][ch] = wv[q];   // read just above by this thread only
        prod *= wv[q];
      }
      sm.xprod[hf][ch] = prod;   // swap the halves' products
      if (tid < 64) asm volatile("bar.sync 1, 64;\n" ::: "memory");
      else asm volatile("bar.sync 2, 64;\n" ::: "memory");
      const float other = sm.xprod[hf ^ 1][ch];
      const float ec = prod * other;
      // the channel's keys are stored as k ⊙ e^{-c} if e^{-c_15} <= e^{60}
      // (the factored A below needs it), else as k ⊙ e^{c_15 - c}; kscale
      // tells the state update which
      const bool safe = ec >= kMinDecay;
      const float einv = safe ? 1.f / ec : 1.f;
      if (hf == 0) {
        sm.ec[ch] = ec;
        sm.kscale[ch] = safe ? ec : 1.f;
      }
      float eb = hf ? other : 1.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int t = 8 * hf + q;
        split_tf32(__bfloat162float(sm.r[buf][t][ch]) * eb, sm.rt_hi[t][ch], sm.rt_lo[t][ch]);
        eb *= wv[q];
      }
      float es = hf ? 1.f : other;
#pragma unroll
      for (int q = 7; q >= 0; --q) {
        const int t = 8 * hf + q;
        split_tf32(__bfloat162float(sm.k[buf][t][ch]) * (es * einv), sm.kt_hi[t][ch],
                   sm.kt_lo[t][ch]);
        es *= wv[q];
      }
      steep = __syncthreads_or(!safe);
    }

    if (!steep) {  // (3) the diagonal A[t][t] = sum_i r_t[i] u[i] k_t[i], t = ks
      const uint4 rr = *reinterpret_cast<const uint4*>(&sm.r[buf][ks][dg]);
      const uint4 kr = *reinterpret_cast<const uint4*>(&sm.k[buf][ks][dg]);
      const uint32_t rw[4] = {rr.x, rr.y, rr.z, rr.w}, kw[4] = {kr.x, kr.y, kr.z, kr.w};
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        d = fmaf(bf16_lo(rw[e]) * ug[2 * e], bf16_lo(kw[e]), d);
        d = fmaf(bf16_hi(rw[e]) * ug[2 * e + 1], bf16_hi(kw[e]), d);
      }
      d += __shfl_xor_sync(0xffffffffu, d, 4);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      if ((tid & 7) == 0) sm.diag[ks] = d;
    } else {  // (3) all of A[t][ks] over channels [dg, dg + 8), summed over the 8 groups
      float kk[8], part[kSub];
      {
        const uint4 kr = *reinterpret_cast<const uint4*>(&sm.k[buf][ks][dg]);
        const uint32_t kw[4] = {kr.x, kr.y, kr.z, kr.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          kk[2 * e] = bf16_lo(kw[e]);
          kk[2 * e + 1] = bf16_hi(kw[e]);
        }
      }
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        const uint4 rr = *reinterpret_cast<const uint4*>(&sm.r[buf][t][dg]);
        const uint32_t rw[4] = {rr.x, rr.y, rr.z, rr.w};
        float rt[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          rt[2 * e] = bf16_lo(rw[e]);
          rt[2 * e + 1] = bf16_hi(rw[e]);
        }
        if (t >= 2 && t >= ks + 2) {   // kk = k_s · prod_{s<m<t} w_m
          const float4 w0 = *reinterpret_cast<const float4*>(&sm.lw[buf][t - 1][dg]);
          const float4 w1 = *reinterpret_cast<const float4*>(&sm.lw[buf][t - 1][dg + 4]);
          kk[0] *= w0.x; kk[1] *= w0.y; kk[2] *= w0.z; kk[3] *= w0.w;
          kk[4] *= w1.x; kk[5] *= w1.y; kk[6] *= w1.z; kk[7] *= w1.w;
        }
        float acc = 0.f;
        if (t == ks) {
#pragma unroll
          for (int e = 0; e < 8; ++e) acc = fmaf(rt[e] * ug[e], kk[e], acc);
        } else if (t > ks) {
#pragma unroll
          for (int e = 0; e < 8; ++e) acc = fmaf(rt[e], kk[e], acc);
        }
        part[t] = acc;
      }
      // reduce-scatter over the 8 lanes of a key (lane bits 0..2): after the
      // three steps lane group index q holds tokens 2q and 2q + 1
      const int q = tid & 7;
      float p8[8], p4[4], p2[2];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool up = q & 4;
        const float send = up ? part[e] : part[e + 8];
        const float keep = up ? part[e + 8] : part[e];
        p8[e] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool up = q & 2;
        const float send = up ? p8[e] : p8[e + 4];
        const float keep = up ? p8[e + 4] : p8[e];
        p4[e] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool up = q & 1;
        const float send = up ? p4[e] : p4[e + 2];
        const float keep = up ? p4[e + 2] : p4[e];
        p2[e] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) sm.a[2 * q + e][ks] = p2[e];
    }
    __syncthreads();

    // (4) the products, warp by warp. Vᵀ as the A operand, depth (token s)
    // permuted: logical column t4 is s = 8kk + 2·t4, column t4 + 4 is s + 1.
    uint32_t va[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int s = 8 * kk + 2 * t4;
      va[kk][0] = __float_as_uint(__bfloat162float(sm.v[buf][s][col0 + g]));
      va[kk][1] = __float_as_uint(__bfloat162float(sm.v[buf][s][col0 + g + 8]));
      va[kk][2] = __float_as_uint(__bfloat162float(sm.v[buf][s + 1][col0 + g]));
      va[kk][3] = __float_as_uint(__bfloat162float(sm.v[buf][s + 1][col0 + g + 8]));
    }
    // inter, Yᵀ = Sᵀ · (r ⊙ e^{b})ᵀ, and the scores, A = (r ⊙ e^{b}) · (k ⊙ e^{-c})ᵀ,
    // in one pass over the channels i (the depth of both, permuted as Sᵀ's
    // columns are: logical column t4 is i = 8m + 2·t4, t4 + 4 is i + 1), so
    // both read r ⊙ e^{b} once and run four independent accumulations.
    // yt[n][e] = y[8n + 2·t4 + (e & 1)][col0 + g + 8·(e >> 1)];
    // ac[n][e] = A[g + 8·(e >> 1)][8n + 2·t4 + (e & 1)]. A steep sub-chunk
    // computes the scores too (they are finite) and then takes step (3)'s.
    float yt[2][4], ac[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) yt[n][e] = ac[n][e] = 0.f;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int i = 8 * m + 2 * t4;
      uint32_t sh[4], sl[4];
      split_tf32(st[m][0], sh[0], sl[0]);
      split_tf32(st[m][2], sh[1], sl[1]);
      split_tf32(st[m][1], sh[2], sl[2]);
      split_tf32(st[m][3], sh[3], sl[3]);
      const uint2 rh[2] = {*reinterpret_cast<const uint2*>(&sm.rt_hi[g][i]),
                           *reinterpret_cast<const uint2*>(&sm.rt_hi[g + 8][i])};
      const uint2 rl[2] = {*reinterpret_cast<const uint2*>(&sm.rt_lo[g][i]),
                           *reinterpret_cast<const uint2*>(&sm.rt_lo[g + 8][i])};
      const uint2 kh[2] = {*reinterpret_cast<const uint2*>(&sm.kt_hi[g][i]),
                           *reinterpret_cast<const uint2*>(&sm.kt_hi[g + 8][i])};
      const uint2 kl[2] = {*reinterpret_cast<const uint2*>(&sm.kt_lo[g][i]),
                           *reinterpret_cast<const uint2*>(&sm.kt_lo[g + 8][i])};
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        mma_tf32(yt[n], sl[0], sl[1], sl[2], sl[3], rh[n].x, rh[n].y);
        mma_tf32(ac[n], rl[0].x, rl[1].x, rl[0].y, rl[1].y, kh[n].x, kh[n].y);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        mma_tf32(yt[n], sh[0], sh[1], sh[2], sh[3], rl[n].x, rl[n].y);
        mma_tf32(ac[n], rh[0].x, rh[1].x, rh[0].y, rh[1].y, kl[n].x, kl[n].y);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        mma_tf32(yt[n], sh[0], sh[1], sh[2], sh[3], rh[n].x, rh[n].y);
        mma_tf32(ac[n], rh[0].x, rh[1].x, rh[0].y, rh[1].y, kh[n].x, kh[n].y);
      }
    }
    // intra: Yᵀ += Vᵀ · Aᵀ. The B fragment of token tile n and key step kk
    // is A[8n + g][8kk + 2·t4 + {0, 1}] = ac[kk][2n], ac[kk][2n + 1].
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {   // keep s < t, the bonus on s = t
        const int t = g + 8 * (e >> 1), s = 8 * n + 2 * t4 + (e & 1);
        const float a = steep ? sm.a[t][s]
                              : (s < t ? ac[n][e] : (s == t ? sm.diag[t] : 0.f));
        split_tf32(a, ah[n][e], al[n][e]);
      }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        if (kk == 1 && n == 0) continue;   // keys 8..15 against tokens 0..7: all zero
        mma_tf32(yt[n], va[kk][0], va[kk][1], va[kk][2], va[kk][3], al[kk][2 * n],
                 al[kk][2 * n + 1]);
        mma_tf32(yt[n], va[kk][0], va[kk][1], va[kk][2], va[kk][3], ah[kk][2 * n],
                 ah[kk][2 * n + 1]);
      }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + 8 * n + 2 * t4 + (e & 1);
        if (t < T) yb[(long long)t * sy.t + col0 + g + 8 * (e >> 1)] = yt[n][e];
      }
    // update: Sᵀ = Sᵀ · diag(e^{c_15}) + Vᵀ · (k ⊙ e^{c_15 - c}), the last
    // factor stored as k ⊙ e^{-c} times kscale = e^{c_15} where it is safe
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int s = 8 * kk + 2 * t4, i = 8 * n + g;
        mma_tf32(p, va[kk][0], va[kk][1], va[kk][2], va[kk][3], sm.kt_lo[s][i],
                 sm.kt_lo[s + 1][i]);
        mma_tf32(p, va[kk][0], va[kk][1], va[kk][2], va[kk][3], sm.kt_hi[s][i],
                 sm.kt_hi[s + 1][i]);
      }
      const float2 ec = *reinterpret_cast<const float2*>(&sm.ec[8 * n + 2 * t4]);
      const float2 ks2 = *reinterpret_cast<const float2*>(&sm.kscale[8 * n + 2 * t4]);
      st[n][0] = fmaf(ec.x, st[n][0], ks2.x * p[0]);
      st[n][1] = fmaf(ec.y, st[n][1], ks2.y * p[1]);
      st[n][2] = fmaf(ec.x, st[n][2], ks2.x * p[2]);
      st[n][3] = fmaf(ec.y, st[n][3], ks2.y * p[3]);
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 8 * n + 2 * t4 + (e & 1), j = col0 + g + 8 * (e >> 1);
      s_out[sbase + i * HD + j] = st[n][e];
    }
}

bool aligned16(const void* p, const Strides& s, int elt) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (s.b * elt) % 16 == 0 &&
         (s.h * elt) % 16 == 0 && (s.t * elt) % 16 == 0;
}

}  // namespace

// r, k, v (f32 or bf16) and logw (f32): (B, H, T, hd) given by their
// (b, h, t) strides in elements, hd contiguous; u: (H, hd) f32 contiguous;
// s0 (nullable) and s_out: (B, H, hd, hd) f32 contiguous; y: (B, H, T, hd)
// f32 given by its strides. Returns cudaGetLastError() after the launch (0
// on success), or cudaErrorInvalidValue for a head dim without a kernel.
extern "C" int rwkv6_wkv_launch(
    const void* r, const void* k, const void* v, const void* logw, const void* u,
    const void* s0, void* y, void* s_out,
    long long r_b, long long r_h, long long r_t, long long k_b, long long k_h, long long k_t,
    long long v_b, long long v_h, long long v_t, long long w_b, long long w_h, long long w_t,
    long long y_b, long long y_h, long long y_t, int B, int H, int T, int head_dim,
    int is_bf16, void* stream) {
  const Strides sr{r_b, r_h, r_t}, sk{k_b, k_h, k_t}, sv{v_b, v_h, v_t}, sw{w_b, w_h, w_t},
      sy{y_b, y_h, y_t};
  const float* w = static_cast<const float*>(logw);
  const float* uu = static_cast<const float*>(u);
  const float* s = static_cast<const float*>(s0);
  float* yy = static_cast<float*>(y);
  float* so = static_cast<float*>(s_out);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (head_dim != HD) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    const bool vec = aligned16(r, sr, 2) && aligned16(k, sk, 2) && aligned16(v, sv, 2) &&
                     aligned16(logw, sw, 4);
    rwkv6_wkv_chunked<<<B * H, kThreads, 0, cs>>>(
        static_cast<const __nv_bfloat16*>(r), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), w, uu, s, yy, so, sr, sk, sv, sw, sy, H, T, vec);
  } else {
    rwkv6_wkv_seq<<<B * H, HD, 0, cs>>>(
        static_cast<const float*>(r), static_cast<const float*>(k), static_cast<const float*>(v),
        w, uu, s, yy, so, sr, sk, sv, sw, sy, H, T);
  }
  return (int)cudaGetLastError();
}
