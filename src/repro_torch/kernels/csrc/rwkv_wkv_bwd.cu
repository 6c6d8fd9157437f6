// rwkv6_wkv_bwd: the backward of the RWKV6 (Finch) WKV recurrence of
// rwkv_wkv.cu.
//
// No TPU kernel to replace: the reference differentiates its chunked scan
// (src/repro/models/ssm.py, _rwkv6_chunk under rwkv6_forward) through XLA.
//
// Per (batch, head), with key dim i, value dim j, w_t = e^{logw_t}, P_t the
// state before token t (P_0 = state0) and G_t = dL/dP_{t+1}, walking back
// in time from G_{T-1} = dS_T (or 0):
//     dr_t[i]    = sum_j P_t[i][j] dy_t[j] + u[i] k_t[i] (v_t · dy_t)
//     dk_t[i]    = sum_j G_t[i][j] v_t[j]  + r_t[i] u[i] (v_t · dy_t)
//     dv_t[j]    = sum_i k_t[i] G_t[i][j]  + (sum_i r_t[i] u[i] k_t[i]) dy_t[j]
//     dlogw_t[i] = w_t[i] sum_j G_t[i][j] P_t[i][j]
//     du[i]     += r_t[i] k_t[i] (v_t · dy_t)
//     G_{t-1}    = diag(w_t) G_t + r_t dy_tᵀ,          dS_0 = G_{-1}
// dlogw is formed from the state itself, never from a difference of
// cumulative sums, and P_t is never recovered by dividing by w (a step of
// logw = -55 underflows w): the kernel walks forward from state0 first,
// keeping P at every 8-token boundary in a scratch buffer (B·H·ceil(T/8)
// states of 16 KB), then, sub-chunk by sub-chunk backward, recomputes the
// sub-chunk's 8 states from its boundary into registers. Recomputing costs
// one more pass of the forward recurrence; keeping every state instead
// would cost 16 KB a token and head of device memory (0.27 GB a layer at
// the tuning shape) and as many bytes moved twice.
//
// What bounds it on the H100: the f32 operations, about 12·hd² per token
// and head (dr, dk, dv, dlogw, the G update and the forward state again:
// 0.83 GFLOP at B = 8, H = 64, T = 33, 12 µs at the CUDA cores' 67
// TFLOP/s, against 26 MB of inputs and gradients, 8 µs at 3.35 TB/s).
// This first kernel is sequential in time and runs on the CUDA cores; its
// time is set by that sequence (a few hundred dependent instructions and
// barriers a token). The chunked form on the tensor cores, as the bf16
// forward has, is later work.
//
// One block of 256 threads per (batch, head): thread (i, q) = (tid / 4,
// tid % 4) owns row i of the state and of G, columns [16q, 16q + 16), in
// registers. So the sums over j (dr, dk, dlogw) are 16 FMAs and two lane
// shuffles, the G and P updates are local, and dv, a sum over i, is reduced
// over a warp's 8 rows by a reduce-scatter of shuffles and over the 8
// warps through shared memory in a fixed order. Every sum has a fixed
// order, so two calls give the same bits. Per 8-token sub-chunk the block
// stages r, k, v, w and dy in shared memory (rows past T as k = v = dy = 0,
// w = 1) and one warp a token forms v · dy and sum_i r u k. du is kept per
// (batch, head) and summed over the batch in order by a second small
// kernel. r, k, v (f32 or bf16), logw, dy and the gradients are read and
// written in place through their (b, h, t) strides, hd contiguous; dr, dk
// and dv are stored in r's type, dlogw, du and dS_0 in f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Strides { long long b, h, t; };   // in elements; hd is contiguous

constexpr int HD = 64;                  // the head dim the kernel is written for
constexpr int kL = 8;                   // tokens per sub-chunk: the checkpoint interval
constexpr int kQ = 4;                   // column groups a row is split into
constexpr int kC = HD / kQ;             // columns a thread owns
constexpr int kThreads = HD * kQ;       // 256
constexpr int kWarps = kThreads / 32;   // 8: one warp per staged token
static_assert(kWarps == kL, "one warp forms each staged token's scalars");

__device__ __forceinline__ float load_elt(const float* p) { return *p; }
__device__ __forceinline__ float load_elt(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_elt(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_elt(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Stage {
  float r[kL][HD], k[kL][HD], v[kL][HD], w[kL][HD], dy[kL][HD];
  float vdy[kL];              // v_t · dy_t
  float a[kL];                // sum_i r_t[i] u[i] k_t[i]
  float dv[kL][kWarps][HD];   // each warp's dv partial over its 8 rows
};

// Stages tokens [t0, t0 + kL) and their two scalars; ends with a barrier.
template <typename T>
__device__ __forceinline__ void stage(Stage& sm, const T* rb, const T* kb, const T* vb,
                                      const float* wb, const float* dyb, const float* ub,
                                      Strides sr, Strides sk, Strides sv, Strides sw,
                                      Strides sdy, int t0, int n_tok) {
  for (int idx = threadIdx.x; idx < kL * HD; idx += kThreads) {
    const int tt = idx / HD, c = idx % HD;
    const long long t = t0 + tt;
    const bool live = t < n_tok;
    sm.r[tt][c] = live ? load_elt(rb + t * sr.t + c) : 0.f;
    sm.k[tt][c] = live ? load_elt(kb + t * sk.t + c) : 0.f;
    sm.v[tt][c] = live ? load_elt(vb + t * sv.t + c) : 0.f;
    sm.w[tt][c] = live ? expf(wb[t * sw.t + c]) : 1.f;
    sm.dy[tt][c] = live ? dyb[t * sdy.t + c] : 0.f;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float vd = sm.v[warp][lane] * sm.dy[warp][lane] + sm.v[warp][lane + 32] * sm.dy[warp][lane + 32];
  float a = sm.r[warp][lane] * ub[lane] * sm.k[warp][lane] +
            sm.r[warp][lane + 32] * ub[lane + 32] * sm.k[warp][lane + 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    vd += __shfl_xor_sync(0xffffffffu, vd, o);
    a += __shfl_xor_sync(0xffffffffu, a, o);
  }
  if (lane == 0) {
    sm.vdy[warp] = vd;
    sm.a[warp] = a;
  }
  __syncthreads();
}

// The sum of x over the 4 lanes of a row (lane bits 0 and 1).
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
rwkv6_wkv_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ logw, const float* __restrict__ u,
                     const float* __restrict__ s0, const float* __restrict__ dy,
                     const float* __restrict__ ds_t, T* __restrict__ dr, T* __restrict__ dk,
                     T* __restrict__ dv, float* __restrict__ dlogw, float* __restrict__ du_part,
                     float* __restrict__ ds0, float* __restrict__ ckpt, Strides sr, Strides sk,
                     Strides sv, Strides sw, Strides sdy, Strides sdr, Strides sdk, Strides sdv,
                     Strides sdw, int H, int n_tok) {
  __shared__ __align__(16) Stage sm;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, i = tid >> 2, q = tid & 3, c0 = q * kC;
  const int warp = tid >> 5, lane = tid & 31;
  const T* rb = r + b * sr.b + h * sr.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const float* wb = logw + b * sw.b + h * sw.h;
  const float* dyb = dy + b * sdy.b + h * sdy.h;
  const float* ub = u + h * HD;
  T* drb = dr + b * sdr.b + h * sdr.h;
  T* dkb = dk + b * sdk.b + h * sdk.h;
  T* dvb = dv + b * sdv.b + h * sdv.h;
  float* dwb = dlogw + b * sdw.b + h * sdw.h;
  const float ui = ub[i];
  const int n_sub = (n_tok + kL - 1) / kL;
  float* ck = ckpt + (long long)bh * n_sub * HD * HD + i * HD + c0;
  const long long sbase = (long long)bh * HD * HD + i * HD + c0;

  // -- forward: the states, a checkpoint every kL tokens, dr and du ----------------
  float S[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) S[c] = s0 ? s0[sbase + c] : 0.f;
  float du = 0.f;
  for (int sc = 0; sc < n_sub; ++sc) {
    const int t0 = sc * kL;
    float4* dst = reinterpret_cast<float4*>(ck + (long long)sc * HD * HD);
#pragma unroll
    for (int e = 0; e < kC / 4; ++e)
      dst[e] = make_float4(S[4 * e], S[4 * e + 1], S[4 * e + 2], S[4 * e + 3]);
    __syncthreads();   // the previous sub-chunk's reads of the stage are done
    stage(sm, rb, kb, vb, wb, dyb, ub, sr, sk, sv, sw, sdy, t0, n_tok);
#pragma unroll
    for (int tt = 0; tt < kL; ++tt) {
      if (t0 + tt >= n_tok) break;   // block-uniform
      const float* dyt = sm.dy[tt] + c0;
      const float* vt = sm.v[tt] + c0;
      float p = 0.f;
#pragma unroll
      for (int c = 0; c < kC; ++c) p = fmaf(S[c], dyt[c], p);
      p = row_sum(p);
      const float ki = sm.k[tt][i], wi = sm.w[tt][i];
      if (q == 0) {
        store_elt(drb + (long long)(t0 + tt) * sdr.t + i, fmaf(ui * ki, sm.vdy[tt], p));
        du = fmaf(sm.r[tt][i] * ki, sm.vdy[tt], du);
      }
#pragma unroll
      for (int c = 0; c < kC; ++c) S[c] = fmaf(wi, S[c], ki * vt[c]);
    }
  }

  // -- backward: G from dS_T, sub-chunk by sub-chunk ---------------------------------
  float G[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) G[c] = ds_t ? ds_t[sbase + c] : 0.f;
  const int b2 = (lane >> 2) & 1, b3 = (lane >> 3) & 1, b4 = (lane >> 4) & 1;
  const int cc = 8 * b4 + 4 * b3 + 2 * b2;   // the 2 columns this lane's dv partial ends on
  for (int sc = n_sub - 1; sc >= 0; --sc) {
    const int t0 = sc * kL;
    __syncthreads();   // the previous sub-chunk's dv pass is done with the stage
    stage(sm, rb, kb, vb, wb, dyb, ub, sr, sk, sv, sw, sdy, t0, n_tok);
    float P[kL][kC];   // P[tt] = the state before token t0 + tt, from the checkpoint
    {
      const float4* src = reinterpret_cast<const float4*>(ck + (long long)sc * HD * HD);
#pragma unroll
      for (int e = 0; e < kC / 4; ++e) {
        const float4 x = src[e];
        P[0][4 * e] = x.x;
        P[0][4 * e + 1] = x.y;
        P[0][4 * e + 2] = x.z;
        P[0][4 * e + 3] = x.w;
      }
    }
#pragma unroll
    for (int tt = 1; tt < kL; ++tt) {
      const float wi = sm.w[tt - 1][i], ki = sm.k[tt - 1][i];
      const float* vt = sm.v[tt - 1] + c0;
#pragma unroll
      for (int c = 0; c < kC; ++c) P[tt][c] = fmaf(wi, P[tt - 1][c], ki * vt[c]);
    }
#pragma unroll
    for (int tt = kL - 1; tt >= 0; --tt) {
      if (t0 + tt < n_tok) {   // block-uniform
        const long long t = t0 + tt;
        const float ki = sm.k[tt][i], wi = sm.w[tt][i], ri = sm.r[tt][i];
        const float* vt = sm.v[tt] + c0;
        const float* dyt = sm.dy[tt] + c0;
        float pk = 0.f, pw = 0.f, x[kC];
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          pk = fmaf(G[c], vt[c], pk);
          pw = fmaf(G[c], P[tt][c], pw);
          x[c] = ki * G[c];
        }
        pk = row_sum(pk);
        pw = row_sum(pw);
        if (q == 0) {
          store_elt(dkb + t * sdk.t + i, fmaf(ri * ui, sm.vdy[tt], pk));
          dwb[t * sdw.t + i] = wi * pw;
        }
        // dv: x summed over the warp's 8 rows (lane bits 2..4), reduce-scattered
        // so that each lane ends with 2 of its 16 columns
        float y8[8], y4[4], y2[2];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float send = b4 ? x[e] : x[e + 8], keep = b4 ? x[e + 8] : x[e];
          y8[e] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float send = b3 ? y8[e] : y8[e + 4], keep = b3 ? y8[e + 4] : y8[e];
          y4[e] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float send = b2 ? y4[e] : y4[e + 2], keep = b2 ? y4[e + 2] : y4[e];
          y2[e] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
        }
        sm.dv[tt][warp][c0 + cc] = y2[0];
        sm.dv[tt][warp][c0 + cc + 1] = y2[1];
#pragma unroll
        for (int c = 0; c < kC; ++c) G[c] = fmaf(wi, G[c], ri * dyt[c]);
      }
    }
    __syncthreads();
    for (int idx = tid; idx < kL * HD; idx += kThreads) {   // dv, the warps summed in order
      const int tt = idx / HD, j = idx % HD;
      if (t0 + tt < n_tok) {
        float s = 0.f;
#pragma unroll
        for (int w8 = 0; w8 < kWarps; ++w8) s += sm.dv[tt][w8][j];
        store_elt(dvb + (long long)(t0 + tt) * sdv.t + j, fmaf(sm.a[tt], sm.dy[tt][j], s));
      }
    }
  }
  if (ds0) {
#pragma unroll
    for (int c = 0; c < kC; ++c) ds0[sbase + c] = G[c];
  }
  if (du_part && q == 0) du_part[(long long)bh * HD + i] = du;
}

// du (H, HD) = du_part (B, H, HD) summed over the batch in order.
__global__ void rwkv6_wkv_bwd_du(const float* __restrict__ du_part, float* __restrict__ du,
                                 int B, int H) {
  const int h = blockIdx.x, i = threadIdx.x;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += du_part[((long long)b * H + h) * HD + i];
  du[h * HD + i] = s;
}

}  // namespace

// r, k, v (f32 or bf16), logw and dy (f32): (B, H, T, hd) given by their
// (b, h, t) strides in elements, hd contiguous; dr, dk, dv (r's type) and
// dlogw (f32) likewise; u (H, hd) f32 contiguous; s0, ds_t and ds0
// (nullable) (B, H, hd, hd) f32 contiguous; ckpt B·H·ceil(T/8)·hd·hd f32
// scratch; du_part (B, H, hd) and du (H, hd) f32, both null when du is not
// wanted. Returns cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for a head dim without a kernel.
extern "C" int rwkv6_wkv_bwd_launch(
    const void* r, const void* k, const void* v, const void* logw, const void* u,
    const void* s0, const void* dy, const void* ds_t, void* dr, void* dk, void* dv, void* dlogw,
    void* du_part, void* du, void* ds0, void* ckpt,
    long long r_b, long long r_h, long long r_t, long long k_b, long long k_h, long long k_t,
    long long v_b, long long v_h, long long v_t, long long w_b, long long w_h, long long w_t,
    long long dy_b, long long dy_h, long long dy_t, long long dr_b, long long dr_h,
    long long dr_t, long long dk_b, long long dk_h, long long dk_t, long long dv_b,
    long long dv_h, long long dv_t, long long dw_b, long long dw_h, long long dw_t, int B,
    int H, int T, int head_dim, int is_bf16, void* stream) {
  const Strides sr{r_b, r_h, r_t}, sk{k_b, k_h, k_t}, sv{v_b, v_h, v_t}, sw{w_b, w_h, w_t},
      sdy{dy_b, dy_h, dy_t}, sdr{dr_b, dr_h, dr_t}, sdk{dk_b, dk_h, dk_t}, sdv{dv_b, dv_h, dv_t},
      sdw{dw_b, dw_h, dw_t};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (head_dim != HD) return (int)cudaErrorInvalidValue;
  const float* lw = static_cast<const float*>(logw);
  const float* uu = static_cast<const float*>(u);
  const float* s = static_cast<const float*>(s0);
  const float* g = static_cast<const float*>(dy);
  const float* dst = static_cast<const float*>(ds_t);
  float* dwp = static_cast<float*>(dlogw);
  float* dup = static_cast<float*>(du_part);
  float* d0 = static_cast<float*>(ds0);
  float* cp = static_cast<float*>(ckpt);
  if (is_bf16) {
    using E = __nv_bfloat16;
    rwkv6_wkv_bwd_kernel<E><<<B * H, kThreads, 0, cs>>>(
        static_cast<const E*>(r), static_cast<const E*>(k), static_cast<const E*>(v), lw, uu, s,
        g, dst, static_cast<E*>(dr), static_cast<E*>(dk), static_cast<E*>(dv), dwp, dup, d0, cp,
        sr, sk, sv, sw, sdy, sdr, sdk, sdv, sdw, H, T);
  } else {
    rwkv6_wkv_bwd_kernel<float><<<B * H, kThreads, 0, cs>>>(
        static_cast<const float*>(r), static_cast<const float*>(k), static_cast<const float*>(v),
        lw, uu, s, g, dst, static_cast<float*>(dr), static_cast<float*>(dk),
        static_cast<float*>(dv), dwp, dup, d0, cp, sr, sk, sv, sw, sdy, sdr, sdk, sdv, sdw, H, T);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || du_part == nullptr) return (int)err;
  rwkv6_wkv_bwd_du<<<H, HD, 0, cs>>>(dup, static_cast<float*>(du), B, H);
  return (int)cudaGetLastError();
}
