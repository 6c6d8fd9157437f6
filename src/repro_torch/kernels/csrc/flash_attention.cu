// flash_attention: causal / sliding-window GQA prefill attention with an
// online softmax; the (S, L) score matrix never reaches device memory.
//
// Replaces the TPU kernel flash_attention in
// src/repro/kernels/flash_attention.py (Pallas body _kernel).
//
// What bounds it on the H100: at the scoring path's shapes (gpt2-base:
// B = 16, H = 12, hd = 64, S = L = 33 or 513, bf16) the work is small:
// 4·B·H·(live pairs)·hd operations against q, k, v and o read or written
// once. Both bounds are microseconds; what costs is filling 132 SMs and
// not wasting the tensor cores on masked tiles.
//
// Design: one block per (64-row query tile, head, batch), four warps of 16
// query rows each. The TPU kernel carries (m, l, acc) across KV tiles in
// VMEM because its grid runs in order; here the KV axis is a loop inside
// the block, and (m, l, acc) live in registers. KV head = h / (H / Hkv).
// Query row i sits at position q_offset + i; column j is live iff
// j < kv_len, j <= q_pos when causal, and j > q_pos − window when window > 0.
// KV tiles wholly above the causal diagonal or wholly left of the window are
// not visited; ragged S and L are zero-filled and masked here. The running
// max starts at −1e30, the TPU kernel's masking constant, and masked scores
// get probability exactly 0, so a row with no live column gives 0.
// Scores, softmax and the output sum are f32. In bf16 the probabilities are
// rounded to bf16 for the P·V product on the tensor cores, as the reference's
// XLA path rounds them to v's dtype; in f32 both products are f32 FMAs.
// This first version has no cp.async, TMA or wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "warp_tile.cuh"

using namespace repro_torch;

namespace {

constexpr int kRowsQ = 64;    // query rows per block: 4 warps × 16
constexpr int kColsK = 64;    // KV columns per step
constexpr int kThreads = 128;

struct Strides { long long b, h, s; };   // in elements; the last dim is contiguous

template <typename T> struct Pad;
template <> struct Pad<__nv_bfloat16> { static constexpr int v = 8; };
template <> struct Pad<float> { static constexpr int v = 4; };

// Shared memory: Q and K tiles [64][LDQ], Vᵀ tile [HD][LDV], one P tile
// [16][LDV] per warp. The padding keeps fragment loads on distinct banks
// and rows 16-byte aligned.
template <typename T, int HD>
struct Layout {
  static constexpr int LDQ = HD + Pad<T>::v;
  static constexpr int LDV = kColsK + Pad<T>::v;
  static constexpr int bytes =
      (int)sizeof(T) * (kRowsQ * LDQ + kColsK * LDQ + HD * LDV + 4 * 16 * LDV);
};

// Vᵀ[d][r] = V[j0 + r][d] for r < 64, zero past the last row.
template <typename T, int HD>
__device__ __forceinline__ void load_vt(T* vt, int ldv, const T* src, long long ld,
                                        int j0, int nrows) {
  constexpr int VEC = 16 / sizeof(T), PER_ROW = HD / VEC;
  for (int i = threadIdx.x; i < kColsK * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (j0 + r < nrows) u = *reinterpret_cast<const uint4*>(src + (j0 + r) * ld + c);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int x = 0; x < VEC; ++x) vt[(c + x) * ldv + r] = e[x];
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    Strides sq, Strides sk, Strides sv, Strides so,
                    int n_heads, int n_kv_heads, int S, int L, int kv_len,
                    int q_offset, int causal, int window, float scale) {
  using Lay = Layout<T, HD>;
  constexpr int LDQ = Lay::LDQ, LDV = Lay::LDV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + kRowsQ * LDQ;
  T* vt = ks + kColsK * LDQ;
  T* ps = vt + HD * LDV;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int s0 = blockIdx.x * kRowsQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (n_heads / n_kv_heads);
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  T* ob = o + b * so.b + h * so.h;

  load_tile<T, kRowsQ, HD, kThreads>(qs, LDQ, qb, sq.s, s0, S, 0, HD);

  const int ra = s0 + warp * 16 + g, rb = ra + 8;      // this lane's query rows
  const int pa = q_offset + ra, pb = q_offset + rb;    // and their positions
  const int kv_live = min(kv_len, L);
  int kv_end = kv_live;
  if (causal) kv_end = min(kv_end, q_offset + min(s0 + kRowsQ, S));
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q_offset + s0 - window + 1);
  kv_begin -= kv_begin % kColsK;

  float ma = kNegInf, mb = kNegInf, la = 0.f, lb = 0.f;
  float oacc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  T* pw = ps + warp * 16 * LDV;

  for (int j0 = kv_begin; j0 < kv_end; j0 += kColsK) {
    __syncthreads();   // the previous step's K, Vᵀ and P tiles are consumed
    load_tile<T, kColsK, HD, kThreads>(ks, LDQ, kb, sk.s, j0, L, 0, HD);
    load_vt<T, HD>(vt, LDV, vb, sv.s, j0, L);
    __syncthreads();

    float sacc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
    warp_tile_mma<8, HD>(qs + warp * 16 * LDQ, LDQ, ks, LDQ, sacc);

    float xa = -INFINITY, xb = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j0 + 8 * j + 2 * t + e;
        const bool in = col < kv_live;
        const bool live_a = in && (!causal || col <= pa) && (window <= 0 || col > pa - window);
        const bool live_b = in && (!causal || col <= pb) && (window <= 0 || col > pb - window);
        sacc[j][e] = live_a ? sacc[j][e] * scale : -INFINITY;
        sacc[j][2 + e] = live_b ? sacc[j][2 + e] * scale : -INFINITY;
        xa = fmaxf(xa, sacc[j][e]);
        xb = fmaxf(xb, sacc[j][2 + e]);
      }
    // the running max never drops below -1e30, so exp(-inf - m) is exactly 0
    const float mna = fmaxf(ma, quad_max(xa)), mnb = fmaxf(mb, quad_max(xb));
    const float alpha_a = expf(ma - mna), alpha_b = expf(mb - mnb);
    float suma = 0.f, sumb = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p_a = expf(sacc[j][e] - mna), p_b = expf(sacc[j][2 + e] - mnb);
        suma += p_a;
        sumb += p_b;
        pw[g * LDV + 8 * j + 2 * t + e] = from_f32<T>(p_a);
        pw[(g + 8) * LDV + 8 * j + 2 * t + e] = from_f32<T>(p_b);
      }
    la = la * alpha_a + quad_sum(suma);
    lb = lb * alpha_b + quad_sum(sumb);
    ma = mna;
    mb = mnb;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      oacc[n][0] *= alpha_a; oacc[n][1] *= alpha_a;
      oacc[n][2] *= alpha_b; oacc[n][3] *= alpha_b;
    }
    __syncwarp();      // this warp's P tile is written
    warp_tile_mma<HD / 8, kColsK>(pw, LDV, vt, LDV, oacc);
  }

  const float da = fmaxf(la, 1e-30f), db = fmaxf(lb, 1e-30f);
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = 8 * n + 2 * t + e;
      if (ra < S) ob[ra * so.s + d] = from_f32<T>(oacc[n][e] / da);
      if (rb < S) ob[rb * so.s + d] = from_f32<T>(oacc[n][2 + e] / db);
    }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, const Strides* st,
           int B, int H, int Hkv, int S, int L, int kv_len, int q_offset, int causal,
           int window, float scale, cudaStream_t stream) {
  auto kern = flash_attention_fwd<T, HD>;
  constexpr int bytes = Layout<T, HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kRowsQ - 1) / kRowsQ, H, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), st[0], st[1], st[2], st[3], H, Hkv, S, L, kv_len, q_offset,
      causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (B, H, S, hd); k, v: (B, Hkv, L, hd), each given by its (b, h, s)
// strides in elements with hd contiguous. Returns cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue for a head dim
// without a template.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o,
    long long q_b, long long q_h, long long q_s, long long k_b, long long k_h, long long k_s,
    long long v_b, long long v_h, long long v_s, long long o_b, long long o_h, long long o_s,
    int B, int H, int Hkv, int S, int L, int kv_len, int q_offset, int causal, int window,
    int head_dim, int is_bf16, float scale, void* stream) {
  const Strides st[4] = {{q_b, q_h, q_s}, {k_b, k_h, k_s}, {v_b, v_h, v_s}, {o_b, o_h, o_s}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return is_bf16 ? launch<__nv_bfloat16, 64>(q, k, v, o, st, B, H, Hkv, S, L, kv_len, q_offset, causal, window, scale, s)
                   : launch<float, 64>(q, k, v, o, st, B, H, Hkv, S, L, kv_len, q_offset, causal, window, scale, s);
  if (head_dim == 128)
    return is_bf16 ? launch<__nv_bfloat16, 128>(q, k, v, o, st, B, H, Hkv, S, L, kv_len, q_offset, causal, window, scale, s)
                   : launch<float, 128>(q, k, v, o, st, B, H, Hkv, S, L, kv_len, q_offset, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
