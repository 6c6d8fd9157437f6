// flash_attention_bwd: dQ, dK and dV of flash_attention (causal / sliding-
// window GQA with q_offset and kv_len), in the FlashAttention-2 form: the
// (S, L) probabilities are recomputed tile by tile from Q, K and the
// forward's log-sum-exp, and never reach device memory.
//
// No TPU counterpart: the reference differentiates its attention through
// XLA (src/repro/train/objectives.py, lpt_loss under jax.value_and_grad),
// and its Pallas flash_attention has no backward. This kernel computes the
// same gradient for the port's hand-written forward.
//
// The function, with s = scale · q·k on live pairs (the forward's mask:
// column j is live for row i iff j < kv_len, j <= q_offset + i when causal,
// j > q_offset + i - window when window > 0), P = exp(s - lse) and
// D_i = Σ_d dO[i, d] · O[i, d]:
//     dV = Pᵀ·dO,   dS = P ∘ (dO·Vᵀ - D),   dQ = scale · dS·K,   dK = scale · dSᵀ·Q,
// with dK and dV summed over the query heads of each KV head. A row with no
// live column has P = 0 and gets zero gradient; so does a KV row no query
// sees.
//
// What bounds it on the H100: at vicuna-7b's 4112 positions (hd = 128) the
// products, 5 per live pair and head where the forward has 2; at gpt2-base's
// 33 positions the bytes, and in practice launch latency. Three kernels,
// none with atomics, so the result does not depend on scheduling:
//   1. fa_bwd_delta: D, one warp per row.
//   2. fa_bwd_dkdv: one block per (64-row KV tile, KV head, batch row); the
//      block walks the G query heads of its KV head and the query tiles that
//      see its KV tile, so each KV head's sum over its query heads stays in
//      registers.
//   3. fa_bwd_dq: one block per (64-row query tile, head, batch row) over the
//      KV tiles its rows see, as the forward.
// bf16 (a first design on mma.sync m16n8k16, warp_tile.cuh, as the
// forward): four warps of 16 rows; the tiles a block streams (Q and dO in
// dK/dV, K and V in dQ) double-buffered by cp.async, rows past the end
// zero-filled, one barrier a tile; fragments by ldmatrix; products whose
// depth runs over a tile's rows read it by ldmatrix.trans; P and dS stay in
// registers as the A operand (rounded to bf16, as the forward rounds P);
// only tiles that cross the causal diagonal, the window's edge, kv_len or S
// evaluate the mask. Shared memory: hd = 64 55 KB, hd = 128 103 KB, two
// blocks an SM.
// f32: CUDA cores, 32-row tiles in shared memory, each thread a few dot
// products; it is the reference of the CPU-against-card check, not a fast
// path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "warp_tile.cuh"

using namespace repro_torch;

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;       // bf16 tile rows (queries and keys)
constexpr int kTileF = 32;      // f32 tile rows

struct Strides { long long b, h, s; };   // in elements; the last dim is contiguous

struct Mask {
  int S, kv_live, q_offset, causal, window;
  __device__ __forceinline__ bool live(int i, int j) const {
    return i < S && j < kv_live && (!causal || j <= q_offset + i) &&
           (window <= 0 || j > q_offset + i - window);
  }
};

// The query rows [begin, end) that see some column of the KV tile [j0, j0 + rows),
// begin rounded down to a multiple of the tile.
__device__ __forceinline__ void query_range(const Mask& m, int j0, int rows, int tile,
                                            int* begin, int* end) {
  int b = m.causal ? max(0, j0 - m.q_offset) : 0;
  int e = m.S;
  if (m.window > 0) e = min(e, j0 + rows - 1 + m.window - m.q_offset);
  b -= b % tile;
  *begin = b;
  *end = (j0 < m.kv_live) ? e : 0;
}

// The KV rows [begin, end) that the query rows [s0, s0 + rows) see, begin rounded
// down to a multiple of the tile (the forward's range).
__device__ __forceinline__ void key_range(const Mask& m, int s0, int rows, int tile,
                                          int* begin, int* end) {
  int e = m.kv_live;
  if (m.causal) e = min(e, m.q_offset + min(s0 + rows, m.S));
  int b = m.window > 0 ? max(0, m.q_offset + s0 - m.window + 1) : 0;
  b -= b % tile;
  *begin = b;
  *end = e;
}

// -- D = rowsum(dO ∘ O) ------------------------------------------------------------

template <typename T>
__global__ void fa_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                             float* __restrict__ delta, Strides so, Strides sd, int H, int S,
                             int hd, long long n_rows) {
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int i = (int)(row % S);
  const long long bh = row / S;
  const int h = (int)(bh % H), b = (int)(bh / H);
  const T* op = o + b * so.b + h * so.h + i * so.s;
  const T* dp = dout + b * sd.b + h * sd.h + i * sd.s;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc += to_f32(op[d]) * to_f32(dp[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// -- bf16: mma.sync ------------------------------------------------------------------

// Shared memory of both bf16 kernels: six [64][HD + 8] tiles (the block's own
// two, and two stages of the two it streams) and two stages of lse and D.
template <int HD>
struct Layout {
  static constexpr int LD = HD + 8;            // 16 bytes of padding: ldmatrix rows on distinct banks
  static constexpr int TILE = kTile * LD;
  static constexpr int bytes = 6 * TILE * 2 + 2 * 2 * kTile * 4;
};

// Whether every (query, key) pair of the query rows [i0, i0 + 64) and the
// key rows [j0, j0 + 64) is live: such a tile skips the mask.
__device__ __forceinline__ bool all_live(const Mask& m, int i0, int j0) {
  return i0 + kTile <= m.S && j0 + kTile <= m.kv_live &&
         (!m.causal || j0 + kTile - 1 <= m.q_offset + i0) &&
         (m.window <= 0 || j0 > m.q_offset + i0 + kTile - 1 - m.window);
}

// Starts the copy of rows [row0, row0 + 64) of a (nrows × HD) matrix, row
// stride ld, into a [64][HD + 8] tile; rows past nrows are zero-filled.
template <int HD>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long ld, int row0, int nrows) {
  constexpr int PER_ROW = HD / 8, LD = Layout<HD>::LD;
#pragma unroll
  for (int x = 0; x < kTile * PER_ROW / kThreads; ++x) {
    const int i = threadIdx.x + x * kThreads;
    const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
    const bool in = row0 + r < nrows;
    cp_async_16(dst + r * LD + c, src + (in ? row0 + r : 0) * ld + c, in ? 16 : 0);
  }
}

// acc (16 rows of this warp × 64 columns) = A·Bᵀ: A the warp's 16 rows of tile a,
// B the 64 rows of tile b, depth HD over both tiles' columns.
template <int HD>
__device__ __forceinline__ void rows_by_rows(float (&acc)[8][4], const __nv_bfloat16* a,
                                             const __nv_bfloat16* b) {
  constexpr int LD = Layout<HD>::LD;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int s = 0; s < HD / 16; ++s) {
    uint32_t af[4];
    ldmatrix_x4(af, a + 16 * warp * LD + a_rows(LD) + 16 * s);
#pragma unroll
    for (int pair = 0; pair < 4; ++pair) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b + b_rows(LD) + 16 * pair * LD + 16 * s);
      mma_bf16(acc[2 * pair], af, bf[0], bf[1]);
      mma_bf16(acc[2 * pair + 1], af, bf[2], bf[3]);
    }
  }
}

// out (16 × HD) += X·T: X (16 × 64) the accumulators x, rounded to bf16, as
// the A operand; T a tile whose 64 rows are the depth.
template <int HD>
__device__ __forceinline__ void regs_by_tile(float (&out)[HD / 8][4], const float (&x)[8][4],
                                             const __nv_bfloat16* tile) {
  constexpr int LD = Layout<HD>::LD;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t af[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                            pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                            pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                            pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < HD / 8; n += 2) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, tile + b_cols(LD) + 16 * kk * LD + 8 * n);
      mma_bf16(out[n], af, bf[0], bf[1]);
      mma_bf16(out[n + 1], af, bf[2], bf[3]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, Strides sq,
                 Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv, int H, int Hkv,
                 int L, Mask m, float scale, float scale_log2) {
  using Lay = Layout<HD>;
  constexpr int NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + Lay::TILE;
  __nv_bfloat16* qd = vs + Lay::TILE;     // stage st: Q at 2·st·TILE, dO after it
  float* ld_s = reinterpret_cast<float*>(qd + 4 * Lay::TILE);   // stage st: lse (log2 units), D

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int hk = blockIdx.x, b = blockIdx.y, j0 = blockIdx.z * kTile;   // heaviest tiles first
  const int G = H / Hkv;
  int i_begin, i_end;
  query_range(m, j0, kTile, kTile, &i_begin, &i_end);
  const int n_qt = i_begin < i_end ? (i_end - i_begin + kTile - 1) / kTile : 0;
  const int n_it = G * n_qt;              // (query head, query tile) pairs, head-major

  // Starts step it's copies into its stage: the Q and dO tiles by cp.async,
  // lse and D by plain loads (read after the barrier that follows the wait).
  auto load_step = [&](int it) {
    const int h = hk * G + it / n_qt, i0 = i_begin + (it % n_qt) * kTile, st = it & 1;
    __nv_bfloat16* qs = qd + 2 * st * Lay::TILE;
    copy_tile<HD>(qs, q + b * sq.b + h * sq.h, sq.s, i0, m.S);
    copy_tile<HD>(qs + Lay::TILE, dout + b * sdo.b + h * sdo.h, sdo.s, i0, m.S);
    if (threadIdx.x < kTile) {
      const int i = i0 + threadIdx.x;
      const long long o = ((long long)b * H + h) * m.S + i;
      ld_s[st * 2 * kTile + threadIdx.x] = i < m.S ? lse[o] * kLog2e : 0.f;
      ld_s[st * 2 * kTile + kTile + threadIdx.x] = i < m.S ? delta[o] : 0.f;
    }
  };
  if (n_it > 0) {
    copy_tile<HD>(ks, k + b * sk.b + hk * sk.h, sk.s, j0, L);
    copy_tile<HD>(vs, v + b * sv.b + hk * sv.h, sv.s, j0, L);
    load_step(0);
  }
  cp_async_commit();

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const int ja = j0 + 16 * warp + g, jb = ja + 8;   // this lane's KV rows

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<0>();
    __syncthreads();   // step it is visible to all, and every warp is done with step it - 1
    if (it + 1 < n_it) load_step(it + 1);   // into the stage step it - 1 used
    cp_async_commit();
    const int i0 = i_begin + (it % n_qt) * kTile, st = it & 1;
    const __nv_bfloat16* qs = qd + 2 * st * Lay::TILE;
    const __nv_bfloat16* dos = qs + Lay::TILE;
    const float* lse_s = ld_s + st * 2 * kTile;
    const float* dl_s = lse_s + kTile;

    float sa[8][4], dp[8][4];
    rows_by_rows<HD>(sa, ks, qs);     // Sᵀ: this warp's KV rows × the tile's queries
    rows_by_rows<HD>(dp, vs, dos);    // dPᵀ = V·dOᵀ
    const bool edge = !all_live(m, i0, j0);
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ic = 8 * jn + 2 * t + e, i = i0 + ic;
        const float l2 = lse_s[ic], dd = dl_s[ic];
        float pa = exp2_approx(fmaf(sa[jn][e], scale_log2, -l2));
        float pb = exp2_approx(fmaf(sa[jn][2 + e], scale_log2, -l2));
        if (edge) {
          if (!m.live(i, ja)) pa = 0.f;
          if (!m.live(i, jb)) pb = 0.f;
        }
        sa[jn][e] = pa;
        sa[jn][2 + e] = pb;
        dp[jn][e] = pa * (dp[jn][e] - dd);
        dp[jn][2 + e] = pb * (dp[jn][2 + e] - dd);
      }
    regs_by_tile<HD>(dva, sa, dos);   // dV += Pᵀ·dO
    regs_by_tile<HD>(dka, dp, qs);    // dK += dSᵀ·Q
  }
  cp_async_wait<0>();

  __nv_bfloat16* dkb = dk + b * sdk.b + hk * sdk.h;
  __nv_bfloat16* dvb = dv + b * sdv.b + hk * sdv.h;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int d = 8 * n + 2 * t;
    if (ja < L) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + ja * sdk.s + d) =
          __floats2bfloat162_rn(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + ja * sdv.s + d) =
          __floats2bfloat162_rn(dva[n][0], dva[n][1]);
    }
    if (jb < L) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + jb * sdk.s + d) =
          __floats2bfloat162_rn(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + jb * sdv.s + d) =
          __floats2bfloat162_rn(dva[n][2], dva[n][3]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dq, Strides sq, Strides sk, Strides sv, Strides sdo,
               Strides sdq, int H, int Hkv, int L, Mask m, float scale, float scale_log2) {
  using Lay = Layout<HD>;
  constexpr int LD = Lay::LD, KSTEPS = HD / 16, NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + Lay::TILE;
  __nv_bfloat16* kv = dos + Lay::TILE;    // stage st: K at 2·st·TILE, V after it

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int s0 = (gridDim.z - 1 - blockIdx.z) * kTile;   // heaviest causal tiles first
  const int hk = h / (H / Hkv);
  int kv_begin, kv_end;
  key_range(m, s0, kTile, kTile, &kv_begin, &kv_end);
  const int n_tiles = kv_begin < kv_end ? (kv_end - kv_begin + kTile - 1) / kTile : 0;
  const __nv_bfloat16* kb = k + b * sk.b + hk * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + hk * sv.h;

  // Group 0 is Q, dO and KV tile 0; every step commits one group, empty or not.
  if (n_tiles > 0) {
    copy_tile<HD>(qs, q + b * sq.b + h * sq.h, sq.s, s0, m.S);
    copy_tile<HD>(dos, dout + b * sdo.b + h * sdo.h, sdo.s, s0, m.S);
    copy_tile<HD>(kv, kb, sk.s, kv_begin, L);
    copy_tile<HD>(kv + Lay::TILE, vb, sv.s, kv_begin, L);
  }
  cp_async_commit();

  const int ra = s0 + 16 * warp + g, rb = ra + 8;   // this lane's query rows
  const long long row_base = ((long long)b * H + h) * m.S;
  const float la2 = ra < m.S ? lse[row_base + ra] * kLog2e : 0.f;
  const float lb2 = rb < m.S ? lse[row_base + rb] * kLog2e : 0.f;
  const float da = ra < m.S ? delta[row_base + ra] : 0.f;
  const float db = rb < m.S ? delta[row_base + rb] : 0.f;

  uint32_t qf[KSTEPS][4];   // dO's fragments are read from shared memory each tile
  float dqa[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = kv_begin + it * kTile;
    cp_async_wait<0>();
    __syncthreads();   // tile it is visible to all, and every warp is done with tile it - 1
    if (it == 0) {
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s) ldmatrix_x4(qf[s], qs + 16 * warp * LD + a_rows(LD) + 16 * s);
    }
    if (it + 1 < n_tiles) {   // tile it + 1 into the stage tile it - 1 used
      __nv_bfloat16* nxt = kv + ((it + 1) & 1) * 2 * Lay::TILE;
      copy_tile<HD>(nxt, kb, sk.s, j0 + kTile, L);
      copy_tile<HD>(nxt + Lay::TILE, vb, sv.s, j0 + kTile, L);
    }
    cp_async_commit();
    const __nv_bfloat16* ks = kv + (it & 1) * 2 * Lay::TILE;
    const __nv_bfloat16* vs = ks + Lay::TILE;

    float sa[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sa[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      uint32_t df[4];
      ldmatrix_x4(df, dos + 16 * warp * LD + a_rows(LD) + 16 * s);
#pragma unroll
      for (int pair = 0; pair < 4; ++pair) {
        uint32_t bf[4];
        ldmatrix_x4(bf, ks + b_rows(LD) + 16 * pair * LD + 16 * s);
        mma_bf16(sa[2 * pair], qf[s], bf[0], bf[1]);
        mma_bf16(sa[2 * pair + 1], qf[s], bf[2], bf[3]);
        ldmatrix_x4(bf, vs + b_rows(LD) + 16 * pair * LD + 16 * s);
        mma_bf16(dp[2 * pair], df, bf[0], bf[1]);
        mma_bf16(dp[2 * pair + 1], df, bf[2], bf[3]);
      }
    }
    const bool edge = !all_live(m, s0, j0);
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + 8 * jn + 2 * t + e;
        float pa = exp2_approx(fmaf(sa[jn][e], scale_log2, -la2));
        float pb = exp2_approx(fmaf(sa[jn][2 + e], scale_log2, -lb2));
        if (edge) {
          if (!m.live(ra, j)) pa = 0.f;
          if (!m.live(rb, j)) pb = 0.f;
        }
        sa[jn][e] = pa * (dp[jn][e] - da);         // dS
        sa[jn][2 + e] = pb * (dp[jn][2 + e] - db);
      }
    regs_by_tile<HD>(dqa, sa, ks);   // dQ += dS·K
  }
  cp_async_wait<0>();

  __nv_bfloat16* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int d = 8 * n + 2 * t;
    if (ra < m.S)
      *reinterpret_cast<__nv_bfloat162*>(dqb + ra * sdq.s + d) =
          __floats2bfloat162_rn(dqa[n][0] * scale, dqa[n][1] * scale);
    if (rb < m.S)
      *reinterpret_cast<__nv_bfloat162*>(dqb + rb * sdq.s + d) =
          __floats2bfloat162_rn(dqa[n][2] * scale, dqa[n][3] * scale);
  }
}

// -- f32: CUDA cores -----------------------------------------------------------------

template <int HD>
struct LayoutF {
  static constexpr int LD = HD + 1;            // odd: a column walk hits distinct banks
  static constexpr int LP = kTileF + 1;
  static constexpr int bytes = (int)sizeof(float) * (4 * kTileF * LD + 2 * kTileF * LP + 2 * kTileF);
};

// Rows [row0, row0 + 32) of a (nrows × HD) matrix into a [32][HD + 1] tile,
// zero past nrows.
template <int HD>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long ld, int row0,
                                          int nrows) {
  constexpr int LD = LayoutF<HD>::LD;
  for (int x = threadIdx.x; x < kTileF * HD; x += kThreads) {
    const int r = x / HD, c = x % HD;
    dst[r * LD + c] = row0 + r < nrows ? src[(long long)(row0 + r) * ld + c] : 0.f;
  }
}

template <int HD>
__device__ __forceinline__ float dot_rows(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv, Strides sq, Strides sk,
                Strides sv, Strides sdo, Strides sdk, Strides sdv, int H, int Hkv, int L, Mask m,
                float scale) {
  using Lay = LayoutF<HD>;
  constexpr int LD = Lay::LD, LP = Lay::LP, PER = HD / 4;
  extern __shared__ __align__(16) float smf[];
  float* ks = smf;
  float* vs = ks + kTileF * LD;
  float* qs = vs + kTileF * LD;
  float* dos = qs + kTileF * LD;
  float* ps = dos + kTileF * LD;
  float* dss = ps + kTileF * LP;
  float* lse_s = dss + kTileF * LP;
  float* dl_s = lse_s + kTileF;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hk = blockIdx.x, b = blockIdx.y, j0 = blockIdx.z * kTileF;
  const int G = H / Hkv;
  int i_begin, i_end;
  query_range(m, j0, kTileF, kTileF, &i_begin, &i_end);
  const int jr = threadIdx.x >> 2, d0 = threadIdx.x & 3;   // the (KV row, columns) this thread sums

  float dka[PER], dva[PER];
#pragma unroll
  for (int x = 0; x < PER; ++x) dka[x] = dva[x] = 0.f;

  if (i_begin < i_end) {
    load_rows<HD>(ks, k + b * sk.b + hk * sk.h, sk.s, j0, L);
    load_rows<HD>(vs, v + b * sv.b + hk * sv.h, sv.s, j0, L);
    for (int h = hk * G; h < (hk + 1) * G; ++h) {
      const long long row_base = ((long long)b * H + h) * m.S;
      for (int i0 = i_begin; i0 < i_end; i0 += kTileF) {
        __syncthreads();
        load_rows<HD>(qs, q + b * sq.b + h * sq.h, sq.s, i0, m.S);
        load_rows<HD>(dos, dout + b * sdo.b + h * sdo.h, sdo.s, i0, m.S);
        if (threadIdx.x < kTileF) {
          const int i = i0 + threadIdx.x;
          lse_s[threadIdx.x] = i < m.S ? lse[row_base + i] : 0.f;
          dl_s[threadIdx.x] = i < m.S ? delta[row_base + i] : 0.f;
        }
        __syncthreads();
        for (int r = warp; r < kTileF; r += kThreads / 32) {   // P and dS, KV row r, query lane
          const float s = dot_rows<HD>(ks + r * LD, qs + lane * LD);
          const float dpv = dot_rows<HD>(vs + r * LD, dos + lane * LD);
          const float p = m.live(i0 + lane, j0 + r) ? expf(s * scale - lse_s[lane]) : 0.f;
          ps[r * LP + lane] = p;
          dss[r * LP + lane] = p * (dpv - dl_s[lane]);
        }
        __syncthreads();
        for (int ic = 0; ic < kTileF; ++ic) {
          const float p = ps[jr * LP + ic], ds = dss[jr * LP + ic];
#pragma unroll
          for (int x = 0; x < PER; ++x) {
            dva[x] = fmaf(p, dos[ic * LD + d0 + 4 * x], dva[x]);
            dka[x] = fmaf(ds, qs[ic * LD + d0 + 4 * x], dka[x]);
          }
        }
      }
    }
  }
  const int j = j0 + jr;
  if (j < L) {
    float* dkr = dk + b * sdk.b + hk * sdk.h + j * sdk.s;
    float* dvr = dv + b * sdv.b + hk * sdv.h + j * sdv.s;
#pragma unroll
    for (int x = 0; x < PER; ++x) {
      dkr[d0 + 4 * x] = dka[x] * scale;
      dvr[d0 + 4 * x] = dva[x];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, Strides sq, Strides sk, Strides sv, Strides sdo,
              Strides sdq, int H, int Hkv, int L, Mask m, float scale) {
  using Lay = LayoutF<HD>;
  constexpr int LD = Lay::LD, LP = Lay::LP, PER = HD / 4;
  extern __shared__ __align__(16) float smf[];
  float* qs = smf;
  float* dos = qs + kTileF * LD;
  float* ks = dos + kTileF * LD;
  float* vs = ks + kTileF * LD;
  float* dss = vs + kTileF * LD;
  float* lse_s = dss + 2 * kTileF * LP;
  float* dl_s = lse_s + kTileF;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x, b = blockIdx.y, s0 = blockIdx.z * kTileF;
  const int hk = h / (H / Hkv);
  int kv_begin, kv_end;
  key_range(m, s0, kTileF, kTileF, &kv_begin, &kv_end);
  const int ir = threadIdx.x >> 2, d0 = threadIdx.x & 3;
  const long long row_base = ((long long)b * H + h) * m.S;

  float dqa[PER];
#pragma unroll
  for (int x = 0; x < PER; ++x) dqa[x] = 0.f;

  if (kv_begin < kv_end) {
    load_rows<HD>(qs, q + b * sq.b + h * sq.h, sq.s, s0, m.S);
    load_rows<HD>(dos, dout + b * sdo.b + h * sdo.h, sdo.s, s0, m.S);
    if (threadIdx.x < kTileF) {
      const int i = s0 + threadIdx.x;
      lse_s[threadIdx.x] = i < m.S ? lse[row_base + i] : 0.f;
      dl_s[threadIdx.x] = i < m.S ? delta[row_base + i] : 0.f;
    }
    for (int j0 = kv_begin; j0 < kv_end; j0 += kTileF) {
      __syncthreads();
      load_rows<HD>(ks, k + b * sk.b + hk * sk.h, sk.s, j0, L);
      load_rows<HD>(vs, v + b * sv.b + hk * sv.h, sv.s, j0, L);
      __syncthreads();
      for (int r = warp; r < kTileF; r += kThreads / 32) {   // dS, query row r, KV lane
        const float s = dot_rows<HD>(qs + r * LD, ks + lane * LD);
        const float dpv = dot_rows<HD>(dos + r * LD, vs + lane * LD);
        const float p = m.live(s0 + r, j0 + lane) ? expf(s * scale - lse_s[r]) : 0.f;
        dss[r * LP + lane] = p * (dpv - dl_s[r]);
      }
      __syncthreads();
      for (int jc = 0; jc < kTileF; ++jc) {
        const float ds = dss[ir * LP + jc];
#pragma unroll
        for (int x = 0; x < PER; ++x) dqa[x] = fmaf(ds, ks[jc * LD + d0 + 4 * x], dqa[x]);
      }
    }
  }
  const int i = s0 + ir;
  if (i < m.S) {
    float* dqr = dq + b * sdq.b + h * sdq.h + i * sdq.s;
#pragma unroll
    for (int x = 0; x < PER; ++x) dqr[d0 + 4 * x] = dqa[x] * scale;
  }
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, void* dk, void* dv, const Strides* st, int B, int H,
              int Hkv, int S, int L, const Mask& m, int is_bf16, float scale,
              cudaStream_t stream) {
  // st: q, k, v, dout, dq, dk, dv
  if (is_bf16) {
    using T = __nv_bfloat16;
    constexpr int bytes = Layout<HD>::bytes;
    auto kv_kern = fa_bwd_dkdv_bf16<HD>;
    auto q_kern = fa_bwd_dq_bf16<HD>;
    cudaError_t err = cudaFuncSetAttribute(kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(q_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    kv_kern<<<dim3(Hkv, B, (L + kTile - 1) / kTile), kThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        st[0], st[1], st[2], st[3], st[5], st[6], H, Hkv, L, m, scale, scale * kLog2e);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    q_kern<<<dim3(H, B, (S + kTile - 1) / kTile), kThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), st[0], st[1], st[2],
        st[3], st[4], H, Hkv, L, m, scale, scale * kLog2e);
  } else {
    constexpr int bytes = LayoutF<HD>::bytes;
    auto kv_kern = fa_bwd_dkdv_f32<HD>;
    auto q_kern = fa_bwd_dq_f32<HD>;
    cudaError_t err = cudaFuncSetAttribute(kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(q_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    kv_kern<<<dim3(Hkv, B, (L + kTileF - 1) / kTileF), kThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk),
        static_cast<float*>(dv), st[0], st[1], st[2], st[3], st[5], st[6], H, Hkv, L, m, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    q_kern<<<dim3(H, B, (S + kTileF - 1) / kTileF), kThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), st[0], st[1],
        st[2], st[3], st[4], H, Hkv, L, m, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, dout, dq: (B, H, S, hd); k, v, dk, dv: (B, Hkv, L, hd), each given by
// its (b, h, s) strides in elements with hd contiguous; lse (the forward's)
// and delta (scratch, written here) (B, H, S) f32 contiguous. dk and dv are
// written whole (zero where no query sees a row). Returns cudaGetLastError()
// after the launches (0 on success), or cudaErrorInvalidValue for a head dim
// without a template.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv,
    long long q_b, long long q_h, long long q_s, long long k_b, long long k_h, long long k_s,
    long long v_b, long long v_h, long long v_s, long long o_b, long long o_h, long long o_s,
    long long do_b, long long do_h, long long do_s, long long dq_b, long long dq_h,
    long long dq_s, long long dk_b, long long dk_h, long long dk_s, long long dv_b,
    long long dv_h, long long dv_s, int B, int H, int Hkv, int S, int L, int kv_len,
    int q_offset, int causal, int window, int head_dim, int is_bf16, float scale,
    void* stream) {
  if (head_dim != 64 && head_dim != 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides so = {o_b, o_h, o_s}, sdo = {do_b, do_h, do_s};
  const Strides st[7] = {{q_b, q_h, q_s}, {k_b, k_h, k_s}, {v_b, v_h, v_s}, sdo,
                         {dq_b, dq_h, dq_s}, {dk_b, dk_h, dk_s}, {dv_b, dv_h, dv_s}};
  const Mask m = {S, kv_len < L ? kv_len : L, q_offset, causal, window};
  const long long n_rows = (long long)B * H * S;
  float* dl = static_cast<float*>(delta);
  const unsigned blocks = (unsigned)((n_rows + 7) / 8);
  if (is_bf16)
    fa_bwd_delta<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), dl, so,
        sdo, H, S, head_dim, n_rows);
  else
    fa_bwd_delta<float><<<blocks, 256, 0, s>>>(static_cast<const float*>(o),
                                               static_cast<const float*>(dout), dl, so, sdo, H,
                                               S, head_dim, n_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* lz = static_cast<const float*>(lse);
  if (head_dim == 64)
    return launch_hd<64>(q, k, v, dout, lz, dl, dq, dk, dv, st, B, H, Hkv, S, L, m, is_bf16,
                         scale, s);
  return launch_hd<128>(q, k, v, dout, lz, dl, dq, dk, dv, st, B, H, Hkv, S, L, m, is_bf16,
                        scale, s);
}
