// flash_attention: causal / sliding-window GQA prefill attention with an
// online softmax; the (S, L) score matrix never reaches device memory.
//
// Replaces the TPU kernel flash_attention in
// src/repro/kernels/flash_attention.py (Pallas body _kernel).
//
// What bounds it on the H100: bytes. At the scoring path's shapes
// (gpt2-base: B = 16, H = 12, hd = 64, S = L = 33 or 513, bf16) q, k, v and
// o moved once take 0.0010 / 0.0151 ms at 3.35 TB/s, and the live pairs'
// 4·B·H·pairs·hd operations 0.0004 / 0.0065 ms on the bf16 tensor cores.
// What costs is data movement through registers and shared memory, and
// latency that nothing overlaps.
//
// The function: query row i sits at position q_offset + i; column j is live
// iff j < kv_len, j <= q_pos when causal, and j > q_pos − window when
// window > 0. KV head = h / (H / Hkv). A row with no live column gives 0.
//
// Design, bf16 (FlashAttention-2 on mma.sync): one block per (64-row query
// tile, head, batch), four warps of 16 query rows each. The grid's slowest
// axis is the query tile, walked from the last, so every head's heaviest
// causal tile starts before any lighter one. The TPU kernel carries
// (m, l, acc) across KV tiles in VMEM because its grid runs in order; here
// the KV axis is a loop inside the block and (m, l, acc) live in registers.
//   - Copies: the Q tile and 64-row K and V tiles go to shared memory by
//     cp.async, 16 bytes a thread, rows past the end zero-filled. K and V
//     have two stages: tile j + 1's copy is in flight while tile j is in
//     the tensor cores; one barrier a tile.
//   - Q's fragments are loaded once by ldmatrix and stay in registers, at
//     hd <= 128. At hd = 256 see the register plan below.
//   - S = Q·Kᵀ by mma.sync m16n8k16, K's fragments by ldmatrix from the
//     row-major tile.
//   - Softmax in base 2: scale·log2(e) and the running max are applied in
//     one FFMA, so each probability is one FFMA and one ex2.approx. Only
//     tiles that cross the causal diagonal, kv_len or the window's left edge
//     evaluate the mask; a warp skips a tile in which none of its rows has a
//     live column. The running max starts at −1e30, the TPU kernel's masking
//     constant, and masked scores get probability exactly 0. Each lane keeps
//     a partial row sum; the four lanes of a row add theirs once, at the end.
//   - P·V: the probabilities stay in registers, and in f32 as the TPU kernel
//     keeps them (it casts v to f32 and takes p·v in f32). One bf16 P errs by
//     up to 2^-8 of each probability, so P = P_hi + P_lo, two bf16 terms
//     (P_lo the rounded remainder: together within 2^-16 of P). The score
//     accumulators of two n8 tiles, split so, are the A operands of two
//     m16n8k16 products (warp_tile.cuh) against the same V fragments, into
//     the same f32 accumulators: a second P·V product a k-step, since all 16
//     rows of the A tile are live (flash_decode's spare rows do not exist
//     here). V's fragments come from its row-major tile by ldmatrix.trans.
// Shared memory: hd = 64 45 KB, hd = 112 75 KB, hd = 128 85 KB, hd = 256
// 168,960 B (one block an SM).
//
// Register plan at hd = 256 (paligemma-3b). Per lane, the hd-128 design
// would hold Q's fragments (16 rows x 256 bf16 over 32 lanes: 64
// registers), the output accumulators (16 x 256 f32: 128), the 64-column
// score tile (32) and P_hi, P_lo (8 a k-step): over Hopper's 255 a thread
// before any address. So at hd > 128 Q's fragments are not kept: each
// k-step of Q·Kᵀ re-reads its 16 x 16 A fragment from the Q tile, which
// stays in shared memory for the block's life, by one ldmatrix.x4 (4
// registers). That adds 8 KB of shared-memory reads a warp a KV tile beside
// the 32 KB of K it reads, and changes no sum: the KV step stays 64 columns,
// so scores, softmax, P_hi + P_lo and the output sums are those of the
// hd-128 design (tests/test_torch_kernels.py:fa_pv_mirror holds for both).
// ptxas for sm_90a (printed by chip_smoke.py's phase 1): 255 registers and
// 188 B of spill stores and loads (a 184 B stack frame), against 252
// registers and none at hd = 128; 168,960 B of dynamic shared memory. Its
// times beside SDPA's and its bound are in PERF.md. The f32 kernel at
// hd = 256: 244 registers, no spill.
//
// Head dims 64, 112 (zamba2-7b's shared attention), 128 and 256
// (paligemma-3b) are instantiated. hd = 112 is 7 k-steps of 16 in Q·Kᵀ and 14 n8 tiles of
// output, taken in pairs by ldmatrix.x4.trans in P·V (14 is even); the
// 7 k-steps are taken one at a time, so nothing pairs them. A row is
// HD + 8 = 120 elements, 240 bytes: 16-byte aligned for cp.async and
// ldmatrix, and eight rows 60 words apart start on banks 0, 28, 24, ..., 4,
// so an ldmatrix phase has no bank conflict (hd = 256: rows of 264
// elements, 132 words, banks 0, 4, ..., 28). The f32 kernel needs hd % 4
// == 0 (float4 rows) and hd % 8 == 0 (n8 output tiles); 112 and 256 are
// both. At hd = 256 its shared memory is 220,160 B, under the 232,448 B a
// block may opt in to, and its accumulators 128 registers a lane.
//
// Both element types can also write each row's log-sum-exp (a null pointer
// writes nothing; the output is the same either way), which the backward in
// flash_attention_bwd.cu reads.
//
// f32 keeps the CUDA-core design: the same tiling, K and Vᵀ loaded through
// registers, P through shared memory, both products as f32 FMAs (Hopper's
// tensor cores take f32 only as TF32). Scores, softmax and the output sum
// are f32 in both.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "warp_tile.cuh"

using namespace repro_torch;

namespace {

constexpr int kRowsQ = 64;    // query rows per block: 4 warps × 16
constexpr int kColsK = 64;    // KV columns per step
constexpr int kThreads = 128;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides { long long b, h, s; };   // in elements; the last dim is contiguous

// -- bf16: tensor cores, cp.async ----------------------------------------------

// Shared memory: Q [64][LD], then two stages of K [64][LD] and V [64][LD].
// LD = hd + 8: 16 bytes of padding put the eight rows of an ldmatrix on
// distinct banks and keep every row 16-byte aligned.
template <int HD>
struct TcLayout {
  static_assert(HD % 16 == 0 && (HD / 8) % 2 == 0, "k-steps of 16, n8 output tiles in pairs");
  static constexpr int LD = HD + 8;
  static constexpr int TILE = kColsK * LD;
  static constexpr int bytes = 2 * (kRowsQ * LD + 2 * 2 * TILE);
  // Q's fragments kept in registers for the block's life (hd <= 128), or
  // re-read from the Q tile at each k-step (hd = 256: the register plan)
  static constexpr bool Q_REGS = HD <= 128;
};

// Two probabilities as P_hi + P_lo: hi = (a, b) rounded to bf16, lo = the
// remainders (exact in f32) rounded to bf16, so hi + lo is within 2^-16 of
// (a, b); lo in the low half as pack_bf16 orders them.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - f.x, b - f.y);
}

// Starts the copy of rows [row0, row0 + 64) of a (nrows × HD) matrix, row
// stride ld, into a [64][HD + 8] tile; rows past nrows are zero-filled.
template <int HD>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long ld, int row0, int nrows) {
  constexpr int PER_ROW = HD / 8, LD = TcLayout<HD>::LD;
#pragma unroll
  for (int x = 0; x < 64 * PER_ROW / kThreads; ++x) {
    const int i = threadIdx.x + x * kThreads;
    const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
    const bool in = row0 + r < nrows;
    cp_async_16(dst + r * LD + c, src + (in ? row0 + r : 0) * ld + c, in ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, Strides sq, Strides sk, Strides sv, Strides so, int n_heads,
                     int n_kv_heads, int S, int L, int kv_len, int q_offset, int causal,
                     int window, float scale_log2) {
  using Lay = TcLayout<HD>;
  constexpr int LD = Lay::LD, KSTEPS = HD / 16, NO = HD / 8;
  constexpr bool Q_REGS = Lay::Q_REGS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kv_s = qs + kRowsQ * LD;            // stage st: K at 2·st·TILE, V after it

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // the grid's slowest axis walks the query tiles from the last: every head's
  // heaviest causal tile is scheduled before any lighter one
  const int s0 = (gridDim.z - 1 - blockIdx.z) * kRowsQ;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (n_heads / n_kv_heads);
  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + hk * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + hk * sv.h;
  __nv_bfloat16* ob = o + b * so.b + h * so.h;

  // the block's KV tiles
  const int kv_live = min(kv_len, L);
  int kv_end = kv_live;
  if (causal) kv_end = min(kv_end, q_offset + min(s0 + kRowsQ, S));
  int kv_begin = window > 0 ? max(0, q_offset + s0 - window + 1) : 0;
  kv_begin -= kv_begin % kColsK;
  const int n_tiles = kv_begin < kv_end ? (kv_end - kv_begin + kColsK - 1) / kColsK : 0;

  // this warp's rows r0 .. r0 + 15, their positions and the columns any of
  // them sees
  const int r0 = s0 + 16 * warp;
  const int p_lo = q_offset + r0, p_hi = p_lo + 15;
  const bool warp_live = r0 < S;
  const int w_end = causal ? min(kv_live, p_hi + 1) : kv_live;
  const int w_begin = window > 0 ? p_lo - window + 1 : 0;

  // Group s is tile s (the first also Q); every step commits one group, empty
  // or not, so that the count stays uniform.
  if (n_tiles > 0) {
    copy_tile<HD>(qs, qb, sq.s, s0, S);
    copy_tile<HD>(kv_s, kb, sk.s, kv_begin, L);
    copy_tile<HD>(kv_s + Lay::TILE, vb, sv.s, kv_begin, L);
  }
  cp_async_commit();

  // rows g ([0]) and g + 8 ([1]): the running max of the scaled scores
  // (base 2), this lane's partial sum; the output sums. qf: Q's fragments,
  // all k-steps (Q_REGS) or the current one
  const __nv_bfloat16* qw = qs + 16 * warp * LD + a_rows(LD);
  uint32_t qf[Q_REGS ? KSTEPS : 1][4];
  float mrow[2] = {kNegInf, kNegInf}, lrow[2] = {0.f, 0.f}, oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = kv_begin + it * kColsK;
    cp_async_wait<0>();
    __syncthreads();   // tile it is visible to all, and every warp is done with tile it - 1
    if (Q_REGS && it == 0) {
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s) ldmatrix_x4(qf[Q_REGS ? s : 0], qw + 16 * s);
    }
    {   // tile it + 1 into the stage tile it - 1 used; one group a step, empty or not
      if (it + 1 < n_tiles) {
        __nv_bfloat16* nxt = kv_s + ((it + 1) & 1) * 2 * Lay::TILE;
        copy_tile<HD>(nxt, kb, sk.s, j0 + kColsK, L);
        copy_tile<HD>(nxt + Lay::TILE, vb, sv.s, j0 + kColsK, L);
      }
      cp_async_commit();
    }
    if (!warp_live || j0 >= w_end || j0 + kColsK <= w_begin) continue;   // nothing live here
    const __nv_bfloat16* ks = kv_s + (it & 1) * 2 * Lay::TILE;
    const __nv_bfloat16* vs = ks + Lay::TILE;

    const bool masked = j0 + kColsK > kv_live || (causal && j0 + kColsK - 1 > p_lo) ||
                        (window > 0 && j0 < p_hi - window + 1);

    // S = Q·Kᵀ: eight n8 tiles of raw scores
    float sa[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) sa[j][0] = sa[j][1] = sa[j][2] = sa[j][3] = 0.f;
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      if (!Q_REGS) ldmatrix_x4(qf[0], qw + 16 * s);
      const uint32_t(&qa)[4] = qf[Q_REGS ? s : 0];
#pragma unroll
      for (int pair = 0; pair < 4; ++pair) {
        uint32_t bf[4];
        ldmatrix_x4(bf, ks + b_rows(LD) + 16 * pair * LD + 16 * s);
        mma_bf16(sa[2 * pair], qa, bf[0], bf[1]);
        mma_bf16(sa[2 * pair + 1], qa, bf[2], bf[3]);
      }
    }

    if (masked) {
      const int pa = p_lo + g, pb = pa + 8;   // the positions of rows g, g + 8
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = j0 + 8 * j + 2 * t + e;
          const bool in = col < kv_live;
          if (!(in && (!causal || col <= pa) && (window <= 0 || col > pa - window)))
            sa[j][e] = -INFINITY;
          if (!(in && (!causal || col <= pb) && (window <= 0 || col > pb - window)))
            sa[j][2 + e] = -INFINITY;
        }
    }
    float xa = -INFINITY, xb = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      xa = fmaxf(xa, fmaxf(sa[j][0], sa[j][1]));
      xb = fmaxf(xb, fmaxf(sa[j][2], sa[j][3]));
    }
    // the running max never drops below -1e30, so exp2(-inf - m) is exactly 0
    const float mna = fmaxf(mrow[0], quad_max(xa) * scale_log2);
    const float mnb = fmaxf(mrow[1], quad_max(xb) * scale_log2);
    const float alpha_a = exp2_approx(mrow[0] - mna), alpha_b = exp2_approx(mrow[1] - mnb);
    mrow[0] = mna;
    mrow[1] = mnb;
    float suma = 0.f, sumb = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sa[j][0] = exp2_approx(fmaf(sa[j][0], scale_log2, -mna));
      sa[j][1] = exp2_approx(fmaf(sa[j][1], scale_log2, -mna));
      sa[j][2] = exp2_approx(fmaf(sa[j][2], scale_log2, -mnb));
      sa[j][3] = exp2_approx(fmaf(sa[j][3], scale_log2, -mnb));
      suma += sa[j][0] + sa[j][1];
      sumb += sa[j][2] + sa[j][3];
    }
    lrow[0] = lrow[0] * alpha_a + suma;
    lrow[1] = lrow[1] * alpha_b + sumb;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      oacc[n][0] *= alpha_a; oacc[n][1] *= alpha_a;
      oacc[n][2] *= alpha_b; oacc[n][3] *= alpha_b;
    }

    // O += P·V: P (in sa) split into P_hi + P_lo, two bf16 A operands against
    // the same V fragments (ldmatrix.trans from V's row-major tile)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {   // depth: the tile's columns 16·kk .. 16·kk + 15
      uint32_t ph[4], pl[4];
      split_bf16(sa[2 * kk][0], sa[2 * kk][1], ph[0], pl[0]);
      split_bf16(sa[2 * kk][2], sa[2 * kk][3], ph[1], pl[1]);
      split_bf16(sa[2 * kk + 1][0], sa[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(sa[2 * kk + 1][2], sa[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vs + b_cols(LD) + 16 * kk * LD + 8 * n);
        mma_bf16(oacc[n], ph, bf[0], bf[1]);
        mma_bf16(oacc[n + 1], ph, bf[2], bf[3]);
        mma_bf16(oacc[n], pl, bf[0], bf[1]);
        mma_bf16(oacc[n + 1], pl, bf[2], bf[3]);
      }
    }
  }

  const int ra = r0 + g, rb = ra + 8;
  const float la = quad_sum(lrow[0]), lb = quad_sum(lrow[1]);
  const float ia = 1.f / fmaxf(la, 1e-30f);
  const float ib = 1.f / fmaxf(lb, 1e-30f);
  if (lse != nullptr && t == 0) {   // natural log of the row's sum over scaled scores
    float* lr = lse + ((long long)b * n_heads + h) * S;
    if (ra < S) lr[ra] = (mrow[0] + log2f(fmaxf(la, 1e-30f))) * kLn2;
    if (rb < S) lr[rb] = (mrow[1] + log2f(fmaxf(lb, 1e-30f))) * kLn2;
  }
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int d = 8 * n + 2 * t;
    if (ra < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + ra * so.s + d) =
          __floats2bfloat162_rn(oacc[n][0] * ia, oacc[n][1] * ia);
    if (rb < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + rb * so.s + d) =
          __floats2bfloat162_rn(oacc[n][2] * ib, oacc[n][3] * ib);
  }
}

// -- f32: CUDA cores -----------------------------------------------------------

// Shared memory: Q and K tiles [64][LDQ], Vᵀ tile [HD][LDV], one P tile
// [16][LDV] per warp. The padding keeps fragment loads on distinct banks
// and rows 16-byte aligned.
template <int HD>
struct F32Layout {
  static constexpr int LDQ = HD + 4;
  static constexpr int LDV = kColsK + 4;
  static constexpr int bytes =
      (int)sizeof(float) * (kRowsQ * LDQ + kColsK * LDQ + HD * LDV + 4 * 16 * LDV);
};

// Vᵀ[d][r] = V[j0 + r][d] for r < 64, zero past the last row.
template <int HD>
__device__ __forceinline__ void load_vt(float* vt, int ldv, const float* src, long long ld,
                                        int j0, int nrows) {
  constexpr int PER_ROW = HD / 4;
  for (int i = threadIdx.x; i < kColsK * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 4;
    float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j0 + r < nrows) u = *reinterpret_cast<const float4*>(src + (j0 + r) * ld + c);
    vt[(c + 0) * ldv + r] = u.x;
    vt[(c + 1) * ldv + r] = u.y;
    vt[(c + 2) * ldv + r] = u.z;
    vt[(c + 3) * ldv + r] = u.w;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                    Strides sq, Strides sk, Strides sv, Strides so,
                    int n_heads, int n_kv_heads, int S, int L, int kv_len,
                    int q_offset, int causal, int window, float scale) {
  using Lay = F32Layout<HD>;
  constexpr int LDQ = Lay::LDQ, LDV = Lay::LDV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + kRowsQ * LDQ;
  float* vt = ks + kColsK * LDQ;
  float* ps = vt + HD * LDV;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int s0 = blockIdx.x * kRowsQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (n_heads / n_kv_heads);
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + hk * sk.h;
  const float* vb = v + b * sv.b + hk * sv.h;
  float* ob = o + b * so.b + h * so.h;

  load_tile<float, kRowsQ, HD, kThreads>(qs, LDQ, qb, sq.s, s0, S, 0, HD);

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
  float* pw = ps + warp * 16 * LDV;

  for (int j0 = kv_begin; j0 < kv_end; j0 += kColsK) {
    __syncthreads();   // the previous step's K, Vᵀ and P tiles are consumed
    load_tile<float, kColsK, HD, kThreads>(ks, LDQ, kb, sk.s, j0, L, 0, HD);
    load_vt<HD>(vt, LDV, vb, sv.s, j0, L);
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
        pw[g * LDV + 8 * j + 2 * t + e] = p_a;
        pw[(g + 8) * LDV + 8 * j + 2 * t + e] = p_b;
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
  if (lse != nullptr && t == 0) {
    float* lr = lse + ((long long)b * n_heads + h) * S;
    if (ra < S) lr[ra] = ma + logf(da);
    if (rb < S) lr[rb] = mb + logf(db);
  }
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = 8 * n + 2 * t + e;
      if (ra < S) ob[ra * so.s + d] = oacc[n][e] / da;
      if (rb < S) ob[rb * so.s + d] = oacc[n][2 + e] / db;
    }
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, float* lse, const Strides* st, int B,
              int H, int Hkv, int S, int L, int kv_len, int q_offset, int causal, int window,
              int is_bf16, float scale, cudaStream_t stream) {
  if (is_bf16) {
    const dim3 grid(H, B, (S + kRowsQ - 1) / kRowsQ);
    auto kern = flash_attention_bf16<HD>;
    constexpr int bytes = TcLayout<HD>::bytes;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    using T = __nv_bfloat16;
    kern<<<grid, kThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), lse, st[0], st[1], st[2], st[3], H, Hkv, S, L, kv_len, q_offset, causal,
        window, scale * kLog2e);
  } else {
    const dim3 grid((S + kRowsQ - 1) / kRowsQ, H, B);
    auto kern = flash_attention_f32<HD>;
    constexpr int bytes = F32Layout<HD>::bytes;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, kThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), lse, st[0], st[1], st[2], st[3], H, Hkv, S, L, kv_len, q_offset,
        causal, window, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (B, H, S, hd); k, v: (B, Hkv, L, hd), each given by its (b, h, s)
// strides in elements with hd contiguous; lse, if not null, (B, H, S) f32
// contiguous: each row's natural log-sum-exp of its scaled live scores
// (below -1e29 for a row with no live column). Returns cudaGetLastError()
// after the launch (0 on success), or cudaErrorInvalidValue for a head dim
// without a template (64, 112, 128 and 256 have one).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, void* lse,
    long long q_b, long long q_h, long long q_s, long long k_b, long long k_h, long long k_s,
    long long v_b, long long v_h, long long v_s, long long o_b, long long o_h, long long o_s,
    int B, int H, int Hkv, int S, int L, int kv_len, int q_offset, int causal, int window,
    int head_dim, int is_bf16, float scale, void* stream) {
  const Strides st[4] = {{q_b, q_h, q_s}, {k_b, k_h, k_s}, {v_b, v_h, v_s}, {o_b, o_h, o_s}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch_hd<64>(q, k, v, o, static_cast<float*>(lse), st, B, H, Hkv, S, L, kv_len, q_offset, causal, window,
                         is_bf16, scale, s);
  if (head_dim == 112)
    return launch_hd<112>(q, k, v, o, static_cast<float*>(lse), st, B, H, Hkv, S, L, kv_len, q_offset, causal, window,
                          is_bf16, scale, s);
  if (head_dim == 128)
    return launch_hd<128>(q, k, v, o, static_cast<float*>(lse), st, B, H, Hkv, S, L, kv_len, q_offset, causal, window,
                          is_bf16, scale, s);
  if (head_dim == 256)
    return launch_hd<256>(q, k, v, o, static_cast<float*>(lse), st, B, H, Hkv, S, L, kv_len, q_offset, causal, window,
                          is_bf16, scale, s);
  return (int)cudaErrorInvalidValue;
}
