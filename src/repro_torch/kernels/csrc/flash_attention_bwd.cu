// flash_attention_bwd: dQ, dK and dV of flash_attention (causal / sliding-
// window GQA with q_offset and kv_len), in the FlashAttention form: the
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
// products, 5 per live pair and head (the scores again, dP, dV, dK, dQ)
// where the forward has 2; at gpt2-base's 33 positions the bytes, and in
// practice launch latency.
//
// bf16: one pass on TMA, mbarriers and wgmma (the FlashAttention-3 form),
// three launches:
//   1. fa_bwd_prep: one warp per query row (padded to 64): D, the saved
//      log-sum-exp in log2 units, and the row of an f32 dQ scratch zeroed.
//   2. fa_bwd_bf16: one block per (128-row KV tile, KV head, batch row), the
//      tiles that the most queries see first. Three warpgroups:
//      - Warpgroup 2 produces: after setmaxnreg gives its registers away (24
//        a thread), one thread loads the K and V tiles once by TMA and then
//        keeps a ring of 2 stages in flight: the Q and dO tiles (64 query
//        rows), the rows' log-sum-exp and D, over the KV head's G query
//        heads and only the query tiles the masks let see the KV tile. Rows
//        past S and L arrive as TMA's zeros (the tensor maps end there);
//        strided q/k/v/dO are read through 4-d maps.
//      - Warpgroups 0 and 1 (240 registers a thread) own 64 KV rows each.
//        Per query tile each computes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (wgmma
//        m64n64k16, both operands K-major in shared memory), Pᵀ and dSᵀ on
//        the accumulators (exp2 with scale·log2 e folded into one FFMA; the
//        mask only on tiles that cross the diagonal, the window's edge,
//        kv_len or S; an LSE below -1e29 on a masked row gives P = 0), rounds
//        them to bf16 and uses them as the register A operand of dV += Pᵀ·dO
//        (issued while dS is computed) and dK += dSᵀ·Q (dO and Q read
//        MN-major from the same tiles). dK and dV stay in registers across
//        the whole loop, so GQA sums over a KV head's query heads without
//        atomics.
//      - dSᵀ also goes to shared memory (the 128-byte swizzle, double
//        buffered), and dQ_tile = dS·K is one more wgmma read MN-major from
//        it and from the K tile: at hd 128 each warpgroup takes 64 of dQ's
//        128 columns over both warpgroups' 128 KV rows (a named barrier
//        between them a step); at hd 64 each takes all 64 columns over its
//        own 64 rows. The 64 × 64 f32 share goes from registers into the
//        scratch by 16-byte atomic adds (red.global.add.v4.f32), in register
//        order so that a warp's adds cover 512 contiguous bytes: a row-major
//        scratch (32 bytes of 16 rows an add) is 25% slower on the H100
//        (tools/backward_variants.py, row_major_dq), and staging the share
//        in shared memory for one bulk reduce-add was slower too, its wait
//        for the shared memory to be read back holding the warpgroup. dQ's
//        sum over KV tiles therefore runs in the order the blocks reach it:
//        it changes from run to run by f32 rounding, where dK and dV do not.
//      This removes the second kernel of the mma.sync design and its second
//      S and dP: 10·hd operations a live pair and head instead of 14·hd.
//      Shared memory: hd 112 and 128 165,928 B, hd 64 100,392 B (one block an SM:
//      384 threads at 168 registers on entry fill the register file).
//   3. fa_bwd_dq_out: the scratch (register order) times scale into dq's dtype
//      and strides.
// Head dim 112 (zamba2-7b's shared attention) runs the hd-128 code on a tile
// padded to 128 columns in shared memory: the tensor maps end at column 112,
// so TMA fills columns 112-127 of Q, K, V and dO's second 64-column block
// with zeros. Sᵀ and dPᵀ take only the 7 k-steps of 16 that hold data; dV,
// dK and dQ are computed 128 wide (their columns 112-127 come out 0) and
// those columns are never stored. The dQ scratch rows are 128 floats wide
// (Smem<HD>::HP), not HD. A native 112-wide product (wgmma n = 112) would
// save the padded eighth of dV, dK and dQ's products.
// f32: three kernels on the CUDA cores, none with atomics (deterministic):
// fa_bwd_delta (D), fa_bwd_dkdv_f32 (a block per 32-row KV tile over its KV
// head's query heads) and fa_bwd_dq_f32 (a block per 32-row query tile);
// it is the reference of the CPU-against-card check, not a fast path.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "warp_tile.cuh"

using namespace repro_torch;

namespace {

constexpr int kThreads = 128;   // f32 kernels
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

// -- D = rowsum(dO ∘ O) (f32) ------------------------------------------------------------

__global__ void fa_bwd_delta(const float* __restrict__ o, const float* __restrict__ dout,
                             float* __restrict__ delta, Strides so, Strides sd, int H, int S,
                             int hd, long long n_rows) {
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int i = (int)(row % S);
  const long long bh = row / S;
  const int h = (int)(bh % H), b = (int)(bh / H);
  const float* op = o + b * so.b + h * so.h + i * so.s;
  const float* dp = dout + b * sd.b + h * sd.h + i * sd.s;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc += op[d] * dp[d];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// -- bf16: TMA, mbarriers and wgmma ----------------------------------------------------

constexpr int kBc = 128;               // KV rows a block: two consumer warpgroups of 64
constexpr int kBr = 64;                // query rows a step
constexpr int kStages = 2;
constexpr int kBf16Threads = 384;      // two consumer warpgroups, one producer
enum : int { kBarDs = 1, kBarWg = 2 };  // named barriers: both consumers; kBarWg + wg: one

// Shared memory of fa_bwd_bf16, in bytes from a 1024-aligned base: K, V, the
// ring's stages (Q then dO), two dSᵀ buffers (128 KV rows × 64 queries), the
// stages' lse and D, mbarriers.
// A tile of HD columns is HP / 64 column blocks of 128-byte rows, HP = HD
// rounded up to 64 (112 -> 128: the last 16 columns TMA's zeros).
template <int HD>
struct Smem {
  static constexpr int HP = (HD + 63) / 64 * 64;    // padded head dim
  static constexpr int KV_BLOCK = kBc * 128;         // one column block of K or V
  static constexpr int Q_BLOCK = kBr * 128;          // one column block of Q or dO
  static constexpr int KV_BYTES = HP / 64 * KV_BLOCK;
  static constexpr int Q_BYTES = HP / 64 * Q_BLOCK;
  static constexpr int DS_BYTES = kBc * 128;
  static constexpr int K = 0, V = KV_BYTES, RING = 2 * KV_BYTES;
  static constexpr int DS = RING + kStages * 2 * Q_BYTES;
  static constexpr int LD = DS + 2 * DS_BYTES;
  static constexpr int BARS = LD + kStages * 2 * kBr * 4;
  static constexpr int bytes = BARS + (2 * kStages + 1) * 8 + 1024;   // + room to align
  static_assert(bytes <= 232448, "a block may use 232,448 bytes of shared memory");
};

// Whether every (query, key) pair of the query rows [i0, i0 + 64) and the key
// rows [j0, j0 + 64) is live: such a tile skips the mask.
__device__ __forceinline__ bool all_live(const Mask& m, int i0, int j0) {
  return i0 + 64 <= m.S && j0 + 64 <= m.kv_live && (!m.causal || j0 + 63 <= m.q_offset + i0) &&
         (m.window <= 0 || j0 > m.q_offset + i0 + 63 - m.window);
}

// One warp per padded query row: D (0 past S), the log-sum-exp in log2 units
// (0 past S: those rows are masked) and the row's HP floats of the dQ
// scratch set to 0.
template <int HD>
__global__ void fa_bwd_prep(const __nv_bfloat16* __restrict__ o,
                            const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                            float* __restrict__ lse2, float* __restrict__ dl,
                            float* __restrict__ dq_acc, Strides so, Strides sd, int H, int S,
                            int S_pad, long long n_rows) {
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int i = (int)(row % S_pad);
  const long long bh = row / S_pad;
  const int h = (int)(bh % H), b = (int)(bh / H);
  float acc = 0.f;
  if (i < S) {
    const __nv_bfloat16* op = o + b * so.b + h * so.h + i * so.s;
    const __nv_bfloat16* dp = dout + b * sd.b + h * sd.h + i * sd.s;
    for (int d = 2 * lane; d < HD; d += 64) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(op + d));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dp + d));
      acc += x.x * y.x + x.y * y.y;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    dl[row] = acc;
    lse2[row] = i < S ? lse[bh * S + i] * kLog2e : 0.f;
  }
  constexpr int HP = Smem<HD>::HP;
  if (4 * lane < HP)
    reinterpret_cast<float4*>(dq_acc + row * HP)[lane] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// One thread of the producer warpgroup: K and V once, then the block's query
// tiles through the ring.
template <int HD>
__device__ __forceinline__ void produce(uint8_t* smem, uint64_t* full, uint64_t* empty,
                                        uint64_t* kvbar, const CUtensorMap* tm_q,
                                        const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                        const CUtensorMap* tm_do, const float* lse2,
                                        const float* dl, int hk, int b, int j0, int G,
                                        int i_begin, int n_qt, int n_it, int H, int S_pad) {
  using Sm = Smem<HD>;
  mbar_expect_tx(kvbar, 2 * Sm::KV_BYTES);   // a box past column HD counts whole
#pragma unroll
  for (int cb = 0; cb < Sm::HP / 64; ++cb) {
    tma_load_4d(smem + Sm::K + cb * Sm::KV_BLOCK, tm_k, kvbar, 64 * cb, j0, hk, b);
    tma_load_4d(smem + Sm::V + cb * Sm::KV_BLOCK, tm_v, kvbar, 64 * cb, j0, hk, b);
  }
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < n_it; ++it) {
    const int h = hk * G + it / n_qt, i0 = i_begin + (it % n_qt) * kBr;
    mbar_wait(&empty[stage], phase ^ 1);
    mbar_expect_tx(&full[stage], 2 * Sm::Q_BYTES + 2 * kBr * 4);
    uint8_t* qs = smem + Sm::RING + stage * 2 * Sm::Q_BYTES;
#pragma unroll
    for (int cb = 0; cb < Sm::HP / 64; ++cb) {
      tma_load_4d(qs + cb * Sm::Q_BLOCK, tm_q, &full[stage], 64 * cb, i0, h, b);
      tma_load_4d(qs + Sm::Q_BYTES + cb * Sm::Q_BLOCK, tm_do, &full[stage], 64 * cb, i0, h, b);
    }
    const long long row = ((long long)b * H + h) * S_pad + i0;
    float* ld = reinterpret_cast<float*>(smem + Sm::LD) + stage * 2 * kBr;
    bulk_load(ld, lse2 + row, kBr * 4, &full[stage]);
    bulk_load(ld + kBr, dl + row, kBr * 4, &full[stage]);
    if (++stage == kStages) { stage = 0; phase ^= 1; }
  }
}

// d (64 × HD) = A · B (+ d if scale_d) with A from registers and B MN-major:
// the dV and dK products.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  wgmma_m64n64k16_rs(d, a, db, scale_d);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  wgmma_m64n128k16_rs(d, a, db, scale_d);
}

// A consumer warpgroup (wg 0 or 1): KV rows [j0 + 64·wg, +64) of the block.
template <int HD>
__device__ __forceinline__ void consume(uint8_t* smem, uint64_t* full, uint64_t* empty,
                                        uint64_t* kvbar, float* __restrict__ dq_acc,
                                        __nv_bfloat16* __restrict__ dk,
                                        __nv_bfloat16* __restrict__ dv, Strides sdk, Strides sdv,
                                        int wg, int hk, int b, int j0, int G, int i_begin,
                                        int n_qt, int n_it, int H, int L, int S_pad, Mask m,
                                        float scale, float c) {
  using Sm = Smem<HD>;
  constexpr int HP = Sm::HP;
  constexpr int NO = HP / 2;                 // accumulator floats of a 64 × HP product
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int jw0 = j0 + 64 * wg;              // this warpgroup's first KV row
  const int ja = jw0 + 16 * warp + g, jb = ja + 8;   // this lane's two KV rows
  const uint32_t base = smem_u32(smem);
  const uint32_t k_rows = base + Sm::K + 64 * wg * 128, v_rows = base + Sm::V + 64 * wg * 128;
  const float* ld_all = reinterpret_cast<const float*>(smem + Sm::LD);
  float dva[NO], dka[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dva[i] = dka[i] = 0.f;

  if (n_it > 0) mbar_wait(kvbar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < n_it; ++it) {
    const int h = hk * G + it / n_qt, i0 = i_begin + (it % n_qt) * kBr;
    mbar_wait(&full[stage], phase);
    const uint32_t qs = base + Sm::RING + stage * 2 * Sm::Q_BYTES, dos = qs + Sm::Q_BYTES;
    const float* lse_s = ld_all + stage * 2 * kBr;
    const float* dl_s = lse_s + kBr;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: this warpgroup's 64 KV rows × the tile's 64
    // queries, over the HD / 16 k-steps that hold data
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t ka = (kk >> 2) * Sm::KV_BLOCK + (kk & 3) * 32;
      const uint32_t qa = (kk >> 2) * Sm::Q_BLOCK + (kk & 3) * 32;
      wgmma_m64n64k16_ss<0, 0>(s, desc_k_major(k_rows + ka), desc_k_major(qs + qa), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t ka = (kk >> 2) * Sm::KV_BLOCK + (kk & 3) * 32;
      const uint32_t qa = (kk >> 2) * Sm::Q_BLOCK + (kk & 3) * 32;
      wgmma_m64n64k16_ss<0, 0>(dp, desc_k_major(v_rows + ka), desc_k_major(dos + qa), kk > 0);
    }
    wgmma_commit();

    // Pᵀ, while dPᵀ is still in the tensor cores; column 8n + 2t + e is query i0 + that
    const bool edge = !all_live(m, i0, jw0);
    wgmma_wait<1>();
    fence_regs(s);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float l = e ? l2.y : l2.x;
        float pa = exp2_approx(fmaf(s[4 * n + e], c, -l));
        float pb = exp2_approx(fmaf(s[4 * n + 2 + e], c, -l));
        if (edge) {
          const int i = i0 + 8 * n + 2 * t + e;
          if (!m.live(i, ja)) pa = 0.f;
          if (!m.live(i, jb)) pb = 0.f;
        }
        s[4 * n + e] = pa;
        s[4 * n + 2 + e] = pb;
      }
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int x = 0; x < 4; ++x) pa[k][x] = pack_bf16(s[8 * k + 2 * x], s[8 * k + 2 * x + 1]);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma_rs(dva, pa[k], desc_mn_major(dos + k * 2048, Sm::Q_BLOCK), 1);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(dp);
#pragma unroll
    for (int n = 0; n < 8; ++n) {   // dSᵀ = Pᵀ ∘ (dPᵀ - D)
      const float2 d2 = *reinterpret_cast<const float2*>(dl_s + 8 * n + 2 * t);
      dp[4 * n] = s[4 * n] * (dp[4 * n] - d2.x);
      dp[4 * n + 1] = s[4 * n + 1] * (dp[4 * n + 1] - d2.y);
      dp[4 * n + 2] = s[4 * n + 2] * (dp[4 * n + 2] - d2.x);
      dp[4 * n + 3] = s[4 * n + 3] * (dp[4 * n + 3] - d2.y);
    }
    // Pᵀ and dSᵀ in bf16 as A operands: k16 step k covers queries 16k .. 16k + 15
    uint32_t da[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int x = 0; x < 4; ++x) da[k][x] = pack_bf16(dp[8 * k + 2 * x], dp[8 * k + 2 * x + 1]);
    // dSᵀ into shared memory in the 128-byte swizzle: the 16-byte chunk of
    // n8 tile n in row r lies at chunk n ^ (r % 8), and r % 8 = g
    uint8_t* dsb = smem + Sm::DS + (it & 1) * Sm::DS_BYTES;
    const int r0 = 64 * wg + 16 * warp + g, r1 = r0 + 8;
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int chunk = ((2 * k + hh) ^ g) << 4;
        *reinterpret_cast<uint32_t*>(dsb + r0 * 128 + chunk + 4 * t) = da[k][2 * hh];
        *reinterpret_cast<uint32_t*>(dsb + r1 * 128 + chunk + 4 * t) = da[k][2 * hh + 1];
      }
    fence_proxy_async();

    // dV += Pᵀ·dO, dK += dSᵀ·Q: the depth is the tile's query rows
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma_rs(dka, da[k], desc_mn_major(qs + k * 2048, Sm::Q_BLOCK), 1);
    wgmma_commit();

    // this warpgroup's share of dQ_tile = dS·K (A = dSᵀ read MN-major)
    float dq[32];
    const uint32_t dsa = smem_u32(dsb);
    if constexpr (HP == 128) {   // columns [64·wg, +64) over all 128 KV rows
      bar_sync(kBarDs, 256);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBc / 16; ++kk)
        wgmma_m64n64k16_ss<1, 1>(dq, desc_mn_major(dsa + kk * 2048, Sm::DS_BYTES),
                                 desc_mn_major(base + Sm::K + wg * Sm::KV_BLOCK + kk * 2048,
                                               Sm::KV_BLOCK), kk > 0);
    } else {                     // all 64 columns over this warpgroup's 64 KV rows
      bar_sync(kBarWg + wg, 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_ss<1, 1>(dq, desc_mn_major(dsa + 64 * wg * 128 + kk * 2048, Sm::DS_BYTES),
                                 desc_mn_major(base + Sm::K + 64 * wg * 128 + kk * 2048,
                                               Sm::KV_BLOCK), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    fence_regs(dq);
    fence_regs(pa);
    fence_regs(da);
    release(&empty[stage]);

    // the share added into the f32 scratch in register order (see
    // fa_bwd_dq_out): 16-byte atomic adds (red.global.add.v4.f32), a warp's
    // 512 bytes side by side
    {
      float4* dst = reinterpret_cast<float4*>(
          dq_acc + (((long long)b * H + h) * S_pad + i0) * HP + (HP == 128 ? 64 * 64 * wg : 0));
#pragma unroll
      for (int x = 0; x < 8; ++x)
        atomicAdd(dst + x * 128 + tid,
                  make_float4(dq[4 * x], dq[4 * x + 1], dq[4 * x + 2], dq[4 * x + 3]));
    }
    if (++stage == kStages) { stage = 0; phase ^= 1; }
  }

  __nv_bfloat16* dkb = dk + b * sdk.b + hk * sdk.h;
  __nv_bfloat16* dvb = dv + b * sdv.b + hk * sdv.h;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {         // columns past HD (all 0) are not stored
    const int d = 8 * n + 2 * t;
    if (ja < L) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + ja * sdk.s + d) =
          __floats2bfloat162_rn(dka[4 * n] * scale, dka[4 * n + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + ja * sdv.s + d) =
          __floats2bfloat162_rn(dva[4 * n], dva[4 * n + 1]);
    }
    if (jb < L) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + jb * sdk.s + d) =
          __floats2bfloat162_rn(dka[4 * n + 2] * scale, dka[4 * n + 3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + jb * sdv.s + d) =
          __floats2bfloat162_rn(dva[4 * n + 2], dva[4 * n + 3]);
    }
  }
}

// c = scale · log2 e. Block (KV head, batch row, KV tile).
template <int HD>
__global__ void __launch_bounds__(kBf16Threads, 1)
fa_bwd_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
            const float* __restrict__ lse2, const float* __restrict__ dl,
            float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dk,
            __nv_bfloat16* __restrict__ dv, Strides sdk, Strides sdv, int H, int Hkv, int L,
            int S_pad, Mask m, float scale, float c) {
  using Sm = Smem<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Sm::BARS);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = empty + kStages;

  const int hk = blockIdx.x, b = blockIdx.y, j0 = blockIdx.z * kBc;
  const int G = H / Hkv;
  int i_begin, i_end;
  query_range(m, j0, kBc, kBr, &i_begin, &i_end);
  const int n_qt = i_begin < i_end ? (i_end - i_begin + kBr - 1) / kBr : 0;
  const int n_it = G * n_qt;                 // (query head, query tile) steps, head-major

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);               // one arrival per consumer warp
    }
    mbar_init(kvbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // the warpgroup index, from lane 0 so that the compiler sees it is uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256 && n_it > 0)
      produce<HD>(smem, full, empty, kvbar, &tm_q, &tm_k, &tm_v, &tm_do, lse2, dl, hk, b, j0, G,
                  i_begin, n_qt, n_it, H, S_pad);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    consume<HD>(smem, full, empty, kvbar, dq_acc, dk, dv, sdk, sdv, wg, hk, b, j0, G, i_begin,
                n_qt, n_it, H, L, S_pad, m, scale, c);
  }
}

// dq = scale · the f32 scratch. Per (batch row, head, 64-row query tile) it
// holds HP / 64 shares of 64 × 64 (hd 112 and 128: columns [64w, +64); hd
// 64: one), each in register order: float4 x of consumer thread tid =
// 32·warp + 4g + t at (x · 128 + tid) · 4 holds rows 16·warp + g and + 8,
// columns 8x + 2t and + 1 of the share. One thread per float4, read side by
// side; columns past HD are skipped.
template <int HD>
__global__ void fa_bwd_dq_out(const float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dq,
                              Strides sdq, int H, int S, int S_pad, float scale,
                              long long n_vec) {
  constexpr int HP = Smem<HD>::HP;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_vec) return;
  const int tid = (int)(idx % 128), x = (int)((idx / 128) % 8);
  const long long share = idx / 1024;              // (bh, tile, w), w fastest
  const int w = (int)(share % (HP / 64));
  const long long tile = share / (HP / 64);
  const int tiles = S_pad / 64;
  const int i = (int)(tile % tiles) * 64 + 16 * (tid >> 5) + ((tid & 31) >> 2);
  const int col = 64 * w + 8 * x + 2 * (tid & 3);
  if (i >= S || col >= HD) return;
  const long long bh = tile / tiles;
  const int h = (int)(bh % H), b = (int)(bh / H);
  const float4 v = reinterpret_cast<const float4*>(dq_acc)[idx];
  __nv_bfloat16* out = dq + b * sdq.b + h * sdq.h + col;
  *reinterpret_cast<__nv_bfloat162*>(out + i * sdq.s) =
      __floats2bfloat162_rn(v.x * scale, v.y * scale);
  if (i + 8 < S)
    *reinterpret_cast<__nv_bfloat162*>(out + (i + 8) * sdq.s) =
        __floats2bfloat162_rn(v.z * scale, v.w * scale);
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

// The four tensor maps of a bf16 call: q and dO (box 64 rows), k and v
// (box 128 rows), each (hd, rows, heads, batch) with its strides.
bool bwd_maps(CUtensorMap* maps, const void* q, const void* k, const void* v, const void* dout,
              const Strides* st, int B, int H, int Hkv, int S, int L, int hd) {
  const long long qd[4] = {hd, S, H, B}, kd[4] = {hd, L, Hkv, B};
  const void* base[4] = {q, k, v, dout};   // st[0..3]: the same four
  for (int x = 0; x < 4; ++x) {
    const long long strides[3] = {st[x].s, st[x].h, st[x].b};
    const bool is_q = x == 0 || x == 3;
    if (!bf16_map(&maps[x], base[x], 4, is_q ? qd : kd, strides, is_q ? kBr : kBc)) return false;
  }
  return true;
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, const void* o, const void* dout,
                const float* lse, float* work, void* dq, void* dk, void* dv, const Strides* st,
                const Strides& so, int B, int H, int Hkv, int S, int L, const Mask& m,
                float scale, cudaStream_t stream) {
  // st: q, k, v, dout, dq, dk, dv
  using T = __nv_bfloat16;
  CUtensorMap maps[4];
  if (!bwd_maps(maps, q, k, v, dout, st, B, H, Hkv, S, L, HD)) return (int)cudaErrorInvalidValue;
  const int S_pad = (S + kBr - 1) / kBr * kBr;
  const long long n_rows = (long long)B * H * S_pad;
  float* lse2 = work;
  float* dl = work + n_rows;
  float* dq_acc = work + 2 * n_rows;
  fa_bwd_prep<HD><<<(unsigned)((n_rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, lse2, dl, dq_acc, so, st[3], H,
      S, S_pad, n_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  static bool attr = false;
  if (!attr) {
    err = cudaFuncSetAttribute(fa_bwd_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Smem<HD>::bytes);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  fa_bwd_bf16<HD><<<dim3(Hkv, B, (L + kBc - 1) / kBc), kBf16Threads, Smem<HD>::bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse2, dl, dq_acc, static_cast<T*>(dk),
      static_cast<T*>(dv), st[5], st[6], H, Hkv, L, S_pad, m, scale, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n_vec = n_rows * Smem<HD>::HP / 4;
  fa_bwd_dq_out<HD><<<(unsigned)((n_vec + 255) / 256), 256, 0, stream>>>(
      dq_acc, static_cast<T*>(dq), st[4], H, S, S_pad, scale, n_vec);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, float* delta, void* dq, void* dk, void* dv, const Strides* st,
               const Strides& so, int B, int H, int Hkv, int S, int L, const Mask& m,
               float scale, cudaStream_t stream) {
  const long long n_rows = (long long)B * H * S;
  fa_bwd_delta<<<(unsigned)((n_rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout), delta, so, st[3], H, S, HD,
      n_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr int bytes = LayoutF<HD>::bytes;
  auto kv_kern = fa_bwd_dkdv_f32<HD>;
  auto q_kern = fa_bwd_dq_f32<HD>;
  err = cudaFuncSetAttribute(kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
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
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), st[0], st[1], st[2],
      st[3], st[4], H, Hkv, L, m, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, dout, dq: (B, H, S, hd); k, v, dk, dv: (B, Hkv, L, hd), each given by
// its (b, h, s) strides in elements with hd contiguous; lse (the forward's)
// (B, H, S) f32 contiguous. work is f32 scratch: bf16 B·H·S_pad·(2 + hp)
// floats (S_pad = S rounded up to 64, hp = hd rounded up to 64: the
// log-sum-exp in log2 units, D, the dQ sums), f32 B·H·S (D). dk and dv are written whole (zero where no query
// sees a row). Returns cudaGetLastError() after the launches (0 on success),
// or cudaErrorInvalidValue for a head dim without a template or tensor maps
// that cannot be made.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* work, void* dq, void* dk, void* dv,
    long long q_b, long long q_h, long long q_s, long long k_b, long long k_h, long long k_s,
    long long v_b, long long v_h, long long v_s, long long o_b, long long o_h, long long o_s,
    long long do_b, long long do_h, long long do_s, long long dq_b, long long dq_h,
    long long dq_s, long long dk_b, long long dk_h, long long dk_s, long long dv_b,
    long long dv_h, long long dv_s, int B, int H, int Hkv, int S, int L, int kv_len,
    int q_offset, int causal, int window, int head_dim, int is_bf16, float scale,
    void* stream) {
  if (head_dim != 64 && head_dim != 112 && head_dim != 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides so = {o_b, o_h, o_s};
  const Strides st[7] = {{q_b, q_h, q_s}, {k_b, k_h, k_s}, {v_b, v_h, v_s}, {do_b, do_h, do_s},
                         {dq_b, dq_h, dq_s}, {dk_b, dk_h, dk_s}, {dv_b, dv_h, dv_s}};
  const Mask m = {S, kv_len < L ? kv_len : L, q_offset, causal, window};
  const float* lz = static_cast<const float*>(lse);
  float* w = static_cast<float*>(work);
#define FA_BWD_LAUNCH(HD)                                                                  \
  (is_bf16 ? launch_bf16<HD>(q, k, v, o, dout, lz, w, dq, dk, dv, st, so, B, H, Hkv, S, L, m, \
                             scale, s)                                                       \
           : launch_f32<HD>(q, k, v, o, dout, lz, w, dq, dk, dv, st, so, B, H, Hkv, S, L, m,  \
                            scale, s))
  if (head_dim == 64) return FA_BWD_LAUNCH(64);
  if (head_dim == 112) return FA_BWD_LAUNCH(112);
  return FA_BWD_LAUNCH(128);
#undef FA_BWD_LAUNCH
}
