// mla_decode: absorbed multi-head latent attention (DeepSeek-V2 MLA) for one
// decode token, split over the cache, plus the exact log-sum-exp combine.
//
// Replaces the TPU kernel mla_decode in src/repro/kernels/mla_decode.py
// (Pallas body _kernel) and its combine_partials merge.
//
// The function: every query head h of a batch row reads the one latent
// cache row per position, ckv (r = 512) and kpe (rd = 64):
//     s[h, j] = (q_lat[h]·ckv[j] + q_pe[h]·kpe[j]) · scale
//     out[h]  = softmax_j(s[h, :]) · ckv
// over the live rows j < hi (the wrapper folds kv_len and q_pos into hi).
//
// What bounds it on the H100: both, nearly. All heads share one latent row,
// so the cache is read once for 128 heads: at deepseek-v2's serve shape
// (B = 16, H = 128, 32767 live rows, bf16) a call reads 0.60 GB (0.18 ms at
// 3.35 TB/s) and does 146 GFLOP (0.15 ms on the bf16 tensor cores, about
// 2.2 ms on the f32 CUDA cores). Unlike GQA decode the products must run on
// the tensor cores.
//
// Design: one block per (group of query heads, split, batch row): in bf16
// 64 heads and 16 warps, in f32 32 heads and 8 warps (four warps per m16
// tile of heads). The heads are the M dimension of both products, as they
// are the MXU rows of the TPU kernel. Per tile of 32 cache rows:
//   1. the rows [ckv | kpe] (576 wide) are copied into shared memory with
//      cp.async, every 16-byte copy of a tile in flight at once; in bf16 two
//      tile buffers alternate, so the next tile's copy runs under this one;
//   2. scores S = [q_lat | q_pe] · tileᵀ (heads × 32, depth 576) with
//      mma.sync.m16n8k16: each warp takes one m16 tile of heads over one
//      quarter of the depth (144) for all 32 rows, its q fragments held in
//      registers for the whole walk (bf16), its four n8 accumulators four
//      independent chains; the quarters' partial sums meet in shared memory;
//   3. an online softmax per head row (8 threads a row): running max and
//      sum stay in those threads' registers, the rescale factor goes to
//      shared memory, the probabilities P to shared memory;
//   4. O += P · ckv_tile: each warp owns 64 of the 512 output columns for
//      32 heads, 64 f32 accumulators a thread (128 heads × 512 columns would
//      be the whole register file). ckv's rows are read as the col-major B
//      operand by ldmatrix.trans, so the tile in shared memory serves both
//      products and nothing is transposed.
// In bf16, P is rounded for the tensor cores as P = P_hi + P_lo, two bf16
// terms, and both are multiplied: one bf16 term would err by 2^-9 of each
// probability, an error that the output, an average over up to 10^5 rows
// near 0, does not shrink. The two terms keep about 16 bits; the PV product
// then costs twice the minimum. In f32 both products are f32 FMAs on the
// CUDA cores in the same register layout (Hopper's tensor cores take f32
// only as TF32), q stays in shared memory and one tile buffer fits. Scores,
// softmax and accumulators are f32 throughout.
//
// Shared memory: bf16 119.5 KB, f32 167.75 KB: one block an SM (512 bf16
// threads hold at most 128 registers each). The head groups of a (split,
// batch row) are adjacent in blockIdx.x, so they run together and the
// second read of a tile can come from L2. A partition emits its output
// normalised by its own sum and its log-sum-exp, -1e30 when empty, as the
// TPU kernel does; decode_combine.cuh merges the partitions. Nothing is
// padded: heads past H and rows past hi are zero-filled and masked here.
// No TMA or wgmma yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_combine.cuh"
#include "warp_tile.cuh"

using namespace repro_torch;

namespace {

constexpr int kR = 512;                 // kv_lora_rank: latent width, output width
constexpr int kRd = 64;                 // qk_rope_head_dim
constexpr int kK = kR + kRd;            // score depth
constexpr int kRows = 32;               // cache rows per tile
constexpr int kCols = 64;               // output columns a warp owns
constexpr int kN8 = kCols / 8;          // its n8 tiles
constexpr int kColChunks = kR / kCols;  // warps sharing one group of 32 heads

template <typename T> struct Pad;       // row padding: distinct banks, 16-byte rows
template <> struct Pad<__nv_bfloat16> { static constexpr int v = 8; };
template <> struct Pad<float> { static constexpr int v = 4; };

constexpr int kQuarter = kK / 4;        // the score depth a warp sums: 144
constexpr int kSteps = kQuarter / 16;   // its k16 steps
// A block: HEADS query heads (bf16 64, f32 32), 4 warps per m16 tile of
// them. Shared memory: STAGES cache tiles [kRows][LD]; in f32 q [HEADS][LD]
// (bf16 keeps q in registers and stages it through the tile buffers);
// PLANES planes of P [HEADS][LDP] in T; four partial score sums
// [4][HEADS][LDS] f32, one per quarter of the depth; the rescale factors and
// the final sums, HEADS f32 each. bf16 double-buffers the tiles; f32, twice
// as wide, has room for one tile and half the heads.
template <typename T>
struct Layout {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int HEADS = BF16 ? 64 : 32;
  static constexpr int MTILES = HEADS / 16;
  static constexpr int WARPS = 4 * MTILES;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int LD = kK + Pad<T>::v;
  static constexpr int LDP = kRows + Pad<T>::v;
  static constexpr int LDS = kRows + 4;
  static constexpr int STAGES = BF16 ? 2 : 1;
  static constexpr int Q_ROWS = BF16 ? 0 : HEADS;
  static constexpr int PLANES = BF16 ? 2 : 1;              // bf16: P_hi and P_lo
  static constexpr int bytes = (int)sizeof(T) * ((STAGES * kRows + Q_ROWS) * LD
                                                 + PLANES * HEADS * LDP)
                               + 4 * (4 * HEADS * LDS + 2 * HEADS);
  static_assert(!BF16 || HEADS == STAGES * kRows, "bf16 stages q through the tile buffers");
  static_assert(WARPS == kColChunks * (HEADS / 32), "every warp owns 64 columns of 32 heads");
};

// A warp's share of the scores: 16 heads (its m16 tile) × the tile's 32
// rows over one quarter of the depth (144), as four n8 accumulators in the
// accumulator layout of mma.sync m16n8: acc[n][0..1] = S[g][8n + 2t + {0, 1}],
// acc[n][2..3] the same columns of row g + 8.
//
// bf16: the warp's q fragments stay in registers for the whole walk (9 k16
// steps × 4 registers), so a tile costs only its own rows from shared
// memory; each ldmatrix.x4 brings the B fragments of two n8 tiles (lane
// addresses from b_rows, warp_tile.cuh), and the four accumulators are four
// independent mma chains of 9.
struct QFrag {
  uint32_t a[kSteps][4];
  // q: the warp's 16 rows from their first depth column, leading dim LD
  __device__ __forceinline__ void load(const __nv_bfloat16* q) {
    constexpr int LD = Layout<__nv_bfloat16>::LD;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) ldmatrix_x4(a[s], q + a_rows(LD) + 16 * s);
  }
  // tile: the 32 cache rows from the warp's first depth column
  __device__ __forceinline__ void scores(const __nv_bfloat16* tile, float (&acc)[4][4]) const {
    constexpr int LD = Layout<__nv_bfloat16>::LD;
    const __nv_bfloat16* row = tile + b_rows(LD);
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
#pragma unroll
      for (int pair = 0; pair < 2; ++pair) {
        uint32_t b[4];
        ldmatrix_x4(b, row + 16 * pair * LD + 16 * s);
        mma_bf16(acc[2 * pair], a[s], b[0], b[1]);
        mma_bf16(acc[2 * pair + 1], a[s], b[2], b[3]);
      }
  }
};

// f32: q stays in shared memory and the products are f32 FMAs on the CUDA
// cores in the same layout.
struct QFrag32 {
  const float* q;
  __device__ __forceinline__ void load(const float* q_rows) { q = q_rows; }
  __device__ __forceinline__ void scores(const float* tile, float (&acc)[4][4]) const {
    constexpr int LD = Layout<float>::LD;
    warp_tile_mma<4, kQuarter>(q, LD, tile, LD, acc);
  }
};

template <typename T> struct QFragOf;
template <> struct QFragOf<__nv_bfloat16> { using type = QFrag; };
template <> struct QFragOf<float> { using type = QFrag32; };

// acc[m][n] += P[16m .. 16m+15][:] · V[:][8n .. 8n+7] over the tile's kRows
// rows, for this warp's kCols columns: P is the warp's 32 rows of the
// [HEADS][LDP] planes (PLANES of them),
// V the cache tile from this warp's first column, leading dimension LD.
__device__ __forceinline__ void pv_mma(const __nv_bfloat16* P, const __nv_bfloat16* V,
                                       float (&acc)[2][kN8][4]) {
  using Lay = Layout<__nv_bfloat16>;
  constexpr int LD = Lay::LD, LDP = Lay::LDP;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // ldmatrix.x4.trans at b_cols: the b0, b1 fragments of n8 tiles n, n + 1
#pragma unroll
  for (int k0 = 0; k0 < kRows; k0 += 16) {
    uint32_t a[2][2][4];                                   // [plane][m tile]
#pragma unroll
    for (int pl = 0; pl < 2; ++pl)
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const __nv_bfloat16* p = P + pl * Layout<__nv_bfloat16>::HEADS * LDP + (16 * m + g) * LDP
                                 + k0 + 2 * t;
        a[pl][m][0] = *reinterpret_cast<const uint32_t*>(p);
        a[pl][m][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDP);
        a[pl][m][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        a[pl][m][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDP + 8);
      }
#pragma unroll
    for (int n = 0; n < kN8; n += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, V + b_cols(LD) + k0 * LD + 8 * n);
#pragma unroll
      for (int pl = 0; pl < 2; ++pl)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_bf16(acc[m][n], a[pl][m], b[0], b[1]);
          mma_bf16(acc[m][n + 1], a[pl][m], b[2], b[3]);
        }
    }
  }
}

// The same product in f32 on the CUDA cores, in the accumulator layout of
// mma.sync m16n8: acc[m][n][0..1] = C[16m + g][8n + 2t + {0, 1}], [2..3]
// the same columns of row 16m + g + 8.
__device__ __forceinline__ void pv_mma(const float* P, const float* V, float (&acc)[2][kN8][4]) {
  using Lay = Layout<float>;
  constexpr int LD = Lay::LD, LDP = Lay::LDP;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < kRows; ++k) {
    float a[2][2];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      a[m][0] = P[(16 * m + g) * LDP + k];
      a[m][1] = P[(16 * m + g + 8) * LDP + k];
    }
#pragma unroll
    for (int n = 0; n < kN8; ++n) {
      const float b0 = V[k * LD + 8 * n + 2 * t], b1 = V[k * LD + 8 * n + 2 * t + 1];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        acc[m][n][0] = fmaf(a[m][0], b0, acc[m][n][0]);
        acc[m][n][1] = fmaf(a[m][0], b1, acc[m][n][1]);
        acc[m][n][2] = fmaf(a[m][1], b0, acc[m][n][2]);
        acc[m][n][3] = fmaf(a[m][1], b1, acc[m][n][3]);
      }
    }
  }
}

__device__ __forceinline__ void store_p(__nv_bfloat16* P, int idx, float p) {
  constexpr int plane = Layout<__nv_bfloat16>::HEADS * Layout<__nv_bfloat16>::LDP;
  const __nv_bfloat16 hi = __float2bfloat16(p);
  P[idx] = hi;
  P[plane + idx] = __float2bfloat16(p - __bfloat162float(hi));
}
__device__ __forceinline__ void store_p(float* P, int idx, float p) { P[idx] = p; }

// Starts the copy of [a | b] rows (kR and kRd wide, row strides sa and sb)
// into shared rows of leading dimension ld with cp.async, 16 bytes a thread,
// every copy of the tile in flight at once. Rows past n are zero-filled and
// their source is not read.
template <typename T, int ROWS>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* a, long long sa,
                                          const T* b, long long sb, int n) {
  constexpr int VEC = 16 / sizeof(T), PER_ROW = kK / VEC;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += Layout<T>::THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    const int src_row = r < n ? r : 0;
    const T* src = c < kR ? a + src_row * sa + c : b + src_row * sb + (c - kR);
    cp_async_16(dst + r * ld + c, src, r < n ? 16 : 0);
  }
  cp_async_commit();
}

template <typename T>
__global__ void __launch_bounds__(Layout<T>::THREADS, 1)
mla_decode_partial(const T* __restrict__ q_lat, const T* __restrict__ q_pe,
                   const T* __restrict__ ckv, const T* __restrict__ kpe,
                   float* __restrict__ o_part, float* __restrict__ lse_part,
                   long long ql_b, long long ql_h, long long qp_b, long long qp_h,
                   long long c_b, long long c_l, long long p_b, long long p_l,
                   int H, int hi, int per, int splits, float scale) {
  using Lay = Layout<T>;
  constexpr int LD = Lay::LD, LDP = Lay::LDP, LDS = Lay::LDS, STAGES = Lay::STAGES;
  constexpr int HEADS = Lay::HEADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tiles = reinterpret_cast<T*>(smem_raw);
  T* qs = tiles + STAGES * kRows * LD;
  T* ps = qs + Lay::Q_ROWS * LD;
  float* sp = reinterpret_cast<float*>(ps + Lay::PLANES * HEADS * LDP);
  float* alpha_s = sp + 4 * HEADS * LDS;
  float* l_s = alpha_s + HEADS;

  const int h0 = blockIdx.x * HEADS, split = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_begin = split * per;
  const int row_end = min(row_begin + per, hi);
  const T* ckv_b = ckv + b * c_b;
  const T* kpe_b = kpe + b * p_b;

  // q: [q_lat | q_pe] rows, zero past the last head; bf16 stages it through
  // the tile buffers into registers
  T* q_rows = Lay::BF16 ? tiles : qs;
  copy_rows<T, HEADS>(q_rows, LD, q_lat + b * ql_b + h0 * ql_h, ql_h,
                       q_pe + b * qp_b + h0 * qp_h, qp_h, H - h0);
  cp_async_wait<0>();
  __syncthreads();
  // scores: this warp's 16 heads (m16 tile mt) over one quarter of the depth
  // (kq); output: its kCols columns (c0) of 32 heads (32·hh onwards)
  const int mt = warp % Lay::MTILES, kq = warp / Lay::MTILES;
  const int c0 = (warp % kColChunks) * kCols, hh = warp / kColChunks;
  typename QFragOf<T>::type qf;
  qf.load(q_rows + 16 * mt * LD + kq * kQuarter);
  __syncthreads();   // the staging buffers are free again

  // softmax: 8 threads a head row, 4 scores each; the row's running max and
  // sum live in those threads' registers (the same values in all 8)
  const int srow = threadIdx.x >> 3, scol = (threadIdx.x & 7) * 4;
  float m_run = kNegInf, l_run = 0.f;
  float oacc[2][kN8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < kN8; ++n) oacc[m][n][0] = oacc[m][n][1] = oacc[m][n][2] = oacc[m][n][3] = 0.f;

  // With two stages the next tile's copy is in flight while this one is
  // used. The loop bounds are uniform over the block, so every thread
  // reaches every barrier; rows at or past row_end are zero-filled and
  // masked.
  if (STAGES == 2 && row_begin < row_end)
    copy_rows<T, kRows>(tiles, LD, ckv_b + row_begin * c_l, c_l, kpe_b + row_begin * p_l, p_l,
                        row_end - row_begin);
  int it = 0;
  for (int j0 = row_begin; j0 < row_end; j0 += kRows, ++it) {
    T* cur = tiles + (STAGES == 2 ? it & 1 : 0) * kRows * LD;
    if (STAGES == 1) {
      copy_rows<T, kRows>(cur, LD, ckv_b + j0 * c_l, c_l, kpe_b + j0 * p_l, p_l, row_end - j0);
      cp_async_wait<0>();
    } else if (j0 + kRows < row_end) {
      const int j1 = j0 + kRows;
      copy_rows<T, kRows>(tiles + ((it + 1) & 1) * kRows * LD, LD, ckv_b + j1 * c_l, c_l,
                          kpe_b + j1 * p_l, p_l, row_end - j1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // the tile's copies are visible to all

    float sacc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
    qf.scores(cur + kq * kQuarter, sacc);
    float* part = sp + kq * HEADS * LDS;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        part[(16 * mt + g) * LDS + 8 * n + 2 * t + e] = sacc[n][e];
        part[(16 * mt + g + 8) * LDS + 8 * n + 2 * t + e] = sacc[n][2 + e];
      }
    __syncthreads();

    float s[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = srow * LDS + scol + x;
      const float v = (sp[i] + sp[HEADS * LDS + i]) + (sp[2 * HEADS * LDS + i] + sp[3 * HEADS * LDS + i]);
      s[x] = j0 + scol + x < row_end ? v * scale : -INFINITY;
    }
    float mx = fmaxf(fmaxf(s[0], s[1]), fmaxf(s[2], s[3]));
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    // m_run never drops below -1e30, so a masked score's exp(-inf - mn) is exactly 0
    const float mn = fmaxf(m_run, mx);
    const float alpha = expf(m_run - mn);
    float sum = 0.f;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float p = expf(s[x] - mn);
      sum += p;
      store_p(ps, srow * LDP + scol + x, p);
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    l_run = l_run * alpha + sum;
    m_run = mn;
    if ((threadIdx.x & 7) == 0) alpha_s[srow] = alpha;
    __syncthreads();

#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float aa = alpha_s[32 * hh + 16 * m + g], ab = alpha_s[32 * hh + 16 * m + g + 8];
#pragma unroll
      for (int n = 0; n < kN8; ++n) {
        oacc[m][n][0] *= aa; oacc[m][n][1] *= aa;
        oacc[m][n][2] *= ab; oacc[m][n][3] *= ab;
      }
    }
    pv_mma(ps + 32 * hh * LDP, cur + c0, oacc);
    __syncthreads();   // the tile and P are consumed before they are overwritten
  }

  if ((threadIdx.x & 7) == 0) {
    l_s[srow] = l_run;
    if (h0 + srow < H) {
      const long long row = ((long long)b * H + h0 + srow) * splits + split;
      lse_part[row] = l_run > 0.f ? m_run + logf(fmaxf(l_run, 1e-30f)) : kNegInf;
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 32 * hh + 16 * m + g + 8 * half;
      if (h0 + r >= H) continue;
      const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
      float* o = o_part + (((long long)b * H + h0 + r) * splits + split) * kR + c0 + 2 * t;
#pragma unroll
      for (int n = 0; n < kN8; ++n)
        *reinterpret_cast<float2*>(o + 8 * n) =
            make_float2(oacc[m][n][2 * half] * inv, oacc[m][n][2 * half + 1] * inv);
    }
}

template <typename T>
int launch(const void* q_lat, const void* q_pe, const void* ckv, const void* kpe,
           float* o_part, float* lse, void* out, const long long* st, int B, int H, int hi,
           int per, int splits, float scale, cudaStream_t stream) {
  auto kern = mla_decode_partial<T>;
  constexpr int bytes = Layout<T>::bytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + Layout<T>::HEADS - 1) / Layout<T>::HEADS, splits, B);
  kern<<<grid, Layout<T>::THREADS, bytes, stream>>>(
      static_cast<const T*>(q_lat), static_cast<const T*>(q_pe), static_cast<const T*>(ckv),
      static_cast<const T*>(kpe), o_part, lse, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], H, hi, per, splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine<T, kR><<<B * H, kR, 0, stream>>>(o_part, lse, static_cast<T*>(out), splits);
  return (int)cudaGetLastError();
}

}  // namespace

// q_lat (B, H, r) and q_pe (B, H, rd) with strides (b, h); ckv (B, L, r)
// and kpe (B, L, rd) with strides (b, l); the last dim contiguous
// everywhere, strides in elements. Rows [0, hi) are live; partition s holds
// rows [s·per, min((s+1)·per, hi)). o_part (B, H, splits, r) and lse
// (B, H, splits) are f32 scratch; out is (B, H, r) contiguous in q's dtype.
// Returns cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for dims without a template.
extern "C" int mla_decode_launch(
    const void* q_lat, const void* q_pe, const void* ckv, const void* kpe, void* o_part,
    void* lse, void* out, long long ql_b, long long ql_h, long long qp_b, long long qp_h,
    long long c_b, long long c_l, long long p_b, long long p_l, int B, int H, int hi, int per,
    int splits, int rank, int rope_dim, int is_bf16, float scale, void* stream) {
  if (rank != kR || rope_dim != kRd) return (int)cudaErrorInvalidValue;
  const long long st[8] = {ql_b, ql_h, qp_b, qp_h, c_b, c_l, p_b, p_l};
  float* op = static_cast<float*>(o_part);
  float* ls = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(q_lat, q_pe, ckv, kpe, op, ls, out, st, B, H, hi, per, splits, scale, s)
                 : launch<float>(q_lat, q_pe, ckv, kpe, op, ls, out, st, B, H, hi, per, splits, scale, s);
}
