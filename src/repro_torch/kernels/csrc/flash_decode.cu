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
// and V, 0.32 ms at 3.35 TB/s, against 7.5 GFLOP (under 0.01 ms): 7
// operations a byte. The kernel should do nothing but keep the memory busy.
//
// Both designs run one block per (split, kv-head and group of up to 8 query
// heads, batch row). The G query heads that share a kv-head are handled
// together, so each K and V row is read from device memory once for all of
// them. The live rows [lo, hi) (the wrapper folds kv_len, q_pos and the
// window into that range) are cut into `splits` equal partitions; each block
// walks its partition with an online softmax and emits its output
// normalised by its own sum and its log-sum-exp per head, as the TPU kernel
// does: an empty partition gets lse = -1e30. The combine kernel
// (decode_combine.cuh, shared with mla_decode.cu) then weights each
// partition by exp(lse - max lse), a -1e30 lse by exactly 0, and writes the
// output in q's dtype. Nothing is padded in device memory: the ragged edge
// is masked here.
//
// bf16, a streaming kernel with the math on the tensor cores:
//   - The block's query heads are the M rows of mma.sync m16n8k16: head g0 + g
//     is row g, rows 8..15 are zero in Q·Kᵀ. q's fragments are read once
//     from device memory and stay in registers.
//   - Each of the 4 warps walks its own 16-row chunks of the partition
//     (chunk c belongs to warp c mod 4) through a private ring of 3 chunk
//     slots in shared memory, filled by cp.async (16 bytes a lane, rows
//     past the partition zero-filled, each 128-byte line fetched into L2
//     whole): two chunks are in flight while the third is used, and a warp
//     waits only on its own copies (__syncwarp, no block barrier in the
//     loop). A block keeps 68 KB in flight; the wrapper's split count gives
//     each SM one block, which keeps the memory as busy as two did, and
//     leaves fewer partitions to combine.
//   - Scores S = Q·Kᵀ (16 heads × 16 rows) with K's fragments by ldmatrix
//     from the row-major chunk; softmax in base 2, scale·log2(e) and the
//     running max applied in one FFMA before ex2.approx; the mask is
//     evaluated only on a chunk that crosses the partition's end.
//   - P·V with P in registers as the A operand: one bf16 P errs by 2^-9 of
//     each probability, which an output near 0 averaged over 32767 rows
//     does not shrink, so P = P_hi + P_lo, two bf16 terms. The zero rows
//     carry the second term: A row g holds head g's P_hi, row g + 8 its
//     P_lo, and the two accumulator rows are added at the end, so the
//     split costs no extra product. V's fragments come by ldmatrix.trans
//     from the row-major chunk.
//   - The warps' (m, l, acc) are merged in shared memory at the end (the
//     rings are free by then).
// f32 keeps the CUDA-core design: lanes split a row's head dim, 16 bytes
// each, a warp holds 1 to 4 rows at once, each lane keeps its slice of
// every query head and accumulator in registers, and the block's row slots
// are merged in shared memory (Hopper's tensor cores take f32 only as
// TF32). Scores, softmax sums and accumulators are f32 in both.
//
// Head dims 64, 112 (zamba2-7b's shared attention), 128 and 256
// (paligemma-3b) are instantiated. bf16 at hd = 112: 7 k-steps of 16 in
// Q·Kᵀ, 14 n8 output tiles taken in pairs in P·V, rows of 120 elements (240
// bytes, 16-byte aligned, eight rows on distinct banks), 90 KB a block. f32
// at hd = 112: a row takes 28 lanes of 4 values, so a warp holds one row in
// a group of 32 lanes; lanes 28..31 load nothing, add zeros into the row's
// shuffle sum and write nothing.
//
// hd = 256, bf16: the same design. Per lane it keeps q's fragments (only
// A rows 0..7 are loaded, 2 registers a k-step: 32), the accumulators
// (P_hi·V and P_lo·V of one head row over 256 columns: 128), the 16-row
// score tile (8) and P's A operand (4): about 180 registers before
// addresses, under the 255 a thread, so nothing is re-read. The ring stays
// 3 slots deep: 3 x 16 rows x (K, V) x 264 elements x 2 B = 50,688 B a warp,
// 202,752 B a block, under the 232,448 B a block may opt in to: one block
// an SM, which is what auto_splits plans, with 128 KB of K and V in flight
// an SM. paligemma-3b's GQA group is 8 (H = 8 over one kv-head): one block's
// 8 query-head rows exactly. f32 at hd = 256: a lane takes 8 values of a row
// (two float4 loads), so a row is still one warp of 32 lanes.
// ptxas for sm_90a (printed by chip_smoke.py's phase 1): bf16 255
// registers, 44 B of spill stores and 56 B of loads (a 48 B stack frame),
// 202,752 B of dynamic and 256 B of static shared memory; f32 (8 heads a
// block) 241 registers, no spill, 33,024 B of static shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "decode_combine.cuh"
#include "warp_tile.cuh"

using namespace repro_torch;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kLn2 = 0.6931471805599453f;

// -- bf16: tensor cores, cp.async ------------------------------------------------

constexpr int kChunk = 16;     // cache rows a warp takes per step (the P·V depth)
constexpr int kStages = 3;     // chunk slots in a warp's ring
constexpr int kHeads = 8;      // query heads a block handles (A rows 0..7)

// Shared memory: per warp a ring of kStages slots, each a K and a V chunk
// [16][LD]. LD = hd + 8: 16 bytes of padding put the eight rows of an
// ldmatrix on distinct banks. hd = 256: 198 KB a block, one block an SM;
// hd = 128: 102 KB, two; hd = 112: 90 KB, two; hd = 64: 54 KB, four.
template <int HD>
struct TcLayout {
  static_assert(HD % 16 == 0 && (HD / 8) % 2 == 0, "k-steps of 16, n8 output tiles in pairs");
  static constexpr int LD = HD + 8;
  static constexpr int CHUNK = kChunk * LD;            // elements
  static constexpr int RING = kStages * 2 * CHUNK;     // elements, one warp's
  static constexpr int bytes = kWarps * RING * 2;
  static_assert(kHeads * HD * 4 <= RING * 2, "a warp's merge slot fits in its ring");
};

// Starts the copy of cache rows [row0, row0 + 16) (row stride ld) into a
// [16][LD] chunk; rows at or past row_end are zero-filled and not read.
template <int HD>
__device__ __forceinline__ void copy_chunk(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long ld, int row0, int row_end) {
  constexpr int PER_ROW = HD / 8, LD = TcLayout<HD>::LD;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int x = 0; x < kChunk * PER_ROW / 32; ++x) {
    const int i = lane + 32 * x;
    const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
    const bool in = row0 + r < row_end;
    cp_async_16(dst + r * LD + c, src + (in ? row0 + r : row0) * ld + c, in ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_decode_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, float* __restrict__ o_part,
                  float* __restrict__ lse_part, long long q_b, long long q_h, long long k_b,
                  long long k_l, long long k_h, long long v_b, long long v_l, long long v_h,
                  int H, int Hkv, int groups, int lo, int hi, int per, int splits,
                  float scale_log2) {
  using Lay = TcLayout<HD>;
  constexpr int LD = Lay::LD, KSTEPS = HD / 16, NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float sm_m[kWarps][kHeads];
  __shared__ float sm_l[kWarps][kHeads];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x, b = blockIdx.z;
  const int hk = blockIdx.y / groups, G = H / Hkv;
  const int g0 = (blockIdx.y % groups) * kHeads;
  const int gn = min(kHeads, G - g0);                // live query heads of this block
  const int row_begin = lo + split * per;
  const int row_end = min(row_begin + per, hi);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw) + warp * Lay::RING;
  const __nv_bfloat16* kb = k + b * k_b + hk * k_h;
  const __nv_bfloat16* vb = v + b * v_b + hk * v_h;

  // this warp's chunks: c = warp, warp + kWarps, ...; chunk c starts at row_begin + 16c
  const int n_chunks = row_begin < row_end ? (row_end - row_begin + kChunk - 1) / kChunk : 0;
  const int mine = n_chunks > warp ? (n_chunks - warp + kWarps - 1) / kWarps : 0;
  // Every step commits one copy group, empty or not, so that group i is chunk i.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < mine) {
      const int row0 = row_begin + kChunk * (warp + kWarps * s);
      copy_chunk<HD>(ring + s * 2 * Lay::CHUNK, kb, k_l, row0, row_end);
      copy_chunk<HD>(ring + s * 2 * Lay::CHUNK + Lay::CHUNK, vb, v_l, row0, row_end);
    }
    cp_async_commit();
  }

  // q: A row g is head g0 + g, zero past the block's heads; a[1] and a[3]
  // (rows 8..15) are zero
  uint32_t qf[KSTEPS][2];
  {
    const __nv_bfloat16* qr = q + b * q_b + (hk * G + g0 + min(g, gn - 1)) * q_h + 2 * t;
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      qf[s][0] = g < gn ? *reinterpret_cast<const uint32_t*>(qr + 16 * s) : 0u;
      qf[s][1] = g < gn ? *reinterpret_cast<const uint32_t*>(qr + 16 * s + 8) : 0u;
    }
  }

  // head g's running max (base 2) and this lane's partial sum; oacc[n][0..1]
  // sums P_hi·V, oacc[n][2..3] P_lo·V, both for head g
  float m = kNegInf, l = 0.f;
  float oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;

  for (int i = 0; i < mine; ++i) {
    cp_async_wait<kStages - 2>();
    __syncwarp();      // chunk i is visible to the warp, and chunk i - 1's slot is read
    {
      const int nx = i + kStages - 1;
      if (nx < mine) {
        __nv_bfloat16* slot = ring + (nx % kStages) * 2 * Lay::CHUNK;
        const int row0 = row_begin + kChunk * (warp + kWarps * nx);
        copy_chunk<HD>(slot, kb, k_l, row0, row_end);
        copy_chunk<HD>(slot + Lay::CHUNK, vb, v_l, row0, row_end);
      }
      cp_async_commit();
    }
    const __nv_bfloat16* ks = ring + (i % kStages) * 2 * Lay::CHUNK;
    const __nv_bfloat16* vs = ks + Lay::CHUNK;
    const int row0 = row_begin + kChunk * (warp + kWarps * i);

    float sacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      uint32_t bf[4];
      ldmatrix_x4(bf, ks + b_rows(LD) + 16 * s);
      const uint32_t a[4] = {qf[s][0], 0u, qf[s][1], 0u};
      mma_bf16(sacc[0], a, bf[0], bf[1]);
      mma_bf16(sacc[1], a, bf[2], bf[3]);
    }
    // head g's raw scores of rows row0 + {2t, 2t + 1, 2t + 8, 2t + 9}
    float x[4] = {sacc[0][0], sacc[0][1], sacc[1][0], sacc[1][1]};
    if (row0 + kChunk > row_end) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (row0 + 2 * t + (e & 1) + 8 * (e >> 1) >= row_end) x[e] = -INFINITY;
    }
    // m, the running max of the scaled scores, never drops below -1e30, so a
    // masked score's exp2(-inf - m) is exactly 0
    const float mn = fmaxf(m, quad_max(fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]))) * scale_log2);
    const float alpha = exp2_approx(m - mn);
    m = mn;
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = exp2_approx(fmaf(x[e], scale_log2, -mn));
    l = l * alpha + ((p[0] + p[1]) + (p[2] + p[3]));
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      oacc[n][0] *= alpha; oacc[n][1] *= alpha;
      oacc[n][2] *= alpha; oacc[n][3] *= alpha;
    }
    // A: row g = P_hi, row g + 8 = P_lo, depth = the chunk's 16 rows
    const __nv_bfloat162 h01 = __floats2bfloat162_rn(p[0], p[1]);
    const __nv_bfloat162 h23 = __floats2bfloat162_rn(p[2], p[3]);
    const float2 f01 = __bfloat1622float2(h01), f23 = __bfloat1622float2(h23);
    const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(&h01),
                           pack_bf16(p[0] - f01.x, p[1] - f01.y),
                           *reinterpret_cast<const uint32_t*>(&h23),
                           pack_bf16(p[2] - f23.x, p[3] - f23.y)};
#pragma unroll
    for (int n = 0; n < NO; n += 2) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, vs + b_cols(LD) + 8 * n);
      mma_bf16(oacc[n], a, bf[0], bf[1]);
      mma_bf16(oacc[n + 1], a, bf[2], bf[3]);
    }
  }

  // Merge the warps: each writes its (m, l) and its sums for the block's
  // heads into its own ring, which no copy is filling any more.
  cp_async_wait<0>();
  __syncwarp();
  l = quad_sum(l);
  if (t == 0) {
    sm_m[warp][g] = m;
    sm_l[warp][g] = l;
  }
  float* acc_s = reinterpret_cast<float*>(ring);     // [kHeads][HD]
#pragma unroll
  for (int n = 0; n < NO; ++n)
    *reinterpret_cast<float2*>(acc_s + g * HD + 8 * n + 2 * t) =
        make_float2(oacc[n][0] + oacc[n][2], oacc[n][1] + oacc[n][3]);
  __syncthreads();
  for (int i = threadIdx.x; i < gn * HD; i += kThreads) {
    const int hg = i / HD, d = i % HD;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][hg]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(sm_m[w][hg] - M);
      const float* acc_w = reinterpret_cast<const float*>(
          reinterpret_cast<const __nv_bfloat16*>(smem_raw) + w * Lay::RING);
      L = fmaf(sm_l[w][hg], wt, L);
      O = fmaf(acc_w[hg * HD + d], wt, O);
    }
    const float den = fmaxf(L, 1e-30f);
    const long long row = ((long long)b * H + hk * G + g0 + hg) * splits + split;
    o_part[row * HD + d] = O / den;
    if (d == 0) lse_part[row] = L > 0.f ? (M + log2f(den)) * kLn2 : kNegInf;
  }
}

// -- f32: CUDA cores -------------------------------------------------------------

// HD: head dim; GT: query heads handled by one block. A row's LPR lanes
// sit in a group of GROUP lanes, the power of two the shuffle sum spans;
// the group's last GROUP - LPR lanes are idle (4 at hd = 112, none at 64,
// 128 or 256). A lane takes 4 values of a row, 8 at hd = 256 (a row is
// at most one warp).
template <int HD, int GT>
struct Shape {
  static constexpr int VEC = HD > 128 ? 8 : 4;      // elements per lane
  static constexpr int LPR = HD / VEC;              // lanes that hold a row's values
  static constexpr int GROUP = LPR > 16 ? 32 : LPR > 8 ? 16 : 8;   // lanes per row
  static constexpr int RPW = 32 / GROUP;            // rows a warp holds at once
  static constexpr int SLOTS = kWarps * RPW;        // row slots of the block
  static constexpr int ROWS = GT >= 8 ? 2 : 4;      // rows per slot per step
};

// VEC consecutive floats at p (16-byte aligned), as float4 loads
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; i += 4) {
    const float4 u = *reinterpret_cast<const float4*>(p + i);
    out[i] = u.x, out[i + 1] = u.y, out[i + 2] = u.z, out[i + 3] = u.w;
  }
}

template <int HD, int GT>
__global__ void __launch_bounds__(kThreads)
flash_decode_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o_part,
                 float* __restrict__ lse_part, long long q_b, long long q_h,
                 long long k_b, long long k_l, long long k_h, long long v_b,
                 long long v_l, long long v_h, int H, int Hkv, int groups,
                 int lo, int hi, int per, int splits, float scale) {
  using S = Shape<HD, GT>;
  constexpr int VEC = S::VEC, LPR = S::LPR, SLOTS = S::SLOTS, ROWS = S::ROWS;
  __shared__ float sm_m[SLOTS][GT];
  __shared__ float sm_l[SLOTS][GT];
  __shared__ __align__(16) float sm_acc[SLOTS][GT][HD];

  const int split = blockIdx.x, b = blockIdx.z;
  const int hk = blockIdx.y / groups, G = H / Hkv;
  const int g0 = (blockIdx.y % groups) * GT;
  const int gn = min(GT, G - g0);                    // live query heads of this block
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = warp * S::RPW + lane / S::GROUP;
  // lanes past a row's LPR (4 of 32 at hd = 112) load nothing and write nothing
  const bool holds = lane % S::GROUP < LPR;
  const int c = holds ? (lane % S::GROUP) * VEC : 0;   // this lane's slice of the head dim
  const int row_begin = lo + split * per;
  const int row_end = min(row_begin + per, hi);

  float qr[GT][VEC], acc[GT][VEC], m[GT], l[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int x = 0; x < VEC; ++x) acc[g][x] = 0.f, qr[g][x] = 0.f;
    if (g < gn && holds) load_vec<VEC>(q + b * q_b + (hk * G + g0 + g) * q_h + c, qr[g]);
  }

  const float* kb = k + b * k_b + hk * k_h + c;
  const float* vb = v + b * v_b + hk * v_h + c;
  // The loop bound is uniform over the block, so every lane reaches every
  // shuffle; rows at or past row_end are masked.
  for (int base = row_begin; base < row_end; base += SLOTS * ROWS) {
    float kr[ROWS][VEC], vr[ROWS][VEC];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int j = base + r * SLOTS + slot;
#pragma unroll
      for (int x = 0; x < VEC; ++x) kr[r][x] = vr[r][x] = 0.f;
      if (j < row_end && holds) {
        load_vec<VEC>(kb + j * k_l, kr[r]);
        load_vec<VEC>(vb + j * v_l, vr[r]);
      }
    }
    float s[ROWS][GT];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float d = 0.f;
#pragma unroll
        for (int x = 0; x < VEC; ++x) d = fmaf(qr[g][x], kr[r][x], d);
#pragma unroll
        for (int off = S::GROUP / 2; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
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
        l[g] += p;
#pragma unroll
        for (int x = 0; x < VEC; ++x) acc[g][x] = fmaf(p, vr[r][x], acc[g][x]);
      }
      m[g] = mn;
    }
  }

  // Merge the row slots: one (m, l, acc) per query head.
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (lane % S::GROUP == 0) {
      sm_m[slot][g] = m[g];
      sm_l[slot][g] = l[g];
    }
    if (holds) {
#pragma unroll
      for (int x = 0; x < VEC; ++x) sm_acc[slot][g][c + x] = acc[g][x];
    }
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

// -- launches --------------------------------------------------------------------

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, float* o_part, float* lse,
                void* out, const long long* st, int B, int H, int Hkv, int lo, int hi, int per,
                int splits, float scale, cudaStream_t stream) {
  using T = __nv_bfloat16;
  const int groups = (H / Hkv + kHeads - 1) / kHeads;
  const dim3 grid(splits, Hkv * groups, B);
  auto kern = flash_decode_bf16<HD>;
  constexpr int bytes = TcLayout<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), o_part, lse,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], H, Hkv, groups, lo, hi, per,
      splits, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine<T, HD><<<B * H, HD, 0, stream>>>(o_part, lse, static_cast<T*>(out), splits);
  return (int)cudaGetLastError();
}

template <int HD, int GT>
int launch_f32(const void* q, const void* k, const void* v, float* o_part, float* lse,
               void* out, const long long* st, int B, int H, int Hkv, int lo, int hi, int per,
               int splits, float scale, cudaStream_t stream) {
  const int G = H / Hkv, groups = (G + GT - 1) / GT;
  const dim3 grid(splits, Hkv * groups, B);
  flash_decode_f32<HD, GT><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      o_part, lse, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], H, Hkv, groups, lo,
      hi, per, splits, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine<float, HD><<<B * H, HD, 0, stream>>>(o_part, lse, static_cast<float*>(out),
                                                      splits);
  return (int)cudaGetLastError();
}

template <int HD>
int dispatch(int is_bf16, int g_tile, const void* q, const void* k, const void* v,
             float* o_part, float* lse, void* out, const long long* st, int B, int H, int Hkv,
             int lo, int hi, int per, int splits, float scale, cudaStream_t s) {
  if (is_bf16)
    return launch_bf16<HD>(q, k, v, o_part, lse, out, st, B, H, Hkv, lo, hi, per, splits, scale, s);
  switch (g_tile) {
    case 1: return launch_f32<HD, 1>(q, k, v, o_part, lse, out, st, B, H, Hkv, lo, hi, per, splits, scale, s);
    case 2: return launch_f32<HD, 2>(q, k, v, o_part, lse, out, st, B, H, Hkv, lo, hi, per, splits, scale, s);
    case 4: return launch_f32<HD, 4>(q, k, v, o_part, lse, out, st, B, H, Hkv, lo, hi, per, splits, scale, s);
    case 8: return launch_f32<HD, 8>(q, k, v, o_part, lse, out, st, B, H, Hkv, lo, hi, per, splits, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q: (B, H, hd) with strides (q_b, q_h); k, v: (B, L, Hkv, hd) with strides
// (b, l, h); hd contiguous everywhere, strides in elements. Rows [lo, hi)
// are live; partition s holds rows [lo + s·per, min(lo + (s+1)·per, hi)).
// o_part (B, H, splits, hd) and lse (B, H, splits) are f32 scratch; out is
// (B, H, hd) contiguous in q's dtype. g_tile ∈ {1, 2, 4, 8}: query heads
// per f32 block (a bf16 block takes up to 8 heads as its mma rows and
// ignores it). Returns cudaGetLastError() after the launches (0 on
// success), or cudaErrorInvalidValue for a head dim or g_tile without a
// template.
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
    return dispatch<64>(is_bf16, g_tile, q, k, v, op, ls, out, st, B, H, Hkv, lo, hi, per, splits, scale, s);
  if (head_dim == 112)
    return dispatch<112>(is_bf16, g_tile, q, k, v, op, ls, out, st, B, H, Hkv, lo, hi, per, splits, scale, s);
  if (head_dim == 128)
    return dispatch<128>(is_bf16, g_tile, q, k, v, op, ls, out, st, B, H, Hkv, lo, hi, per, splits, scale, s);
  if (head_dim == 256)
    return dispatch<256>(is_bf16, g_tile, q, k, v, op, ls, out, st, B, H, Hkv, lo, hi, per, splits, scale, s);
  return (int)cudaErrorInvalidValue;
}
