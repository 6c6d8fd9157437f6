// score_ce: per-token NLL of softmax(hidden · embᵀ) at the gold labels,
// without ever writing the (T, V) logits to device memory.
//
// Replaces the TPU kernel score_ce in src/repro/kernels/score_ce.py (Pallas
// body _kernel, the Prompt Bank's Eqn-1 hot spot).
//
// What bounds it on the H100: at gpt2-base's scoring shapes (D = 768,
// V = 50257, bf16) bytes at T = 272 rows (the 77 MB embedding read once,
// 23 µs at 3.35 TB/s, against 21 GFLOP, 21 µs at 989 TFLOP/s) and the
// tensor cores at T = 7952 (614 GFLOP, 0.62 ms). rwkv6-7b (D = 4096,
// V = 65536) and deepseek-v2 (D = 5120, V = 102400) are likewise bytes-bound
// at 272 rows and operations-bound at thousands.
//
// Both element types split the vocabulary across blocks (so a short T still
// fills the card): each block walks its own vocabulary range with a running
// max m, sum l and gold logit per row, and a second small kernel merges the
// splits, nll = M + log Σ_i l_i · exp(m_i − M) − gold, M = max_i m_i.
// Columns past V (the ragged edge of 50257) are masked and never enter l.
// Logits are f32 (bf16 products are exact in f32).
//
// bf16: a Hopper GEMM main loop with the softmax as its epilogue.
//   - A block is 128 token rows × a range of 256-column vocabulary tiles:
//     two consumer warpgroups (64 rows each, 232 registers a thread by
//     setmaxnreg) and one producer warpgroup (40).
//   - The producer's one thread feeds a ring of 4 stages in shared memory
//     by TMA: per stage the block's 128 × 64 hidden tile and the 256 × 64
//     emb tile, in the 128-byte swizzle that wgmma reads. Full and empty
//     mbarriers order the ring; rows past T and V and depth past D arrive
//     as TMA's zeros.
//   - Each consumer runs wgmma m64n256k16 from shared memory on both
//     operands, one stage's four k16 steps per commit, with one stage's
//     products in flight while it waits for the next; its 64 × 256 logits
//     stay in registers (128 a thread).
//   - The epilogue of a tile: the ragged last tile masks its columns past
//     V, then the online softmax in base 2 (ex2.approx, log2 e folded into
//     one FFMA) and the gold logit, on the tile's registers; (m, l, gold)
//     stay in registers across tiles. A warpgroup whose 64 rows all lie
//     past T skips the epilogue.
//   - The grid walks row tiles fastest, so the blocks that run together
//     share their vocabulary tiles: with one block an SM and the splits
//     sized to the card, each emb byte comes from device memory about once
//     and the hidden tiles are re-read from L2.
// f32 keeps the first design: a block of 4 warps computes 64 × 64 tiles
// with f32 FMAs, both tiles loaded through registers each 32-deep chunk.
//
// The combine pass can also write each row's log-sum-exp (a null pointer
// writes nothing), which the backward reads.
//
// Backward (score_ce_bwd_launch; no TPU counterpart: the reference takes
// this gradient through XLA): dh = G · E with G = g · (softmax −
// onehot(label)) from the saved log-sum-exp, one vocabulary chunk of G in
// memory at a time. What bounds it: the logits again (2·T·V·D operations)
// and G · E (as many) at thousands of rows; the embedding, read by both
// products, at a short T. bf16 (the section "backward" below): the
// forward's persistent main loop writes the chunk's G, a wgmma kernel of
// this file adds G · E into f32 partials split over the vocabulary (a short
// T has few output tiles), and a last pass sums them in a fixed order. f32:
// the G pass on the CUDA cores, G · E left to the caller.
//
// The embedding's gradient (score_ce_de_launch, for pretraining the tied
// embedding; no TPU counterpart either): dE = Gᵀ · h, one vocabulary chunk
// of G at a time, after that chunk's G pass. What bounds it: 2·T·V·D
// operations more, so that the backward with dE does three such products
// (the logits again, dh and dE: 6·T·V·D, 0.12 ms at gpt2-base's V and D for
// T = 512 rows at 989 TFLOP/s). bf16: a wgmma kernel of this file
// (score_ce_de_bf16 below); f32: left to the caller, as f32 G · E is.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "warp_tile.cuh"

using namespace repro_torch;

namespace {

// -- f32: 64 × 64 tiles on the CUDA cores -------------------------------------------

constexpr int kRows = 64;     // token rows per block: 4 warps × 16
constexpr int kCols = 64;     // vocabulary columns per step
constexpr int kThreads = 128;
constexpr int kKc = 32, kLd = 36;   // depth of a shared-memory chunk, padded row

__global__ void __launch_bounds__(kThreads)
score_ce_f32(const float* __restrict__ hidden, const float* __restrict__ emb,
             const int* __restrict__ labels, float* __restrict__ part_m,
             float* __restrict__ part_l, float* __restrict__ part_g,
             int n_tok, int dim, int vocab, int n_split) {
  __shared__ __align__(16) float hs[kRows * kLd];
  __shared__ __align__(16) float es[kCols * kLd];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int row0 = blockIdx.x * kRows, split = blockIdx.y;
  const int n_tiles = (vocab + kCols - 1) / kCols;
  const int tile_lo = (int)((long long)split * n_tiles / n_split);
  const int tile_hi = (int)((long long)(split + 1) * n_tiles / n_split);
  const int r0 = row0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int lab0 = r0 < n_tok ? labels[r0] : -1;
  const int lab1 = r1 < n_tok ? labels[r1] : -1;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f, g0 = 0.f, g1 = 0.f;

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int v0 = tile * kCols;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int k0 = 0; k0 < dim; k0 += kKc) {
      __syncthreads();
      load_tile<float, kRows, kKc, kThreads>(hs, kLd, hidden, dim, row0, n_tok, k0, dim);
      load_tile<float, kCols, kKc, kThreads>(es, kLd, emb, dim, v0, vocab, k0, dim);
      __syncthreads();
      warp_tile_mma<8, kKc>(hs + warp * 16 * kLd, kLd, es, kLd, acc);
    }
    // online logsumexp over the tile's columns that lie inside the vocabulary
    // (v0 < vocab, so every row sees at least one)
    float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (v0 + 8 * j + 2 * t + e < vocab) {
          x0 = fmaxf(x0, acc[j][e]);
          x1 = fmaxf(x1, acc[j][2 + e]);
        }
    const float mn0 = fmaxf(m0, quad_max(x0)), mn1 = fmaxf(m1, quad_max(x1));
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = v0 + 8 * j + 2 * t + e;
        if (col < vocab) {
          s0 += expf(acc[j][e] - mn0);
          s1 += expf(acc[j][2 + e] - mn1);
          if (col == lab0) g0 += acc[j][e];
          if (col == lab1) g1 += acc[j][2 + e];
        }
      }
    l0 = l0 * expf(m0 - mn0) + quad_sum(s0);
    l1 = l1 * expf(m1 - mn1) + quad_sum(s1);
    m0 = mn0;
    m1 = mn1;
  }
  g0 = quad_sum(g0);
  g1 = quad_sum(g1);
  if (t == 0) {
    const long long o = (long long)split * n_tok;
    if (r0 < n_tok) { part_m[o + r0] = m0; part_l[o + r0] = l0; part_g[o + r0] = g0; }
    if (r1 < n_tok) { part_m[o + r1] = m1; part_l[o + r1] = l1; part_g[o + r1] = g1; }
  }
}

// -- bf16: TMA, mbarriers and wgmma --------------------------------------------------

constexpr int kBM = 128;                 // token rows per block
constexpr int kBN = 256;                 // vocabulary columns per tile
constexpr int kBK = 64;                  // depth per stage: one 128-byte swizzle row of bf16
constexpr int kStages = 4;
constexpr int kConsumerWarps = 8;        // two warpgroups of 64 rows
constexpr int kTcThreads = 32 * kConsumerWarps + 128;  // + the producer warpgroup
constexpr int kStageA = kBM * kBK * 2;   // 16 KB
constexpr int kStageB = kBN * kBK * 2;   // 32 KB
constexpr int kTcSmem = kStages * (kStageA + kStageB) + 2 * kStages * 8 + 1024;   // + alignment
// The backward's G pass: a ring of 3 stages and, per consumer warpgroup, its
// 64 × 256 G tile in bf16 (four column blocks of 64 rows × 128 bytes) for
// the TMA store.
constexpr int kBwdStages = 3;
constexpr int kGTile = 64 * kBN * 2;
constexpr int kBwdSmem = kBwdStages * (kStageA + kStageB) + 2 * kGTile + 2 * kBwdStages * 8 + 1024;

// acc (this warpgroup's 64 rows × 256 columns) = the products of one tile
// over the depth, from the ring (kRing stages)'s next n_k stages (none: acc
// is left as it is): wgmma m64n256k16 with A K-major and B K-major (the logits: emb's rows are the columns) or
// MN-major (G·E: emb's rows are the depth), one stage's four k16 steps per
// commit, one stage's products in flight while the next is waited for; each
// stage is released once the products after it are issued, the last once
// they are done.
template <bool kMnB, int kRing = kStages>
__device__ __forceinline__ void tile_products(float (&acc)[128], uint32_t a_base, uint32_t b_base,
                                              uint64_t* full, uint64_t* empty, int& stage,
                                              uint32_t& phase, int n_k) {
  const int lane = threadIdx.x & 31;
  int prev = -1;
  for (int kt = 0; kt < n_k; ++kt) {
    mbar_wait(&full[stage], phase);
    wgmma_fence();
    const uint32_t a = a_base + stage * kStageA, b = b_base + stage * kStageB;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t db = kMnB ? desc_mn_major(b + kk * 2048, kStageB / 4)
                               : desc_k_major(b + kk * 32);
      wgmma_m64n256k16_ss<0, kMnB>(acc, desc_k_major(a + kk * 32), db, (kt > 0 || kk > 0) ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait<1>();   // the previous stage's products are done
    if (prev >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
    }
    prev = stage;
    if (++stage == kRing) { stage = 0; phase ^= 1; }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  __syncwarp();
  if (lane == 0 && prev >= 0) mbar_arrive(&empty[prev]);
}

// The consumer warpgroups' part of score_ce_bf16.
__device__ __forceinline__ void consume(uint8_t* sa, uint8_t* sb, uint64_t* full, uint64_t* empty,
                                        const int* __restrict__ labels,
                                        float* __restrict__ part_m, float* __restrict__ part_l,
                                        float* __restrict__ part_g, int n_tok, int vocab,
                                        int row0, int split, int tile_lo, int tile_hi, int n_k) {
  // consumers: warpgroup wg owns rows [row0 + 64·wg, +64)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  // a warpgroup whose rows all lie past T still runs the products (on TMA's
  // zeros: the block's time is set by its other warpgroup) but no epilogue
  const bool live = row0 + 64 * wg < n_tok;
  const int r0 = row0 + 64 * wg + 16 * (warp & 3) + g, r1 = r0 + 8;
  const int lab0 = r0 < n_tok ? labels[r0] : -1;
  const int lab1 = r1 < n_tok ? labels[r1] : -1;
  const uint32_t a_base = smem_u32(sa) + 64 * wg * kBK * 2, b_base = smem_u32(sb);
  float m0 = kNegInf, m1 = kNegInf;   // running max, in log2 units
  float l0 = 0.f, l1 = 0.f, g0 = 0.f, g1 = 0.f;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    tile_products<false>(acc, a_base, b_base, full, empty, stage, phase, n_k);
    if (!live) continue;

    const int v0 = tile * kBN;
    if (v0 + kBN > vocab) {   // the ragged last tile: columns past V never enter max or l
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (v0 + 8 * j + 2 * t + e >= vocab) acc[4 * j + e] = acc[4 * j + 2 + e] = kNegInf;
    }
    float x0 = kNegInf, x1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      x0 = fmaxf(x0, fmaxf(acc[4 * j], acc[4 * j + 1]));
      x1 = fmaxf(x1, fmaxf(acc[4 * j + 2], acc[4 * j + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(x0) * kLog2e), mn1 = fmaxf(m1, quad_max(x1) * kLog2e);
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      s0 += exp2_approx(fmaf(acc[4 * j], kLog2e, -mn0)) +
            exp2_approx(fmaf(acc[4 * j + 1], kLog2e, -mn0));
      s1 += exp2_approx(fmaf(acc[4 * j + 2], kLog2e, -mn1)) +
            exp2_approx(fmaf(acc[4 * j + 3], kLog2e, -mn1));
    }
    l0 = l0 * exp2_approx(m0 - mn0) + s0;   // per-lane partial sums: m is quad-uniform
    l1 = l1 * exp2_approx(m1 - mn1) + s1;
    m0 = mn0;
    m1 = mn1;
    // the gold logit, if it falls in this tile, from the lane that holds it
    const int c0 = lab0 - v0, c1 = lab1 - v0;
    if (c0 >= 0 && c0 < kBN && ((c0 >> 1) & 3) == t) {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
        if (j == (c0 >> 3)) g0 += (c0 & 1) ? acc[4 * j + 1] : acc[4 * j];
    }
    if (c1 >= 0 && c1 < kBN && ((c1 >> 1) & 3) == t) {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
        if (j == (c1 >> 3)) g1 += (c1 & 1) ? acc[4 * j + 3] : acc[4 * j + 2];
    }
  }
  if (!live) return;
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  g0 = quad_sum(g0);
  g1 = quad_sum(g1);
  if (t == 0) {
    constexpr float kLn2 = 0.6931471805599453f;
    const long long o = (long long)split * n_tok;
    if (r0 < n_tok) { part_m[o + r0] = m0 * kLn2; part_l[o + r0] = l0; part_g[o + r0] = g0; }
    if (r1 < n_tok) { part_m[o + r1] = m1 * kLn2; part_l[o + r1] = l1; part_g[o + r1] = g1; }
  }
}

__global__ void __launch_bounds__(kTcThreads, 1)
score_ce_bf16(const __grid_constant__ CUtensorMap tm_h, const __grid_constant__ CUtensorMap tm_e,
              const int* __restrict__ labels, float* __restrict__ part_m,
              float* __restrict__ part_l, float* __restrict__ part_g, int n_tok, int dim,
              int vocab, int n_split, int row_tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sa = smem;                                   // kStages × 128 × 64 hidden
  uint8_t* sb = smem + kStages * kStageA;               // kStages × 256 × 64 emb
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + kStages * kStageB);
  uint64_t* empty = full + kStages;

  const int warp = threadIdx.x >> 5;
  const int rt = blockIdx.x % row_tiles, split = blockIdx.x / row_tiles;
  const int row0 = rt * kBM;
  const int n_vt = (vocab + kBN - 1) / kBN;
  const int tile_lo = (int)((long long)split * n_vt / n_split);
  const int tile_hi = (int)((long long)(split + 1) * n_vt / n_split);
  const int n_k = (dim + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // the warpgroup index, from lane 0 so that the compiler sees it is uniform
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  if (wg == kConsumerWarps / 4) {   // the producer warpgroup: one thread starts the copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 32 * kConsumerWarps) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = tile_lo; tile < tile_hi; ++tile)
        for (int kt = 0; kt < n_k; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], kStageA + kStageB);
          tma_load_2d(sa + stage * kStageA, &tm_h, &full[stage], kt * kBK, row0);
          tma_load_2d(sb + stage * kStageB, &tm_e, &full[stage], kt * kBK, tile * kBN);
          if (++stage == kStages) { stage = 0; phase ^= 1; }
        }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    consume(sa, sb, full, empty, labels, part_m, part_l, part_g, n_tok, vocab, row0, split,
            tile_lo, tile_hi, n_k);
  }
}

// One warp per row: the lanes read the splits' partials in parallel. With a
// non-null lse it also writes each row's log-sum-exp, which the backward reads.
__global__ void score_ce_combine(const float* __restrict__ part_m,
                                 const float* __restrict__ part_l,
                                 const float* __restrict__ part_g,
                                 float* __restrict__ nll, float* __restrict__ lse,
                                 int n_tok, int n_split) {
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (r >= n_tok) return;
  float M = -INFINITY;
  for (int i = lane; i < n_split; i += 32) M = fmaxf(M, part_m[(long long)i * n_tok + r]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
  float L = 0.f, G = 0.f;
  for (int i = lane; i < n_split; i += 32) {
    const long long o = (long long)i * n_tok + r;
    L += part_l[o] * expf(part_m[o] - M);
    G += part_g[o];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    L += __shfl_xor_sync(0xffffffffu, L, o);
    G += __shfl_xor_sync(0xffffffffu, G, o);
  }
  if (lane == 0) {
    const float lz = M + logf(fmaxf(L, 1e-30f));
    nll[r] = lz - G;
    if (lse != nullptr) lse[r] = lz;
  }
}

// -- backward ------------------------------------------------------------------------
//
// dL/dhidden = G · E, G[r, c] = g_r · (exp(logit[r, c] − lse_r) − [c == label_r]),
// one vocabulary chunk [c0, c0 + width) at a time, so that only a (T, chunk)
// slice of G is ever in memory. dE, when it is asked for, is formed from the
// same chunk of G after this pass (see "the embedding's gradient"). bf16:
//   1. score_ce_bwd_bf16 recomputes the chunk's logits with the forward's
//      producer and main loop, each block walking its own range of
//      256-column tiles with the ring kept full across them, and writes G in
//      bf16 (XLA rounds the logits' gradient to the operands' type), zero in
//      the padding columns up to ldg: each warpgroup stages its 64 × 256
//      G tile in shared memory and one thread stores it by TMA, which
//      overlaps the next tile's products. That buffer leaves room for a ring
//      of 3 stages where the forward has 4. What bounds it beyond the
//      products: the G epilogue (exponentials, G staged, two named barriers
//      a tile) stalls both warpgroups, which share the ring's stages, while
//      the tensor cores idle (tools/backward_variants.py, no_g_epilogue).
//   2. score_ce_ge_bf16: dh's f32 partial of each vocabulary split, G (K-major
//      A) times the chunk's E rows (MN-major B: E's rows are the depth), a
//      128 × 256 output tile a block over a range of 64-row k tiles; the
//      first chunk writes the partials, later chunks add to them (each element
//      owned by one block, so the order is fixed).
//   3. score_ce_ge_sum (after the last chunk) sums the splits' partials in
//      split order and rounds to bf16.
// So the whole sum is f32 and does not depend on scheduling, and no library
// GEMM runs. The splits fill the card when T × D has few output tiles (a
// short T: at T = 136, D = 768 six tiles, 22 splits); the partials stay
// within a byte budget that the wrapper sets (kernels/score_ce.py).

// The consumer warpgroups' part of score_ce_bwd_bf16: G of the tiles
// [tile_lo, tile_hi) of the chunk, 128 rows a tile. Each warpgroup stores its
// 64 × 256 G tile into shared memory (the 128-byte swizzle, no bank
// conflicts) and one thread writes it out by TMA, which clips rows past T
// and columns past ldg and overlaps the next tile's products.
__device__ __forceinline__ void consume_bwd(uint8_t* sa, uint8_t* sb, uint8_t* sg, uint64_t* full,
                                            uint64_t* empty, const CUtensorMap* tm_g,
                                            const int* __restrict__ labels,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ gout, int n_tok, int c0,
                                            int v_end, int row0, int tile_lo, int tile_hi,
                                            int n_k) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int tid = threadIdx.x & 127;
  const bool live = row0 + 64 * wg < n_tok;   // as the forward: products, but no epilogue
  const int r0 = row0 + 64 * wg + 16 * (warp & 3) + g, r1 = r0 + 8;
  const uint32_t a_base = smem_u32(sa) + 64 * wg * kBK * 2, b_base = smem_u32(sb);
  uint8_t* tile_g = sg + wg * kGTile;
  const int q0 = 16 * (warp & 3) + g, q1 = q0 + 8;   // this lane's rows of the G tile
  const bool in0 = r0 < n_tok, in1 = r1 < n_tok;
  const float l0 = in0 ? lse[r0] * kLog2e : 0.f, l1 = in1 ? lse[r1] * kLog2e : 0.f;
  const float s0 = in0 ? gout[r0] : 0.f, s1 = in1 ? gout[r1] : 0.f;
  const int y0 = in0 ? labels[r0] : -1, y1 = in1 ? labels[r1] : -1;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    tile_products<false, kBwdStages>(acc, a_base, b_base, full, empty, stage, phase, n_k);
    if (!live) continue;
    const int v0 = c0 + tile * kBN;
    if (tid == 0) bulk_wait_read<0>();   // the last tile's store has read the buffer
    bar_sync(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = v0 + 8 * j + 2 * t;
      float v[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = col + e < v_end;   // zeros past the chunk, up to ldg
        v[e] = in ? s0 * (exp2_approx(fmaf(acc[4 * j + e], kLog2e, -l0)) -
                          (col + e == y0 ? 1.f : 0.f)) : 0.f;
        v[2 + e] = in ? s1 * (exp2_approx(fmaf(acc[4 * j + 2 + e], kLog2e, -l1)) -
                              (col + e == y1 ? 1.f : 0.f)) : 0.f;
      }
      // column block j / 8; the 16-byte chunk j % 8 of row q at chunk (j % 8) ^ (q % 8)
      uint8_t* blk = tile_g + (j >> 3) * (64 * 128) + ((((j & 7) ^ g)) << 4) + 4 * t;
      *reinterpret_cast<uint32_t*>(blk + q0 * 128) = pack_bf16(v[0], v[1]);
      *reinterpret_cast<uint32_t*>(blk + q1 * 128) = pack_bf16(v[2], v[3]);
    }
    fence_proxy_async();
    bar_sync(1 + wg, 128);
    if (tid == 0) {
#pragma unroll
      for (int cb = 0; cb < kBN / 64; ++cb)
        tma_store_2d(tm_g, tile_g + cb * (64 * 128), v0 - c0 + 64 * cb, row0 + 64 * wg);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait_all();
}

// Block (row tile, split), row tiles fastest as in the forward; split takes
// the chunk's 256-column tiles [split·n/n_split, (split + 1)·n/n_split).
__global__ void __launch_bounds__(kTcThreads, 1)
score_ce_bwd_bf16(const __grid_constant__ CUtensorMap tm_h, const __grid_constant__ CUtensorMap tm_e,
                  const __grid_constant__ CUtensorMap tm_g, const int* __restrict__ labels,
                  const float* __restrict__ lse, const float* __restrict__ gout, int n_tok,
                  int dim, int c0, int v_end, int n_split, int row_tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sa = smem;
  uint8_t* sb = smem + kBwdStages * kStageA;
  uint8_t* sg = sb + kBwdStages * kStageB;
  uint64_t* full = reinterpret_cast<uint64_t*>(sg + 2 * kGTile);
  uint64_t* empty = full + kBwdStages;

  const int warp = threadIdx.x >> 5;
  const int row0 = (blockIdx.x % row_tiles) * kBM, split = blockIdx.x / row_tiles;
  const int n_vt = (v_end - c0 + kBN - 1) / kBN;
  const int tile_lo = (int)((long long)split * n_vt / n_split);
  const int tile_hi = (int)((long long)(split + 1) * n_vt / n_split);
  const int n_k = (dim + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  if (wg == kConsumerWarps / 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 32 * kConsumerWarps) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = tile_lo; tile < tile_hi; ++tile)
        for (int kt = 0; kt < n_k; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], kStageA + kStageB);
          tma_load_2d(sa + stage * kStageA, &tm_h, &full[stage], kt * kBK, row0);
          tma_load_2d(sb + stage * kStageB, &tm_e, &full[stage], kt * kBK, c0 + tile * kBN);
          if (++stage == kBwdStages) { stage = 0; phase ^= 1; }
        }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    consume_bwd(sa, sb, sg, full, empty, &tm_g, labels, lse, gout, n_tok, c0, v_end, row0,
                tile_lo, tile_hi, n_k);
  }
}

// Block (row tile, column tile of D, split), row tiles fastest: the blocks
// that run together share E's tiles through L2. A stage is G's 128 rows × 64
// chunk columns (16 KB) and the 64 matching E rows × 256 columns of D, four
// column blocks of 64 (32 KB); split takes the chunk's 64-row k tiles
// [split·n_kt/n_split, (split + 1)·n_kt/n_split). part is (n_split, T, D) f32.
__global__ void __launch_bounds__(kTcThreads, 1)
score_ce_ge_bf16(const __grid_constant__ CUtensorMap tm_g, const __grid_constant__ CUtensorMap tm_e,
                 float* __restrict__ part, int n_tok, int dim, int c0, int n_kt, int n_split,
                 int row_tiles, int col_tiles, int first) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sa = smem;
  uint8_t* sb = smem + kStages * kStageA;
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + kStages * kStageB);
  uint64_t* empty = full + kStages;

  const int warp = threadIdx.x >> 5;
  const int rt = blockIdx.x % row_tiles, dt = (blockIdx.x / row_tiles) % col_tiles;
  const int split = blockIdx.x / (row_tiles * col_tiles);
  const int k_lo = (int)((long long)split * n_kt / n_split);
  const int k_hi = (int)((long long)(split + 1) * n_kt / n_split);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  if (wg == kConsumerWarps / 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 32 * kConsumerWarps) {
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = k_lo; kt < k_hi; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], kStageA + kStageB);
        tma_load_2d(sa + stage * kStageA, &tm_g, &full[stage], kt * kBK, rt * kBM);
#pragma unroll
        for (int cb = 0; cb < kBN / 64; ++cb)
          tma_load_2d(sb + stage * kStageB + cb * (kStageB / 4), &tm_e, &full[stage],
                      dt * kBN + 64 * cb, c0 + kt * kBK);
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int r0 = rt * kBM + 64 * wg + 16 * (warp & 3) + (lane >> 2), r1 = r0 + 8;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    int stage = 0;
    uint32_t phase = 0;
    tile_products<true>(acc, smem_u32(sa) + 64 * wg * kBK * 2, smem_u32(sb), full, empty, stage,
                        phase, k_hi - k_lo);
    float* p0 = part + ((long long)split * n_tok + r0) * dim;
    float* p1 = part + ((long long)split * n_tok + r1) * dim;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int d = dt * kBN + 8 * j + 2 * t;
      if (d >= dim) continue;
      float2 a = make_float2(acc[4 * j], acc[4 * j + 1]);
      float2 b = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      if (r0 < n_tok) {
        float2* q = reinterpret_cast<float2*>(p0 + d);
        if (!first) { const float2 o = *q; a.x += o.x; a.y += o.y; }
        *q = a;
      }
      if (r1 < n_tok) {
        float2* q = reinterpret_cast<float2*>(p1 + d);
        if (!first) { const float2 o = *q; b.x += o.x; b.y += o.y; }
        *q = b;
      }
    }
  }
}

// dh (n elements, bf16) = Σ_s part[s] in split order, four elements a thread.
__global__ void score_ce_ge_sum(const float* __restrict__ part, __nv_bfloat16* __restrict__ dh,
                                long long n, int n_split) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (4 * i >= n) return;
  float4 acc = reinterpret_cast<const float4*>(part)[i];
  for (int s = 1; s < n_split; ++s) {
    const float4 x = reinterpret_cast<const float4*>(part + s * n)[i];
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(dh) + 2 * i;
  out[0] = __floats2bfloat162_rn(acc.x, acc.y);
  out[1] = __floats2bfloat162_rn(acc.z, acc.w);
}

// -- the embedding's gradient --------------------------------------------------------
//
// dE[c0 + m, :] = Σ_r G[r, m] · h[r, :] over the T tokens r, for the chunk's
// columns m of G (bf16, rows ldg apart) as the G pass left them. Each chunk
// owns its rows of dE, so there is no split, no atomic and no partial: a
// block owns a 128 × 256 tile of dE (128 vocabulary rows, 256 columns of D),
// walks the whole depth T with its sums in f32 registers, and rounds to
// E's type (bf16) once. A stage is 64 tokens: Gᵀ's 128 × 64, two 64-column
// boxes of G read MN-major (the vocabulary runs along G's rows), and h's
// 64 × 256, four 64-column boxes read MN-major (D runs along h's rows), as
// score_ce_ge_bf16 reads E; a ring of 4 stages fed by TMA from one producer
// thread, two consumer warpgroups of 64 vocabulary rows. Rows of T past the
// end and columns past ldg arrive as TMA's zeros; rows past the chunk are
// not stored. The grid walks the column tiles of D fastest, so the blocks
// that read one tile of G run together and share it through L2.

// acc (this warpgroup's 64 vocabulary rows × 256 columns of D) = Gᵀ · h over
// the ring's first n_k stages: wgmma m64n256k16, A and B both MN-major.
__device__ __forceinline__ void de_products(float (&acc)[128], uint32_t a_base, uint32_t b_base,
                                            uint64_t* full, uint64_t* empty, int n_k) {
  const int lane = threadIdx.x & 31;
  int stage = 0, prev = -1;
  uint32_t phase = 0;
  for (int kt = 0; kt < n_k; ++kt) {
    mbar_wait(&full[stage], phase);
    wgmma_fence();
    const uint32_t a = a_base + stage * kStageA, b = b_base + stage * kStageB;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_m64n256k16_ss<1, 1>(acc, desc_mn_major(a + kk * 2048, kStageA / 2),
                                desc_mn_major(b + kk * 2048, kStageB / 4),
                                (kt > 0 || kk > 0) ? 1 : 0);
    wgmma_commit();
    wgmma_wait<1>();   // the previous stage's products are done
    if (prev >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
    }
    prev = stage;
    if (++stage == kStages) { stage = 0; phase ^= 1; }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  __syncwarp();
  if (lane == 0 && prev >= 0) mbar_arrive(&empty[prev]);
}

// Block (column tile of D, vocabulary row tile), column tiles fastest.
__global__ void __launch_bounds__(kTcThreads, 1)
score_ce_de_bf16(const __grid_constant__ CUtensorMap tm_g, const __grid_constant__ CUtensorMap tm_h,
                 __nv_bfloat16* __restrict__ de, int n_tok, int dim, int c0, int v_end,
                 int d_tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sa = smem;                             // kStages × (2 × 64 tokens × 64 columns of G)
  uint8_t* sb = smem + kStages * kStageA;         // kStages × (4 × 64 tokens × 64 columns of h)
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + kStages * kStageB);
  uint64_t* empty = full + kStages;

  const int warp = threadIdx.x >> 5;
  const int dt = blockIdx.x % d_tiles, mt = blockIdx.x / d_tiles;
  const int n_k = (n_tok + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  if (wg == kConsumerWarps / 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 32 * kConsumerWarps) {
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < n_k; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], kStageA + kStageB);
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
          tma_load_2d(sa + stage * kStageA + mb * (kStageA / 2), &tm_g, &full[stage],
                      mt * kBM + 64 * mb, kt * kBK);
#pragma unroll
        for (int cb = 0; cb < kBN / 64; ++cb)
          tma_load_2d(sb + stage * kStageB + cb * (kStageB / 4), &tm_h, &full[stage],
                      dt * kBN + 64 * cb, kt * kBK);
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31, t = lane & 3;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    de_products(acc, smem_u32(sa) + wg * (kStageA / 2), smem_u32(sb), full, empty, n_k);
    const int m0 = c0 + mt * kBM + 64 * wg + 16 * (warp & 3) + (lane >> 2), m1 = m0 + 8;
    __nv_bfloat16* p0 = de + (long long)m0 * dim;
    __nv_bfloat16* p1 = de + (long long)m1 * dim;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int d = dt * kBN + 8 * j + 2 * t;
      if (d >= dim) continue;
      if (m0 < v_end)
        *reinterpret_cast<__nv_bfloat162*>(p0 + d) = __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      if (m1 < v_end)
        *reinterpret_cast<__nv_bfloat162*>(p1 + d) =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// f32: 64 × 64 tiles on the CUDA cores, as the f32 forward.
__global__ void __launch_bounds__(kThreads)
score_ce_bwd_f32(const float* __restrict__ hidden, const float* __restrict__ emb,
                 const int* __restrict__ labels, const float* __restrict__ lse,
                 const float* __restrict__ gout, float* __restrict__ G, int ldg, int n_tok,
                 int dim, int vocab, int c0, int v_end) {
  __shared__ __align__(16) float hs[kRows * kLd];
  __shared__ __align__(16) float es[kCols * kLd];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int row0 = blockIdx.x * kRows, v0 = c0 + blockIdx.y * kCols;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int k0 = 0; k0 < dim; k0 += kKc) {
    __syncthreads();
    load_tile<float, kRows, kKc, kThreads>(hs, kLd, hidden, dim, row0, n_tok, k0, dim);
    load_tile<float, kCols, kKc, kThreads>(es, kLd, emb, dim, v0, vocab, k0, dim);
    __syncthreads();
    warp_tile_mma<8, kKc>(hs + warp * 16 * kLd, kLd, es, kLd, acc);
  }
  const int r0 = row0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const bool in0 = r0 < n_tok, in1 = r1 < n_tok;
  const float l0 = in0 ? lse[r0] : 0.f, l1 = in1 ? lse[r1] : 0.f;
  const float s0 = in0 ? gout[r0] : 0.f, s1 = in1 ? gout[r1] : 0.f;
  const int y0 = in0 ? labels[r0] : -1, y1 = in1 ? labels[r1] : -1;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = v0 + 8 * j + 2 * t + e, lc = col - c0;
      if (lc >= ldg) continue;
      const bool live = col < v_end;
      if (in0)
        G[(long long)r0 * ldg + lc] =
            live ? s0 * (expf(acc[j][e] - l0) - (col == y0 ? 1.f : 0.f)) : 0.f;
      if (in1)
        G[(long long)r1 * ldg + lc] =
            live ? s1 * (expf(acc[j][2 + e] - l1) - (col == y1 ? 1.f : 0.f)) : 0.f;
    }
}

// A (rows × cols) row-major bf16 matrix read in boxes of box_rows × 64.
bool map_2d(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const long long dims[2] = {cols, rows}, strides[1] = {cols};
  return bf16_map(map, base, 2, dims, strides, box_rows);
}

}  // namespace

// part holds 3 × n_split × n_tok f32 (m, l, gold); nll n_tok f32. bf16
// blocks take 128 rows and 256-column tiles, f32 blocks 64 and 64; n_split
// splits the vocabulary tiles of that size. Returns cudaGetLastError()
// after the launches (0 on success), or cudaErrorInvalidValue if a tensor
// map cannot be made.
extern "C" int score_ce_launch(const void* hidden, const void* emb, const void* labels,
                               void* part, void* nll, void* lse, int n_tok, int dim, int vocab,
                               int n_split, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pm = static_cast<float*>(part);
  float* pl = pm + (long long)n_split * n_tok;
  float* pg = pl + (long long)n_split * n_tok;
  const int* lab = static_cast<const int*>(labels);
  if (is_bf16) {
    CUtensorMap tm_h, tm_e;
    if (!map_2d(&tm_h, hidden, n_tok, dim, kBM) || !map_2d(&tm_e, emb, vocab, dim, kBN))
      return (int)cudaErrorInvalidValue;
    static bool attr = false;
    if (!attr) {
      const cudaError_t e = cudaFuncSetAttribute(
          score_ce_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
      if (e != cudaSuccess) return (int)e;
      attr = true;
    }
    const int row_tiles = (n_tok + kBM - 1) / kBM;
    score_ce_bf16<<<row_tiles * n_split, kTcThreads, kTcSmem, s>>>(
        tm_h, tm_e, lab, pm, pl, pg, n_tok, dim, vocab, n_split, row_tiles);
  } else {
    const dim3 grid((n_tok + kRows - 1) / kRows, n_split);
    score_ce_f32<<<grid, kThreads, 0, s>>>(static_cast<const float*>(hidden),
                                           static_cast<const float*>(emb), lab, pm, pl, pg,
                                           n_tok, dim, vocab, n_split);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  score_ce_combine<<<(n_tok + 7) / 8, 256, 0, s>>>(pm, pl, pg, static_cast<float*>(nll),
                                                  static_cast<float*>(lse), n_tok, n_split);
  return (int)cudaGetLastError();
}

// The backward over one vocabulary chunk [c0, c0 + width): G (n_tok × ldg,
// hidden's element type; ldg a multiple of 8 and at least width) = g ·
// (softmax − onehot) on the chunk's columns, zero in the padding; lse and g
// are n_tok f32. bf16 also adds G · E[c0, c0 + width) into part (ge_splits
// × n_tok × dim f32; the first chunk writes it) and, after the last chunk,
// writes dh (n_tok × dim bf16) = part summed over the splits; the G pass
// splits the chunk's 256-column tiles g_splits ways. f32 leaves G · E to the
// caller. Returns cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue if a tensor map cannot be made.
extern "C" int score_ce_bwd_launch(const void* hidden, const void* emb, const void* labels,
                                   const void* lse, const void* gout, void* G, int ldg,
                                   void* part, void* dh, int n_tok, int dim, int vocab, int c0,
                                   int width, int g_splits, int ge_splits, int first, int last,
                                   int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int v_end = c0 + width < vocab ? c0 + width : vocab;
  const int* lab = static_cast<const int*>(labels);
  const float* lz = static_cast<const float*>(lse);
  const float* go = static_cast<const float*>(gout);
  if (!is_bf16) {
    const dim3 grid((n_tok + kRows - 1) / kRows, (width + kCols - 1) / kCols);
    score_ce_bwd_f32<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(hidden), static_cast<const float*>(emb), lab, lz, go,
        static_cast<float*>(G), ldg, n_tok, dim, vocab, c0, v_end);
    return (int)cudaGetLastError();
  }
  CUtensorMap tm_h, tm_e, tm_g, tm_gs, tm_e64;
  if (!map_2d(&tm_h, hidden, n_tok, dim, kBM) || !map_2d(&tm_e, emb, vocab, dim, kBN) ||
      !map_2d(&tm_g, G, n_tok, ldg, kBM) || !map_2d(&tm_gs, G, n_tok, ldg, 64) ||
      !map_2d(&tm_e64, emb, vocab, dim, kBK))
    return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(score_ce_bwd_bf16,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(score_ce_ge_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kTcSmem);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const int row_tiles = (n_tok + kBM - 1) / kBM;
  score_ce_bwd_bf16<<<row_tiles * g_splits, kTcThreads, kBwdSmem, s>>>(
      tm_h, tm_e, tm_gs, lab, lz, go, n_tok, dim, c0, v_end, g_splits, row_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int col_tiles = (dim + kBN - 1) / kBN, n_kt = (width + kBK - 1) / kBK;
  float* pf = static_cast<float*>(part);
  score_ce_ge_bf16<<<row_tiles * col_tiles * ge_splits, kTcThreads, kTcSmem, s>>>(
      tm_g, tm_e64, pf, n_tok, dim, c0, n_kt, ge_splits, row_tiles, col_tiles, first);
  err = cudaGetLastError();
  if (err != cudaSuccess || !last) return (int)err;
  const long long n = (long long)n_tok * dim;
  score_ce_ge_sum<<<(unsigned)((n / 4 + 255) / 256), 256, 0, s>>>(
      pf, static_cast<__nv_bfloat16*>(dh), n, ge_splits);
  return (int)cudaGetLastError();
}

// dE rows [c0, c0 + width) (de: vocab × dim bf16, E's layout) = the chunk's
// G (n_tok × ldg bf16, as score_ce_bwd_launch wrote it)ᵀ · hidden (n_tok ×
// dim bf16). Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue if a tensor map cannot be made.
extern "C" int score_ce_de_launch(const void* G, int ldg, const void* hidden, void* de, int n_tok,
                                  int dim, int vocab, int c0, int width, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap tm_g, tm_h;
  if (!map_2d(&tm_g, G, n_tok, ldg, kBK) || !map_2d(&tm_h, hidden, n_tok, dim, kBK))
    return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        score_ce_de_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const int v_end = c0 + width < vocab ? c0 + width : vocab;
  const int m_tiles = (width + kBM - 1) / kBM, d_tiles = (dim + kBN - 1) / kBN;
  score_ce_de_bf16<<<m_tiles * d_tiles, kTcThreads, kTcSmem, s>>>(
      tm_g, tm_h, static_cast<__nv_bfloat16*>(de), n_tok, dim, c0, v_end, d_tiles);
  return (int)cudaGetLastError();
}
