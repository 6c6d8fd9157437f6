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
// this gradient through XLA). For one vocabulary chunk it recomputes the
// logits with the forward's main loop (bf16: one block per 128 × 256 tile,
// the same TMA ring and wgmma products; f32: 64 × 64 tiles) and writes, as
// its epilogue, G = g · (softmax − onehot(label)) from the saved
// log-sum-exp, in hidden's element type as XLA rounds the logits' gradient
// to the operands' type. The caller multiplies G by the chunk's emb rows
// (a plain GEMM), so only a (T, chunk) slice of the (T, V) gradient is ever
// in memory. Bound: the same products as the forward plus T × chunk
// elements written and read back by that GEMM.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// Waits until the phase of parity `parity` has completed. A wait that lasts
// 2^34 clocks (about 10 s) traps, so a broken pipeline fails the launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  long long start = 0;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (!done) {
      if (start == 0) start = clock64();
      else if (clock64() - start > (1LL << 34)) __trap();
    }
  } while (!done);
}

// A box of the tensor map at (c0 = depth, c1 = row) into shared memory,
// completing `bytes` of the barrier's transaction count.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(smem_u32(bar))
      : "memory");
}

// wgmma descriptor of a K-major tile in the 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart (the tile's base 1024-aligned).
// Adding 2 advances it by one k16 step (32 bytes).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t smem_addr) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// d (64 × 256, f32, the m16n8 accumulator layout per n8 tile: d[4j + e] is
// row 16·warp + g + 8·(e >> 1), column 8j + 2t + (e & 1)) = A · Bᵀ (+ d if
// scale_d), A 64 × 16 and B 256 × 16 bf16, both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// Pins the accumulators after a wgmma wait: later reads may not move above it.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
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
    int prev = -1;
    for (int kt = 0; kt < n_k; ++kt) {
      mbar_wait(&full[stage], phase);
      wgmma_fence();
      const uint64_t da = sw128_desc(a_base + stage * kStageA);
      const uint64_t db = sw128_desc(b_base + stage * kStageB);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_m64n256k16(acc, da + 2 * kk, db + 2 * kk, (kt > 0 || kk > 0) ? 1 : 0);
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
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[prev]);
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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// -- backward: dL/dlogits of one vocabulary chunk -----------------------------------
//
// G[r, c - c0] = g_r · (exp(logit[r, c] − lse_r) − [c == label_r]) for the
// columns c of [c0, v_end), zero in the padding columns up to ldg. The
// logits are recomputed by the forward's main loop; dh = G · E[c0:v_end] is
// left to a matrix product outside the kernel, as the reference leaves it to
// XLA. E is frozen, so no dE is formed.

// The consumer warpgroups' part of score_ce_bwd_bf16: one 128 × 256 tile.
__device__ __forceinline__ void consume_bwd(uint8_t* sa, uint8_t* sb, uint64_t* full,
                                            uint64_t* empty, const int* __restrict__ labels,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ gout,
                                            __nv_bfloat16* __restrict__ G, int ldg, int n_tok,
                                            int c0, int v_end, int row0, int v0, int n_k) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r0 = row0 + 64 * wg + 16 * (warp & 3) + g, r1 = r0 + 8;
  const uint32_t a_base = smem_u32(sa) + 64 * wg * kBK * 2, b_base = smem_u32(sb);
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  int stage = 0, prev = -1;
  uint32_t phase = 0;
  for (int kt = 0; kt < n_k; ++kt) {
    mbar_wait(&full[stage], phase);
    wgmma_fence();
    const uint64_t da = sw128_desc(a_base + stage * kStageA);
    const uint64_t db = sw128_desc(b_base + stage * kStageB);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_m64n256k16(acc, da + 2 * kk, db + 2 * kk, (kt > 0 || kk > 0) ? 1 : 0);
    wgmma_commit();
    wgmma_wait<1>();
    if (prev >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
    }
    prev = stage;
    if (++stage == kStages) { stage = 0; phase ^= 1; }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[prev]);

  const bool in0 = r0 < n_tok, in1 = r1 < n_tok;
  const float l0 = in0 ? lse[r0] * kLog2e : 0.f, l1 = in1 ? lse[r1] * kLog2e : 0.f;
  const float s0 = in0 ? gout[r0] : 0.f, s1 = in1 ? gout[r1] : 0.f;
  const int y0 = in0 ? labels[r0] : -1, y1 = in1 ? labels[r1] : -1;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = v0 + 8 * j + 2 * t, lc = col - c0;
    if (lc >= ldg) continue;
    float v[4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool live = col + e < v_end;
      v[e] = live ? s0 * (exp2_approx(fmaf(acc[4 * j + e], kLog2e, -l0)) -
                          (col + e == y0 ? 1.f : 0.f)) : 0.f;
      v[2 + e] = live ? s1 * (exp2_approx(fmaf(acc[4 * j + 2 + e], kLog2e, -l1)) -
                              (col + e == y1 ? 1.f : 0.f)) : 0.f;
    }
    if (in0)
      *reinterpret_cast<__nv_bfloat162*>(G + (long long)r0 * ldg + lc) =
          __floats2bfloat162_rn(v[0], v[1]);
    if (in1)
      *reinterpret_cast<__nv_bfloat162*>(G + (long long)r1 * ldg + lc) =
          __floats2bfloat162_rn(v[2], v[3]);
  }
}

// One block per (128-row tile, 256-column vocabulary tile of the chunk): the
// forward's producer and main loop over the depth, then the G epilogue.
__global__ void __launch_bounds__(kTcThreads, 1)
score_ce_bwd_bf16(const __grid_constant__ CUtensorMap tm_h, const __grid_constant__ CUtensorMap tm_e,
                  const int* __restrict__ labels, const float* __restrict__ lse,
                  const float* __restrict__ gout, __nv_bfloat16* __restrict__ G, int ldg,
                  int n_tok, int dim, int c0, int v_end, int row_tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sa = smem;
  uint8_t* sb = smem + kStages * kStageA;
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + kStages * kStageB);
  uint64_t* empty = full + kStages;

  const int warp = threadIdx.x >> 5;
  const int row0 = (blockIdx.x % row_tiles) * kBM;
  const int v0 = c0 + (blockIdx.x / row_tiles) * kBN;
  const int n_k = (dim + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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
        tma_load_2d(sa + stage * kStageA, &tm_h, &full[stage], kt * kBK, row0);
        tma_load_2d(sb + stage * kStageB, &tm_e, &full[stage], kt * kBK, v0);
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    consume_bwd(sa, sb, full, empty, labels, lse, gout, G, ldg, n_tok, c0, v_end, row0, v0, n_k);
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

// cuTensorMapEncodeTiled from the libcuda the process already loaded (no
// link-time dependency on libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A (rows × dim) row-major bf16 matrix read in boxes of box_rows × 64 in the
// 128-byte swizzle; out-of-bounds elements read as zero.
bool bf16_map(CUtensorMap* map, const void* base, int rows, int dim, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t gdim[2] = {(cuuint64_t)dim, (cuuint64_t)rows};
  const cuuint64_t gstride[1] = {(cuuint64_t)dim * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t estride[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), gdim,
                gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
    if (!bf16_map(&tm_h, hidden, n_tok, dim, kBM) || !bf16_map(&tm_e, emb, vocab, dim, kBN))
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
// hidden's element type; ldg even and at least width) = g · (softmax −
// onehot) on the chunk's columns, zero past V and in the padding. lse and
// g are n_tok f32. Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue if a tensor map cannot be made.
extern "C" int score_ce_bwd_launch(const void* hidden, const void* emb, const void* labels,
                                   const void* lse, const void* gout, void* G, int ldg,
                                   int n_tok, int dim, int vocab, int c0, int width,
                                   int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int v_end = c0 + width < vocab ? c0 + width : vocab;
  const int* lab = static_cast<const int*>(labels);
  const float* lz = static_cast<const float*>(lse);
  const float* go = static_cast<const float*>(gout);
  if (is_bf16) {
    CUtensorMap tm_h, tm_e;
    if (!bf16_map(&tm_h, hidden, n_tok, dim, kBM) || !bf16_map(&tm_e, emb, vocab, dim, kBN))
      return (int)cudaErrorInvalidValue;
    static bool attr = false;
    if (!attr) {
      const cudaError_t e = cudaFuncSetAttribute(
          score_ce_bwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
      if (e != cudaSuccess) return (int)e;
      attr = true;
    }
    const int row_tiles = (n_tok + kBM - 1) / kBM, col_tiles = (width + kBN - 1) / kBN;
    score_ce_bwd_bf16<<<row_tiles * col_tiles, kTcThreads, kTcSmem, s>>>(
        tm_h, tm_e, lab, lz, go, static_cast<__nv_bfloat16*>(G), ldg, n_tok, dim, c0, v_end,
        row_tiles);
  } else {
    const dim3 grid((n_tok + kRows - 1) / kRows, (width + kCols - 1) / kCols);
    score_ce_bwd_f32<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(hidden), static_cast<const float*>(emb), lab, lz, go,
        static_cast<float*>(G), ldg, n_tok, dim, vocab, c0, v_end);
  }
  return (int)cudaGetLastError();
}
