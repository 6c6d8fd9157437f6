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
// 3.35 TB/s) and does 146 GFLOP (0.15 ms at 989 TFLOP/s): 242 operations a
// byte against the card's ridge of 295. The products must run on Hopper's
// tensor cores at close to their full rate, which only wgmma reaches.
//
// bf16: TMA, mbarriers and wgmma. One block per (group of 64 query heads,
// split, batch row), three warpgroups:
//   - Warpgroup 2 produces: after setmaxnreg gives its registers away (40 a
//     thread), one thread loads the block's Q = [q_lat | q_pe] once and then
//     keeps a ring of 2 stages of 64 cache rows [ckv | kpe] in flight, by
//     TMA with full/empty mbarriers. Q and each stage are 9 column blocks of
//     64 rows × 64 columns (128 bytes, the 128-byte swizzle that wgmma
//     reads): 8 of the latent, 1 of the rope part. Heads past H and rows
//     past hi arrive as TMA's zeros (the tensor maps end at H and hi). A
//     wait that lasts about 10 s traps, so a broken pipeline fails the
//     launch instead of hanging the card.
//   - Warpgroup 0 (232 registers a thread) computes a tile's 64 heads × 64
//     rows of scores with 36 wgmma m64n64k16 over the 576-wide depth, Q and
//     the tile both K-major in shared memory: no depth split and no partial
//     sums in shared memory. The online softmax runs on the accumulators: a
//     head row's 64 scores sit in one quad of lanes, so its max and sum are
//     two shuffles; scale · log2 e is folded into one FFMA before
//     ex2.approx; the running max and sum stay in registers (a partial sum
//     per lane, reduced once at the end).
//   - P is rounded to one bf16 term. Warpgroup 0 packs it in registers into
//     the A operand of its P·ckv (output columns 0-255), and stores it into
//     shared memory, with the rows' rescale factors, for warpgroup 1 (output
//     columns 256-511), which reads it there as a K-major A operand. Two
//     named barriers hand P over (written, read). Each consumer keeps its
//     64 × 256 f32 output in 128 accumulator registers and runs 4 wgmma
//     m64n256k16 a tile whose B is the stage's ckv part read MN-major: the
//     one tile in shared memory is the K-major B of the scores and the
//     MN-major B of P·ckv, with no transposed copy. Warpgroup 0 waits for
//     its P·ckv before it issues the next tile's scores, so that each stage
//     is freed as soon as both halves of P·ckv are done: the ring waits on
//     the loads more than on the products.
//   - One bf16 term of P errs by at most 2^-9 of each probability; at the
//     serve shape that takes under half of the parity tolerance
//     (tests/test_torch_mla.py's CPU mirror of this arithmetic). Two terms
//     (hi + lo) would double the P·ckv products, and their second P tile
//     would not fit.
// Tensor work a 64-row tile: 36 m64n64k16 + 2 × 4 m64n256k16, the minimum.
// Shared memory: Q 73,728 B + P 8,192 B + 2 stages × 73,728 B + rescale
// factors and sums 512 B + 5 mbarriers 40 B + 1,024 B to align the swizzled
// tiles = 230,952 B of the 232,448 a block may use: one block an SM, and no
// room for a third stage. So the ring overlaps the loads with the products
// only in part (on an H100 at the serve shape each alone takes most of the
// kernel's time; tools/mla_decode_variants.py, PERF.md). A cluster of two
// blocks sharing each tile by TMA multicast was slower: the loads alone are
// not held back by the second read of a tile from L2.
// The grid is (head groups, splits, batch rows), head groups fastest: at
// H = 128 the two blocks of a (split, batch row) run side by side and the
// second read of each tile comes from L2. The wrapper sizes the splits to
// one wave of blocks.
//
// f32 keeps the first design, on the CUDA cores (Hopper's tensor cores take
// f32 only as TF32): one block of 8 warps per 32 heads; per 32-row tile the
// rows are copied by cp.async, each warp sums one m16 tile of heads over a
// quarter of the depth and the quarters meet in shared memory, the softmax
// runs on 8 threads a head row, P goes to shared memory and each warp owns
// 64 output columns. Shared memory 171,776 B.
//
// Both emit, per partition, an output normalised by its own sum and its
// log-sum-exp, -1e30 when empty, as the TPU kernel does; decode_combine.cuh
// merges the partitions. Scores, softmax and accumulators are f32
// throughout. Nothing is padded: heads past H and rows past hi are zeros
// and masked here.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

#include "decode_combine.cuh"
#include "warp_tile.cuh"

using namespace repro_torch;

namespace {

constexpr int kR = 512;                 // kv_lora_rank: latent width, output width
constexpr int kRd = 64;                 // qk_rope_head_dim
constexpr int kK = kR + kRd;            // score depth

// -- bf16: TMA, mbarriers and wgmma --------------------------------------------------

constexpr int kHeads = 64;                    // query heads a block: the M of both products
constexpr int kTile = 64;                     // cache rows a stage
constexpr int kStages = 2;
constexpr int kBlocks = kK / 64;              // 128-byte column blocks: 8 of ckv, 1 of kpe
constexpr int kColBlock = kTile * 128;        // bytes of one column block (Q's too: kHeads rows)
constexpr int kQBytes = kBlocks * kColBlock;  // 73,728
constexpr int kPBytes = kHeads * kTile * 2;   // P: one column block, 8,192
constexpr int kStageBytes = kBlocks * kColBlock;
constexpr int kThreads = 384;                 // two consumer warpgroups, one producer
// Q, P, the ring, the rescale factors and final sums (64 f32 each), the
// mbarriers, and room to align the swizzled tiles to 1024 bytes
constexpr int kSmem = kQBytes + kPBytes + kStages * kStageBytes + 2 * kHeads * 4
                      + (2 * kStages + 1) * 8 + 1024;
static_assert(kHeads == kTile, "Q and a stage share one column-block layout");
static_assert(kSmem <= 232448, "a block may use 232,448 bytes of shared memory");

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
// 2^34 clocks (about 10 s) traps.
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

// The box of a 3-d tensor map at (c0 = column, c1 = row, c2 = batch row)
// into shared memory, completing its bytes on the barrier.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(smem_u32(bar))
      : "memory");
}

// wgmma descriptors of a column block in the 128-byte swizzle (its base
// 1024-aligned), rows of 128 bytes:
//  - K-major (the depth runs along a row): 8-row groups 1024 bytes apart;
//    adding 32 bytes advances one k16 step.
//  - MN-major (N runs along a row, the depth down the rows): 8-row depth
//    groups 1024 bytes apart (stride offset), 64-wide N blocks one column
//    block apart (leading offset); adding 2048 bytes advances one k16 step.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kColBlock >> 4) << 16) |
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

// Accumulator layout of wgmma m64nN (f32), per n8 tile j: d[4j + e] is row
// 16·warp + g + 8·(e >> 1), column 8j + 2t + (e & 1) (g = lane / 4,
// t = lane % 4, warp within the warpgroup). The A operand from registers is
// mma.sync m16n8k16's A per warp: a[0] row g, columns 2t, 2t + 1; a[1] row
// g + 8; a[2] row g, columns 2t + 8, 2t + 9; a[3] row g + 8, the same.

// d (64 × 64) = A · Bᵀ (+ d if scale_d), A 64 × 16 and B 64 × 16, both
// K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 × 256) += A · B, A 64 × 16 from registers, B 16 × 256 MN-major in
// shared memory (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128], const uint32_t (&a)[4],
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d (64 × 256) += A · B, A 64 × 16 K-major and B 16 × 256 MN-major, both in
// shared memory (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_m64n256k16_ss_tb(float (&d)[128], uint64_t desc_a,
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
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
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

// Pin registers across an asynchronous product: reads and writes may not
// move across this point, and values stay live up to it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// Named barriers between the two consumer warpgroups (256 threads): one
// side arrives, the other waits.
enum : int { kBarPFull = 1, kBarPFree = 2, kBarSums = 3 };
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// A consumer warp's share of a stage is consumed.
__device__ __forceinline__ void release(uint64_t* empty) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty);
}

// o (rows g and g + 8 of this warp's 16, 256 columns from col0) normalised
// by the final sums, into the partition's f32 partial output.
__device__ __forceinline__ void store_partial(const float (&o)[128], float l0, float l1,
                                              float* __restrict__ o_part, int H, int h0, int b,
                                              int split, int splits, int col0) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int r0 = 16 * warp + (lane >> 2), r1 = r0 + 8;
  const long long row = (long long)b * H + h0;
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  float* out0 = o_part + ((row + r0) * splits + split) * kR + col0 + 2 * (lane & 3);
  float* out1 = o_part + ((row + r1) * splits + split) * kR + col0 + 2 * (lane & 3);
  if (h0 + r0 < H) {
#pragma unroll
    for (int j = 0; j < 32; ++j)
      *reinterpret_cast<float2*>(out0 + 8 * j) = make_float2(o[4 * j] * inv0, o[4 * j + 1] * inv0);
  }
  if (h0 + r1 < H) {
#pragma unroll
    for (int j = 0; j < 32; ++j)
      *reinterpret_cast<float2*>(out1 + 8 * j) =
          make_float2(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

// Warpgroup 0: per tile the scores s = Q · tileᵀ (36 k16 steps over the
// 576-wide depth, 4 in each column block of Q and of the tile, the same
// offsets in both), the online softmax, P into registers and into shared
// memory for warpgroup 1, then P·ckv for output columns [0, 256) with P as
// the register A operand.
__device__ __forceinline__ void consume_scores(const uint8_t* qs, uint8_t* ps, const uint8_t* ring,
                                               float* alpha_s, float* l_s, uint64_t* full,
                                               uint64_t* empty, uint64_t* qbar,
                                               float* __restrict__ o_part,
                                               float* __restrict__ lse_part, int H, int h0, int b,
                                               int split, int splits, int row_begin, int row_end,
                                               int n_tiles, float c) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g, r1 = r0 + 8;      // this lane's two head rows of the block's 64
  const uint32_t q = smem_u32(qs), ring0 = smem_u32(ring);
  float o[128], s[32];
  uint32_t pa[4][4];                  // P as the A operand, one k16 step of rows each
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) pa[k][0] = pa[k][1] = pa[k][2] = pa[k][3] = 0u;
  float m0 = kNegInf, m1 = kNegInf;   // running max of rows r0 and r1, in log2 units
  float l0 = 0.f, l1 = 0.f;           // this lane's part of their running sums

  mbar_wait(qbar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % kStages;
    // the last tile's P·ckv is done before these scores are issued, so its
    // stage is refilled as early as can be: the ring waits on the loads
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    if (it > 0) release(&empty[(it - 1) % kStages]);
    mbar_wait(&full[stage], (it / kStages) & 1);
    const uint32_t tile = ring0 + stage * kStageBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kK / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kColBlock + (kk & 3) * 32;
      wgmma_m64n64k16_ss(s, desc_k_major(q + off), desc_k_major(tile + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    const int j0 = row_begin + it * kTile;
    if (j0 + kTile > row_end) {       // the split's ragged last tile
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (j0 + 8 * n + 2 * t + e >= row_end) s[4 * n + e] = s[4 * n + 2 + e] = -INFINITY;
    }
    float x0 = kNegInf, x1 = kNegInf;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      x0 = fmaxf(x0, fmaxf(s[4 * n], s[4 * n + 1]));
      x1 = fmaxf(x1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
    // m never drops below -1e30, so a masked score's 2^(-inf) is exactly 0
    const float mn0 = fmaxf(m0, quad_max(x0) * c), mn1 = fmaxf(m1, quad_max(x1) * c);
    const float a0 = exp2_approx(m0 - mn0), a1 = exp2_approx(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[4 * n] = exp2_approx(fmaf(s[4 * n], c, -mn0));
      s[4 * n + 1] = exp2_approx(fmaf(s[4 * n + 1], c, -mn0));
      s[4 * n + 2] = exp2_approx(fmaf(s[4 * n + 2], c, -mn1));
      s[4 * n + 3] = exp2_approx(fmaf(s[4 * n + 3], c, -mn1));
      sum0 += s[4 * n] + s[4 * n + 1];
      sum1 += s[4 * n + 2] + s[4 * n + 3];
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int k = 0; k < 4; ++k) {   // rows 16k .. 16k + 15 of the tile: n8 tiles 2k, 2k + 1
      pa[k][0] = pack_bf16(s[8 * k], s[8 * k + 1]);
      pa[k][1] = pack_bf16(s[8 * k + 2], s[8 * k + 3]);
      pa[k][2] = pack_bf16(s[8 * k + 4], s[8 * k + 5]);
      pa[k][3] = pack_bf16(s[8 * k + 6], s[8 * k + 7]);
    }
    // P to shared memory as a K-major A operand in the 128-byte swizzle: the
    // 16-byte chunk of n8 tile j in row r lies at chunk j ^ (r % 8), and
    // r0 % 8 = r1 % 8 = g; the 32 lanes of a store hit 32 distinct banks
    if (it > 0) bar_sync(kBarPFree);  // warpgroup 1 has read the last tile's P and rescale
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int chunk = ((2 * k + h) ^ g) << 4;
        *reinterpret_cast<uint32_t*>(ps + r0 * 128 + chunk + 4 * t) = pa[k][2 * h];
        *reinterpret_cast<uint32_t*>(ps + r1 * 128 + chunk + 4 * t) = pa[k][2 * h + 1];
      }
    if (t == 0) {
      alpha_s[r0] = a0;
      alpha_s[r1] = a1;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // P, for wgmma's reads
    bar_arrive(kBarPFull);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma_m64n256k16_rs(o, pa[k], desc_mn_major(tile + k * 2048), 1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(pa);

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (t == 0) {
    constexpr float kLn2 = 0.6931471805599453f;
    l_s[r0] = l0;
    l_s[r1] = l1;
    const long long row = (long long)b * H + h0;
    if (h0 + r0 < H) lse_part[(row + r0) * splits + split] = l0 > 0.f ? m0 * kLn2 + logf(l0) : kNegInf;
    if (h0 + r1 < H) lse_part[(row + r1) * splits + split] = l1 > 0.f ? m1 * kLn2 + logf(l1) : kNegInf;
  }
  bar_arrive(kBarSums);
  store_partial(o, l0, l1, o_part, H, h0, b, split, splits, 0);
}

// Warpgroup 1: per tile P·ckv for output columns [256, 512), P read from
// shared memory as the A operand, once warpgroup 0 has written it.
__device__ __forceinline__ void consume_p(const uint8_t* ps, const uint8_t* ring,
                                          const float* alpha_s, const float* l_s, uint64_t* full,
                                          uint64_t* empty, float* __restrict__ o_part, int H,
                                          int h0, int b, int split, int splits, int n_tiles) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int r0 = 16 * warp + (lane >> 2), r1 = r0 + 8;
  const uint32_t p = smem_u32(ps), ring0 = smem_u32(ring);
  float o[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % kStages;
    bar_sync(kBarPFull);
    mbar_wait(&full[stage], (it / kStages) & 1);   // long complete: the tile is visible here too
    const float a0 = alpha_s[r0], a1 = alpha_s[r1];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }
    const uint32_t v = ring0 + stage * kStageBytes + 4 * kColBlock;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_m64n256k16_ss_tb(o, desc_k_major(p + k * 32), desc_mn_major(v + k * 2048), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if (it + 1 < n_tiles) bar_arrive(kBarPFree);
    release(&empty[stage]);
  }
  bar_sync(kBarSums);
  store_partial(o, l_s[r0], l_s[r1], o_part, H, h0, b, split, splits, 256);
}

// One thread of the producer warpgroup: Q once, then the split's tiles
// through the ring.
__device__ __forceinline__ void produce(uint8_t* qs, uint8_t* ring, uint64_t* full,
                                        uint64_t* empty, uint64_t* qbar, const CUtensorMap* tm_ql,
                                        const CUtensorMap* tm_qp, const CUtensorMap* tm_ckv,
                                        const CUtensorMap* tm_kpe, int h0, int b, int row_begin,
                                        int n_tiles) {
  mbar_expect_tx(qbar, kQBytes);
#pragma unroll
  for (int cb = 0; cb < kBlocks - 1; ++cb) tma_load_3d(qs + cb * kColBlock, tm_ql, qbar, 64 * cb, h0, b);
  tma_load_3d(qs + (kBlocks - 1) * kColBlock, tm_qp, qbar, 0, h0, b);
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < n_tiles; ++it) {
    mbar_wait(&empty[stage], phase ^ 1);
    mbar_expect_tx(&full[stage], kStageBytes);
    uint8_t* dst = ring + stage * kStageBytes;
    const int j = row_begin + it * kTile;
#pragma unroll
    for (int cb = 0; cb < kBlocks - 1; ++cb)
      tma_load_3d(dst + cb * kColBlock, tm_ckv, &full[stage], 64 * cb, j, b);
    tma_load_3d(dst + (kBlocks - 1) * kColBlock, tm_kpe, &full[stage], 0, j, b);
    if (++stage == kStages) { stage = 0; phase ^= 1; }
  }
}

// c = scale · log2 e. Partition `split` holds rows [split·per,
// min((split + 1)·per, hi)).
__global__ void __launch_bounds__(kThreads, 1)
mla_decode_bf16(const __grid_constant__ CUtensorMap tm_ql, const __grid_constant__ CUtensorMap tm_qp,
                const __grid_constant__ CUtensorMap tm_ckv,
                const __grid_constant__ CUtensorMap tm_kpe, float* __restrict__ o_part,
                float* __restrict__ lse_part, int H, int hi, int per, int splits, float c) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ps = qs + kQBytes;
  uint8_t* ring = ps + kPBytes;
  float* alpha_s = reinterpret_cast<float*>(ring + kStages * kStageBytes);
  float* l_s = alpha_s + kHeads;
  uint64_t* full = reinterpret_cast<uint64_t*>(l_s + kHeads);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int h0 = blockIdx.x * kHeads, split = blockIdx.y, b = blockIdx.z;
  const int row_begin = split * per, row_end = min(row_begin + per, hi);
  const int n_tiles = row_end > row_begin ? (row_end - row_begin + kTile - 1) / kTile : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);        // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, from lane 0 so that the compiler sees it is uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256)
      produce(qs, ring, full, empty, qbar, &tm_ql, &tm_qp, &tm_ckv, &tm_kpe, h0, b, row_begin,
              n_tiles);
  } else if (wg == 0) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    consume_scores(qs, ps, ring, alpha_s, l_s, full, empty, qbar, o_part, lse_part, H, h0, b,
                   split, splits, row_begin, row_end, n_tiles, c);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    consume_p(ps, ring, alpha_s, l_s, full, empty, o_part, H, h0, b, split, splits, n_tiles);
  }
}

// -- f32: the first design, on the CUDA cores -----------------------------------------

constexpr int kF32Heads = 32;              // query heads a block: two m16 tiles
constexpr int kF32Warps = 8;               // four per m16 tile, one per quarter of the depth
constexpr int kF32Threads = 32 * kF32Warps;
constexpr int kF32Rows = 32;               // cache rows a tile
constexpr int kCols = 64;                  // output columns a warp owns
constexpr int kN8 = kCols / 8;             // its n8 tiles
constexpr int kQuarter = kK / 4;           // the score depth a warp sums: 144
constexpr int kLd = kK + 4;                // row padding: distinct banks, 16-byte rows
constexpr int kLdp = kF32Rows + 4;
constexpr int kLds = kF32Rows + 4;
// the tile [kF32Rows][kLd], q [kF32Heads][kLd], P [kF32Heads][kLdp], four
// partial score sums [4][kF32Heads][kLds], the rescale factors and the
// final sums
constexpr int kF32Smem = 4 * ((kF32Rows + kF32Heads) * kLd + kF32Heads * kLdp)
                         + 4 * (4 * kF32Heads * kLds + 2 * kF32Heads);
static_assert(kF32Warps == kR / kCols, "every warp owns 64 columns of the 32 heads");

// acc[m][n] += P[16m .. 16m+15][:] · V[:][8n .. 8n+7] over the tile's rows
// for this warp's columns, f32 FMAs in the accumulator layout of mma.sync
// m16n8: acc[m][n][0..1] = C[16m + g][8n + 2t + {0, 1}], [2..3] the same
// columns of row 16m + g + 8.
__device__ __forceinline__ void pv_f32(const float* P, const float* V, float (&acc)[2][kN8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < kF32Rows; ++k) {
    float a[2][2];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      a[m][0] = P[(16 * m + g) * kLdp + k];
      a[m][1] = P[(16 * m + g + 8) * kLdp + k];
    }
#pragma unroll
    for (int n = 0; n < kN8; ++n) {
      const float b0 = V[k * kLd + 8 * n + 2 * t], b1 = V[k * kLd + 8 * n + 2 * t + 1];
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

// Copies [a | b] rows (kR and kRd wide, row strides sa and sb) into shared
// rows of leading dimension kLd with cp.async, 16 bytes a thread, every copy
// in flight at once. Rows past n are zero-filled and their source is not
// read.
template <int ROWS>
__device__ __forceinline__ void copy_rows(float* dst, const float* a, long long sa,
                                          const float* b, long long sb, int n) {
  constexpr int PER_ROW = kK / 4;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += kF32Threads) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 4;
    const int src_row = r < n ? r : 0;
    const float* src = c < kR ? a + src_row * sa + c : b + src_row * sb + (c - kR);
    cp_async_16(dst + r * kLd + c, src, r < n ? 16 : 0);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kF32Threads, 1)
mla_decode_f32(const float* __restrict__ q_lat, const float* __restrict__ q_pe,
               const float* __restrict__ ckv, const float* __restrict__ kpe,
               float* __restrict__ o_part, float* __restrict__ lse_part,
               long long ql_b, long long ql_h, long long qp_b, long long qp_h,
               long long c_b, long long c_l, long long p_b, long long p_l,
               int H, int hi, int per, int splits, float scale) {
  extern __shared__ __align__(16) unsigned char smem_f32[];
  float* tile = reinterpret_cast<float*>(smem_f32);
  float* qs = tile + kF32Rows * kLd;
  float* ps = qs + kF32Heads * kLd;
  float* sp = ps + kF32Heads * kLdp;
  float* alpha_s = sp + 4 * kF32Heads * kLds;
  float* l_s = alpha_s + kF32Heads;

  const int h0 = blockIdx.x * kF32Heads, split = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_begin = split * per;
  const int row_end = min(row_begin + per, hi);
  const float* ckv_b = ckv + b * c_b;
  const float* kpe_b = kpe + b * p_b;

  // q: [q_lat | q_pe] rows, zero past the last head
  copy_rows<kF32Heads>(qs, q_lat + b * ql_b + h0 * ql_h, ql_h, q_pe + b * qp_b + h0 * qp_h, qp_h,
                       H - h0);
  cp_async_wait<0>();
  __syncthreads();
  // scores: this warp's 16 heads (m16 tile mt) over one quarter of the depth
  // (kq); output: its kCols columns (c0) of the 32 heads
  const int mt = warp % 2, kq = warp / 2;
  const int c0 = warp * kCols;
  const float* q_warp = qs + 16 * mt * kLd + kq * kQuarter;

  // softmax: 8 threads a head row, 4 scores each; the row's running max and
  // sum live in those threads' registers (the same values in all 8)
  const int srow = threadIdx.x >> 3, scol = (threadIdx.x & 7) * 4;
  float m_run = kNegInf, l_run = 0.f;
  float oacc[2][kN8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < kN8; ++n) oacc[m][n][0] = oacc[m][n][1] = oacc[m][n][2] = oacc[m][n][3] = 0.f;

  // The loop bounds are uniform over the block, so every thread reaches
  // every barrier; rows at or past row_end are zero-filled and masked.
  for (int j0 = row_begin; j0 < row_end; j0 += kF32Rows) {
    copy_rows<kF32Rows>(tile, ckv_b + j0 * c_l, c_l, kpe_b + j0 * p_l, p_l, row_end - j0);
    cp_async_wait<0>();
    __syncthreads();   // the tile's copies are visible to all

    float sacc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
    warp_tile_mma<4, kQuarter>(q_warp, kLd, tile + kq * kQuarter, kLd, sacc);
    float* part = sp + kq * kF32Heads * kLds;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        part[(16 * mt + g) * kLds + 8 * n + 2 * t + e] = sacc[n][e];
        part[(16 * mt + g + 8) * kLds + 8 * n + 2 * t + e] = sacc[n][2 + e];
      }
    __syncthreads();

    float s[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = srow * kLds + scol + x;
      const float v = (sp[i] + sp[kF32Heads * kLds + i])
                      + (sp[2 * kF32Heads * kLds + i] + sp[3 * kF32Heads * kLds + i]);
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
      ps[srow * kLdp + scol + x] = p;
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    l_run = l_run * alpha + sum;
    m_run = mn;
    if ((threadIdx.x & 7) == 0) alpha_s[srow] = alpha;
    __syncthreads();

#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float aa = alpha_s[16 * m + g], ab = alpha_s[16 * m + g + 8];
#pragma unroll
      for (int n = 0; n < kN8; ++n) {
        oacc[m][n][0] *= aa; oacc[m][n][1] *= aa;
        oacc[m][n][2] *= ab; oacc[m][n][3] *= ab;
      }
    }
    pv_f32(ps, tile + c0, oacc);
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
      const int r = 16 * m + g + 8 * half;
      if (h0 + r >= H) continue;
      const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
      float* o = o_part + (((long long)b * H + h0 + r) * splits + split) * kR + c0 + 2 * t;
#pragma unroll
      for (int n = 0; n < kN8; ++n)
        *reinterpret_cast<float2*>(o + 8 * n) =
            make_float2(oacc[m][n][2 * half] * inv, oacc[m][n][2 * half + 1] * inv);
    }
}

// -- host ------------------------------------------------------------------------------

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

// A (batch, rows, width) bf16 array with element strides (sb, sr, 1), read
// in boxes of 64 rows × 64 columns in the 128-byte swizzle; elements out of
// bounds read as zero.
bool bf16_map(CUtensorMap* map, const void* base, int width, int rows, int batch, long long sr,
              long long sb) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t gdim[3] = {(cuuint64_t)width, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t gstride[2] = {(cuuint64_t)sr * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)kTile, 1};
  const cuuint32_t estride[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), gdim, gstride,
                box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_bf16(const void* q_lat, const void* q_pe, const void* ckv, const void* kpe,
                float* o_part, float* lse, const long long* st, int B, int H, int hi, int per,
                int splits, float scale, cudaStream_t stream) {
  CUtensorMap tm_ql, tm_qp, tm_ckv, tm_kpe;
  const int rows = hi > 0 ? hi : 1;   // an empty call loads no rows
  if (!bf16_map(&tm_ql, q_lat, kR, H, B, st[1], st[0]) ||
      !bf16_map(&tm_qp, q_pe, kRd, H, B, st[3], st[2]) ||
      !bf16_map(&tm_ckv, ckv, kR, rows, B, st[5], st[4]) ||
      !bf16_map(&tm_kpe, kpe, kRd, rows, B, st[7], st[6]))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mla_decode_bf16,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + kHeads - 1) / kHeads, splits, B);
  mla_decode_bf16<<<grid, kThreads, kSmem, stream>>>(tm_ql, tm_qp, tm_ckv, tm_kpe, o_part, lse,
                                                     H, hi, per, splits, scale * kLog2e);
  return (int)cudaGetLastError();
}

int launch_f32(const void* q_lat, const void* q_pe, const void* ckv, const void* kpe,
               float* o_part, float* lse, const long long* st, int B, int H, int hi, int per,
               int splits, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(mla_decode_f32,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kF32Smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + kF32Heads - 1) / kF32Heads, splits, B);
  mla_decode_f32<<<grid, kF32Threads, kF32Smem, stream>>>(
      static_cast<const float*>(q_lat), static_cast<const float*>(q_pe),
      static_cast<const float*>(ckv), static_cast<const float*>(kpe), o_part, lse, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], H, hi, per, splits, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q_lat (B, H, r) and q_pe (B, H, rd) with strides (b, h); ckv (B, L, r)
// and kpe (B, L, rd) with strides (b, l); the last dim contiguous
// everywhere, strides in elements (in bf16 multiples of 8, every base
// 16-byte aligned: TMA's conditions). Rows [0, hi) are live; partition s
// holds rows [s·per, min((s+1)·per, hi)). o_part (B, H, splits, r) and lse
// (B, H, splits) are f32 scratch; out is (B, H, r) contiguous in q's dtype.
// Returns cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for dims without a template or a tensor map that
// cannot be made.
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
  const int rc = is_bf16 ? launch_bf16(q_lat, q_pe, ckv, kpe, op, ls, st, B, H, hi, per, splits, scale, s)
                         : launch_f32(q_lat, q_pe, ckv, kpe, op, ls, st, B, H, hi, per, splits, scale, s);
  if (rc) return rc;
  if (is_bf16)
    decode_combine<__nv_bfloat16, kR><<<B * H, kR, 0, s>>>(op, ls, static_cast<__nv_bfloat16*>(out), splits);
  else
    decode_combine<float, kR><<<B * H, kR, 0, s>>>(op, ls, static_cast<float*>(out), splits);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the partial kernel a launch asks for, in bytes.
extern "C" int mla_decode_smem_bytes(int is_bf16) { return is_bf16 ? kSmem : kF32Smem; }
