// score_ce: per-token NLL of softmax(hidden · embᵀ) at the gold labels,
// without ever writing the (T, V) logits to device memory.
//
// Replaces the TPU kernel score_ce in src/repro/kernels/score_ce.py (Pallas
// body _kernel, the Prompt Bank's Eqn-1 hot spot).
//
// What bounds it on the H100: at the scoring path's shape (T = 16 eval rows
// × 17 tokens = 272, D = 768, V = 50257, bf16) the product is 21 GFLOP and
// the embedding is 77 MB, so bytes (23 µs at 3.35 TB/s) and tensor-core
// operations (21 µs at 989 TFLOP/s) are nearly balanced. With few token rows
// the danger is an idle card: 272 rows make only 5 tiles of 64.
//
// Design: the TPU kernel carries (m, l, gold) across vocabulary tiles in
// VMEM because its grid runs in order. Here blocks run in parallel, so the
// vocabulary is also split across blocks (grid.y) until the card is full:
// each block loops over its own vocabulary range with a running max m and
// sum l per row in registers and picks up the gold logit when it falls in
// its range; a second small kernel merges the splits,
//     nll = M + log Σ_i l_i · exp(m_i − M) − gold,   M = max_i m_i.
// Columns past V (the ragged edge of 50257) are masked here and never enter
// l. Logits are f32 (bf16 products on the tensor cores are exact in f32).
// This first version reloads each hidden chunk for every vocabulary tile
// (from L2) and synchronises around every chunk: no cp.async, TMA or wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "warp_tile.cuh"

using namespace repro_torch;

namespace {

constexpr int kRows = 64;     // token rows per block: 4 warps × 16
constexpr int kCols = 64;     // vocabulary columns per step
constexpr int kThreads = 128;

// Depth of one shared-memory chunk and its padded leading dimension (the
// padding spreads the fragment loads over all 32 banks).
template <typename T> struct Chunk;
template <> struct Chunk<__nv_bfloat16> { static constexpr int K = 64, LD = 72; };
template <> struct Chunk<float> { static constexpr int K = 32, LD = 36; };

template <typename T>
__global__ void __launch_bounds__(kThreads)
score_ce_partial(const T* __restrict__ hidden, const T* __restrict__ emb,
                 const int* __restrict__ labels, float* __restrict__ part_m,
                 float* __restrict__ part_l, float* __restrict__ part_g,
                 int n_tok, int dim, int vocab, int n_split) {
  constexpr int KC = Chunk<T>::K, LD = Chunk<T>::LD;
  __shared__ __align__(16) T hs[kRows * LD];
  __shared__ __align__(16) T es[kCols * LD];
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
    for (int k0 = 0; k0 < dim; k0 += KC) {
      __syncthreads();
      load_tile<T, kRows, KC, kThreads>(hs, LD, hidden, dim, row0, n_tok, k0, dim);
      load_tile<T, kCols, KC, kThreads>(es, LD, emb, dim, v0, vocab, k0, dim);
      __syncthreads();
      warp_tile_mma<8, KC>(hs + warp * 16 * LD, LD, es, LD, acc);
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

__global__ void score_ce_combine(const float* __restrict__ part_m,
                                 const float* __restrict__ part_l,
                                 const float* __restrict__ part_g,
                                 float* __restrict__ nll, int n_tok, int n_split) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_tok) return;
  float M = -INFINITY;
  for (int i = 0; i < n_split; ++i) M = fmaxf(M, part_m[(long long)i * n_tok + r]);
  float L = 0.f, G = 0.f;
  for (int i = 0; i < n_split; ++i) {
    const long long o = (long long)i * n_tok + r;
    L += part_l[o] * expf(part_m[o] - M);
    G += part_g[o];
  }
  nll[r] = M + logf(fmaxf(L, 1e-30f)) - G;
}

}  // namespace

// part holds 3 × n_split × n_tok f32 (m, l, gold); nll n_tok f32.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int score_ce_launch(const void* hidden, const void* emb, const void* labels,
                               void* part, void* nll, int n_tok, int dim, int vocab,
                               int n_split, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pm = static_cast<float*>(part);
  float* pl = pm + (long long)n_split * n_tok;
  float* pg = pl + (long long)n_split * n_tok;
  const int* lab = static_cast<const int*>(labels);
  const dim3 grid((n_tok + kRows - 1) / kRows, n_split);
  if (is_bf16) {
    score_ce_partial<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(hidden), static_cast<const __nv_bfloat16*>(emb),
        lab, pm, pl, pg, n_tok, dim, vocab, n_split);
  } else {
    score_ce_partial<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(hidden), static_cast<const float*>(emb),
        lab, pm, pl, pg, n_tok, dim, vocab, n_split);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  score_ce_combine<<<(n_tok + 255) / 256, 256, 0, s>>>(pm, pl, pg,
                                                       static_cast<float*>(nll),
                                                       n_tok, n_split);
  return (int)cudaGetLastError();
}
