#!/usr/bin/env python3
"""Times variants of the two bf16 backward kernels beside the kernels
themselves, on one NVIDIA GPU, to show what their designs buy.

    python3 tools/backward_variants.py

Each variant is the committed source (src/repro_torch/kernels/csrc/
flash_attention_bwd.cu or score_ce.cu) with a few lines replaced, compiled
with the port's nvcc flags into build/backward_variants/ and timed through
the port's wrapper with chip_smoke.time_ms, in the order kernel, variants,
kernel, at phase 9a's shapes (vicuna-7b train_4k: B = 1, H = 32, S = L =
4112, hd = 128; one 512-position chunk: T = 512, D = 4096, V = 32000;
gpt2-base tuning: B = 8, H = 12, S = 33, hd = 64 and T = 136, D = 768,
V = 50257):

- flash_attention_bwd, row_major_dq: dQ's f32 scratch row-major, each
  warp's 16-byte atomic adds covering 32 bytes of 16 rows (lanes t and
  t ^ 1 swap a pair) instead of 512 contiguous bytes in register order;
- flash_attention_bwd, no_dq_adds: dQ's atomic adds left out (dq wrong;
  their cost removed);
- score_ce_bwd, no_g_epilogue: the G pass with no epilogue (G never
  written, dh wrong; the products and the ring alone);
- score_ce_bwd, pair_multicast_ge: the G·E kernel in clusters of two
  blocks (row tiles 2m and 2m + 1), each loading half of every stage's E
  tile into both blocks by TMA .multicast::cluster, a stage refilled once
  the consumers of both blocks have released it (16-arrival empty
  barriers, half of them remote); row tiles padded to an even count.

The variants that keep the function are checked against the plain version
before they are timed. Prints the card's name and power limit first and
last.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import score_ce as sc  # noqa: E402

OUT = ROOT / "build" / "backward_variants"


def sub(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"variant no longer applies: {old[:70]!r}")
    return text.replace(old, new)


def between(text: str, start: str, end: str, new: str) -> str:
    """text with [start, end) replaced by new; both markers must be unique."""
    if text.count(start) != 1 or text.count(end) != 1 or text.index(start) > text.index(end):
        raise SystemExit(f"variant no longer applies: {start[:70]!r}")
    return text[:text.index(start)] + new + text[text.index(end):]


ROW_MAJOR_ADDS = r'''    {
      const bool odd = t & 1;
      float* dst = dq_acc + (((long long)b * H + h) * S_pad + i0 + 16 * warp + g + (odd ? 8 : 0)) * HD +
                   (HD == 128 ? 64 * wg : 0) + 2 * (t & ~1);
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const float ra = __shfl_xor_sync(0xffffffffu, odd ? dq[4 * x] : dq[4 * x + 2], 1);
        const float rb = __shfl_xor_sync(0xffffffffu, odd ? dq[4 * x + 1] : dq[4 * x + 3], 1);
        atomicAdd(reinterpret_cast<float4*>(dst + 8 * x),
                  odd ? make_float4(ra, rb, dq[4 * x + 2], dq[4 * x + 3])
                      : make_float4(dq[4 * x], dq[4 * x + 1], ra, rb));
      }
    }
'''
ROW_MAJOR_OUT = r'''template <int HD>
__global__ void fa_bwd_dq_out(const float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dq,
                              Strides sdq, int H, int S, int S_pad, float scale,
                              long long n_vec) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_vec) return;
  const int col = (int)(idx % (HD / 4)) * 4;
  const long long row = idx / (HD / 4);
  const int i = (int)(row % S_pad);
  if (i >= S) return;
  const long long bh = row / S_pad;
  const int h = (int)(bh % H), b = (int)(bh / H);
  const float4 v = reinterpret_cast<const float4*>(dq_acc)[idx];
  __nv_bfloat162* out =
      reinterpret_cast<__nv_bfloat162*>(dq + b * sdq.b + h * sdq.h + i * sdq.s + col);
  out[0] = __floats2bfloat162_rn(v.x * scale, v.y * scale);
  out[1] = __floats2bfloat162_rn(v.z * scale, v.w * scale);
}

'''


def row_major_dq(src: str) -> str:
    src = between(src, "    // the share added into the f32 scratch in register order (see",
                  "    if (++stage == kStages) { stage = 0; phase ^= 1; }\n  }\n\n  __nv_bfloat16* dkb",
                  ROW_MAJOR_ADDS)
    return between(src, "// dq = scale · the f32 scratch. Per (batch row", "// -- f32: CUDA cores",
                   ROW_MAJOR_OUT)


def no_dq_adds(src: str) -> str:
    return sub(src, """        atomicAdd(dst + x * 128 + tid,""", """        if (dq[0] == 12345.f) atomicAdd(dst + x * 128 + tid,""")


def no_g_epilogue(src: str) -> str:
    return sub(src, """    if (!live) continue;
    const int v0 = c0 + tile * kBN;
    if (tid == 0) bulk_wait_read<0>();""", """    if (live || !live) continue;
    const int v0 = c0 + tile * kBN;
    if (tid == 0) bulk_wait_read<0>();""")


PAIR_HELPERS = r'''
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive_peer(uint64_t* bar, uint32_t peer) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(bar)), "r"(peer));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" :: "r"(a) : "memory");
}
__device__ __forceinline__ void tma_load_2d_mc(void* dst, const CUtensorMap* map, uint64_t* bar,
                                               int c0, int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1, {%2, %3}], [%4], %5;\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

'''
PAIR_GE = r'''__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kTcThreads, 1)
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
  const uint32_t rank = cluster_rank(), peer = rank ^ 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * kConsumerWarps);   // both blocks' consumers
    }
    mbar_init_fence();
  }
  cluster_sync();

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
        // this block's half of E's tile, into both blocks of the pair
#pragma unroll
        for (int cb = 2 * rank; cb < 2 * rank + 2; ++cb)
          tma_load_2d_mc(sb + stage * kStageB + cb * (kStageB / 4), &tm_e, &full[stage],
                         dt * kBN + 64 * cb, c0 + kt * kBK, 3);
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      }
      // the pair's last releases, so that no remote arrival outlives this block
      for (int x = 0; x < kStages; ++x) {
        mbar_wait(&empty[stage], phase ^ 1);
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
    tile_products<true, kStages, true>(acc, smem_u32(sa) + 64 * wg * kBK * 2, smem_u32(sb), full,
                                       empty, stage, phase, k_hi - k_lo, peer);
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

'''


def pair_multicast_ge(src: str) -> str:
    src = sub(src, "// acc (this warpgroup's 64 rows × 256 columns) = the products of one tile",
              PAIR_HELPERS + "// acc (this warpgroup's 64 rows × 256 columns) = the products of one tile")
    src = sub(src, """template <bool kMnB, int kRing = kStages>
__device__ __forceinline__ void tile_products(float (&acc)[128], uint32_t a_base, uint32_t b_base,
                                              uint64_t* full, uint64_t* empty, int& stage,
                                              uint32_t& phase, int n_k) {""", """template <bool kMnB, int kRing = kStages, bool kPeer = false>
__device__ __forceinline__ void tile_products(float (&acc)[128], uint32_t a_base, uint32_t b_base,
                                              uint64_t* full, uint64_t* empty, int& stage,
                                              uint32_t& phase, int n_k, uint32_t peer = 0) {""")
    src = sub(src, """    if (prev >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
    }""", """    if (prev >= 0) {
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&empty[prev]);
        if (kPeer) mbar_arrive_peer(&empty[prev], peer);
      }
    }""")
    src = sub(src, """  __syncwarp();
  if (lane == 0 && prev >= 0) mbar_arrive(&empty[prev]);
}""", """  __syncwarp();
  if (lane == 0 && prev >= 0) {
    mbar_arrive(&empty[prev]);
    if (kPeer) mbar_arrive_peer(&empty[prev], peer);
  }
}""")
    src = between(src, "__global__ void __launch_bounds__(kTcThreads, 1)\nscore_ce_ge_bf16(",
                  "// dh (n elements, bf16) = Σ_s part[s] in split order", PAIR_GE)
    return sub(src, """  float* pf = static_cast<float*>(part);
  score_ce_ge_bf16<<<row_tiles * col_tiles * ge_splits, kTcThreads, kTcSmem, s>>>(
      tm_g, tm_e64, pf, n_tok, dim, c0, n_kt, ge_splits, row_tiles, col_tiles, first);""", """  const int ge_rows = (row_tiles + 1) / 2 * 2;   // pairs of row tiles share E's tiles
  float* pf = static_cast<float*>(part);
  score_ce_ge_bf16<<<ge_rows * col_tiles * ge_splits, kTcThreads, kTcSmem, s>>>(
      tm_g, tm_e64, pf, n_tok, dim, c0, n_kt, ge_splits, ge_rows, col_tiles, first);""")


def build(source: str, name: str, text: str) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{source}-{name}.cu", OUT / f"{source}-{name}.so"
    cu.write_text(text)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc {source} {name} failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    _build.load(source)                           # the wrapper's argtypes, on the kernel's library
    for fn_name in ("flash_attention_bwd_launch", "score_ce_launch", "score_ce_bwd_launch"):
        if hasattr(_build._LIBS[source], fn_name):
            ref = getattr(_build._LIBS[source], fn_name)
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype
    return lib


def run(source: str, variants: dict, cases: list) -> None:
    """cases: (label, call, plain or None for each variant's check)."""
    _build.load(source)
    src = (_build.CSRC / f"{source}.cu").read_text()
    libs = {"kernel": _build._LIBS[source]}
    libs.update({name: build(source, name, make(src)) for name, (make, _) in variants.items()})
    for label, call, plain in cases:
        ref = plain()
        for name, (_, keeps) in variants.items():
            if keeps:
                _build._LIBS[source] = libs[name]
                outs = call()
                for a, b in zip(outs if isinstance(outs, tuple) else (outs,),
                                ref if isinstance(ref, tuple) else (ref,)):
                    chip_smoke.check_bwd(f"{source} {name} {label}", a, b, torch.bfloat16)
        for name in ["kernel", *variants, "kernel"]:
            _build._LIBS[source] = libs[name]
            print(f"{label}: {source} {name} {chip_smoke.time_ms(call):.4f} ms")
        _build._LIBS[source] = libs["kernel"]


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("backward_variants: no CUDA device is available")
    print(chip_smoke.gpu_line())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    bf = torch.bfloat16
    cases = []
    for B, H, S, hd in ((1, 32, 4112, 128), (8, 12, 33, 64)):
        q, k, v, do = (torch.randn(B, H, S, hd, generator=gen, device=dev).to(bf) for _ in range(4))
        out, lse = fa.flash_attention(q, k, v, return_lse=True)
        cases.append((f"B={B} H={H} S=L={S} hd={hd}",
                      lambda q=q, k=k, v=v, o=out, d=do, l=lse: fa.flash_attention_bwd(q, k, v, o, d, l),
                      lambda q=q, k=k, v=v, o=out, d=do, l=lse: fa.flash_attention_bwd_plain(q, k, v, o, d, l)))
    run("flash_attention_bwd", {"row_major_dq": (row_major_dq, True),
                                "no_dq_adds": (no_dq_adds, False)}, cases)
    cases = []
    for T, D, V in ((512, 4096, 32000), (136, 768, 50257)):
        h = torch.randn(T, D, generator=gen, device=dev).to(bf)
        e = (torch.randn(V, D, generator=gen, device=dev) * 0.05).to(bf)
        lab = torch.randint(0, V, (T,), generator=gen, device=dev, dtype=torch.int32)
        g = torch.full((T,), 1.0 / T, device=dev)
        _, lse = sc.score_ce(h, e, lab, return_lse=True)
        cases.append((f"T={T} D={D} V={V}",
                      lambda h=h, e=e, lab=lab, l=lse, g=g: sc.score_ce_bwd(h, e, lab, l, g),
                      lambda h=h, e=e, lab=lab, l=lse, g=g: sc.score_ce_bwd_plain(h, e, lab, l, g)))
    run("score_ce", {"no_g_epilogue": (no_g_epilogue, False),
                     "pair_multicast_ge": (pair_multicast_ge, True)}, cases)
    print(chip_smoke.gpu_line())


if __name__ == "__main__":
    main()
