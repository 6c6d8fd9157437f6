#!/usr/bin/env python3
"""Times variants of the bf16 mla_decode kernel beside the kernel itself,
on one NVIDIA GPU, to show what bounds it.

    python3 tools/mla_decode_variants.py

Each variant is the committed source (src/repro_torch/kernels/csrc/
mla_decode.cu) with a few lines replaced, compiled with the port's nvcc
flags into build/mla_decode_variants/ and timed through the port's wrapper
with chip_smoke.time_ms, at phase 8a's decode_32k (B = 16) and long_500k
(B = 1) shapes, in the order kernel, variants, kernel:

- products_only: the producer loads the first two tiles and then only
  signals the ring, so the consumers run every product on stale tiles
  (the loads' cost removed; the outputs are wrong);
- loads_only: the consumers release each tile as it lands (the products'
  cost removed);
- pair_multicast: the two head-group blocks of a (split, batch row) form a
  cluster of two; each block's producer loads half of every tile's column
  blocks into both blocks by TMA .multicast::cluster, and a stage is
  refilled once the consumers of both blocks have released it (16-arrival
  empty barriers, half of them remote);
- pair_multicast_loads_only: the same, with the consumers releasing each
  tile as it lands.

The pair variant is checked against the plain version before it is timed.
Prints the card's name and power limit first and last.
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
from repro_torch.kernels.mla_decode import mla_decode, mla_decode_plain  # noqa: E402

OUT = ROOT / "build" / "mla_decode_variants"


def sub(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"variant no longer applies: {old[:70]!r}")
    return text.replace(old, new)


def products_only(src: str) -> str:
    return sub(src, """    mbar_wait(&empty[stage], phase ^ 1);
    mbar_expect_tx(&full[stage], kStageBytes);""", """    mbar_wait(&empty[stage], phase ^ 1);
    if (it >= kStages) {
      mbar_arrive(&full[stage]);
      if (++stage == kStages) { stage = 0; phase ^= 1; }
      continue;
    }
    mbar_expect_tx(&full[stage], kStageBytes);""")


def loads_only(src: str) -> str:
    src = sub(src, """    if (it > 0) release(&empty[(it - 1) % kStages]);
    mbar_wait(&full[stage], (it / kStages) & 1);
    const uint32_t tile = ring0 + stage * kStageBytes;""", """    mbar_wait(&full[stage], (it / kStages) & 1);
    if (true) { release(&empty[stage]); continue; }
    const uint32_t tile = ring0 + stage * kStageBytes;""")
    return sub(src, """    bar_sync(kBarPFull);
    mbar_wait(&full[stage], (it / kStages) & 1);""", """    mbar_wait(&full[stage], (it / kStages) & 1);
    if (true) { release(&empty[stage]); continue; }
    bar_sync(kBarPFull);""")


def pair_multicast(src: str) -> str:
    src = sub(src, "// wgmma descriptors of a column block", r'''__device__ __forceinline__ void tma_load_3d_pair(void* dst, const CUtensorMap* map, uint64_t* bar,
                                                 int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3, %4}], [%5], %6;\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(smem_u32(bar)), "h"((uint16_t)0x3)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive_peer(uint64_t* bar) {
  uint32_t remote;
  asm volatile("{\n.reg .u32 rank;\nmov.u32 rank, %%cluster_ctarank;\nxor.b32 rank, rank, 1;\n"
               "mapa.shared::cluster.u32 %0, %1, rank;\n}\n"
               : "=r"(remote) : "r"(smem_u32(bar)));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" :: "r"(remote) : "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// wgmma descriptors of a column block''')
    src = sub(src, """__device__ __forceinline__ void release(uint64_t* empty) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty);
}""", """__device__ __forceinline__ void release(uint64_t* empty) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    mbar_arrive(empty);
    mbar_arrive_peer(empty);
  }
}""")
    src = sub(src, """#pragma unroll
    for (int cb = 0; cb < kBlocks - 1; ++cb)
      tma_load_3d(dst + cb * kColBlock, tm_ckv, &full[stage], 64 * cb, j, b);
    tma_load_3d(dst + (kBlocks - 1) * kColBlock, tm_kpe, &full[stage], 0, j, b);""", """    const int first = cluster_rank() == 0 ? 0 : 5, last = first == 0 ? 5 : kBlocks;
    for (int cb = first; cb < last; ++cb)
      tma_load_3d_pair(dst + cb * kColBlock, cb < kBlocks - 1 ? tm_ckv : tm_kpe, &full[stage],
                       cb < kBlocks - 1 ? 64 * cb : 0, j, b);""")
    src = sub(src, """      mbar_init(&empty[s], 8);        // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
  }
  __syncthreads();""", """      mbar_init(&empty[s], 16);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
  }
  cluster_sync();""")
    src = sub(src, """      produce(qs, ring, full, empty, qbar, &tm_ql, &tm_qp, &tm_ckv, &tm_kpe, h0, b, row_begin,
              n_tiles);""", """      produce(qs, ring, full, empty, qbar, &tm_ql, &tm_qp, &tm_ckv, &tm_kpe, h0, b, row_begin,
              n_tiles);
    __syncwarp();
    cluster_sync();""")
    src = sub(src, """                   split, splits, row_begin, row_end, n_tiles, c);""",
              """                   split, splits, row_begin, row_end, n_tiles, c);
    cluster_sync();""")
    src = sub(src, """    consume_p(ps, ring, alpha_s, l_s, full, empty, o_part, H, h0, b, split, splits, n_tiles);""",
              """    consume_p(ps, ring, alpha_s, l_s, full, empty, o_part, H, h0, b, split, splits, n_tiles);
    cluster_sync();""")
    return sub(src, """  mla_decode_bf16<<<grid, kThreads, kSmem, stream>>>(tm_ql, tm_qp, tm_ckv, tm_kpe, o_part, lse,
                                                     H, hi, per, splits, scale * kLog2e);""",
               """  if (grid.x % 2) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 2;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mla_decode_bf16, tm_ql, tm_qp, tm_ckv, tm_kpe, o_part, lse, H,
                           hi, per, splits, scale * kLog2e);
  if (err != cudaSuccess) return (int)err;""")


def build(name: str, text: str) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    cu.write_text(text)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc {name} failed:\n{proc.stdout}{proc.stderr}")
    log = (proc.stdout + proc.stderr).splitlines()
    print(f"built {name}: " + "; ".join(line.strip() for line in log if "spill" in line))
    lib = ctypes.CDLL(str(so))
    fn = lib.mla_decode_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 8 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("mla_decode_variants: no CUDA device is available")
    print(chip_smoke.gpu_line())
    src = (_build.CSRC / "mla_decode.cu").read_text()
    variants = {"kernel": src, "products_only": products_only(src), "loads_only": loads_only(src),
                "pair_multicast": pair_multicast(src),
                "pair_multicast_loads_only": loads_only(pair_multicast(src))}
    libs = {name: build(name, text) for name, text in variants.items()}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    scale = 192 ** -0.5
    for shape, B, L in (("decode_32k", 16, 32768), ("long_500k", 1, 524288)):
        H, live = 128, L - 1
        ql, qp = (torch.randn(B, H, d, generator=gen, device=dev).bfloat16() for d in (512, 64))
        ckv, kpe = (torch.randn(B, L, d, generator=gen, device=dev).bfloat16() for d in (512, 64))
        call = lambda: mla_decode(ql, qp, ckv, kpe, scale=scale, kv_len=live)
        _build._LIBS["mla_decode"] = libs["pair_multicast"]
        out = call()
        torch.cuda.synchronize()
        ref = mla_decode_plain(ql, qp, ckv, kpe, scale=scale, kv_len=live)
        chip_smoke.check_close(f"pair_multicast {shape}", out, ref, chip_smoke.DECODE_BF16_RTOL,
                               chip_smoke.DECODE_BF16_ATOL * ref.float().abs().max().item())
        for name in ["kernel", *[n for n in variants if n != "kernel"], "kernel"]:
            _build._LIBS["mla_decode"] = libs[name]
            print(f"{shape} B={B} H={H} kv_len={live}: {name} {chip_smoke.time_ms(call):.4f} ms")
        del ql, qp, ckv, kpe, out, ref
        torch.cuda.empty_cache()
    _build._LIBS.pop("mla_decode", None)
    print(chip_smoke.gpu_line())


if __name__ == "__main__":
    main()
