#!/usr/bin/env python3
"""Times the bf16 ``rwkv6_wkv`` backward beside the sequential kernel it
replaced and beside variants of its own design, on one NVIDIA GPU, in one
process.

    python3 tools/wkv_bwd_variants.py [--phases]

Each variant is the committed source (src/repro_torch/kernels/csrc/
rwkv_wkv_bwd.cu) with a few lines replaced, compiled with the port's nvcc
flags into build/wkv_bwd_variants/ and called through the port's wrapper:

- sequential: the launcher's bf16 branch runs the sequential kernel of the
  same file instantiated for bf16 (one block of 256 threads per (batch,
  head), the state kept every 8 tokens: the bf16 kernel before the chunked
  form), its scratch sized for 8-token intervals;
- swizzled: the chunked kernel's f32 tiles unpadded, 64 words a row, with
  column bits 3-4 XORed by a function of the row instead of rows padded to
  68 words (conflict-free in every pattern, but the addresses are no
  longer affine in the unrolled indices);
- three_blocks, two_blocks: the chunked kernel compiled for three or two
  blocks an SM (168 or 255 registers a thread) instead of four (128).

All are checked against the plain version at phase 9e's bf16 tolerance,
then timed with chip_smoke.time_ms in the order kernel, variants, kernel,
at the tuning shape (B = 8, H = 64, T = 33, zero start state, no dS_T) and
at T = 529 (a 513-token lookup's tokens and 16 prompt positions). Prints
ptxas's registers and spills of each kernel, and the card's name and power
limit first and last. With --phases, also a copy of the chunked kernel
with clock64 read at each phase's end by threads 0 and 64 (a thread of the
per-channel warps and one of the dv warps), summed over blocks with atomic
adds, printed as cycles per block and sub-chunk at both shapes.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import rwkv_wkv as rw  # noqa: E402

OUT = ROOT / "build" / "wkv_bwd_variants"
SOURCE = "rwkv_wkv_bwd"

SEQUENTIAL_BF16 = '''  if (is_bf16) {   // the sequential kernel, instantiated for bf16
    using E = __nv_bfloat16;
    rwkv6_wkv_bwd_kernel<E><<<B * H, kThreads, 0, cs>>>(
        static_cast<const E*>(r), static_cast<const E*>(k), static_cast<const E*>(v), lw, uu, s,
        g, dst, static_cast<E*>(dr), static_cast<E*>(dk), static_cast<E*>(dv), dwp, dup, d0, cp,
        sr, sk, sv, sw, sdy, sdr, sdk, sdv, sdw, H, T);
'''


def sequential(src: str) -> str:
    start = "  if (is_bf16) {   // the chunked kernel\n"
    end = "  } else {\n    rwkv6_wkv_bwd_kernel<float>"
    if src.count(start) != 1 or src.count(end) != 1 or src.index(start) > src.index(end):
        raise SystemExit("variant no longer applies: the launcher's bf16 branch moved")
    return src[:src.index(start)] + SEQUENTIAL_BF16 + src[src.index(end):]


def sub(text: str, old: str, new: str, count: int = 1) -> str:
    if text.count(old) != count:
        raise SystemExit(f"variant no longer applies: {old[:70]!r}")
    return text.replace(old, new)


SWIZZLE = """// [rows][64] f32 tiles without padding, column bits 3-4 XORed with
// s(row) = (row ^ row >> 1) & 3
__device__ __forceinline__ int swz(int row, int col) {
  return row * HD + (col ^ (((row ^ (row >> 1)) & 3) << 3));
}
"""


def swizzled(src: str) -> str:
    start, end = "constexpr int kLd = 68;\n", "struct ChunkSmem {"
    if src.count(start) != 1 or src.count(end) != 1:
        raise SystemExit("variant no longer applies: the tile layout moved")
    src = src[:src.index(start)] + SWIZZLE + "\n" + src[src.index(end):]
    src = sub(src, "[HD * kLd]", "[HD * HD]")
    src = sub(src, "[kSub * kLd]", "[kSub * HD]", count=5)
    return re.sub(r"\bat\(", "swz(", src)


def blocks(n: int):
    return lambda src: sub(src, "__launch_bounds__(kCThreads, 4)", f"__launch_bounds__(kCThreads, {n})")


PHASES = ["forward: copy in", "forward: decays", "forward: update and store",
          "(1) copy in of dy, v", "(2) dY S_inᵀ, V G_outᵀ", "(1) wait for r, k, logw",
          "(3) decays | dA", "(4) A | -", "(5) channels | dv, G", "wait"]
PHASE_AT = [   # (text, phase index, the clock read before the text or after it)
    ("                 sc * kSub, T, vec);\n      cp_async_wait<0>();\n      __syncthreads();\n", 0,
     "after"),
    ("      __syncthreads();\n      // Sᵀ = Sᵀ", 1, "between"),
    ("      __syncthreads();   // the stage is read; the next load may overwrite it\n", 2, "after"),
    ("    __syncthreads();   // dy and v are in; the previous sub-chunk's G_in is in place\n", 3,
     "after"),
    ("    cp_async_wait<0>();\n    __syncthreads();   // r, k and logw are in", 4, "before"),
    ("    __syncthreads();   // r, k and logw are in; the products of (2) too\n", 5, "after"),
    ("    const bool steep = __syncthreads_or(unsafe);\n", 6, "after"),
    ("    if (tid < HD) {\n      // (5a)", 7, "before"),
    ("    __syncthreads();   // G_in in place; the stage is free for the next sub-chunk\n", 8,
     "before"),
    ("    __syncthreads();   // G_in in place; the stage is free for the next sub-chunk\n", 9,
     "after"),
]


def phases(src: str) -> str:
    """The chunked kernel with clock64 read at each point of PHASE_AT."""
    src = sub(src, "namespace {\n\nstruct Strides", """__device__ unsigned long long g_phase[32];
#define PHASE(k) if ((threadIdx.x & 63) == 0) { const long long c_ = clock64(); \\
  atomicAdd(&g_phase[(threadIdx.x >> 6) * 16 + (k)], (unsigned long long)(c_ - t_)); t_ = c_; }
extern "C" int read_phases(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_phase, sizeof(g_phase));
}
extern "C" int reset_phases() {
  unsigned long long z[32] = {0};
  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));
}
namespace {

struct Strides""")
    src = sub(src, "  ChunkSmem& sm = *reinterpret_cast<ChunkSmem*>(smem_raw);\n",
              "  ChunkSmem& sm = *reinterpret_cast<ChunkSmem*>(smem_raw);\n  long long t_ = clock64();\n")
    for text, k, where in PHASE_AT:
        mark = f"PHASE({k})\n"
        if where == "after":
            src = sub(src, text, text + mark)
        elif where == "before":
            src = sub(src, text, mark + text)
        else:   # between the two lines of text
            first, rest = text.split("\n", 1)
            src = sub(src, text, first + "\n" + mark + rest)
    return src


def print_phases(lib: ctypes.CDLL, call, T: int, label: str) -> None:
    """Cycles per block and sub-chunk of each phase of one call."""
    lib.read_phases.argtypes = [ctypes.c_void_p]
    call()
    torch.cuda.synchronize()
    lib.reset_phases()
    call()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 32)()
    lib.read_phases(ctypes.cast(buf, ctypes.c_void_p))
    n_sub, blocks_ = -(-T // 16), 8 * 64
    print(f"{label}: cycles per block and sub-chunk, thread 0 (per-channel warps) | "
          f"thread 64 (dv warps)")
    for k, name in enumerate(PHASES):
        steps = max(n_sub - 1 if name.startswith("forward") else n_sub, 1)
        print(f"  {name:28s} {buf[k] / blocks_ / steps:9.0f} | {buf[16 + k] / blocks_ / steps:9.0f}")


def build(name: str, text: str) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{SOURCE}-{name}.cu", OUT / f"{SOURCE}-{name}.so"
    cu.write_text(text)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc {SOURCE} {name} failed:\n{proc.stdout}{proc.stderr}")
    print_registers(name, proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(so))
    ref = _build.load(SOURCE).rwkv6_wkv_bwd_launch
    fn = lib.rwkv6_wkv_bwd_launch
    fn.argtypes, fn.restype = ref.argtypes, ref.restype
    return lib


def print_registers(label: str, log: str) -> None:
    """ptxas -v's registers and spills of each entry function in ``log``."""
    entry = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = next((n for n in ("rwkv6_wkv_bwd_chunked", "rwkv6_wkv_bwd_kernel",
                                      "rwkv6_wkv_bwd_du") if n in m.group(1)), m.group(1))
        elif entry and ("spill" in line or "registers" in line):
            print(f"ptxas {label} {entry}: {line.split(':', 1)[-1].strip()}")


VARIANTS = {"sequential": sequential, "swizzled": swizzled, "three_blocks": blocks(3),
            "two_blocks": blocks(2)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", action="store_true",
                    help="also time the chunked kernel's phases with clock64")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("wkv_bwd_variants: no CUDA device is available")
    print(chip_smoke.gpu_line())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7)
    _build.load(SOURCE)
    print_registers("kernel", _build.library_path(SOURCE).with_suffix(".log").read_text())
    src = (_build.CSRC / f"{SOURCE}.cu").read_text()
    texts = {name: make(src) for name, make in VARIANTS.items()}
    if args.phases:
        texts["phases"] = phases(src)
    with ThreadPoolExecutor(len(texts)) as pool:   # one nvcc a variant, all at once
        built = {name: pool.submit(build, name, text) for name, text in texts.items()}
        libs = {"kernel": _build._LIBS[SOURCE], **{n: f.result() for n, f in built.items()}}
    timed = ["kernel", *VARIANTS, "kernel"]

    def use(name: str) -> None:
        _build._LIBS[SOURCE] = libs[name]
        rw.BWD_CHECKPOINT = 8 if name == "sequential" else 16

    try:
        for T in (33, 529):
            r, k, v, logw, u, _, dy, _ = chip_smoke.wkv_bwd_inputs(
                gen, dev, 8, 64, T, "drawn", False, False, torch.bfloat16)
            call = lambda: rw.rwkv6_wkv_bwd(r, k, v, logw, u, None, dy, None, need_du=False)
            ref = rw.rwkv6_wkv_bwd_plain(r, k, v, logw, u, None, dy)
            label = f"B=8 H=64 T={T} hd=64 bf16"
            for name in libs:
                use(name)
                for g, a, b in zip(chip_smoke.WKV_GRADS, call(), ref):
                    if a is not None:
                        chip_smoke.check_rel_max(f"{label} {name} {g}", a, b,
                                                 chip_smoke.WKV_BWD_TOL[torch.bfloat16])
            for name in timed:
                use(name)
                print(f"{label}: rwkv6_wkv_bwd {name} {chip_smoke.time_ms(call):.4f} ms")
            b_ms, b_by, cuda_core_ms = chip_smoke.wkv_bwd_bound(8, 64, T, 64, 2)
            print(f"{label}: bound {b_ms:.4f} ms ({b_by}; the operations on the CUDA cores "
                  f"{cuda_core_ms:.4f} ms)")
            if args.phases:
                use("phases")
                print_phases(libs["phases"], call, T, label)
            del r, k, v, logw, dy, ref
    finally:
        use("kernel")
    print(chip_smoke.gpu_line())


if __name__ == "__main__":
    main()
