#!/usr/bin/env python3
"""Holds the bf16 flash_attention kernel beside its one-term P·V variant, on
one NVIDIA GPU: what splitting P into P_hi + P_lo buys in accuracy and
what it costs in time.

    python3 tools/flash_attention_variants.py

The variant is what src/repro_torch/kernels/csrc/flash_attention.cu ran
before P was split: one bf16 P as the A operand of each P·V product. It is
made from the committed source by ONE_TERM_SUBS (each substitution must
apply exactly once, so an edit of the kernel's P·V block that breaks one
fails loudly: edit the substitutions with it), compiled with the port's
nvcc flags into build/flash_attention_variants/ and launched through the
port's wrapper.

- Gaps: at each bf16 case of chip_smoke.FLASH_CASES, and at qwen2-7b's
  heads at S = L = 32768 in slices of 1024 queries, the largest error
  against flash_attention_plain (P in f32) and its share of phase 2's bound
  (chip_smoke.fa_bf16_bound: at most 1 where it holds) for the kernel, the
  one-term variant and the plain version with P rounded to bf16. Printed,
  not held: the variant falls outside the bound by design.
- Cost: the kernel and the variant timed with chip_smoke.time_ms in the
  order kernel, variant, kernel, variant at gpt2-base's lookup (S = 513, hd
  64), vicuna-7b's train_4k (S = 4112, hd 128) and zamba2-7b's lookup (S =
  513, hd 112), causal, MHA.

Prints the card's name and power limit first and last.
"""
from __future__ import annotations

import contextlib
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
from repro_torch.kernels.flash_attention import (_scores, flash_attention,  # noqa: E402
                                                 flash_attention_plain)

OUT = ROOT / "build" / "flash_attention_variants"

ONE_TERM_SUBS = [
    ("""      uint32_t ph[4], pl[4];
      split_bf16(sa[2 * kk][0], sa[2 * kk][1], ph[0], pl[0]);
      split_bf16(sa[2 * kk][2], sa[2 * kk][3], ph[1], pl[1]);
      split_bf16(sa[2 * kk + 1][0], sa[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(sa[2 * kk + 1][2], sa[2 * kk + 1][3], ph[3], pl[3]);
""", """      const uint32_t ph[4] = {pack_bf16(sa[2 * kk][0], sa[2 * kk][1]),
                              pack_bf16(sa[2 * kk][2], sa[2 * kk][3]),
                              pack_bf16(sa[2 * kk + 1][0], sa[2 * kk + 1][1]),
                              pack_bf16(sa[2 * kk + 1][2], sa[2 * kk + 1][3])};
"""),
    ("""        mma_bf16(oacc[n], pl, bf[0], bf[1]);
        mma_bf16(oacc[n + 1], pl, bf[2], bf[3]);
""", ""),
]

# B, H, S = L, hd of the cost's timings (causal, MHA)
SPLIT_COST_SHAPES = [(16, 12, 513, 64), (1, 32, 4112, 128), (16, 32, 513, 112)]
SLICE_ROWS = 1024


def one_term_p_source(src: str) -> str:
    for old, new in ONE_TERM_SUBS:
        if src.count(old) != 1:
            raise SystemExit(f"the one-term P·V variant no longer applies to "
                             f"flash_attention.cu: {old.strip()[:60]!r}")
        src = src.replace(old, new)
    return src


def build_one_term() -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / "flash_attention_one_term.cu", OUT / "flash_attention_one_term.so"
    cu.write_text(one_term_p_source((_build.CSRC / "flash_attention.cu").read_text()))
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc of the one-term variant failed:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(so))


@contextlib.contextmanager
def fa_library(lib):
    """flash_attention's wrapper launches from ``lib`` inside the block."""
    _build.load("flash_attention")
    saved, _build._LIBS["flash_attention"] = _build._LIBS["flash_attention"], lib
    try:
        yield
    finally:
        _build._LIBS["flash_attention"] = saved


def flash_attention_p_bf16(q, k, v, **kw):
    """flash_attention_plain with P rounded to bf16 before P·V, as one bf16
    A operand rounds it: exp(s - row max) rounded, P·V in f32, divided by the
    f32 row sum."""
    B, H, S, hd = q.shape
    kw = {"causal": True, "window": 0, "q_offset": 0, "kv_len": None, **kw}
    scores, live = _scores(q, k, **kw)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True)) * live
    pv = torch.einsum("bhgsl,bhld->bhgsd", p.to(torch.bfloat16).float(), v.float())
    return (pv / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)).reshape(B, H, S, hd).to(q.dtype)


def gap(out: torch.Tensor, ref: torch.Tensor, rtol: float, atol: float):
    """(max abs error, the largest share of the bound atol + rtol·|ref| that
    an element's error takes: at most 1 where the bound holds)."""
    err = (out.float() - ref.float()).abs()
    return err.max().item(), (err / (atol + rtol * ref.float().abs())).max().item()


def gaps(one_term, gen, dev) -> None:
    for B, H, Hkv, S, L, hd, kw in chip_smoke.FLASH_CASES:
        kw = {"causal": True, **kw}
        q = torch.randn(B, H, S, hd, generator=gen, device=dev).bfloat16()
        k, v = (torch.randn(B, Hkv, L, hd, generator=gen, device=dev).bfloat16()
                for _ in range(2))
        ref = flash_attention_plain(q, k, v, **kw)
        rtol, atol = chip_smoke.fa_bf16_bound(ref)
        after = gap(flash_attention(q, k, v, **kw), ref, rtol, atol)
        with fa_library(one_term):
            before = gap(flash_attention(q, k, v, **kw), ref, rtol, atol)
        rounded = gap(flash_attention_p_bf16(q, k, v, **kw), ref, rtol, atol)
        print(f"B={B} H={H} Hkv={Hkv} S={S} L={L} hd={hd} {kw}: kernel {after[0]:.3e} "
              f"({after[1]:.2f} of the bound); one bf16 P {before[0]:.3e} ({before[1]:.2f}); "
              f"plain with P rounded to bf16 {rounded[0]:.3e} ({rounded[1]:.2f})")
    # qwen2-7b's heads at prefill_32k's length, in slices
    q = torch.randn(1, 28, 32768, 128, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(1, 4, 32768, 128, generator=gen, device=dev).bfloat16()
            for _ in range(2))
    out = flash_attention(q, k, v, causal=True)
    with fa_library(one_term):
        before = flash_attention(q, k, v, causal=True)
    worst = {"kernel": (0.0, 0.0), "one bf16 P": (0.0, 0.0)}
    for s0 in range(0, q.shape[2], SLICE_ROWS):
        s1 = s0 + SLICE_ROWS
        ref = flash_attention_plain(q[:, :, s0:s1], k[:, :, :s1], v[:, :, :s1], causal=True,
                                    q_offset=s0)
        rtol, atol = chip_smoke.fa_bf16_bound(ref)
        for name, o in (("kernel", out), ("one bf16 P", before)):
            g = gap(o[:, :, s0:s1], ref, rtol, atol)
            worst[name] = tuple(max(a, b) for a, b in zip(worst[name], g))
    print("B=1 H=28 Hkv=4 S=L=32768 hd=128 causal, 32 slices: " + "; ".join(
        f"{name} {e:.3e} ({share:.2f} of the bound)" for name, (e, share) in worst.items()))


def cost(one_term, gen, dev) -> None:
    for B, H, S, hd in SPLIT_COST_SHAPES:
        q, k, v = (torch.randn(B, H, S, hd, generator=gen, device=dev).bfloat16()
                   for _ in range(3))
        times = {"split": [], "one_term": []}
        for name in ("split", "one_term", "split", "one_term"):
            with fa_library(one_term) if name == "one_term" else contextlib.nullcontext():
                times[name].append(chip_smoke.time_ms(
                    lambda: flash_attention(q, k, v, causal=True)))
        best = {name: min(t) for name, t in times.items()}
        print(f"B={B} H={H} S=L={S} hd={hd} causal bf16: P split (the kernel) "
              f"{times['split'][0]:.4f} / {times['split'][1]:.4f} ms, one bf16 P "
              f"{times['one_term'][0]:.4f} / {times['one_term'][1]:.4f} ms: the split costs "
              f"{best['split'] / best['one_term'] - 1:+.1%}")
        del q, k, v


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("flash_attention_variants: no CUDA device is available")
    print(chip_smoke.gpu_line())
    one_term = build_one_term()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)
    gaps(one_term, gen, dev)
    cost(one_term, gen, dev)
    print(chip_smoke.gpu_line())


if __name__ == "__main__":
    main()
