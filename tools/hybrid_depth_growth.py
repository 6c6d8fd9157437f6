#!/usr/bin/env python3
"""How a difference of summation order between zamba2-7b's decode and its
forward grows with depth, in f32, at full depth and a reduced width.

    python3 tools/hybrid_depth_growth.py [--d-model 512]

Builds zamba2-7b's 81 Mamba2 layers (shared attention every 6, 32 heads of
112, state 64, chunk 128) at width ``--d-model`` (d_ff 2 x, V = 32000, f32)
on the CPU from seed 0, and runs chip_smoke.hybrid_depth_witness on 32 tokens
x 2 rows: per block, decode fed the forward's own input against the
forward; through depth, the teacher-forced decode chained block after block
against the forward's hidden state. Both compute the same function, so
their gap is f32 rounding in another order, and its growth with depth is
what a random stack does to any perturbation, bf16 rounding included.
Prints the gaps at a few depths and, last, one JSON line of all of them.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--d-model", type=int, default=512)
    args = ap.parse_args()
    cfg = get_config("zamba2-7b").with_overrides(
        d_model=args.d_model, d_ff=2 * args.d_model, dtype="float32", param_dtype="float32")
    t0 = time.perf_counter()
    model = Model(cfg, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(3, cfg.vocab_size, (2, 32), generator=gen)
    out = chip_smoke.hybrid_depth_witness(f"[depth d={args.d_model}]", model, tokens)
    print(f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"d_model": args.d_model, **out}))


if __name__ == "__main__":
    main()
