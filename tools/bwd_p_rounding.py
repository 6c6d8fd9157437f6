#!/usr/bin/env python3
"""Measures what rounding the recomputed P and dS to bf16 costs the prompt
gradient, on one NVIDIA GPU.

    python3 tools/bwd_p_rounding.py [--seed N]

The bf16 flash_attention_bwd kernel (src/repro_torch/kernels/csrc/
flash_attention_bwd.cu) rounds P to bf16 before dV = Pᵀ·dO and dS before
dK and dQ, as an XLA backward in the operands' type does; its plain
version keeps both in f32. This script takes one prompt gradient of a batch
through the bf16 model three ways and holds each against the same weights
in f32 (attention in f32 through the plain versions):

- kernels: the model's own path (flash_attention and its backward kernel);
- plain, f32 P: the attention through flash_attention_plain and
  flash_attention_bwd_plain (chip_smoke.plain_attention);
- plain, bf16 P: the same, with P and dS rounded to bf16 before their
  products, as the kernel does (``bwd_rounded_p``).

At two models and shapes: zamba2-7b at full width and depth (81 Mamba2
layers, the shared attention at hd 112 applied 13 times) at the tuning
shape (batch 8, 16 prompt positions + 17 tokens), and seamless-m4t-medium
at full width and depth (12 + 12 layers) at the tuning shape and at one
train_4k row (4096 tokens + 16 prompt positions against 1024 frontend
frames), each batch with a seeded frontend. Prints each gradient's gap to
f32, ||g - g_f32|| / ||g_f32||, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402


def bwd_rounded_p(q, k, v, out, dout, lse, *, causal=True, window=0, q_offset=0, kv_len=None):
    """flash_attention_bwd_plain with P and dS rounded to bf16 before the
    products that take them (dV = Pᵀ·dO, dK = dSᵀ·Q, dQ = dS·K), as the bf16
    kernel rounds them; the rest in f32."""
    B, H, S, hd = q.shape
    Hkv = k.shape[1]
    G, scale = H // Hkv, 1.0 / hd ** 0.5
    scores, live = fa._scores(q, k, causal=causal, window=window, q_offset=q_offset,
                              kv_len=kv_len)
    p = torch.exp(scores - lse.float().reshape(B, Hkv, G, S)[..., None]) * live
    do = dout.float().reshape(B, Hkv, G, S, hd)
    delta = (do * out.float().reshape(B, Hkv, G, S, hd)).sum(dim=-1)
    dp = torch.einsum("bhgsd,bhld->bhgsl", do, v.float())
    ds = (p * (dp - delta[..., None])).bfloat16().float()
    p = p.bfloat16().float()
    dq = torch.einsum("bhgsl,bhld->bhgsd", ds, k.float()) * scale
    dk = torch.einsum("bhgsl,bhgsd->bhld", ds, q.float().reshape(B, Hkv, G, S, hd)) * scale
    dv = torch.einsum("bhgsl,bhgsd->bhld", p, do)
    return dq.reshape(B, H, S, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def gaps(label: str, model, prompt0: np.ndarray, batch: dict, chunked: bool) -> dict:
    """The three bf16 gradients' gaps to the f32 model's (see the module
    note)."""
    from repro_torch.models import Model

    grads = {}
    t0 = time.perf_counter()
    _, grads["kernels"] = chip_smoke.prompt_loss_grad(model, prompt0, batch, chunked)
    with chip_smoke.plain_attention():
        _, grads["plain, f32 P"] = chip_smoke.prompt_loss_grad(model, prompt0, batch, chunked)
    with chip_smoke.plain_attention(bwd=bwd_rounded_p):
        _, grads["plain, bf16 P"] = chip_smoke.prompt_loss_grad(model, prompt0, batch, chunked)
    f32 = Model(model.cfg.with_overrides(dtype="float32", param_dtype="float32"),
                device=model.device, seed=None)
    f32.load_state_dict(model.state_dict())
    with chip_smoke.plain_attention():
        _, ref = chip_smoke.prompt_loss_grad(f32, prompt0, batch, chunked)
    del f32
    chip_smoke.free_card()
    out = {route: chip_smoke.rel_gap(g, ref) for route, g in grads.items()}
    print(f"{label}: prompt gradient ||g - g_f32|| / ||g_f32|| "
          + ", ".join(f"{route} {gap:.4e}" for route, gap in out.items())
          + f"; ||g_f32|| {ref.norm().item():.4e} ({time.perf_counter() - t0:.1f} s)")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bwd_p_rounding: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.config import INPUT_SHAPES, TuneConfig
    from repro_torch.configs import get_config
    from repro_torch.data import LoaderConfig, TaskLoader
    from repro_torch.models import Model

    card = chip_smoke.gpu_line()
    print(card)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 30)
    tune_cfg = TuneConfig()
    loader = TaskLoader(chip_smoke.synthetic_task(),
                        LoaderConfig(batch_size=tune_cfg.batch_size, seed=args.seed))
    tune_batch = next(loader)
    rng = np.random.default_rng(args.seed)
    results = {}
    for arch in ("zamba2-7b", "seamless-m4t-medium"):
        cfg = get_config(arch)
        model = Model(cfg, device=dev, seed=args.seed)
        prompt0 = rng.normal(0, 0.5 / np.sqrt(cfg.d_model),
                             (tune_cfg.prompt_len, cfg.d_model)).astype(np.float32)
        batches = {"tuning": (dict(tune_batch), False)}
        if cfg.frontend.kind != "none":
            fc, S = cfg.frontend, INPUT_SHAPES["train_4k"].seq_len
            batches["tuning"][0]["frontend"] = torch.randn(
                tune_cfg.batch_size, fc.num_embeddings, fc.embed_dim, generator=gen, device=dev)
            batches["train_4k row"] = ({
                "tokens": torch.randint(3, cfg.vocab_size, (1, S), generator=gen, device=dev,
                                        dtype=torch.int32),
                "labels": torch.randint(0, cfg.vocab_size, (1, S), generator=gen, device=dev,
                                        dtype=torch.int32),
                "mask": torch.ones(1, S, device=dev),
                "frontend": torch.randn(1, fc.num_embeddings, fc.embed_dim, generator=gen,
                                        device=dev)}, True)
        for name, (batch, chunked) in batches.items():
            positions = tune_cfg.prompt_len + batch["tokens"].shape[1]
            results[(arch, name)] = gaps(f"{arch} at {cfg.num_layers} layers, {name} "
                                         f"({batch['tokens'].shape[0]} x {positions} positions)",
                                         model, prompt0, batch, chunked)
        del model
        chip_smoke.free_card()
    for (arch, name), out in results.items():
        print(f"[p-rounding] {arch}, {name}: bf16 P / f32 P gap ratio "
              f"{out['plain, bf16 P'] / out['plain, f32 P']:.3f}, kernels / plain f32 P "
              f"{out['kernels'] / out['plain, f32 P']:.3f}")
    print(card)


if __name__ == "__main__":
    main()
