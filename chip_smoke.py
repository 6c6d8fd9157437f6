#!/usr/bin/env python3
"""Runs the PyTorch port (src/repro_torch) on one NVIDIA GPU and checks it.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure ends the run with a non-zero exit:

1. Build the CUDA kernels from src/repro_torch/kernels/csrc for sm_90a (one
   nvcc per source, in parallel) and print the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card, in bf16
   and f32, at the scoring path's shapes and at ragged and GQA ones.
3. The Prompt Bank lookup at full width: gpt2-base in bf16 with weights from
   --seed, 48 tasks x 4 jittered seed prompts = 192 candidates, activation
   features, a bank of 48 clusters, then three lookup requests (33, 33 and
   513 positions). Each kernel's launch count over this phase must be > 0.
4. Rescore a few candidates through the port on the CPU in f32 (plain
   versions) and hold the card's scores against them.
5. Time each kernel with CUDA events beside its plain version, one PyTorch
   library call computing the same function, and its bound; then profile
   one Eqn-1 evaluation (host wall clock against device busy time).

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent

# H100 SXM published dense peaks (NVIDIA data sheet) at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

TOL = {torch.bfloat16: 3e-2, torch.float32: 2e-5}   # tolerances of tests/test_kernels.py
# Eqn-1 scores, card against the CPU f32 path with the same weights (phase 4).
# bf16 rounds every activation, so it is held loosely; the kernels keep logits
# and softmax in f32, so the gap is set by the bf16 residual stream.
BF16_SCORE_RTOL = 1e-3
F32_SCORE_RTOL = 1e-5    # card f32 (kernels) against CPU f32 (plain versions)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


SPIN_CYCLES = 20_000_000   # ~10 ms of GPU clock: longer than any call's host-side work


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one call over ``reps`` CUDA-event timings.

    A spin kernel holds the stream busy while the host enqueues the start
    event, the call and the end event, so the events bracket the device
    work alone and not the host's launch overhead (which phase 5's
    per-evaluation profile reports)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_close(name: str, out: torch.Tensor, ref: torch.Tensor, tol: float) -> float:
    """Max abs error of ``out`` against ``ref``; raises past atol = rtol = tol."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    if not torch.isfinite(out).all() or (err > tol + tol * ref.abs()).any():
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {err.max().item():.3e}, tol {tol})")
    return err.max().item()


# -- phase 1 --------------------------------------------------------------------

def phase_build() -> str:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build()
    print(f"[1] built {sorted(libs)} for sm_90a in {time.perf_counter() - t0:.1f} s")
    for name, so in sorted(libs.items()):
        log = so.with_suffix(".log").read_text() if so.with_suffix(".log").exists() else ""
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[1] ptxas {name}: {line.strip()}")
    card = gpu_line()
    print(card)
    return card


# -- phase 2 --------------------------------------------------------------------

def phase_kernels(dev: torch.device, seed: int) -> dict:
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.kernels.score_ce import score_ce, score_ce_plain

    gen = torch.Generator(device=dev).manual_seed(seed)
    worst = {"score_ce": 0.0, "flash_attention": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for T in (272, 16 * 497):
            D, V = 768, 50257
            h = torch.randn(T, D, generator=gen, device=dev).to(dtype)
            e = (torch.randn(V, D, generator=gen, device=dev) * 0.05).to(dtype)
            lab = torch.randint(0, V, (T,), generator=gen, device=dev, dtype=torch.int32)
            out = score_ce(h, e, lab)
            torch.cuda.synchronize()
            err = check_close(f"score_ce T={T} {dtype}", out, score_ce_plain(h, e, lab), TOL[dtype])
            worst["score_ce"] = max(worst["score_ce"], err)
            print(f"[2] score_ce T={T} D={D} V={V} {dtype}: max abs err {err:.3e} (tol {TOL[dtype]})")
        cases = [  # B, H, Hkv, S, L, hd, kwargs
            (16, 12, 12, 33, 33, 64, {}),
            (16, 12, 12, 513, 513, 64, {}),
            (2, 28, 4, 513, 513, 128, {}),
            (2, 28, 4, 513, 513, 128, {"window": 128, "kv_len": 400}),
            (2, 28, 4, 64, 513, 128, {"q_offset": 449}),
        ]
        for B, H, Hkv, S, L, hd, kw in cases:
            q = torch.randn(B, H, S, hd, generator=gen, device=dev).to(dtype)
            k = torch.randn(B, Hkv, L, hd, generator=gen, device=dev).to(dtype)
            v = torch.randn(B, Hkv, L, hd, generator=gen, device=dev).to(dtype)
            out = flash_attention(q, k, v, causal=True, **kw)
            torch.cuda.synchronize()
            ref = flash_attention_plain(q, k, v, causal=True, **kw)
            err = check_close(f"flash_attention {(B, H, Hkv, S, L, hd)} {kw} {dtype}",
                              out, ref, TOL[dtype])
            worst["flash_attention"] = max(worst["flash_attention"], err)
            print(f"[2] flash_attention B={B} H={H} Hkv={Hkv} S={S} L={L} hd={hd} "
                  f"causal {kw} {dtype}: max abs err {err:.3e} (tol {TOL[dtype]})")
    return worst


# -- phase 3 --------------------------------------------------------------------

def phase_slice(dev: torch.device, seed: int):
    from repro_torch.config import TuneConfig
    from repro_torch.configs import get_config
    from repro_torch.core import build_bank, make_score_fn
    from repro_torch.data import make_tasks
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.score_ce import score_ce
    from repro_torch.models import Model

    cfg = get_config("gpt2-base")                      # full width, bf16
    model = Model(cfg, device=dev, seed=seed)
    tune_cfg = TuneConfig(prompt_len=16)
    tasks = make_tasks(vocab=32, partitions=4)         # 12 families x 4 = 48 tasks
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    seed_prompts = {t.task_id: rng.normal(0, 0.5 / np.sqrt(d), (tune_cfg.prompt_len, d))
                    .astype(np.float32) for t in tasks}
    requests = [tasks[5], tasks[30],
                make_tasks(input_len=248, target_len=248)[9]]   # 33, 33, 513 positions
    print(f"[3] {cfg.name}: {cfg.num_layers} layers, d={d}, H={cfg.num_heads}, "
          f"V={cfg.vocab_size}, {cfg.dtype}, weights from seed {seed}")

    score_ce.launches = flash_attention.launches = 0
    t0 = time.perf_counter()
    bank = build_bank(model, seed_prompts, variants_per_prompt=4, seed=seed)
    torch.cuda.synchronize()
    print(f"[3] bank: {len(bank.entries)} candidates, {len(bank.medoid_ids)} clusters, "
          f"features + clustering {time.perf_counter() - t0:.3f} s")
    if len(bank.entries) != 192 or len(bank.medoid_ids) != 48:
        raise AssertionError("bank does not hold 192 candidates in 48 clusters")
    results = []
    for task in requests:
        score_fn = make_score_fn(model, task, tune_cfg)
        positions = tune_cfg.prompt_len + score_fn.eval_batch["tokens"].shape[1]
        res = bank.lookup(score_fn)
        if not np.isfinite(res.score) or res.evaluations < len(bank.medoid_ids):
            raise AssertionError(f"lookup for {task.task_id} gave {res}")
        print(f"[3] request {task.task_id} ({positions} positions): origin={res.entry.origin} "
              f"score={res.score:.6f} evaluations={res.evaluations} "
              f"latency={res.latency_s:.3f} s")
        results.append((task, res))
    launches = {"score_ce": score_ce.launches, "flash_attention": flash_attention.launches}
    print(f"[3] kernel launches on the lookup path: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the lookup path")
    return model, bank, results, launches


# -- phase 4 --------------------------------------------------------------------

def phase_rescore(model, bank, results, seed: int) -> None:
    from repro_torch.config import TuneConfig
    from repro_torch.core import make_score_fn
    from repro_torch.models import Model

    tune_cfg = TuneConfig(prompt_len=16)
    f32 = model.cfg.with_overrides(dtype="float32", param_dtype="float32")
    ref_cpu = Model(f32, device="cpu", seed=seed)
    ref_cpu.load_state_dict(model.state_dict())        # the same (bf16) weights, widened
    f32_gpu = Model(f32, device=model.device, seed=seed)
    f32_gpu.load_state_dict(model.state_dict())
    failed = []
    for task, res in results[:2]:
        entries = [res.entry, bank.entries[bank.medoid_ids[0]]]
        for entry in entries:
            cpu = make_score_fn(ref_cpu, task, tune_cfg)(entry)
            bf16 = make_score_fn(model, task, tune_cfg)(entry)
            f32k = make_score_fn(f32_gpu, task, tune_cfg)(entry)
            r_bf16, r_f32 = abs(bf16 - cpu) / abs(cpu), abs(f32k - cpu) / abs(cpu)
            print(f"[4] {task.task_id} {entry.origin}: cpu f32 {cpu:.6f}, card bf16 {bf16:.6f} "
                  f"(rel {r_bf16:.2e}), card f32 {f32k:.6f} (rel {r_f32:.2e})")
            if not r_bf16 <= BF16_SCORE_RTOL or not r_f32 <= F32_SCORE_RTOL:
                failed.append(f"{task.task_id} {entry.origin}")
    if failed:
        raise AssertionError(f"card scores disagree with the CPU f32 path for {failed} "
                             f"(relative tolerance {BF16_SCORE_RTOL} bf16, {F32_SCORE_RTOL} f32)")


# -- phase 5 --------------------------------------------------------------------

def bound(flops: float, nbytes: float, peak_flops: float):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_times(model, seed: int) -> dict:
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.kernels.score_ce import score_ce, score_ce_plain

    dev, gen = model.device, torch.Generator(device=model.device).manual_seed(seed)
    emb = model.embedding.detach()                     # (V, D) bf16, 77 MB
    V, D = emb.shape
    rows = {}
    for T in (16 * 17, 16 * 497):
        h = torch.randn(T, D, generator=gen, device=dev).to(emb.dtype)
        lab = torch.randint(0, V, (T,), generator=gen, device=dev, dtype=torch.int32)
        flops = 2.0 * T * V * D
        nbytes = (T * D + V * D) * emb.element_size() + T * 4 + T * 4
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        row = {"shape": f"T={T} D={D} V={V} bf16",
               "ms": time_ms(lambda: score_ce(h, emb, lab)),
               "plain_ms": time_ms(lambda: score_ce_plain(h, emb, lab)),
               "library_ms": time_ms(lambda: F.cross_entropy(
                   (h @ emb.T).float(), lab.long(), reduction="none")),
               "bound_ms": b_ms, "bound_by": b_by}
        rows.setdefault("score_ce", []).append(row)
    cfg = model.cfg
    B, H, hd = 16, cfg.num_heads, cfg.resolved_head_dim()
    for S in (33, 513):
        q, k, v = (torch.randn(B, H, S, hd, generator=gen, device=dev).to(emb.dtype)
                   for _ in range(3))
        pairs = S * (S + 1) // 2                      # live (query, key) pairs, causal
        flops = 4.0 * B * H * pairs * hd
        nbytes = 4 * B * H * S * hd * q.element_size()
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        row = {"shape": f"B={B} H={H} S=L={S} hd={hd} causal bf16",
               "ms": time_ms(lambda: flash_attention(q, k, v, causal=True)),
               "plain_ms": time_ms(lambda: flash_attention_plain(q, k, v, causal=True)),
               "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=True)),
               "bound_ms": b_ms, "bound_by": b_by}
        rows.setdefault("flash_attention", []).append(row)
    for name, rs in rows.items():
        for r in rs:
            print(f"[5] {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


def phase_profile(model, bank, results) -> None:
    """Where one Eqn-1 evaluation's time goes: host wall clock per call
    against the device time the profiler attributes to its kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import TuneConfig
    from repro_torch.core import make_score_fn

    entry = bank.entries[0]
    for task, _ in (results[0], results[-1]):
        fn = make_score_fn(model, task, TuneConfig(prompt_len=16))
        positions = 16 + fn.eval_batch["tokens"].shape[1]
        for _ in range(3):
            fn(entry)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fn(entry)
        wall_ms = (time.perf_counter() - t0) / 10 * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn(entry)
        # device-side events only: each aten op's entry repeats its kernels' time
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        dev_ms = sum(e.self_device_time_total for e in events) / 5 / 1e3
        print(f"[5] one evaluation at {positions} positions: host wall {wall_ms:.3f} ms, "
              f"device busy {dev_ms:.3f} ms (idle share {1 - dev_ms / wall_ms:.3f}), "
              f"{sum(e.count for e in events) / 5:.0f} kernels")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
            print(f"[5]   {e.self_device_time_total / 5 / 1e3:.4f} ms  x{e.count // 5:<4d} "
                  f"{e.key[:90]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False     # f32 references stay f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    card = phase_build()
    worst = phase_kernels(dev, args.seed)
    model, bank, results, launches = phase_slice(dev, args.seed)
    phase_rescore(model, bank, results, args.seed)
    rows = phase_times(model, args.seed)
    phase_profile(model, bank, results)

    source = "src/repro_torch/kernels/csrc/{}.cu"
    replaces = {"score_ce": "src/repro/kernels/score_ce.py:101",
                "flash_attention": "src/repro/kernels/flash_attention.py:109"}
    kernels = []
    for name in ("score_ce", "flash_attention"):
        path_row = rows[name][0]          # the default request's shape (33 positions)
        kernels.append({
            "name": name, "route": "cuda", "source": source.format(name),
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": worst[name], "ms": path_row["ms"], "plain_ms": path_row["plain_ms"],
            "bound_ms": path_row["bound_ms"], "bound_by": path_row["bound_by"],
            "library_ms": path_row["library_ms"], "shape": path_row["shape"],
            "long_form": rows[name][1]})
    print(f"[done] {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
