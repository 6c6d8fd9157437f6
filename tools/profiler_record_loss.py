#!/usr/bin/env python3
"""Counts the kernel records that torch.profiler keeps over a long-running
process on one NVIDIA GPU, beside the runtime's launch records.

    python3 tools/profiler_record_loss.py [--seconds 300]

Every 15 s, while the card multiplies 4096 x 4096 f32 matrices in between,
it takes five traces of the same work, one fill and three matrix products
(four kernel launches), each in one way: CUDA activity alone; CPU and CUDA
activity; a 0.5 s spin kernel first; 0.3 s of host sleep before the
launches and after the synchronisation; 256 launches of an empty spin
kernel first. Halfway through it takes 70 GB of device memory. For each
trace it prints one JSON line: seconds since start, the way, the work's
kernel records kept (of 4) and its launch records, and the least and
largest gap in microseconds from a launch record to its kernel's record.
chip_smoke.py's traced_kernels is built on what this shows.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

SPIN_CYCLES = 20_000_000


def read(prof, path: Path, t0: float, way: str, spins: int) -> None:
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "spin_kernel" not in e["name"]]
    runtime = {e["args"].get("correlation"): e for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver")}
    launches = [e for e in runtime.values() if "Launch" in e["name"]]
    gaps = [k["ts"] - runtime[k["args"]["correlation"]]["ts"] for k in kernels
            if k["args"].get("correlation") in runtime]
    print(json.dumps({"t": round(time.perf_counter() - t0, 1), "way": way,
                      "kernel_records": len(kernels), "launch_records": len(launches) - spins,
                      "gap_us_min": min(gaps) if gaps else None,
                      "gap_us_max": max(gaps) if gaps else None}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=300.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profiler_record_loss: no CUDA device is available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,driver_version",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    a = torch.randn(4096, 4096, device="cuda")

    def work():
        for _ in range(3):
            b = a @ a
        return b

    cuda = [ProfilerActivity.CUDA]
    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    path = Path(tempfile.mkdtemp()) / "trace.json"
    t0 = time.perf_counter()
    held = None
    while time.perf_counter() - t0 < args.seconds:
        for way, acts, spin, pad, spacers in (("cuda_only", cuda, False, 0.0, 0),
                                              ("cpu_and_cuda", both, False, 0.0, 0),
                                              ("spin_first", both, True, 0.0, 0),
                                              ("host_padded", both, False, 0.3, 0),
                                              ("spacers_first", both, False, 0.0, 256)):
            with profile(activities=acts) as prof:
                time.sleep(pad)
                if spin:
                    torch.cuda._sleep(50 * SPIN_CYCLES)
                for _ in range(spacers):
                    torch.cuda._sleep(1)
                torch.zeros(1, device="cuda")
                work()
                torch.cuda.synchronize()
                time.sleep(pad)
            read(prof, path, t0, way, int(spin) + spacers)
        t1 = time.perf_counter()
        while time.perf_counter() - t1 < 12:
            work()
        torch.cuda.synchronize()
        if held is None and time.perf_counter() - t0 > args.seconds / 2:
            held = torch.empty(int(70e9), dtype=torch.uint8, device="cuda")
            print("took 70 GB of device memory", flush=True)


if __name__ == "__main__":
    main()
