"""Builds the CUDA sources under ``csrc/`` and loads them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
compiled by ``nvcc`` for Hopper (``sm_90a``). No PyTorch header is included,
so a source builds in seconds. Libraries go to ``build/repro_torch_kernels/``
at the repository root, named by a hash of the sources and the flags: an
edited source is rebuilt and a stale library is never loaded. A failed build
or load raises.

Launch helpers shared by the wrappers also live here: which device a call's
tensors are on, and the current CUDA stream as a pointer.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Names of the kernels that have a source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where ``name``'s library lives, keyed by its source, the shared
    headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compiles every named source that is not built yet: one ``nvcc`` per
    source, all started together. Returns {name: library path}; raises with
    the compiler's output if any build fails."""
    names = list(names) if names is not None else sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True),
                         tmp, so)
    failed = []
    for name, (proc, tmp, so) in running.items():
        out, _ = proc.communicate()
        so.with_suffix(".log").write_text(out)
        if proc.returncode:
            failed.append(f"--- nvcc {name} (exit {proc.returncode}) ---\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LIBS[name] = lib
    return lib


def device_kind(*tensors: torch.Tensor) -> str:
    """``"cpu"`` or ``"cuda"``: where all of a call's tensors lie. Mixed
    devices, or any other device, raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return "cuda"
    raise ValueError("kernel inputs must all lie on the CPU or all on one "
                     f"CUDA device, got {[str(t.device) for t in tensors]}")


def check_launchable(name: str, *tensors: torch.Tensor) -> None:
    """Conditions every CUDA launch needs: contiguous rows 16-byte aligned
    (the kernels load 16 bytes a thread) and no autograd graph. ``score_ce``,
    ``flash_attention`` and ``rwkv6_wkv`` take gradients through their
    ``torch.autograd.Function``s, which launch with grad disabled; the two
    decode kernels, ``flash_decode`` and ``mla_decode``, have no backward
    (the reference never differentiates a decode step) and refuse a call
    under autograd."""
    for t in tensors:
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last dim of every input must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                f"{name}: flash_decode and mla_decode are forward-only (a decode step is "
                f"never differentiated, so they have no backward kernel); run them under "
                f"torch.no_grad()")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
