"""PyTorch / CUDA port of the PromptTuner system for NVIDIA Hopper (sm_90a).

This package sits beside ``repro`` (the JAX reference) and imports nothing of
it. The slice ported so far is the Prompt Bank's lookup path: the dense GQA
decoder's forward pass, Eqn 1's scoring, activation features and the bank.
Its two kernels, ``score_ce`` and ``flash_attention``, are CUDA C++ under
``kernels/csrc`` and are built for ``sm_90a`` at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for the CPU. Without a GPU, asking for ``cuda`` raises; there is no
    silent fall back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: no CUDA device is available; pass "
                "device='cpu' to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"repro_torch runs on cuda or cpu, not {dev}")
    return dev


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """Maps a config's dtype string to the torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; "
                         f"known: {sorted(_DTYPES)}") from None


__all__ = ["DeviceLike", "resolve_device", "torch_dtype"]
