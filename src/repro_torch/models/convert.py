"""Weights from the JAX package: its parameter tree and its ``.npz``
checkpoints, read with numpy alone.

The reference stacks each segment's per-layer parameters on a leading axis
(``blocks/attn/wq`` is (L, d, H, hd)); the port keeps one module per layer
(``blocks.<i>.attn.wq`` is (d, H, hd)). Conversion slices the layer axis and
transposes nothing: both packages use the same layouts.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

STACKED = ("blocks",)          # segments whose parameters carry a layer axis


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    else:
        out[prefix] = tree
    return out


def _to_tensor(arr) -> torch.Tensor:
    arr = np.array(arr)                     # a writable copy
    if arr.dtype.name == "bfloat16":        # torch cannot take numpy's bf16: widen exactly
        arr = arr.astype(np.float32)
    return torch.from_numpy(arr)


def params_from_jax(tree: Dict) -> Dict[str, torch.Tensor]:
    """The reference's nested parameter tree (numpy or JAX arrays) -> a
    ``state_dict`` for ``Model.load_state_dict``, which copies each tensor
    onto the model's device and dtype."""
    state: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(tree).items():
        seg, *rest = path.split("/")
        if seg in STACKED:
            arr = np.asarray(arr)
            for i in range(arr.shape[0]):
                state[".".join([seg, str(i), *rest])] = _to_tensor(arr[i])
        else:
            state[".".join([seg, *rest])] = _to_tensor(arr)
    return state


def load_jax_checkpoint(path: str) -> Dict:
    """Reads a checkpoint written by the reference's ``train/checkpoint.py``
    (path-keyed arrays such as ``params/blocks/attn/wq``) into its nested
    numpy tree."""
    root: Dict[str, Any] = {}
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = root
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return root
