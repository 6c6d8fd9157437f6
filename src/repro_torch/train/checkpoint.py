"""Checkpoints as ``.npz``: the port's copy of the reference's
``train/checkpoint.py``, in numpy and torch.

A tree (nested dicts of tensors or arrays) is flattened to ``/``-joined
keys (``params/blocks/attn/wq``), written with ``np.savez_compressed``
beside a ``.json`` manifest (step, metadata, the sorted keys), so each
package reads the other's files. numpy has no bfloat16, so a bf16 tensor
is written widened to f32 (exactly); loading it back into a bf16 model
rounds nothing.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.convert import flatten_tree, load_jax_checkpoint


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, tree, step: int = 0, meta: Optional[Dict] = None) -> None:
    """Writes ``tree`` to ``path`` (.npz) and its manifest to ``path + '.json'``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {k: _to_numpy(v) for k, v in flatten_tree(tree).items()}
    np.savez_compressed(path, **flat)
    manifest = {"step": step, "meta": meta or {}, "keys": sorted(flat)}
    with open(path + ".json", "w") as f:
        json.dump(manifest, f, indent=1)


def load_checkpoint(path: str) -> Tuple[Dict, Dict]:
    """(tree, manifest): the nested tree of numpy arrays (``params_from_jax``
    turns a parameter tree into a ``state_dict``); the manifest is {} if it
    is missing."""
    tree = load_jax_checkpoint(path)
    manifest = {}
    mpath = _npz(path) + ".json"
    if os.path.exists(mpath):
        with open(mpath) as f:
            manifest = json.load(f)
    return tree, manifest


def checkpoint_exists(path: str) -> bool:
    return os.path.exists(_npz(path))
