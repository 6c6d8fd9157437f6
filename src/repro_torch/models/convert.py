"""Weights from the JAX package: its parameter tree and its ``.npz``
checkpoints, read with numpy alone; and a tuning run's state (prompt
parameters and the optimizer's ``OptState``), so that both packages can
start from one mid-run state.

The reference stacks each segment's per-layer parameters on a leading axis
(``blocks/attn/wq`` is (L, d, H, hd), ``moe/moe/w_gate`` (L, E, d, dff),
``mamba0/mixer/in_z`` (6, d, d_inner), an encoder-decoder's
``decoder/cross/wq`` and ``encoder/blocks/attn/wq``); a hybrid's
``shared_attn``, the encoder's ``final_norm`` and ``frontend_proj`` have
no layer axis. The port keeps one module per layer
(``blocks.<i>.attn.wq`` is (d, H, hd)). Conversion slices the layer axis
and transposes nothing: both packages use the same layouts.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, Optional

import numpy as np
import torch

if TYPE_CHECKING:   # imported where used: the train package imports this module's package
    from repro_torch.train.optimizer import OptState

STACKED = ("blocks", "dense0", "moe", "decoder")   # segments whose parameters carry a layer axis


def _stacked(seg: str) -> bool:
    """Whether a top-level name is a segment with a layer axis: those of
    ``STACKED`` and a hybrid's Mamba2 segments ``mamba0``, ``mamba1``, ...
    (its ``shared_attn`` has none)."""
    return seg in STACKED or (seg.startswith("mamba") and seg[5:].isdigit())


def _stack_names(parts) -> int:
    """How many leading names of a path name a stack with a layer axis: 1
    for a segment, 2 for an encoder-decoder's ``encoder/blocks``, 0 for a
    leaf with no layer axis."""
    if parts[:2] == ["encoder", "blocks"]:
        return 2
    return 1 if _stacked(parts[0]) else 0


def flatten_tree(tree, prefix: str = "") -> Dict[str, Any]:
    """A nested dict -> {"/"-joined path: leaf}, the checkpoints' keys."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}/{k}" if prefix else k))
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
    for path, arr in flatten_tree(tree).items():
        parts = path.split("/")
        n = _stack_names(parts)
        if n:
            arr = np.asarray(arr)
            for i in range(arr.shape[0]):
                state[".".join([*parts[:n], str(i), *parts[n:]])] = _to_tensor(arr[i])
        else:
            state[".".join(parts)] = _to_tensor(arr)
    return state


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict:
    """The inverse of ``params_from_jax``: a ``state_dict`` -> the
    reference's nested tree of numpy arrays, each segment's layers stacked
    on a leading axis in layer order (bf16 widened to f32, exactly)."""
    tree: Dict[str, Any] = {}
    layers: Dict[tuple, Dict[int, np.ndarray]] = {}
    for key, t in state.items():
        arr = t.detach().cpu()
        arr = (arr.float() if arr.dtype == torch.bfloat16 else arr).numpy()
        path = key.split(".")
        n = _stack_names(path)
        if n:
            layers.setdefault((*path[:n], *path[n + 1:]), {})[int(path[n])] = arr
            continue
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = arr
    for path, by_layer in layers.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.stack([by_layer[i] for i in range(len(by_layer))])
    return tree


def load_jax_checkpoint(path: str) -> Dict:
    """Reads a checkpoint written by either package's
    ``train/checkpoint.py`` (path-keyed arrays such as
    ``params/blocks/attn/wq``) into its nested numpy tree."""
    root: Dict[str, Any] = {}
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = root
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return root


def prompt_from_arrays(prompt_params: Dict, device) -> Dict[str, torch.Tensor]:
    """Prompt parameters from arrays: the reference's ({"soft_prompt": (P, d),
    and for the prefix variant "reparam_w"/"reparam_v"}) or any numpy
    arrays, as f32 leaves on ``device`` that require grad."""
    return {k: _to_tensor(v).float().to(device).requires_grad_(True)
            for k, v in prompt_params.items()}


def opt_state_from_jax(state, device) -> OptState:
    """The reference's ``OptState(step, mu, nu)`` (arrays, or None where SGD
    keeps no moment) as the port's, on ``device``."""
    def tree(t: Optional[Dict]) -> Optional[Dict[str, torch.Tensor]]:
        return None if t is None else {k: _to_tensor(v).float().to(device) for k, v in t.items()}

    from repro_torch.train.optimizer import OptState

    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32, device=device)
    return OptState(step, tree(state.mu), tree(state.nu))


def opt_state_to_numpy(state: OptState) -> Dict[str, Any]:
    """{"step": int, "mu": {name: array}, "nu": ...}: the port's state as
    numpy, to hold against the reference's."""
    def tree(t):
        return None if t is None else {k: v.detach().cpu().numpy() for k, v in t.items()}

    return {"step": int(state.step), "mu": tree(state.mu), "nu": tree(state.nu)}
