"""Fused prompt-score cross-entropy: the Prompt Bank hot spot on the H100.

Per-token NLL ``(T,)`` f32 of ``softmax(hidden @ emb.T)`` at ``labels``,
without materialising the ``(T, V)`` logits. Counterpart of the TPU kernel
``repro/kernels/score_ce.py:score_ce``; the CUDA source and the note on its
design and bounds are in ``csrc/score_ce.cu``.

``score_ce`` launches the kernel for CUDA tensors and uses
``score_ce_plain`` only for CPU tensors. ``score_ce.launches`` counts the
kernel's launches (the main kernel and its combine pass count as one).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

ROWS, COLS = 64, 64          # token rows and vocabulary columns of one block step
BLOCKS_PER_SM = 4            # vocabulary splits are added until the card holds this many blocks


def score_ce_plain(hidden: torch.Tensor, emb: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
    """Full-logits log-softmax gather in f32: the same function written out."""
    logits = hidden.float() @ emb.float().T
    gold = logits.gather(-1, labels.long()[:, None])[:, 0]
    return torch.logsumexp(logits, dim=-1) - gold


def _lib() -> ctypes.CDLL:
    lib = _build.load("score_ce")
    fn = lib.score_ce_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def num_splits(n_tok: int, vocab: int, device: torch.device) -> int:
    """Vocabulary splits per token tile: enough blocks to fill the card,
    never more than there are vocabulary tiles."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    row_tiles = -(-n_tok // ROWS)
    return max(1, min(-(-vocab // COLS), -(-BLOCKS_PER_SM * sms // row_tiles)))


def score_ce(hidden: torch.Tensor, emb: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    """hidden (T, D) and emb (V, D) in f32 or bf16, labels (T,) int32 ->
    nll (T,) f32."""
    if _build.device_kind(hidden, emb, labels) == "cpu":
        return score_ce_plain(hidden, emb, labels)
    if hidden.dim() != 2 or emb.dim() != 2 or labels.shape != hidden.shape[:1]:
        raise ValueError("score_ce: expects hidden (T, D), emb (V, D), labels (T,), "
                         f"got {tuple(hidden.shape)}, {tuple(emb.shape)}, "
                         f"{tuple(labels.shape)}")
    T, D = hidden.shape
    V = emb.shape[0]
    if emb.shape[1] != D:
        raise ValueError(f"score_ce: hidden has D={D}, emb has {emb.shape[1]}")
    if hidden.dtype not in (torch.float32, torch.bfloat16) or emb.dtype != hidden.dtype:
        raise ValueError("score_ce: hidden and emb must both be float32 or both "
                         f"bfloat16, got {hidden.dtype} and {emb.dtype}")
    if labels.dtype != torch.int32:
        raise ValueError(f"score_ce: labels must be int32, got {labels.dtype}")
    if D % 8:
        raise ValueError(f"score_ce: D={D} must be a multiple of 8")
    if T == 0 or V == 0:
        raise ValueError("score_ce: empty input")
    for t in (hidden, emb, labels):
        if not t.is_contiguous():
            raise ValueError("score_ce: inputs must be contiguous")
    _build.check_launchable("score_ce", hidden, emb, labels)

    n_split = num_splits(T, V, hidden.device)
    part = torch.empty((3, n_split, T), dtype=torch.float32, device=hidden.device)
    nll = torch.empty((T,), dtype=torch.float32, device=hidden.device)
    rc = _lib().score_ce_launch(
        hidden.data_ptr(), emb.data_ptr(), labels.data_ptr(), part.data_ptr(),
        nll.data_ptr(), T, D, V, n_split, int(hidden.dtype == torch.bfloat16),
        _build.stream_ptr(hidden.device))
    if rc:
        raise RuntimeError(f"score_ce: kernel launch failed with CUDA error {rc}")
    score_ce.launches += 1
    return nll


score_ce.launches = 0
