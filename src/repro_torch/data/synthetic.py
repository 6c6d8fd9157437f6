"""Synthetic task families — the stand-in for the paper's 12 datasets
(Table 6), kept in numpy so that both packages can be fed the same arrays.

Each family is a parameterized seq2seq transformation over a small token
alphabet; the family parameter plays the role of a dataset partition.

Sequence layout handed to the model:   [ BOS input .. SEP target .. ]
labels[t] = token the model should predict at position t (pre-shifted);
mask = 1 on the target region only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

PAD, SEP, BOS = 0, 1, 2
N_SPECIAL = 3


@dataclass(frozen=True)
class TaskSpec:
    family: str
    param: int            # partition parameter (e.g. shift amount)
    vocab: int            # data alphabet size (excl. specials)
    input_len: int = 8
    target_len: int = 8

    @property
    def task_id(self) -> str:
        return f"{self.family}:{self.param}"


def _apply_family(family: str, param: int, x: np.ndarray, vocab: int) -> np.ndarray:
    """x: (B, L) ints in [0, vocab). Returns the target sequence: y_i
    depends on x at a fixed relative offset plus a per-task vocabulary map."""
    L = x.shape[1]
    pos = np.arange(L)[None, :]
    if family == "copy":
        return (x + (param % 3)) % vocab
    if family == "shift":
        return (x + param + 3) % vocab
    if family == "negate":
        return (vocab - 1 - x + param) % vocab
    if family == "mul":
        return (x * (2 * param + 3)) % vocab
    if family == "affine":
        return (3 * x + 2 * param + 1) % vocab
    if family == "xor":
        assert vocab & (vocab - 1) == 0, "xor family needs power-of-2 vocab"
        return x ^ ((param + 1) % vocab)
    if family == "bitrev":
        nbits = int(np.log2(vocab))
        y = np.zeros_like(x)
        for b in range(nbits):
            y |= ((x >> b) & 1) << (nbits - 1 - b)
        return (y + param) % vocab
    if family == "parity_swap":
        return np.where(x % 2 == 0, x + param + 1, x - param - 1) % vocab
    if family == "add_pos":
        return (x + pos + param) % vocab
    if family == "alt_shift":
        return (x + np.where(pos % 2 == 0, param + 1, -(param + 1))) % vocab
    if family == "prev":
        y = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
        return (y + param) % vocab
    if family == "next":
        y = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
        return (y + param) % vocab
    raise ValueError(family)


FAMILIES: List[str] = [
    "copy", "shift", "negate", "mul", "affine", "xor",
    "bitrev", "parity_swap", "add_pos", "alt_shift", "prev", "next",
]


def make_tasks(
    vocab: int = 32, partitions: int = 10, input_len: int = 8, target_len: int = 8
) -> List[TaskSpec]:
    """The paper's 12 datasets x 10 partitions -> 120 tasks."""
    return [
        TaskSpec(f, p, vocab, input_len, target_len)
        for f in FAMILIES
        for p in range(partitions)
    ]


def sample_batch(spec: TaskSpec, rng: np.random.Generator, batch: int) -> Dict:
    """Returns {"tokens", "labels", "mask"} numpy arrays for the LPT loss."""
    off, vocab = N_SPECIAL, spec.vocab
    x = rng.integers(0, vocab, size=(batch, spec.input_len))
    y = _apply_family(spec.family, spec.param, x, vocab)[:, : spec.target_len]
    inp = np.concatenate(
        [
            np.full((batch, 1), BOS),
            x + off,
            np.full((batch, 1), SEP),
            y + off,
        ],
        axis=1,
    ).astype(np.int32)
    tokens = inp[:, :-1]
    labels = inp[:, 1:].copy()
    mask = np.zeros_like(labels, dtype=np.float32)
    tgt_start = 1 + spec.input_len  # position of SEP in tokens; predicts y0
    mask[:, tgt_start:] = 1.0
    return {"tokens": tokens, "labels": labels, "mask": mask}


def batch_to_torch(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """Moves a batch of numpy arrays (or tensors) to ``device``; integer
    arrays stay int32, as the reference's batches are."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
