"""Host-side data pipeline: deterministic batching per task.

The reference seeds each task's stream with ``hash(task_id)``, which Python
salts per process. This copy seeds with ``zlib.crc32(task_id)`` instead, so
a run draws the same batches every time. The two packages therefore draw
different batches for the same task; tests that compare them build the
batches once and hand the same arrays to both.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from repro_torch.data.synthetic import TaskSpec, sample_batch


def _task_seed(task_id: str) -> int:
    return zlib.crc32(task_id.encode()) & 0x7FFFFFFF


@dataclass
class LoaderConfig:
    batch_size: int = 8
    seed: int = 0


class TaskLoader:
    """Infinite iterator of batches for one LPT task."""

    def __init__(self, spec: TaskSpec, cfg: LoaderConfig):
        self.spec = spec
        self.cfg = cfg
        self._rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, _task_seed(spec.task_id)]))

    def __iter__(self) -> Iterator[Dict]:
        return self

    def __next__(self) -> Dict:
        return sample_batch(self.spec, self._rng, self.cfg.batch_size)

    def eval_batch(self, n: int, seed: int = 1234) -> Dict:
        """Fixed evaluation set (the Eqn-1 D_eval, e.g. 16 samples)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, _task_seed(self.spec.task_id)]))
        return sample_batch(self.spec, rng, n)
