"""Assemble a Prompt Bank from task prompts and bind Eqn-1 scoring to a task.

Counterparts of the reference's ``core/bank_builder.py``:
``build_bank`` is ``build_bank_from_pretrain`` with the model and the task
prompts passed in (the reference takes its JAX ``PretrainResult``), with the
same numpy jitter, one batched feature extraction and the same cluster count.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from repro_torch.config import TuneConfig
from repro_torch.core.prompt_bank import PromptBank, PromptEntry
from repro_torch.data import LoaderConfig, TaskLoader, TaskSpec, batch_to_torch
from repro_torch.tuning import PromptTuner, activation_features


def build_bank(
    model,
    task_prompts: Mapping[str, np.ndarray],
    *,
    variants_per_prompt: int = 8,
    noise_scales: Sequence[float] = (0.0, 0.05, 0.15, 0.3),
    num_clusters: int = 0,
    capacity: int = 3000,
    seed: int = 0,
    probes: Optional[np.ndarray] = None,
) -> PromptBank:
    """Candidates = each task's prompt plus jittered variants; features are
    the model's activations on all candidates in one batched forward."""
    rng = np.random.default_rng(seed)
    prompts: List[np.ndarray] = []
    origins: List[str] = []
    for task_id, prompt in task_prompts.items():
        prompt = np.asarray(prompt)
        for v in range(variants_per_prompt):
            scale = noise_scales[v % len(noise_scales)]
            noise = rng.normal(0, scale * (np.abs(prompt).mean() + 1e-6),
                               size=prompt.shape)
            prompts.append((prompt + noise).astype(np.float32))
            origins.append(f"{task_id}/v{v}")
    feats = np.atleast_2d(activation_features(model, np.stack(prompts), probes=probes))
    entries = [PromptEntry(prompt=p, feature=f, origin=o)
               for p, o, f in zip(prompts, origins, feats)]
    # cluster count ~ distinct task groups (the reference's choice; the
    # paper uses K=50 at C~3000)
    k = num_clusters or max(2, min(48, len(entries) // 4))
    bank = PromptBank(capacity=capacity, num_clusters=k, seed=seed)
    bank.add_candidates(entries)
    bank.build()
    return bank


@dataclass
class ScoreContext:
    """Binds Eqn-1 scoring to (model, task eval set); the eval set is moved
    to the model's device once."""
    tuner: PromptTuner
    eval_batch: Dict

    def __call__(self, entry: PromptEntry) -> float:
        return self.tuner.score({"soft_prompt": entry.prompt}, self.eval_batch)


def make_score_fn(model, task: TaskSpec, tune_cfg: TuneConfig,
                  loader: Optional[TaskLoader] = None) -> ScoreContext:
    loader = loader or TaskLoader(task, LoaderConfig(batch_size=tune_cfg.batch_size))
    eval_batch = batch_to_torch(loader.eval_batch(tune_cfg.eval_samples), model.device)
    return ScoreContext(PromptTuner(model, tune_cfg), eval_batch)


def select_manual(d_model: int, prompt_len: int, seed: int = 0) -> np.ndarray:
    """Manual initialization: a generic, uninformed prompt."""
    rng = np.random.default_rng(seed)
    return rng.normal(0, 0.5 / np.sqrt(d_model), (prompt_len, d_model)).astype(np.float32)
