"""Assemble a Prompt Bank from task prompts, bind Eqn-1 scoring to a task,
and the initial-prompt selection strategies the paper compares (§6.1, Fig 9).

Counterparts of the reference's ``core/bank_builder.py``.
``build_bank_from_pretrain`` takes a ``PretrainResult`` (the port's
``train.pretrain``) as the reference's does; it is ``build_bank`` on the
result's model and task prompts (the same numpy jitter, one batched feature
extraction, the same cluster count), which also takes any model and
prompts. ``select_induction`` takes the task prompts, ``measure_ita`` the
model, and ``select_manual`` the prompt's shape.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.config import TuneConfig
from repro_torch.core.prompt_bank import PromptBank, PromptEntry
from repro_torch.data import LoaderConfig, TaskLoader, TaskSpec, batch_to_torch
from repro_torch.models.convert import prompt_from_arrays
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


def build_bank_from_pretrain(pre, **kwargs) -> PromptBank:
    """The Prompt Bank of a pretraining run: ``build_bank(pre.model,
    pre.task_prompts, **kwargs)``, candidates the run's per-task prompts and
    their jittered variants, features the pretrained model's activations."""
    return build_bank(pre.model, pre.task_prompts, **kwargs)


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


def select_score(bank: PromptBank, score_ctx: ScoreContext):
    """The Prompt Bank two-layer lookup (the reference's alias of
    ``bank.lookup``)."""
    return bank.lookup(score_ctx)


def select_manual(d_model: int, prompt_len: int, seed: int = 0) -> np.ndarray:
    """Manual initialization: a generic, uninformed prompt."""
    rng = np.random.default_rng(seed)
    return rng.normal(0, 0.5 / np.sqrt(d_model), (prompt_len, d_model)).astype(np.float32)


def select_ideal(bank: PromptBank, score_ctx: ScoreContext,
                 measure_ita: Callable[[np.ndarray], int], shortlist: int = 20
                 ) -> Tuple[Optional[PromptEntry], float]:
    """The paper's Ideal baseline: shortlist ``shortlist`` prompts by Eqn-1
    score, then pick the one with the best measured ITA (infeasible online).
    ``measure_ita(prompt) -> iterations``."""
    scored = [(score_ctx(e), e) for e in bank.entries if e.origin != "<evicted>"]
    scored.sort(key=lambda t: t[0])
    best_entry, best_ita = None, float("inf")
    for _, e in scored[:shortlist]:
        ita = measure_ita(e.prompt)
        if ita < best_ita:
            best_ita, best_entry = ita, e
    return best_entry, best_ita


def select_induction(task_prompts: Mapping[str, np.ndarray], task: TaskSpec, *,
                     capability: float = 0.5, seed: int = 0) -> np.ndarray:
    """Induction initialization [88], the testbed's analog: an imperfect
    recall of the family's optimized prompts whose fidelity grows with the
    model's ``capability``. ``task_prompts`` {task_id: (P, d)} stands for
    the reference's ``pre.task_prompts``."""
    rng = np.random.default_rng(seed)
    related = [np.asarray(p) for tid, p in task_prompts.items()
               if tid.split(":")[0] == task.family]
    base = np.mean(related, axis=0) if related else np.asarray(next(iter(task_prompts.values())))
    noise_scale = (1.0 - capability) * 2.0 * (np.abs(base).mean() + 1e-6)
    return (base * capability + rng.normal(0, noise_scale, base.shape)).astype(np.float32)


def measure_ita(model, task: TaskSpec, prompt: np.ndarray, tune_cfg: TuneConfig, *,
                target_loss: float, max_iters: int = 400,
                loader: Optional[TaskLoader] = None) -> Tuple[int, bool]:
    """Iterations-To-Accuracy: a real tuning run of ``model`` from ``prompt``
    until the eval loss reaches ``target_loss``. Returns (iterations,
    reached). ``loader`` defaults to the task's own; pass one to feed the
    reference's batches (the two packages seed their loaders differently)."""
    loader = loader or TaskLoader(task, LoaderConfig(batch_size=tune_cfg.batch_size))
    res = PromptTuner(model, tune_cfg).tune(
        loader, prompt_from_arrays({"soft_prompt": prompt}, model.device),
        target_loss=target_loss, max_iters=max_iters)
    return res["iters"], res["reached"]
