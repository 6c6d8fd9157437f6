"""Multi-task pretraining of the testbed models: the port's copy of the
reference's ``train/pretrain.py``.

The model's weights and a per-task prompt table are trained jointly on a
mixture of synthetic task families, so that afterwards a prompt prefix
determines the task and the table's prompts seed the Prompt Bank
(``core.build_bank_from_pretrain``). As in the reference: Adam with
``cosine_schedule(2e-3, min(200, steps), steps)`` over {model weights,
prompt table}, the task of each step drawn by a numpy generator from
``seed``, the loss ``lpt_loss`` of the task's prompt, an artifact cached
under ``artifacts/`` and a warm start from the largest smaller-step
artifact of the same run.

Differences: the model holds its weights (``Model.train_weights`` lets the
gradient reach them, tied models only), so ``PretrainResult`` has no
``params``; weights and the initial table are drawn by torch generators,
and the task loaders seed differently (``data/pipeline.py``), so a run
takes other steps than the reference's (``make_pretrain_step`` is the step
itself, to hold against the reference on the same data). The loss goes
through ``score_ce``, whose backward gives the tied embedding's gradient
(the dE kernel on the card). Artifacts are written as the reference writes
them (its stacked parameter tree and ``prompt_table``) under the port's own
prefix, ``torch_pretrain_...``, so the port never rewrites the reference's
``pretrain_...`` files; ``load_pretrain`` reads either package's.
"""
from __future__ import annotations

import glob
import os
import re
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.config import ModelConfig
from repro_torch.configs import testbed_config
from repro_torch.data import LoaderConfig, TaskLoader, TaskSpec, batch_to_torch, make_tasks
from repro_torch.models import Model, params_from_jax, params_to_jax
from repro_torch.train.checkpoint import checkpoint_exists, load_checkpoint, save_checkpoint
from repro_torch.train.objectives import lpt_loss
from repro_torch.train.optimizer import OptState, Optimizer, adam, cosine_schedule

ARTIFACT_DIR = os.environ.get("REPRO_ARTIFACTS", "artifacts")
ARTIFACT_PREFIX = "torch_pretrain"

# deeper testbed models need longer to cross the prompt-conditioning phase
# transition (the reference's measurement: vicuna-7b converges ~16-24k steps)
DEFAULT_STEPS = {"gpt2-base": 8000, "gpt2-large": 8000, "vicuna-7b": 24000}


@dataclass
class PretrainResult:
    model: Model                          # frozen again, its weights the trained ones
    task_prompts: Dict[str, np.ndarray]   # task_id -> (P, d) optimized prompt
    tasks: List[TaskSpec]
    losses: List[float] = field(default_factory=list)   # each step's loss (none from a cache)


def artifact_path(llm: str, steps, partitions: int) -> str:
    """The port's artifact of a run (``steps`` may be a glob pattern)."""
    return os.path.join(ARTIFACT_DIR, f"{ARTIFACT_PREFIX}_{llm}_s{steps}_p{partitions}.npz")


def load_pretrain(path: str, cfg: ModelConfig, tasks: List[TaskSpec],
                  device: DeviceLike = None) -> PretrainResult:
    """A pretraining artifact of either package (``params`` in the
    reference's tree, ``prompt_table`` (tasks, P, d)) as a PretrainResult
    with ``cfg``'s model on ``device``."""
    tree, _ = load_checkpoint(path)
    model = Model(cfg, device=device, seed=None)
    model.load_state_dict(params_from_jax(tree["params"]))
    table = np.asarray(tree["prompt_table"], np.float32)
    return PretrainResult(model, {t.task_id: table[i] for i, t in enumerate(tasks)}, tasks)


def make_pretrain_step(model: Model, steps: int
                       ) -> Tuple[Callable, Optimizer]:
    """(step, optimizer) of joint pretraining over ``steps`` steps: Adam on
    {"params/<name>": each weight, "prompts": the table} with the
    reference's cosine schedule. ``step(table, opt_state, task_idx, batch)
    -> (table, opt_state, total loss)`` takes the gradient of
    ``lpt_loss(model, table[task_idx], batch)`` for every weight and the
    table, writes the updated weights into ``model`` in place and returns
    the updated table (an f32 leaf that requires grad). The model must be
    training its weights (``model.train_weights()``); ``batch`` holds
    tensors on its device."""
    opt = adam(cosine_schedule(2e-3, min(200, steps), steps))
    params = {f"params/{n}": p for n, p in model.named_parameters()}

    def step(table: torch.Tensor, opt_state: OptState, task_idx: int, batch: Dict
             ) -> Tuple[torch.Tensor, OptState, torch.Tensor]:
        trainable = {**params, "prompts": table}
        tot, _ = lpt_loss(model, table[task_idx], batch)
        grads = torch.autograd.grad(tot, list(trainable.values()))
        updates, opt_state = opt.update(dict(zip(trainable, grads)), opt_state, trainable)
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(p + updates[name])
            new_table = (table + updates["prompts"]).requires_grad_(True)
        return new_table, opt_state, tot.detach()

    return step, opt


def _warm_start(llm: str, steps: int, partitions: int) -> Tuple[Optional[str], int]:
    """The port's artifact of this run with the most steps below ``steps``."""
    best, best_steps = None, 0
    for f in glob.glob(artifact_path(llm, "*", partitions)):
        m = re.search(r"_s(\d+)_p", os.path.basename(f))
        if m and best_steps < int(m.group(1)) < steps:
            best, best_steps = f, int(m.group(1))
    return best, best_steps


def pretrain(llm: str = "gpt2-base", *, steps: int = 0, prompt_len: int = 8,
             batch_size: int = 32, partitions: int = 4, seed: int = 0, cache: bool = True,
             verbose: bool = False, device: DeviceLike = None,
             cfg: Optional[ModelConfig] = None) -> PretrainResult:
    """Joint pretraining of ``testbed_config(llm)`` (or ``cfg``, a tied
    model) on ``make_tasks(vocab=32, partitions)``, on ``device`` (``cuda``
    unless the caller passes ``device="cpu"``). With ``cache`` the artifact
    of this run is loaded if it exists, else the run warm-starts from the
    largest smaller-step one and writes its own."""
    steps = steps or DEFAULT_STEPS.get(llm, 8000)
    cfg = cfg or testbed_config(llm)
    dev = resolve_device(device)
    tasks = make_tasks(vocab=32, partitions=partitions)
    path = artifact_path(llm, steps, partitions)
    if cache and checkpoint_exists(path):
        return load_pretrain(path, cfg, tasks, dev)

    prev_path, prev_steps = _warm_start(llm, steps, partitions) if cache else (None, 0)
    if prev_path is not None:
        pre = load_pretrain(prev_path, cfg, tasks, dev)
        model = pre.model
        table = torch.from_numpy(np.stack([pre.task_prompts[t.task_id] for t in tasks])).to(dev)
        if verbose:
            print(f"[pretrain {llm}] warm start from s{prev_steps}")
    else:
        model = Model(cfg, device=dev, seed=seed)
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        d = cfg.d_model
        table = torch.randn((len(tasks), prompt_len, d), generator=gen, device=dev) \
            * (0.5 / np.sqrt(d))
    steps_to_run = steps - prev_steps
    model.train_weights()
    step, opt = make_pretrain_step(model, steps_to_run)
    table = table.float().requires_grad_(True)
    state = opt.init({**{f"params/{n}": p for n, p in model.named_parameters()},
                      "prompts": table})
    rng = np.random.default_rng(seed)
    loaders = [TaskLoader(t, LoaderConfig(batch_size=batch_size, seed=seed)) for t in tasks]
    t0 = time.time()
    losses = []                      # device scalars: read once at the end, not per step
    try:
        for it in range(steps_to_run):
            ti = int(rng.integers(len(tasks)))
            table, state, loss = step(table, state, ti, batch_to_torch(next(loaders[ti]), dev))
            losses.append(loss)
            if verbose and (it + 1) % 500 == 0:
                print(f"[pretrain {llm}] step {it + 1}/{steps_to_run} "
                      f"loss {float(loss):.3f} ({time.time() - t0:.0f}s)")
    finally:
        model.train_weights(False)
    table_np = table.detach().cpu().numpy()
    if cache:
        save_checkpoint(path, {"params": params_to_jax(model.state_dict()),
                               "prompt_table": table_np},
                        step=steps, meta={"llm": llm, "tasks": [t.task_id for t in tasks]})
    return PretrainResult(model, {t.task_id: table_np[i] for i, t in enumerate(tasks)}, tasks,
                          torch.stack(losses).tolist() if losses else [])
