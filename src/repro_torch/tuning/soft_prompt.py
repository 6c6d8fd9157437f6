"""Soft prompt tuning [Lester et al. '21] and its prefix-style variant [Li &
Liang '21]: the LPT algorithms the paper schedules, and Eqn 1's prompt score
and the Prompt Bank's activation features.

The tunable object is a continuous prompt ``(P, d_model)`` prepended to the
embedded input; the model stays frozen (``Model`` sets ``requires_grad``
False on every weight), so gradients reach the prompt parameters alone.
Prompt parameters are f32 tensors on the model's device; ``embed_inputs``
casts the prompt to the model's dtype, as the reference does. The loss goes
through ``lpt_loss``, whose kernels (``score_ce``, ``flash_attention``)
differentiate through their backward kernels on the card; the reference
lets XLA differentiate it.

Unlike the reference, nothing here takes ``params``: the model holds its
weights. Random initial prompts take a ``torch.Generator``, which draws
other numbers than ``jax.random``; to compare the two packages, hand the
reference's prompt arrays in.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig, TuneConfig
from repro_torch.data import batch_to_torch
from repro_torch.train.objectives import lpt_loss
from repro_torch.train.optimizer import OptState, apply_updates, make_optimizer

PROBE_SEED = 20240517

Prompt = Dict[str, torch.Tensor]


def _leaf(x: torch.Tensor) -> torch.Tensor:
    """A prompt parameter: f32, a leaf that requires grad."""
    return x.detach().float().requires_grad_(True)


def init_prompt_from_tokens(model, token_ids) -> Prompt:
    """The soft prompt initialised from token embeddings (the 'initial
    prompt' a user gives as text; Fig 1 step 1)."""
    ids = torch.as_tensor(np.asarray(token_ids), device=model.device).long()
    return {"soft_prompt": _leaf(model.embedding[ids])}


def init_prompt_random(model, prompt_len: int, generator: torch.Generator) -> Prompt:
    """N(0, (0.5/sqrt(d))²) entries drawn by ``generator``, on its device
    (the model's)."""
    d = model.cfg.d_model
    sp = torch.randn((prompt_len, d), generator=generator, device=generator.device,
                     dtype=torch.float32) * (0.5 / math.sqrt(d))
    return {"soft_prompt": _leaf(sp)}


class PromptTuner:
    def __init__(self, model, tune_cfg: TuneConfig):
        self.model = model
        self.tune_cfg = tune_cfg
        self.optimizer = make_optimizer(tune_cfg.optimizer, tune_cfg.lr, tune_cfg.weight_decay)

    def _materialize_prompt(self, prompt_params: Dict) -> torch.Tensor:
        """The soft prompt, through the prefix variant's small MLP when the
        prompt carries one."""
        dev = self.model.device
        sp = torch.as_tensor(prompt_params["soft_prompt"], device=dev)
        if self.tune_cfg.algorithm == "prefix" and "reparam_w" in prompt_params:
            w = torch.as_tensor(prompt_params["reparam_w"], device=dev)
            v = torch.as_tensor(prompt_params["reparam_v"], device=dev)
            sp = sp + torch.tanh(sp @ w) @ v
        return sp

    def init_prompt(self, generator: torch.Generator, token_ids=None) -> Prompt:
        """From ``token_ids`` when given, else random; the prefix variant
        adds its MLP, ``reparam_w`` (d, r) and ``reparam_v`` (r, d) at std
        0.02 with r = max(d // 4, 8), drawn after the prompt."""
        if token_ids is not None:
            pp = init_prompt_from_tokens(self.model, token_ids)
        else:
            pp = init_prompt_random(self.model, self.tune_cfg.prompt_len, generator)
        if self.tune_cfg.algorithm == "prefix":
            d = self.model.cfg.d_model
            r = max(d // 4, 8)
            kw = dict(generator=generator, device=generator.device, dtype=torch.float32)
            pp["reparam_w"] = _leaf(torch.randn((d, r), **kw) * 0.02)
            pp["reparam_v"] = _leaf(torch.randn((r, d), **kw) * 0.02)
        return pp

    def init_opt(self, prompt_params: Prompt) -> OptState:
        return self.optimizer.init(prompt_params)

    def loss_and_grad(self, prompt_params: Prompt, batch: Dict
                      ) -> Tuple[torch.Tensor, torch.Tensor, Prompt]:
        """(total loss with the MoE aux term, mean loss, gradient of the total
        for each prompt parameter): ``jax.value_and_grad`` of the
        reference's loss. ``batch`` holds tensors on the model's device."""
        params = list(prompt_params.values())
        tot, (loss, _) = lpt_loss(self.model, self._materialize_prompt(prompt_params), batch)
        grads = torch.autograd.grad(tot, params, allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(prompt_params.items(), grads)}
        return tot.detach(), loss.detach(), grads

    def step(self, prompt_params: Prompt, opt_state: OptState, batch: Dict
             ) -> Tuple[Prompt, OptState, torch.Tensor]:
        """One LPT step: the gradient of the loss for the prompt, then the
        optimizer's update. Returns (prompt, state, mean loss as a device
        scalar: reading it waits for the step)."""
        batch = batch_to_torch(batch, self.model.device)
        _, loss, grads = self.loss_and_grad(prompt_params, batch)
        updates, opt_state = self.optimizer.update(grads, opt_state, prompt_params)
        return apply_updates(prompt_params, updates), opt_state, loss

    @torch.no_grad()
    def score(self, prompt_params: Dict, eval_batch: Dict) -> float:
        """Eqn 1: mean loss on D_eval, no tuning. Smaller is better."""
        batch = batch_to_torch(eval_batch, self.model.device)
        _, (loss, _) = lpt_loss(self.model, self._materialize_prompt(prompt_params), batch)
        return float(loss)

    def evaluate(self, prompt_params: Dict, eval_batch: Dict) -> float:
        return self.score(prompt_params, eval_batch)

    def tune(self, loader, prompt_params: Prompt, *, target_loss: Optional[float] = None,
             max_iters: Optional[int] = None, eval_every: Optional[int] = None
             ) -> Dict[str, Any]:
        """LPT until the termination condition (Table 3): the eval-loss
        target or ``max_iters``. With a target, an initial prompt that
        already meets it ends the run at 0 iterations (ITA = 0, the point
        of prompt reuse). Returns {prompt, iters, reached, history}, history
        a list of (iteration, training loss, eval loss), the first entry (0,
        nan, eval) when there is a target. ``loader`` yields numpy batches
        and gives ``eval_batch(n)``."""
        cfg = self.tune_cfg
        max_iters = max_iters or cfg.max_iters
        eval_every = eval_every or cfg.eval_every
        eval_batch = batch_to_torch(loader.eval_batch(cfg.eval_samples), self.model.device)
        opt_state = self.init_opt(prompt_params)
        history = []
        reached = False
        it = 0
        if target_loss is not None:
            ev0 = self.score(prompt_params, eval_batch)
            history.append((0, float("nan"), ev0))
            if ev0 <= target_loss:
                return {"prompt": prompt_params, "iters": 0, "reached": True,
                        "history": history}
        for it in range(1, max_iters + 1):
            prompt_params, opt_state, loss = self.step(prompt_params, opt_state, next(loader))
            if it % eval_every == 0:
                ev = self.score(prompt_params, eval_batch)
                history.append((it, float(loss), ev))
                if target_loss is not None and ev <= target_loss:
                    reached = True
                    break
        return {"prompt": prompt_params, "iters": it, "reached": reached, "history": history}


def default_probes(cfg: ModelConfig, n_probe: int = 4, probe_len: int = 9) -> np.ndarray:
    """Fixed probe inputs shared by all feature extractions, with the
    reference's token range and shape. They come from a numpy RNG, so they
    differ from the reference's ``jax.random`` probes; to compare the two
    packages, pass the reference's probes in."""
    rng = np.random.default_rng(PROBE_SEED)
    lo, hi = 3, cfg.vocab_size // 2 + 3
    return rng.integers(lo, hi, size=(n_probe, probe_len)).astype(np.int32)


@torch.no_grad()
def activation_features(model, prompt, *, probes: Optional[np.ndarray] = None,
                        n_probe: int = 4, probe_len: int = 9) -> np.ndarray:
    """Prompt Bank clustering feature (§4.3.1 'activation features').

    The LLM runs on ``[prompt, probe tokens]`` for a handful of fixed probe
    inputs; the feature is the concatenated final-position hidden state per
    probe, L2-normalised. ``prompt`` is (P, d) or (B, P, d); returns (n·d,)
    or (B, n·d) as numpy f32. A model with a frontend gets the reference's
    all-zero frontend (B·n, F, embed_dim) f32."""
    dev = model.device
    prompt = torch.as_tensor(prompt, device=dev)
    if prompt.dim() == 2:
        prompt = prompt[None]
    B = prompt.shape[0]
    if probes is None:
        probes = default_probes(model.cfg, n_probe, probe_len)
    probes = torch.as_tensor(np.array(probes), device=dev)
    n, L = probes.shape
    tokens = probes[None].expand(B, n, L).reshape(B * n, L)
    frontend = None
    fc = model.cfg.frontend
    if fc.kind != "none":
        frontend = torch.zeros((B * n, fc.num_embeddings, fc.embed_dim), dtype=torch.float32,
                               device=dev)
    hidden = model.backbone(tokens, prompt=prompt.repeat_interleave(n, dim=0), frontend=frontend)
    feat = hidden[:, -1].float().reshape(B, -1)           # prediction state per probe
    feat = feat / (feat.norm(dim=-1, keepdim=True) + 1e-8)
    feat = feat.cpu().numpy()
    return feat[0] if B == 1 else feat
