"""Eqn 1's prompt score and the Prompt Bank's activation features.

The tunable object is a continuous prompt ``(P, d_model)`` prepended to the
embedded input; the model stays frozen. This slice ports the forward-only
serving path: ``PromptTuner.score`` (Eqn 1, no tuning) and
``activation_features``. Tuning itself (``step``, ``tune``) is training and
comes with the training slice.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig, TuneConfig
from repro_torch.data import batch_to_torch
from repro_torch.train.objectives import lpt_loss

PROBE_SEED = 20240517


class PromptTuner:
    def __init__(self, model, tune_cfg: TuneConfig):
        self.model = model
        self.tune_cfg = tune_cfg

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

    @torch.no_grad()
    def score(self, prompt_params: Dict, eval_batch: Dict) -> float:
        """Eqn 1: mean loss on D_eval, no tuning. Smaller is better."""
        batch = batch_to_torch(eval_batch, self.model.device)
        _, (loss, _) = lpt_loss(self.model, self._materialize_prompt(prompt_params), batch)
        return float(loss)


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
    or (B, n·d) as numpy f32."""
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
    hidden = model.backbone(tokens, prompt=prompt.repeat_interleave(n, dim=0))
    feat = hidden[:, -1].float().reshape(B, -1)           # prediction state per probe
    feat = feat / (feat.norm(dim=-1, keepdim=True) + 1e-8)
    feat = feat.cpu().numpy()
    return feat[0] if B == 1 else feat
