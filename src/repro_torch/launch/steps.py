"""Step functions of the entry points, the counterparts of the reference's
``launch/steps.py``:

  * ``train``   — one LPT optimizer step (gradients for the soft prompt
                  only; the model is frozen), with microbatched gradient
                  accumulation when the global batch does not fit;
  * ``prefill`` — batched Eqn-1 scoring: the backbone and the chunked CE,
                  per-example losses;
  * ``decode``  — the one-token serve step against a cache.

The reference's abstract inputs and shardings (``input_specs``,
``step_shardings``, ``build_step``) belong to the distribution slice.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.config import InputShape, ModelConfig, TuneConfig
from repro_torch.train.objectives import lpt_loss_chunked
from repro_torch.train.optimizer import OptState, adam, apply_updates

# Sub-quadratic long-context policy: dense full-attention archs run
# long_500k with a sliding-window cache variant.
LONG_CONTEXT_WINDOW = 8192
SUBQUADRATIC_NATIVE = {"ssm", "hybrid"}      # recurrent state: native O(1)


def model_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Per-shape config adaptations: a sliding window for long decode on
    full-attention GQA archs."""
    if (shape.name == "long_500k" and cfg.arch_type not in SUBQUADRATIC_NATIVE
            and cfg.attention == "gqa" and cfg.sliding_window == 0):
        return cfg.with_overrides(sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


def supports_shape(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """All archs support all four shapes: SSM / hybrid / MLA are natively
    sub-quadratic at 500k; dense GQA archs use the sliding-window variant."""
    return True, ""


def make_train_step(model, tune_cfg: TuneConfig, *, microbatches: int = 1,
                    ce_chunk: int = 512, batch_axes: Tuple[str, ...] = ()):
    """``train_step(prompt_params, opt_state, batch) -> (prompt_params,
    opt_state, loss)`` and the Adam it uses. Gradients of the total loss
    (MoE aux term included) for the prompt only. With ``microbatches`` m the
    batch is split into m equal parts along its first dim, run one after
    the other (each one's activations freed by its backward), and the step
    takes the mean of the m gradients and of the m mean losses, as the
    reference's scan does. The loss is the mean without the aux term, a
    device scalar.

    ``batch_axes`` names mesh axes the reference keeps each microbatch
    sharded over; on one card there is no mesh, so it has no meaning here
    and is accepted for the reference's signature."""
    opt = adam(tune_cfg.lr, weight_decay=tune_cfg.weight_decay)
    m = int(microbatches)

    def grad_fn(prompt_params: Dict, batch: Dict):
        params = list(prompt_params.values())
        tot, (loss, _) = lpt_loss_chunked(model, prompt_params["soft_prompt"], batch,
                                          chunk=ce_chunk)
        grads = torch.autograd.grad(tot, params, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g.float()
                               for p, g in zip(params, grads)]

    def train_step(prompt_params: Dict, opt_state: OptState, batch: Dict):
        batch = {k: torch.as_tensor(v, device=model.device) for k, v in batch.items()}
        if m == 1:
            loss, grads = grad_fn(prompt_params, batch)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % m:
                raise ValueError(f"make_train_step: batch {b} is not a multiple of "
                                 f"microbatches={m}")
            grads, loss = None, torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(m):
                mb = {k: v[i * (b // m):(i + 1) * (b // m)] for k, v in batch.items()}
                l_i, g_i = grad_fn(prompt_params, mb)
                grads = g_i if grads is None else [a + g for a, g in zip(grads, g_i)]
                loss = loss + l_i
            grads = [g / m for g in grads]
            loss = loss / m
        updates, new_opt = opt.update(dict(zip(prompt_params, grads)), opt_state, prompt_params)
        return apply_updates(prompt_params, updates), new_opt, loss

    return train_step, opt


def make_prefill_step(model, *, ce_chunk: int = 512) -> Callable[[Dict, Dict], torch.Tensor]:
    """Batched Eqn-1 scoring: ``prefill_step(prompt_params, batch) -> (B,)``
    per-example losses."""

    @torch.no_grad()
    def prefill_step(prompt_params: Dict, batch: Dict) -> torch.Tensor:
        batch = {k: torch.as_tensor(v, device=model.device) for k, v in batch.items()}
        _, (_, per_ex) = lpt_loss_chunked(model, prompt_params["soft_prompt"], batch,
                                          chunk=ce_chunk)
        return per_ex

    return prefill_step


def make_serve_step(model) -> Callable[[Dict, torch.Tensor, int], Tuple[torch.Tensor, Dict]]:
    """One-token decode: ``serve_step(cache, tokens, cache_len) ->
    (next_token (B, 1) int32, cache)``, the next token by argmax. The
    cache is updated in place (see ``Model.decode_step``); an
    encoder-decoder's cross keys and values (``cache["cross_kv"]``) are
    carried from step to step unchanged."""

    def serve_step(cache: Dict, tokens, cache_len: int) -> Tuple[torch.Tensor, Dict]:
        logits, cache = model.decode_step(cache, tokens, cache_len)
        return logits.argmax(dim=-1).to(torch.int32), cache

    return serve_step
