"""Loss functions for LPT: masked next-token cross-entropy (Eqn 1's L)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops


def token_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                        mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (B, S, V) f32; labels (B, S) int; mask (B, S) {0, 1}.

    Returns (mean over masked tokens, per-example loss (B,))."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = (logz - gold) * mask
    per_ex = nll.sum(dim=-1) / mask.sum(dim=-1).clamp_min(1.0)
    return nll.sum() / mask.sum().clamp_min(1.0), per_ex


def lpt_loss(model, prompt: Optional[torch.Tensor], batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Loss of the model with a soft prompt prepended (the LPT objective).

    batch: {"tokens", "labels", "mask"}, each (B, S), on the model's device.
    The backbone runs on [prompt; tokens]; the token region's hidden states
    go through the fused ``score_ce`` against the output embedding, so the
    (B, S, V) logits are never formed. The (V, d) output embedding is the
    model's own, kept since its weights were set (an untied unembedding is
    not transposed per call). Returns (mean loss + the backbone's auxiliary
    loss, (mean loss, per-example (B,))), as the reference does: the MoE
    layers' router losses enter the first term only, and models without
    MoE layers add 0."""
    cfg = model.cfg
    if cfg.logit_soft_cap > 0:
        raise NotImplementedError(
            f"{cfg.name}: logit_soft_cap > 0 is not supported by score_ce")
    hidden, aux = model.backbone(batch["tokens"], prompt=prompt, return_aux=True)
    S = batch["tokens"].shape[1]
    loss, per_ex = ops.fused_score_ce(hidden[:, -S:], model.output_embedding(),
                                      batch["labels"], batch["mask"])
    return loss + aux["aux_loss"], (loss, per_ex)
