"""Loss functions for LPT: masked next-token cross-entropy (Eqn 1's L).

Both losses take the token region's hidden states through the fused
``score_ce`` (``kernels/ops.py``), whose backward kernel gives dL/dhidden
under autograd; the reference forms the logits and lets XLA differentiate
them."""
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


def _no_soft_cap(cfg) -> None:
    if cfg.logit_soft_cap > 0:
        raise NotImplementedError(
            f"{cfg.name}: logit_soft_cap > 0 is not supported by score_ce")


def chunked_token_cross_entropy(model, hidden: torch.Tensor, labels: torch.Tensor,
                                mask: torch.Tensor, *, chunk: int = 512
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's sequence-chunked CE: ``chunk`` positions at a time,
    each chunk through the fused ``score_ce`` against the model's output
    embedding (one launch a chunk, and one backward launch a chunk under
    autograd), so no chunk's (B, chunk, V) logits are formed either. The
    reference pads the sequence to a chunk multiple; the kernel masks its
    ragged edge, so the last chunk is just shorter.

    hidden (B, S, d); labels/mask (B, S). Returns (mean over masked tokens,
    per-example (B,)), summed per example then divided, as the reference."""
    _no_soft_cap(model.cfg)
    B, S, _ = hidden.shape
    chunk = max(1, min(chunk, S))
    emb = model.output_embedding()
    nll_sum = torch.zeros(B, dtype=torch.float32, device=hidden.device)
    tok_sum = torch.zeros(B, dtype=torch.float32, device=hidden.device)
    for s0 in range(0, S, chunk):
        sl = slice(s0, s0 + chunk)
        m = mask[:, sl].float()
        nll_sum = nll_sum + ops.fused_token_nll(hidden[:, sl], emb, labels[:, sl], m).sum(dim=-1)
        tok_sum = tok_sum + m.sum(dim=-1)
    per_ex = nll_sum / tok_sum.clamp_min(1.0)
    return nll_sum.sum() / tok_sum.sum().clamp_min(1.0), per_ex


def lpt_loss_chunked(model, prompt: Optional[torch.Tensor], batch: Dict[str, torch.Tensor], *,
                     chunk: int = 512
                     ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The production LPT loss: the backbone, then the chunked CE over the
    token region. Returns (mean + the backbone's auxiliary loss, (mean,
    per-example)), the reference's value up to summation order. An
    encoder-decoder's frontend comes in ``batch["frontend"]``."""
    hidden, aux = model.backbone(batch["tokens"], prompt=prompt, frontend=batch.get("frontend"),
                                 return_aux=True)
    S = batch["tokens"].shape[1]
    loss, per_ex = chunked_token_cross_entropy(model, hidden[:, -S:], batch["labels"],
                                               batch["mask"], chunk=chunk)
    return loss + aux["aux_loss"], (loss, per_ex)


def lpt_loss(model, prompt: Optional[torch.Tensor], batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Loss of the model with a soft prompt prepended (the LPT objective).

    batch: {"tokens", "labels", "mask"}, each (B, S), on the model's device,
    and for a model with a frontend "frontend" (B, F, embed_dim).
    The backbone runs on [prompt; tokens]; the token region's hidden states
    go through the fused ``score_ce`` against the output embedding, so the
    (B, S, V) logits are never formed. The (V, d) output embedding is the
    model's own, kept since its weights were set (an untied unembedding is
    not transposed per call). Returns (mean loss + the backbone's auxiliary
    loss, (mean loss, per-example (B,))), as the reference does: the MoE
    layers' router losses enter the first term only, and models without
    MoE layers add 0."""
    _no_soft_cap(model.cfg)
    hidden, aux = model.backbone(batch["tokens"], prompt=prompt, frontend=batch.get("frontend"),
                                 return_aux=True)
    S = batch["tokens"].shape[1]
    loss, per_ex = ops.fused_score_ce(hidden[:, -S:], model.output_embedding(),
                                      batch["labels"], batch["mask"])
    return loss + aux["aux_loss"], (loss, per_ex)
