"""Mixture-of-experts feed-forward: top-k routing with a capacity and a
dense dispatch, the counterpart of the reference's ``models/moe.py``
(``moe_params``, ``capacity``, ``route``, ``_moe_ffn_dense``).

Each token picks its ``top_k`` experts from a softmax over an f32 router.
Its (token, k) pairs take slots in their experts' queues in token-major,
then k order (the order of the reference's cumsum over the flattened ids);
a pair past its expert's capacity is dropped, with weight 0. The experts
run as batched products over their (E, capacity, d) buffers, the same
einsums the reference leaves to XLA, and the shared experts (DeepSeek-style)
are one dense FFN of width ``num_shared * d_ff_expert`` applied to every
token. The reference's expert-parallel ``shard_map`` path
(``moe.py:155-240``) comes with the distribution slice.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig, MoEConfig
from repro_torch.models.common import FFN


class MoE(nn.Module):
    """Parameters of one MoE layer (the reference's moe_params): the router
    (d, E) in f32, expert stacks ``w_gate``/``w_up`` (E, d, dff) and
    ``w_down`` (E, dff, d), and the shared experts' FFN."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device, dtype: torch.dtype):
        super().__init__()
        m, d = cfg.moe, cfg.d_model
        E, dff = m.num_experts, m.d_ff_expert
        kw = dict(device=device, dtype=dtype)
        self.router = nn.Parameter(torch.empty(d, E, device=device, dtype=torch.float32))
        self.w_gate = nn.Parameter(torch.empty(E, d, dff, **kw))
        self.w_up = nn.Parameter(torch.empty(E, d, dff, **kw))
        self.w_down = nn.Parameter(torch.empty(E, dff, d, **kw))
        if m.num_shared_experts > 0:
            self.shared = FFN(cfg, device=device, dtype=dtype, d_ff=m.num_shared_experts * dff)
        else:
            self.shared = None


def capacity(m: MoEConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` tokens: ceil(tokens·k / E · factor),
    rounded up to a multiple of 8, at least 8. The rounding decides which
    pairs drop, so it is the reference's, not a padding choice."""
    cap = int(math.ceil(tokens * m.top_k / m.num_experts * m.capacity_factor))
    return max(8, -(-cap // 8) * 8)


def route(m: MoEConfig, router_w: torch.Tensor, x_flat: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(top-k weights (T, k) f32 renormalised to sum 1, expert ids (T, k)
    int32 in descending probability, Switch load-balancing aux loss)."""
    logits = x_flat.float() @ router_w.float()                      # (T, E)
    probs = torch.softmax(logits, dim=-1)
    topk_p, topk_ids = torch.topk(probs, m.top_k, dim=-1)
    topk_w = topk_p / topk_p.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    E = logits.shape[-1]
    me = probs.mean(dim=0)                                          # mean probability per expert
    ce = torch.zeros(E, dtype=torch.float32, device=x_flat.device).index_add_(
        0, topk_ids.reshape(-1), torch.ones(topk_ids.numel(), device=x_flat.device))
    ce = ce / ce.sum().clamp_min(1.0)
    aux = E * (me * ce).sum() * m.router_aux_loss_weight
    return topk_w, topk_ids.to(torch.int32), aux


def assign_slots(topk_ids: torch.Tensor, num_experts: int, cap: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each (token, k) pair's slot ``expert·cap + position in its queue``,
    positions counted in token-major then k order, and whether it is within
    capacity; a pair past capacity gets the drop slot ``E·cap``."""
    flat = topk_ids.reshape(-1).long()
    onehot = F.one_hot(flat, num_experts)                           # (T·k, E)
    pos = (onehot.cumsum(dim=0) * onehot).sum(dim=-1) - 1
    in_cap = pos < cap
    slot = torch.where(in_cap, flat * cap + pos, torch.full_like(flat, num_experts * cap))
    return slot, in_cap


def moe_ffn(cfg: ModelConfig, p: MoE, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux loss): the reference's dense
    dispatch. Every expert's weights are read once a call, whatever the
    token count, so a decode step at small batch reads all E experts."""
    m = cfg.moe
    B, S, D = x.shape
    T, E = B * S, m.num_experts
    cap = capacity(m, T)
    xf = x.reshape(T, D)
    topk_w, topk_ids, aux = route(m, p.router, xf)
    slot, in_cap = assign_slots(topk_ids, E, cap)
    buf = torch.zeros((E * cap + 1, D), dtype=x.dtype, device=x.device)
    buf[slot] = xf.repeat_interleave(m.top_k, dim=0)       # the drop row takes the dropped pairs
    buf = buf[:E * cap].reshape(E, cap, D)
    gate = F.silu(torch.bmm(buf, p.w_gate))
    up = torch.bmm(buf, p.w_up)
    out = torch.bmm(gate * up, p.w_down).reshape(E * cap, D)
    gathered = out[slot.clamp_max(E * cap - 1)]
    w = (topk_w.reshape(-1) * in_cap.float()).to(x.dtype)
    y = (gathered * w[:, None]).reshape(T, m.top_k, D).sum(dim=1)
    if p.shared is not None:
        y = y + p.shared(xf)
    return y.reshape(B, S, D), aux
