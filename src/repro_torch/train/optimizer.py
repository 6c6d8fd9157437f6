"""Adam (with decoupled weight decay) and SGD on dicts of tensors, and the
cosine schedule: the port's copy of the reference's ``train/optimizer.py``.

Same interface: ``init(params) -> OptState``, ``update(grads, state,
params) -> (updates, state)``, updates *added* to the parameters by
``apply_updates``. Moments are f32 whatever the parameters' dtype, the bias
correction divides by ``1 - b ** step``, weight decay enters the update as
``- lr · wd · p``, and each update is cast to its parameter's dtype. Not
``torch.optim``: its Adam orders the same operations differently and
updates in place. Parameters are dicts of tensors (the prompt's
``soft_prompt`` and, for the prefix variant, ``reparam_w``/``reparam_v``);
the state's tensors live on the parameters' device, ``step`` included, so an
update reads nothing back to the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

Params = Dict[str, torch.Tensor]
LR = Union[float, Callable[[torch.Tensor], torch.Tensor]]


class OptState(NamedTuple):
    step: torch.Tensor             # () int32
    mu: Optional[Params]
    nu: Optional[Params]


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], OptState]
    update: Callable[[Params, OptState, Params], Tuple[Params, OptState]]


def _zeros_like_f32(params: Params) -> Params:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _step0(params: Params) -> torch.Tensor:
    dev = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=dev)


def adam(lr: LR, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda step: torch.tensor(lr, dtype=torch.float32,
                                                                device=step.device))

    def init(params: Params) -> OptState:
        return OptState(_step0(params), _zeros_like_f32(params), _zeros_like_f32(params))

    @torch.no_grad()
    def update(grads: Params, state: OptState, params: Params) -> Tuple[Params, OptState]:
        step = state.step + 1
        lr_t = lr_fn(step)
        mu = {k: b1 * m + (1 - b1) * grads[k].float() for k, m in state.mu.items()}
        nu = {k: b2 * v + (1 - b2) * grads[k].float().square() for k, v in state.nu.items()}
        sf = step.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=sf.device), sf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=sf.device), sf)
        updates = {}
        for k, p in params.items():
            u = -lr_t * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
            if weight_decay:
                u = u - lr_t * weight_decay * p.float()
            updates[k] = u.to(p.dtype)
        return updates, OptState(step, mu, nu)

    return Optimizer(init, update)


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params: Params) -> OptState:
        return OptState(_step0(params), _zeros_like_f32(params), None)

    @torch.no_grad()
    def update(grads: Params, state: OptState, params: Params) -> Tuple[Params, OptState]:
        step = state.step + 1
        if momentum:
            mu = {k: momentum * m + grads[k].float() for k, m in state.mu.items()}
        else:
            mu = {k: g.float() for k, g in grads.items()}
        updates = {k: (-lr * mu[k]).to(p.dtype) for k, p in params.items()}
        return updates, OptState(step, mu if momentum else state.mu, None)

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> Params:
    """New parameters ``p + u``, leaves that require grad as ``p`` did."""
    return {k: (p + updates[k]).requires_grad_(p.requires_grad) for k, p in params.items()}


def cosine_schedule(base_lr: float, warmup: int, total: int
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)

    return fn


def make_optimizer(name: str, lr: LR, weight_decay: float = 0.0) -> Optimizer:
    if name == "adam":
        return adam(lr, weight_decay=weight_decay)
    if name == "adamw":
        return adam(lr, weight_decay=weight_decay or 0.01)
    if name == "sgd":
        return sgd(lr if not callable(lr) else 0.1)
    raise ValueError(name)
