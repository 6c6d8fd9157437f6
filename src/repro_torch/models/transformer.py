"""The dense decoder: embedding, a stack of pre-norm blocks, final norm.

Counterpart of the reference's ``Model`` for ``arch_type="dense"``. The
reference stacks each layer's parameters on a leading axis and runs the
stack with ``jax.lax.scan``; here the stack is an ``nn.ModuleList`` and a
Python loop. Parameter names follow the reference tree (``blocks.<i>.attn.wq``
for ``blocks/attn/wq[i]``), so ``models.convert`` loads a JAX checkpoint with
no transposes.

Like the reference, ``gpt2-base`` uses RoPE, not GPT-2's learned position
table: the port follows the JAX package, not GPT-2.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch import DeviceLike, resolve_device, torch_dtype
from repro_torch.config import ModelConfig
from repro_torch.models.attention import GQAAttention, gqa_forward
from repro_torch.models.common import apply_ffn, apply_norm, embed_tokens, unembed


class Norm(nn.Module):
    """LayerNorm (gamma, beta) or RMSNorm (gamma); parameters always f32."""

    def __init__(self, cfg: ModelConfig, d: int, *, device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.gamma = nn.Parameter(torch.ones(d, device=device, dtype=torch.float32))
        if cfg.norm == "layernorm":
            self.beta = nn.Parameter(torch.zeros(d, device=device, dtype=torch.float32))
        else:
            self.register_parameter("beta", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(self.cfg, self.gamma, self.beta, x)


class FFN(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device: torch.device, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.w_up = nn.Parameter(torch.empty(cfg.d_model, cfg.d_ff, **kw))
        self.w_down = nn.Parameter(torch.empty(cfg.d_ff, cfg.d_model, **kw))
        if cfg.activation == "swiglu":
            self.w_gate = nn.Parameter(torch.empty(cfg.d_model, cfg.d_ff, **kw))
        else:
            self.register_parameter("w_gate", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_ffn(self.cfg, self.w_up, self.w_down, self.w_gate, x)


class DenseBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device: torch.device, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.ln1 = Norm(cfg, cfg.d_model, device=device)
        self.attn = GQAAttention(cfg, device=device, dtype=dtype)
        self.ln2 = Norm(cfg, cfg.d_model, device=device)
        self.ffn = FFN(cfg, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.parallel_block:
            h = self.ln1(x)
            return x + gqa_forward(cfg, self.attn, h, positions) + self.ffn(h)
        x = x + gqa_forward(cfg, self.attn, self.ln1(x), positions)
        return x + self.ffn(self.ln2(x))


class Model(nn.Module):
    """Dense GQA decoder on ``device`` (``cuda`` unless the caller passes
    ``device="cpu"``), its weights drawn from ``seed``."""

    def __init__(self, cfg: ModelConfig, *, device: DeviceLike = None, seed: int = 0):
        super().__init__()
        if cfg.arch_type != "dense" or cfg.attention != "gqa":
            raise NotImplementedError(
                f"{cfg.name}: arch_type={cfg.arch_type!r}, attention={cfg.attention!r} "
                "is not ported yet; the port runs dense GQA decoders, and the MLA/MoE, "
                "SSM, hybrid, encoder-decoder and VLM families come in later slices")
        if cfg.frontend.kind != "none":
            raise NotImplementedError(f"{cfg.name}: modality frontends come in a later slice")
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.dtype)
        pdt = torch_dtype(cfg.param_dtype)
        V, d = cfg.vocab_size, cfg.d_model
        self.embedding = nn.Parameter(torch.empty(V, d, device=dev, dtype=pdt))
        if cfg.tie_embeddings:
            self.register_parameter("unembed", None)
        else:
            self.unembed = nn.Parameter(torch.empty(d, V, device=dev, dtype=pdt))
        self.final_norm = Norm(cfg, d, device=dev)
        self.blocks = nn.ModuleList(
            DenseBlock(cfg, device=dev, dtype=pdt) for _ in range(cfg.num_layers))
        self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Random weights: norms 1 and 0, biases 0, embeddings N(0, 0.02²),
        every other matrix N(0, 1/fan_in) with fan_in the dims it contracts
        (d for wq/wk/wv, H·hd for wo). The reference takes the second-to-last
        dim, which for wq is H: its attention scores then have a std near 64
        and 12 such layers amplify rounding. Drawn on the CPU from ``seed``,
        so a seed gives the same weights on every device."""
        gen = torch.Generator().manual_seed(seed)
        for name, p in sorted(self.named_parameters()):
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "gamma":
                p.fill_(1.0)
            elif leaf in ("beta", "bq", "bk", "bv"):
                p.zero_()
            else:
                fan_in = p.shape[0] * (p.shape[1] if leaf == "wo" else 1)
                std = 0.02 if leaf in ("embedding", "unembed") else 1.0 / math.sqrt(fan_in)
                p.copy_(torch.randn(p.shape, generator=gen) * std)

    # -- forward ---------------------------------------------------------------

    def embed_inputs(self, tokens, prompt: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[soft prompt][token embeddings] -> (x (B, S_total, d), positions
        0..S_total-1). ``prompt`` is (P, d) shared or (B, P, d)."""
        tokens = torch.as_tensor(tokens, device=self.device)
        x = embed_tokens(self.embedding, tokens, self.dtype)
        B = x.shape[0]
        if prompt is not None:
            pe = torch.as_tensor(prompt, device=self.device).to(x.dtype)
            if pe.dim() == 2:
                pe = pe[None].expand(B, *pe.shape)
            x = torch.cat([pe, x], dim=1)
        positions = torch.arange(x.shape[1], device=self.device)[None].expand(B, -1)
        return x, positions

    def backbone(self, tokens, prompt: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Everything up to and including the final norm: hidden (B, S, d).
        (Dense blocks have no auxiliary loss, so none is returned.)"""
        x, positions = self.embed_inputs(tokens, prompt)
        for block in self.blocks:
            x = block(x, positions)
        return self.final_norm(x)

    def forward(self, tokens, prompt: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits (B, S_total, V) in f32."""
        return unembed(self.cfg, self.embedding, self.unembed, self.backbone(tokens, prompt))

