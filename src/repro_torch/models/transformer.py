"""The decoder: embedding, segments of pre-norm blocks, final norm; its
full-sequence forward and its one-token decode step against a cache.

Counterpart of the reference's ``Model`` for the dense decoders
(``arch_type="dense"``), the SSM families (``arch_type="ssm"``: RWKV6 or
Mamba2), the MoE family (``arch_type="moe"``), with GQA or MLA attention,
the Zamba2 hybrid (``arch_type="hybrid"``) and the encoder-decoder
(``arch_type="audio"``). As in the reference's
``plan_segments``, a dense or SSM model is the one segment ``blocks``, a MoE
model the segments ``dense0`` (its first dense layers, FFN width
``d_ff_expert·(top_k + shared)``) and ``moe``, and a hybrid the Mamba2
segments ``mamba0``, ``mamba1``, ... of ``attn_every`` layers each, with one
shared attention + MLP block (``shared_attn``, one set of weights) applied
after every segment but the last. An encoder-decoder is the one segment
``decoder`` of blocks with cross attention, beside ``encoder`` (its own
stack of non-causal blocks and final norm, the reference's ``encoder``
subtree) and ``frontend_proj``, which projects the frontend's frame
embeddings to d_model. Not ported yet: the VLM family and the MoE
expert-parallel dispatch.

The reference stacks each segment's per-layer parameters on a leading axis
and runs the stack with ``jax.lax.scan``; here each segment is an
``nn.ModuleList`` of that name and a Python loop. Parameter names follow the
reference tree (``blocks.<i>.attn.wq`` for ``blocks/attn/wq[i]``,
``moe.<i>.moe.w_gate`` for ``moe/moe/w_gate[i]``, ``mamba0.<i>.mixer.in_z``
for ``mamba0/mixer/in_z[i]``, ``shared_attn.attn.wq`` unstacked), so
``models.convert`` loads a JAX checkpoint with no transposes. The decode
cache keeps the reference's tree, one tensor per leaf with the layer axis
first (``cache["blocks"]["kv"]["k"]`` is (layers, B, L, Hkv, hd),
``cache["moe"]["kv"]["c_kv"]`` (layers, B, L, r), ``cache["mamba0"]["state"]
["h"]`` (layers, B, H, state, 64)), and a hybrid's shared block one KV cache
per application, ``cache["shared_attn"]["app<i>"]["kv"]``, with no layer
axis; an encoder-decoder's cache also holds each decoder layer's cross keys
and values, ``cache["cross_kv"]["k"]`` (layers, B, Lenc, Hkv, hd), which
the decode step reads and never writes. The cache is updated in place.

Like the reference, ``gpt2-base`` uses RoPE, not GPT-2's learned position
table: the port follows the JAX package, not GPT-2.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch import DeviceLike, resolve_device, torch_dtype
from repro_torch.config import ModelConfig
from repro_torch.models.attention import (GQAAttention, MLAAttention, cross_attention,
                                          encode_cross_kv, gqa_decode, gqa_forward,
                                          gqa_init_cache, mla_decode, mla_forward,
                                          mla_init_cache)
from repro_torch.models.common import FFN, Norm, embed_tokens, unembed
from repro_torch.models.moe import MoE, moe_ffn
from repro_torch.models.ssm import (Mamba2Mixer, RWKV6TimeMix, mamba2_decode,
                                    mamba2_forward, mamba2_init_state, rwkv6_decode,
                                    rwkv6_forward, rwkv6_init_state)

# init kinds of the reference's ParamSpecs (models/common.py) for the leaves
# that are not drawn at 1/sqrt(fan_in)
SMALL = ("mu_x", "mu_rkvwg", "tm_w1", "tm_w2", "decay_w1", "decay_w2", "u",
         "router", "conv_w")                                        # std 0.02
ONES = ("gamma", "ln_out", "d_skip", "norm_g")
ZEROS = ("beta", "bq", "bk", "bv", "dt_bias", "conv_b")
DECAY = ("w0", "a_log")   # a linspace from -6 to -1 over each segment's stacked leaf
EXPERT_STACKS = ("w_gate", "w_up", "w_down")   # (E, in, out) under a MoE layer


@dataclass(frozen=True)
class Segment:
    kind: str          # dense | moe | rwkv | mamba | decoder_cross
    count: int
    name: str


def plan_segments(cfg: ModelConfig) -> List[Segment]:
    """The model's segments, as the reference's ``plan_segments`` names
    them; a family the port does not run raises."""
    L, at = cfg.num_layers, cfg.arch_type
    if at == "vlm" and cfg.attention == "gqa" and cfg.moe is None:
        return [Segment("dense", L, "blocks")]     # the frontend is prepended to the sequence
    if cfg.frontend.kind == "none":
        if cfg.attention in ("gqa", "mla"):
            if at == "dense":
                return [Segment("dense", L, "blocks")]
            if at == "moe" and cfg.moe is not None:
                fd = cfg.moe.first_dense_layers
                return ([Segment("dense", fd, "dense0")] if fd else []) + [
                    Segment("moe", L - fd, "moe")]
        if at == "ssm" and cfg.ssm is not None:
            return [Segment("rwkv" if cfg.ssm.kind == "rwkv6" else "mamba", L, "blocks")]
        if at == "hybrid" and cfg.ssm is not None and cfg.hybrid is not None:
            every = cfg.hybrid.attn_every
            return [Segment("mamba", min(every, L - i), f"mamba{g}")
                    for g, i in enumerate(range(0, L, every))]
    if at == "audio" and cfg.encdec is not None and cfg.attention == "gqa" and cfg.moe is None:
        return [Segment("decoder_cross", L, "decoder")]
    raise NotImplementedError(
        f"{cfg.name}: arch_type={cfg.arch_type!r}, attention={cfg.attention!r}, frontend="
        f"{cfg.frontend.kind!r} is not ported (the port runs dense and MoE decoders with GQA "
        "or MLA attention, the RWKV6 and Mamba2 families, the Zamba2 hybrid, the GQA "
        "encoder-decoder and the GQA VLM)")


def dense_ffn_width(cfg: ModelConfig) -> int:
    """FFN width of a dense block: ``d_ff``, or in a MoE model's first dense
    layers ``d_ff_expert·(top_k + num_shared_experts)``."""
    m = cfg.moe
    return cfg.d_ff if m is None else m.d_ff_expert * (m.top_k + m.num_shared_experts)


def make_attention(cfg: ModelConfig, device: torch.device, dtype: torch.dtype
                   ) -> Union[GQAAttention, MLAAttention]:
    cls = MLAAttention if cfg.attention == "mla" else GQAAttention
    return cls(cfg, device=device, dtype=dtype)


def attn_forward(cfg: ModelConfig, p: nn.Module, x: torch.Tensor,
                 positions: torch.Tensor, causal: bool = True) -> torch.Tensor:
    if cfg.attention == "mla":
        return mla_forward(cfg, p, x, positions, causal=causal)
    return gqa_forward(cfg, p, x, positions, causal=causal)


class DenseBlock(nn.Module):
    """A decoder block, or with ``causal`` False an encoder's (the
    reference's ``encoder`` block kind: the same block, attention over
    every position)."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device, dtype: torch.dtype,
                 causal: bool = True):
        super().__init__()
        self.cfg = cfg
        self.causal = causal
        self.ln1 = Norm(cfg, cfg.d_model, device=device)
        self.attn = make_attention(cfg, device, dtype)
        self.ln2 = Norm(cfg, cfg.d_model, device=device)
        self.ffn = FFN(cfg, device=device, dtype=dtype, d_ff=dense_ffn_width(cfg))

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.parallel_block:
            h = self.ln1(x)
            return x + attn_forward(cfg, self.attn, h, positions, self.causal) + self.ffn(h)
        x = x + attn_forward(cfg, self.attn, self.ln1(x), positions, self.causal)
        return x + self.ffn(self.ln2(x))


class Encoder(nn.Module):
    """An encoder-decoder's encoder (the reference's ``encoder`` subtree):
    ``num_encoder_layers`` non-causal blocks and a final norm."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device, dtype: torch.dtype):
        super().__init__()
        self.blocks = nn.ModuleList(DenseBlock(cfg, device=device, dtype=dtype, causal=False)
                                    for _ in range(cfg.encdec.num_encoder_layers))
        self.final_norm = Norm(cfg, cfg.d_model, device=device)


class DecoderCrossBlock(nn.Module):
    """A decoder block with cross attention: causal self-attention, then
    attention over the encoder's output, then the FFN, each pre-normed and
    residual. ``cross`` holds the cross attention's projections."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.ln1 = Norm(cfg, cfg.d_model, device=device)
        self.attn = GQAAttention(cfg, device=device, dtype=dtype)
        self.lnx = Norm(cfg, cfg.d_model, device=device)
        self.cross = GQAAttention(cfg, device=device, dtype=dtype)
        self.ln2 = Norm(cfg, cfg.d_model, device=device)
        self.ffn = FFN(cfg, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                enc_out: torch.Tensor) -> torch.Tensor:
        """The layer's cross keys and values come from ``enc_out`` (B, Lenc,
        d), as in the reference's scan body."""
        cfg = self.cfg
        x = x + gqa_forward(cfg, self.attn, self.ln1(x), positions)
        x = x + cross_attention(cfg, self.cross, self.lnx(x),
                                encode_cross_kv(cfg, self.cross, enc_out))
        return x + self.ffn(self.ln2(x))


class MoEBlock(nn.Module):
    """Attention, then the routed experts; ``forward`` also returns the
    layer's router aux loss."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.ln1 = Norm(cfg, cfg.d_model, device=device)
        self.attn = make_attention(cfg, device, dtype)
        self.ln2 = Norm(cfg, cfg.d_model, device=device)
        self.moe = MoE(cfg, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x + attn_forward(self.cfg, self.attn, self.ln1(x), positions)
        y, aux = moe_ffn(self.cfg, self.moe, self.ln2(x))
        return x + y, aux


class RWKVBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device: torch.device, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.ln1 = Norm(cfg, cfg.d_model, device=device)
        self.tmix = RWKV6TimeMix(cfg, device=device, dtype=dtype)
        self.ln2 = Norm(cfg, cfg.d_model, device=device)
        self.ffn = FFN(cfg, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        y, _ = rwkv6_forward(self.cfg, self.tmix, self.ln1(x))
        x = x + y
        return x + self.ffn(self.ln2(x))


class MambaBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device: torch.device, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.ln = Norm(cfg, cfg.d_model, device=device)
        self.mixer = Mamba2Mixer(cfg, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        return x + mamba2_forward(self.cfg, self.mixer, self.ln(x))[0]


class SharedAttention(nn.Module):
    """Zamba2's shared block (the reference's ``shared_attn``): causal GQA
    attention and an MLP of width ``d_ff``, each pre-normed and residual,
    one set of weights applied after every Mamba2 segment but the last."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.ln = Norm(cfg, cfg.d_model, device=device)
        self.attn = GQAAttention(cfg, device=device, dtype=dtype)
        self.ln2 = Norm(cfg, cfg.d_model, device=device)
        self.ffn = FFN(cfg, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        x = x + gqa_forward(self.cfg, self.attn, self.ln(x), positions)
        return x + self.ffn(self.ln2(x))

    def decode(self, x: torch.Tensor, cache: Dict, cache_len: int) -> torch.Tensor:
        """One-token step against this application's KV cache, written in place."""
        y, _ = gqa_decode(self.cfg, self.attn, self.ln(x), cache["kv"], cache_len)
        x = x + y
        return x + self.ffn(self.ln2(x))


BLOCKS = {"dense": DenseBlock, "moe": MoEBlock, "rwkv": RWKVBlock, "mamba": MambaBlock,
          "decoder_cross": DecoderCrossBlock}


def block_cache(cfg: ModelConfig, kind: str, batch: int, length: int,
                device: torch.device) -> Dict:
    """One layer's empty decode cache. A sliding-window GQA buffer holds
    ``min(length, window)`` slots; an MLA latent cache always ``length``."""
    if kind == "rwkv":
        return {"state": rwkv6_init_state(cfg, batch, device)}
    if kind == "mamba":
        return {"state": mamba2_init_state(cfg, batch, device)}
    dt = torch_dtype(cfg.dtype)
    if cfg.attention == "mla":
        return {"kv": mla_init_cache(cfg, batch, length, dt, device)}
    L = min(length, cfg.sliding_window) if cfg.sliding_window else length
    return {"kv": gqa_init_cache(cfg, batch, L, dt, device)}


def block_decode(cfg: ModelConfig, kind: str, block: nn.Module, x: torch.Tensor,
                 cache: Dict, cache_len: int,
                 enc_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """One-token step of one layer; writes the layer's ``cache`` in place.
    A ``decoder_cross`` layer also reads its cross keys and values
    ``enc_kv``, each (B, Lenc, Hkv, hd)."""
    if kind == "mamba":
        y, st = mamba2_decode(cfg, block.mixer, block.ln(x), cache["state"])
        for name, t in st.items():
            cache["state"][name].copy_(t)
        return x + y
    h = block.ln1(x)
    if kind == "rwkv":
        y, st = rwkv6_decode(cfg, block.tmix, h, cache["state"])
        for name, t in st.items():
            cache["state"][name].copy_(t)
        x = x + y
        return x + block.ffn(block.ln2(x))
    decode = mla_decode if cfg.attention == "mla" else gqa_decode
    y, _ = decode(cfg, block.attn, h, cache["kv"], cache_len)
    if kind == "dense" and cfg.parallel_block:
        return x + y + block.ffn(h)
    x = x + y
    if kind == "moe":
        return x + moe_ffn(cfg, block.moe, block.ln2(x))[0]
    if kind == "decoder_cross":
        x = x + cross_attention(cfg, block.cross, block.lnx(x), enc_kv)
    return x + block.ffn(block.ln2(x))


def _map(fn: Callable[[torch.Tensor], torch.Tensor], tree: Dict) -> Dict:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


class Model(nn.Module):
    """Dense or MoE decoder (GQA or MLA attention), RWKV6 or Mamba2 model,
    Zamba2 hybrid or encoder-decoder on ``device`` (``cuda`` unless the caller passes
    ``device="cpu"``), its weights drawn from ``seed``, or left
    uninitialised for a caller that loads them when ``seed`` is None. Each
    of ``segments`` is an ``nn.ModuleList`` attribute of its name
    (``blocks``, or ``dense0`` and ``moe``, or ``mamba0``, ``mamba1``, ...,
    or ``decoder``), a hybrid's shared block is the attribute
    ``shared_attn``, and an encoder-decoder's encoder ``encoder``. A model
    with a frontend has ``frontend_proj`` (embed_dim, d_model). The
    weights are frozen (``requires_grad`` False, also after
    ``load_state_dict``), as the reference's are under LPT: a forward keeps
    no autograd graph unless the prompt requires grad, and then the graph
    carries the prompt's gradient alone. Pretraining alone trains them,
    through ``train_weights``."""

    def __init__(self, cfg: ModelConfig, *, device: DeviceLike = None,
                 seed: Optional[int] = 0):
        super().__init__()
        self.segments = plan_segments(cfg)
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
        # the (V, d) output embedding score_ce reads: a copy of the untied
        # (d, V) unembedding, made when the weights are set, never per call;
        # ``unembed``'s version counter when the copy was made
        self.register_buffer("unembed_t", None, persistent=False)
        self._unembed_version = -1
        self.final_norm = Norm(cfg, d, device=dev)
        for seg in self.segments:
            setattr(self, seg.name, nn.ModuleList(
                BLOCKS[seg.kind](cfg, device=dev, dtype=pdt) for _ in range(seg.count)))
        if cfg.hybrid is not None and cfg.hybrid.shared_attn:
            self.shared_attn = SharedAttention(cfg, device=dev, dtype=pdt)
        if cfg.encdec is not None:
            self.encoder = Encoder(cfg, device=dev, dtype=pdt)
        if cfg.frontend.kind != "none":
            fe = cfg.frontend.embed_dim
            self.frontend_proj = nn.Parameter(torch.empty(fe, d, device=dev, dtype=pdt))
        else:
            self.register_parameter("frontend_proj", None)
        self._train_weights = False
        self.requires_grad_(False)          # frozen, as the reference's: gradients reach the prompt only
        if seed is not None:
            self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    def output_embedding(self) -> torch.Tensor:
        """The (V, d) output embedding: the tied embedding, or the transposed
        copy of the untied unembedding (V·d more elements resident, 1.09 GB
        for qwen2-7b in bf16). The copy is made by ``init_weights`` and
        ``load_state_dict``, so the untied ``unembed`` must change only
        through them: an in-place write to the Parameter since the copy was
        made raises here (a write through ``unembed.data`` goes unseen)."""
        if self.cfg.tie_embeddings:
            return self.embedding
        if self.unembed._version != self._unembed_version:
            raise RuntimeError("Model.unembed has no current (V, d) copy: it was never set, "
                               "or was written in place since; set the weights through "
                               "load_state_dict or init_weights")
        return self.unembed_t

    @torch.no_grad()
    def _refresh_output_embedding(self) -> None:
        if not self.cfg.tie_embeddings:
            self.unembed_t = self.unembed.detach().T.contiguous()
            self._unembed_version = self.unembed._version

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        result = super().load_state_dict(state_dict, strict=strict, assign=assign)
        self.requires_grad_(self._train_weights)   # ``assign`` may bring in tensors that require grad
        self._refresh_output_embedding()
        return result

    def train_weights(self, on: bool = True) -> "Model":
        """Pretraining's switch: every weight requires grad (``on``), or the
        model is frozen again, as it is on every other path. Only a tied
        model trains: an untied unembedding reaches ``score_ce`` through its
        (V, d) copy ``unembed_t``, which carries no gradient back to
        ``unembed``, so ``on`` raises for it (the reference pretrains only
        tied models: its testbed configs and gpt2-base). Returns the model."""
        if on and not self.cfg.tie_embeddings:
            raise NotImplementedError(
                f"{self.cfg.name}: full-weight training of an untied model is not supported: "
                "score_ce reads the untied unembedding through its (V, d) copy, which carries "
                "no gradient back (pretraining trains tied models only)")
        self._train_weights = bool(on)
        self.requires_grad_(self._train_weights)
        return self

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Random weights: norms and ``ln_out`` 1, LayerNorm betas and biases
        0, embeddings N(0, 0.02²), the reference's "small" leaves (RWKV6's
        token-shift mixes, its LoRAs and ``u``; the MoE router, kept f32;
        Mamba2's ``conv_w``) N(0, 0.02²), Mamba2's ``dt_bias`` and ``conv_b``
        0 and ``d_skip`` and ``norm_g`` 1, RWKV6's ``w0`` and Mamba2's
        ``a_log`` the reference's decay init (a linspace from -6 to -1 over
        the leaf of all of a segment's layers, in layer order), and every
        other matrix N(0, 1/fan_in) with fan_in the dims it contracts: d for
        wq/wk/wv/wr/wg, H·hd for wo, the first dim for the MLA projections,
        and for the (E, in, out) expert stacks ``in`` (d, or d_ff_expert for
        ``w_down``), not E. The reference takes the second-to-last dim, which
        for wq is H: its attention scores then have a std near 64 and 12
        such layers amplify rounding. An expert stack is drawn one expert at
        a time, so no (E, d, dff) f32 temporary is made. Drawn on the model's device by a generator of that device
        seeded with ``seed``: a seed gives the same weights on every run on
        one kind of device (to compare devices, copy the weights with
        ``load_state_dict``), and a 7B model is drawn on the card in seconds
        where the CPU would take minutes."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for name, p in sorted(self.named_parameters()):
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ONES:
                p.fill_(1.0)
            elif leaf in ZEROS:
                p.zero_()
            elif leaf in DECAY:
                continue
            elif leaf in EXPERT_STACKS and p.dim() == 3:
                for e in range(p.shape[0]):
                    p[e].copy_(torch.randn(p.shape[1:], generator=gen, device=p.device)
                               .mul_(1.0 / math.sqrt(p.shape[1])))
            else:
                if leaf in SMALL or leaf in ("embedding", "unembed"):
                    std = 0.02
                else:
                    std = 1.0 / math.sqrt(p.shape[0] * (p.shape[1] if leaf == "wo" else 1))
                p.copy_(torch.randn(p.shape, generator=gen, device=p.device).mul_(std))
        for seg in self.segments:
            for leaf in DECAY:
                ps = [p for b in getattr(self, seg.name) for name, p in b.named_parameters()
                      if name.rsplit(".", 1)[-1] == leaf]
                if ps:
                    decay = torch.linspace(-6.0, -1.0, sum(p.numel() for p in ps))
                    for p, vals in zip(ps, decay.split(ps[0].numel())):
                        p.copy_(vals.reshape(p.shape))
        self._refresh_output_embedding()

    # -- forward ---------------------------------------------------------------

    def frontend_embeddings(self, frontend) -> torch.Tensor:
        """frontend (B, F, embed_dim) @ ``frontend_proj`` in the two's
        promoted dtype (f32 for an f32 frontend and bf16 weights), cast to
        the model's dtype, as the reference computes it."""
        if self.frontend_proj is None:
            raise ValueError(f"{self.cfg.name} has no frontend")
        f = torch.as_tensor(frontend, device=self.device)
        dt = torch.promote_types(f.dtype, self.frontend_proj.dtype)
        return (f.to(dt) @ self.frontend_proj.to(dt)).to(self.dtype)

    def embed_inputs(self, tokens, prompt: Optional[torch.Tensor] = None,
                     frontend: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[frontend embeddings][soft prompt][token embeddings] -> (x (B,
        S_total, d), positions 0..S_total-1). ``prompt`` is (P, d) shared or
        (B, P, d), ``frontend`` (B, F, embed_dim)."""
        tokens = torch.as_tensor(tokens, device=self.device)
        x = embed_tokens(self.embedding, tokens, self.dtype)
        B = x.shape[0]
        parts = []
        if frontend is not None:
            parts.append(self.frontend_embeddings(frontend))
        if prompt is not None:
            pe = torch.as_tensor(prompt, device=self.device).to(x.dtype)
            if pe.dim() == 2:
                pe = pe[None].expand(B, *pe.shape)
            parts.append(pe)
        if parts:
            x = torch.cat([*parts, x], dim=1)
        positions = torch.arange(x.shape[1], device=self.device)[None].expand(B, -1)
        return x, positions

    def encode(self, frontend) -> torch.Tensor:
        """An encoder-decoder's encoder: the frontend (B, F, embed_dim)
        projected (``frontend_embeddings``), the encoder's blocks over
        positions 0..F-1 with no causal mask, and its final norm -> (B, F,
        d)."""
        if frontend is None:
            raise ValueError(f"{self.cfg.name}: an encoder-decoder needs frontend "
                             "(B, frames, embed_dim); pass it in the batch as \"frontend\"")
        x = self.frontend_embeddings(frontend)
        positions = torch.arange(x.shape[1], device=self.device)[None].expand(x.shape[0], -1)
        for block in self.encoder.blocks:
            x = block(x, positions)
        return self.encoder.final_norm(x)

    def backbone(self, tokens, prompt: Optional[torch.Tensor] = None,
                 frontend: Optional[torch.Tensor] = None, *, return_aux: bool = False):
        """Everything up to and including the final norm: hidden (B, S, d),
        or with ``return_aux`` (hidden, {"aux_loss": the MoE layers' router
        losses summed in layer order, 0 for a model without them}), as the
        reference's ``backbone`` returns. An encoder-decoder's ``frontend``
        goes to the encoder only, and each decoder layer computes its cross
        keys and values from the encoder's output."""
        enc_out = None
        if self.cfg.encdec is not None:
            enc_out, frontend = self.encode(frontend), None
        x, positions = self.embed_inputs(tokens, prompt, frontend)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for si, seg in enumerate(self.segments):
            for block in getattr(self, seg.name):
                if seg.kind == "moe":
                    x, a = block(x, positions)
                    aux = aux + a
                elif seg.kind == "decoder_cross":
                    x = block(x, positions, enc_out)
                else:
                    x = block(x, positions)
            if self._shared_after(si):
                x = self.shared_attn(x, positions)
        x = self.final_norm(x)
        return (x, {"aux_loss": aux}) if return_aux else x

    def forward(self, tokens, prompt: Optional[torch.Tensor] = None,
                frontend: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits (B, S_total, V) in f32."""
        return unembed(self.cfg, self.embedding, self.unembed,
                       self.backbone(tokens, prompt, frontend))

    def _shared_after(self, si: int) -> bool:
        """Whether the hybrid's shared block runs after segment ``si``: after
        every segment but the last."""
        return hasattr(self, "shared_attn") and si < len(self.segments) - 1

    # -- decode -----------------------------------------------------------------

    def init_cache(self, batch: int, length: int) -> Dict:
        """An empty decode cache on the model's device, shaped as the
        reference's tree, one entry per segment: ``{"blocks": {"kv": {"k",
        "v", "pos"}}}`` for GQA blocks, ``{"dense0": {"kv": {"c_kv",
        "k_rope", "pos"}}, "moe": {"kv": {...}}}`` for an MLA MoE model,
        ``{"blocks": {"state": {"s", "x_prev"}}}`` for RWKV6, ``{"mamba0":
        {"state": {"h", "conv"}}, ...}`` for Mamba2 segments, each leaf with
        the layer axis first; a hybrid also has ``{"shared_attn": {"app<i>":
        {"kv": {"k", "v", "pos"}}}}``, one KV cache for each application of
        the shared block (its weights are shared, its keys and values are
        not). An encoder-decoder's has ``{"cross_kv": {"k", "v"}}``, each
        (layers, B, encoder_seq_len, Hkv, hd) of zeros, as the reference's:
        the caller fills it from ``encode`` and ``encode_cross_kv``."""
        cache = {}
        for seg in self.segments:
            # one layer's leaves at batch 1 (every leaf is batch-first), widened
            # over layers and batch: the temporary is one row, not one layer
            # (paligemma-3b's decode_32k cache, 77 GB at batch 128, leaves no
            # room for another 4.3 GB layer)
            one = block_cache(self.cfg, seg.kind, 1, length, self.device)
            cache[seg.name] = _map(
                lambda t: t[None].expand(seg.count, batch, *t.shape[1:]).clone(), one)
        if hasattr(self, "shared_attn"):
            cache["shared_attn"] = {
                f"app{i}": block_cache(self.cfg, "dense", batch, length, self.device)
                for i in range(len(self.segments) - 1)}
        cfg = self.cfg
        if cfg.encdec is not None:
            shape = (self.segments[0].count, batch, cfg.encdec.encoder_seq_len, cfg.kv_heads(),
                     cfg.resolved_head_dim())
            cache["cross_kv"] = {k: torch.zeros(shape, dtype=self.dtype, device=self.device)
                                 for k in ("k", "v")}
        return cache

    @torch.no_grad()
    def decode_step(self, cache: Dict, tokens, cache_len: int
                    ) -> Tuple[torch.Tensor, Dict]:
        """tokens (B, 1) int at position ``cache_len`` (a Python int: the
        tokens already cached). Returns (logits (B, 1, V) f32, cache), the
        cache updated in place; an encoder-decoder's ``cross_kv`` is read,
        layer by layer, and returned unchanged."""
        tokens = torch.as_tensor(tokens, device=self.device)
        x = embed_tokens(self.embedding, tokens, self.dtype)
        for si, seg in enumerate(self.segments):
            layers = cache[seg.name]
            for i, block in enumerate(getattr(self, seg.name)):
                enc_kv = None
                if seg.kind == "decoder_cross":
                    enc_kv = (cache["cross_kv"]["k"][i], cache["cross_kv"]["v"][i])
                x = block_decode(self.cfg, seg.kind, block, x, _map(lambda t: t[i], layers),
                                 int(cache_len), enc_kv)
            if self._shared_after(si):
                x = self.shared_attn.decode(x, cache["shared_attn"][f"app{si}"], int(cache_len))
        x = self.final_norm(x)
        return unembed(self.cfg, self.embedding, self.unembed, x), cache
