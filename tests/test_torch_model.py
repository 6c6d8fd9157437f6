"""The port's dense model against the JAX package's, on the smoke configs.

gpt2-base's smoke config is LayerNorm, GELU, QKV bias, tied embeddings and
GQA 4/2; qwen2-7b's is RMSNorm, SwiGLU and untied embeddings. The weights
are made with numpy in the JAX parameter tree's shapes and handed to both
packages: the reference's own init draws wq with std 1/sqrt(H), whose sharp
attention amplifies f32 rounding to ~5e-5 in the logits, while weights at
1/sqrt(fan_in) keep the comparison at the f32 tolerance of 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model
from repro.models import common as jcommon
from repro.train.objectives import lpt_loss as jax_lpt_loss
from repro_torch.configs import smoke_config
from repro_torch.models import Model, params_from_jax
from repro_torch.models import common
from repro_torch.train import lpt_loss, token_cross_entropy

TOL = 1e-5
ARCHS = ["gpt2-base", "qwen2-7b"]


def numpy_params(jmodel, seed):
    """A parameter tree shaped like ``jmodel``'s, with well-conditioned
    numpy values: norms near 1, biases near 0, matrices at 1/sqrt(fan_in)."""
    rng = np.random.default_rng(seed)

    def make(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if "gamma" in name:
            return (1 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        if "beta" in name or any(f"'{b}'" in name for b in ("bq", "bk", "bv")):
            return (0.1 * rng.normal(size=shape)).astype(np.float32)
        if "embedding" in name:
            fan_in = shape[-1]
        elif any(f"'{w}'" in name for w in ("wq", "wk", "wv")):
            fan_in = shape[-3]                       # (L, d, H, hd): contract d
        elif "'wo'" in name:
            fan_in = shape[-3] * shape[-2]           # (L, H, hd, d): contract H*hd
        else:
            fan_in = shape[-2]
        return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(make, jmodel.abstract_params())


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax model, jax params, port model) with the same weights."""
    jmodel = build_model(jax_smoke_config(request.param))
    tree = numpy_params(jmodel, seed=len(request.param))
    model = Model(smoke_config(request.param), device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return jmodel, jax.tree.map(jnp.asarray, tree), model


def _inputs(seed, d, B=2, S=12, P=4, V=512):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, V, (B, S)).astype(np.int32)
    prompt = (rng.normal(size=(P, d)) * 0.1).astype(np.float32)
    batch = {"tokens": tokens,
             "labels": rng.integers(0, V, (B, S)).astype(np.int32),
             "mask": (rng.random((B, S)) > 0.3).astype(np.float32)}
    return tokens, prompt, batch


@pytest.mark.parametrize("with_prompt", [False, True])
def test_backbone_and_forward_match_jax(pair, with_prompt):
    jmodel, params, model = pair
    tokens, prompt, _ = _inputs(0, model.cfg.d_model)
    jp = jnp.asarray(prompt) if with_prompt else None
    tp = torch.from_numpy(prompt) if with_prompt else None
    with torch.no_grad():
        hidden = model.backbone(torch.from_numpy(tokens), tp)
        logits = model(torch.from_numpy(tokens), tp)
    jhidden, _ = jmodel.backbone(params, jnp.asarray(tokens), prompt=jp)
    jlogits, _ = jmodel.forward(params, jnp.asarray(tokens), prompt=jp)
    assert logits.shape == (2, 12 + (4 if with_prompt else 0), 512)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jhidden), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=TOL, atol=TOL)


def test_lpt_loss_matches_jax(pair):
    jmodel, params, model = pair
    _, prompt, batch = _inputs(1, model.cfg.d_model)
    _, (jmean, jper) = jax_lpt_loss(jmodel, params, jnp.asarray(prompt),
                                    {k: jnp.asarray(v) for k, v in batch.items()}, 4)
    with torch.no_grad():
        mean, per = lpt_loss(model, torch.from_numpy(prompt),
                             {k: torch.from_numpy(v) for k, v in batch.items()})
        # the fused path agrees with the full-logits CE of the port's forward
        logits = model(torch.from_numpy(batch["tokens"]), torch.from_numpy(prompt))
        fmean, _ = token_cross_entropy(logits[:, -12:], torch.from_numpy(batch["labels"]),
                                       torch.from_numpy(batch["mask"]))
    np.testing.assert_allclose(float(mean), float(jmean), rtol=TOL)
    np.testing.assert_allclose(per.numpy(), np.asarray(jper), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(fmean), float(mean), rtol=TOL)


@pytest.mark.parametrize("op", ["rms_norm", "layer_norm", "apply_rope", "apply_ffn_gelu",
                                "apply_ffn_swiglu", "unembed_untied"])
def test_common_ops_match_jax(op):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 5, 4, 32)).astype(np.float32)
    g = (1 + 0.1 * rng.normal(size=(32,))).astype(np.float32)
    b = (0.1 * rng.normal(size=(32,))).astype(np.float32)
    tx = torch.from_numpy(x)
    if op == "rms_norm":
        ours, ref = common.rms_norm(tx, torch.from_numpy(g)), jcommon.rms_norm(x, g)
    elif op == "layer_norm":
        ours = common.layer_norm(tx, torch.from_numpy(g), torch.from_numpy(b))
        ref = jcommon.layer_norm(x, g, b)
    elif op == "apply_rope":
        pos = np.broadcast_to(np.arange(3, 8)[None], (2, 5))
        ours = common.apply_rope(tx, torch.from_numpy(pos.copy()), 10000.0)
        ref = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    elif op.startswith("apply_ffn"):
        act = op.rsplit("_", 1)[1]
        cfg = smoke_config("gpt2-base").with_overrides(activation=act)
        w = {k: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
             for k, s in (("w_up", (32, 64)), ("w_gate", (32, 64)), ("w_down", (64, 32)))}
        ours = common.apply_ffn(cfg, *(torch.from_numpy(w[k]) for k in ("w_up", "w_down", "w_gate")), tx)
        ref = jcommon.apply_ffn(jax_smoke_config("gpt2-base").with_overrides(activation=act),
                                {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x))
    else:
        cfg = smoke_config("qwen2-7b").with_overrides(logit_soft_cap=5.0)
        u = (rng.normal(size=(32, 50)) * 0.3).astype(np.float32)
        ours = common.unembed(cfg, None, torch.from_numpy(u), tx)
        ref = jcommon.unembed(jax_smoke_config("qwen2-7b").with_overrides(logit_soft_cap=5.0),
                              {"unembed": jnp.asarray(u)}, jnp.asarray(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def test_load_jax_checkpoint_roundtrip(tmp_path):
    """An .npz written by the reference's checkpoint module loads with numpy
    alone and fills the port's model."""
    from repro.train.checkpoint import save_checkpoint
    from repro_torch.models import load_jax_checkpoint

    jmodel = build_model(jax_smoke_config("qwen2-7b"))
    tree = numpy_params(jmodel, seed=3)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, {"params": tree, "prompt_table": np.zeros((2, 4, 256), np.float32)})
    loaded = load_jax_checkpoint(path)
    assert loaded["prompt_table"].shape == (2, 4, 256)
    model = Model(smoke_config("qwen2-7b"), device="cpu")
    model.load_state_dict(params_from_jax(loaded["params"]))
    np.testing.assert_array_equal(model.blocks[1].attn.wq.detach().numpy(),
                                  tree["blocks"]["attn"]["wq"][1])
    np.testing.assert_array_equal(model.unembed.detach().numpy(), tree["unembed"])
