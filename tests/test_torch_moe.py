"""The port's mixture-of-experts layer and the MLA + MoE model against the
JAX package's.

- ``capacity``, ``route`` (top-k weights, ids, aux loss) and ``moe_ffn``
  against the reference's ``capacity``, ``route`` and ``_moe_ffn_dense``,
  with a capacity factor that forces drops: the dropped (token, k) pairs
  must be the same ones;
- the whole ``smoke_config("deepseek-v2-236b")`` model (1 dense + 2 MoE
  layers, MLA): ``backbone`` with its aux loss, ``forward``, ``lpt_loss``
  (its total carries the aux loss) and decode steps through
  ``make_serve_step`` against the reference's ``Model``;
- ``params_from_jax`` on the reference's ``dense0``/``moe`` tree, and the
  seeded init of expert stacks and the router.

Weights come from numpy at 1/sqrt(fan_in) and go to both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.launch.steps import make_serve_step as jax_make_serve_step
from repro.models import build_model
from repro.models import moe as jmoe
from repro.train.objectives import lpt_loss as jax_lpt_loss
from repro_torch.configs import smoke_config
from repro_torch.launch import make_serve_step
from repro_torch.models import Model, params_from_jax
from repro_torch.models import moe
from repro_torch.train import lpt_loss
from test_torch_mla import moe_numpy_params

TOL = 1e-5
ARCH = "deepseek-v2-236b"


def _close(out, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(out, np.float32), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def _configs(capacity_factor=None):
    jcfg, cfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    if capacity_factor is not None:
        jcfg = jcfg.with_overrides(moe=dataclasses.replace(jcfg.moe,
                                                           capacity_factor=capacity_factor))
        cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, capacity_factor=capacity_factor))
    return jcfg, cfg


@pytest.mark.parametrize("tokens", [1, 2, 16, 33, 200, 528])
@pytest.mark.parametrize("factor", [0.5, 1.25, 26.0])
def test_capacity_matches_jax(tokens, factor):
    jcfg, cfg = _configs(factor)
    assert moe.capacity(cfg.moe, tokens) == jmoe.capacity(jcfg.moe, tokens)


def _layer_pair(capacity_factor=None, seed=5):
    """The first MoE layer's weights from numpy, as a reference dict and as
    the port's module."""
    jcfg, cfg = _configs(capacity_factor)
    jtree = moe_numpy_params(build_model(jcfg), seed)["moe"]["moe"]
    tree = jax.tree.map(lambda a: np.asarray(a)[0], jtree)
    layer = moe.MoE(cfg, device=torch.device("cpu"), dtype=torch.float32)
    layer.load_state_dict(params_from_jax(tree))       # "router", "shared.w_up", ...
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), layer


def test_route_matches_jax():
    jcfg, cfg, jp, layer = _layer_pair()
    x = np.random.default_rng(1).normal(size=(40, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        w, ids, aux = moe.route(cfg.moe, layer.router, torch.from_numpy(x))
    jw, jids, jaux = jmoe.route(jcfg.moe, jp["router"], jnp.asarray(x))
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(w, jw)
    _close(aux, jaux)


def _jax_dropped(jcfg, jp, x):
    """(token, k) pairs past capacity in the reference: its route, then the
    slot count of ``_moe_ffn_dense`` (moe.py:107-110) on its ids."""
    m = jcfg.moe
    _, ids, _ = jmoe.route(m, jp["router"], x)
    cap = jmoe.capacity(m, x.shape[0])
    flat = ids.reshape(-1)
    oh = jax.nn.one_hot(flat, m.num_experts, dtype=jnp.int32)
    pos = (jnp.cumsum(oh, axis=0) * oh).sum(-1) - 1
    return np.asarray(pos >= cap).reshape(ids.shape)


@pytest.mark.parametrize("capacity_factor,T,expect_drops", [(None, 12, False), (None, 200, None),
                                                            (0.5, 200, True)])
def test_moe_ffn_matches_jax(capacity_factor, T, expect_drops):
    jcfg, cfg, jp, layer = _layer_pair(capacity_factor)
    x = np.random.default_rng(T).normal(size=(2, T // 2, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        y, aux = moe.moe_ffn(cfg, layer, torch.from_numpy(x))
    jy, jaux = jmoe._moe_ffn_dense(jcfg, jp, jnp.asarray(x))
    _close(y, jy)
    _close(aux, jaux)
    with torch.no_grad():
        _, ids, _ = moe.route(cfg.moe, layer.router, torch.from_numpy(x.reshape(T, -1)))
    _, in_cap = moe.assign_slots(ids, cfg.moe.num_experts, moe.capacity(cfg.moe, T))
    dropped = ~in_cap.numpy().reshape(ids.shape)
    np.testing.assert_array_equal(dropped, _jax_dropped(jcfg, jp, jnp.asarray(x.reshape(T, -1))))
    if expect_drops is not None:
        assert dropped.any() == expect_drops


# -- the whole model ------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model) with the same weights."""
    jmodel = build_model(jax_smoke_config(ARCH))
    tree = moe_numpy_params(jmodel, seed=11)
    model = Model(smoke_config(ARCH), device="cpu", seed=None)
    model.load_state_dict(params_from_jax(tree))
    return jmodel, jax.tree.map(jnp.asarray, tree), model


@pytest.mark.parametrize("with_prompt", [False, True])
def test_backbone_aux_and_forward_match_jax(pair, with_prompt):
    jmodel, params, model = pair
    B, S = 2, 9
    tokens = np.random.default_rng(3).integers(3, 512, (B, S)).astype(np.int32)
    prompt = (np.random.default_rng(4).normal(size=(4, 256)) * 0.1).astype(np.float32)
    tp, jpr = (torch.from_numpy(prompt), jnp.asarray(prompt)) if with_prompt else (None, None)
    with torch.no_grad():
        hidden, aux = model.backbone(torch.from_numpy(tokens), tp, return_aux=True)
        logits = model(torch.from_numpy(tokens), tp)
    jhidden, jaux = jmodel.backbone(params, jnp.asarray(tokens), prompt=jpr)
    jlogits, _ = jmodel.forward(params, jnp.asarray(tokens), prompt=jpr)
    _close(hidden, jhidden)
    _close(aux["aux_loss"], jaux["aux_loss"])
    assert float(aux["aux_loss"]) > 0
    _close(logits, jlogits)
    with torch.no_grad():                       # existing callers get the hidden state alone
        _close(model.backbone(torch.from_numpy(tokens), tp), jhidden)


def test_lpt_loss_adds_the_aux_loss_as_jax(pair, monkeypatch):
    """At a capacity factor that drops (token, expert) pairs, lpt_loss
    returns the reference's (mean + aux loss, (mean, per-example)), and its
    total exceeds the mean by the backbone's router loss."""
    _, params, loaded = pair
    jcfg, cfg = _configs(0.5)
    jmodel, model = build_model(jcfg), Model(cfg, device="cpu", seed=None)
    model.load_state_dict(loaded.state_dict())
    B, S, P = 2, 12, 4
    rng = np.random.default_rng(21)
    tokens = rng.integers(3, 512, (B, S)).astype(np.int32)
    prompt = (rng.normal(size=(P, cfg.d_model)) * 0.1).astype(np.float32)
    batch = {"tokens": tokens, "labels": rng.integers(3, 512, (B, S)).astype(np.int32),
             "mask": (rng.random((B, S)) > 0.3).astype(np.float32)}
    jtotal, (jmean, jper) = jax_lpt_loss(jmodel, params, jnp.asarray(prompt),
                                         {k: jnp.asarray(v) for k, v in batch.items()}, P)
    routes, real_route = [], moe.route
    def recording(m, router_w, x_flat):
        out = real_route(m, router_w, x_flat)
        routes.append(out[1])
        return out
    monkeypatch.setattr(moe, "route", recording)
    with torch.no_grad():
        total, (mean, per) = lpt_loss(model, torch.from_numpy(prompt),
                                      {k: torch.from_numpy(v) for k, v in batch.items()})
        _, aux = model.backbone(torch.from_numpy(tokens), torch.from_numpy(prompt),
                                return_aux=True)
    assert len(routes) == 4                     # two MoE layers, two backbone runs
    cap = moe.capacity(cfg.moe, B * (S + P))
    assert any(not moe.assign_slots(ids, cfg.moe.num_experts, cap)[1].all() for ids in routes)
    _close(total, jtotal)
    _close(mean, jmean)
    _close(per, jper)
    assert float(aux["aux_loss"]) > 1e-3
    _close(total - mean, aux["aux_loss"])


def test_decode_steps_match_jax(pair):
    """Six prompt tokens teacher-forced, then four serve steps feeding back
    their own tokens, into a 16-token cache: logits, tokens and caches leaf
    by leaf against the reference."""
    jmodel, params, model = pair
    B, length = 2, 16
    tokens = np.random.default_rng(9).integers(3, 512, (B, 6)).astype(np.int32)
    jstep = jax.jit(jmodel.decode_step)
    jcache, cache = jmodel.init_cache(B, length), model.init_cache(B, length)
    assert cache["moe"]["kv"]["c_kv"].shape == (2, B, length, 64)
    assert cache["dense0"]["kv"]["k_rope"].shape == (1, B, length, 16)
    for t in range(tokens.shape[1]):
        jlogits, jcache = jstep(params, jcache, jnp.asarray(tokens[:, t:t + 1]), jnp.int32(t))
        logits, cache = model.decode_step(cache, torch.from_numpy(tokens[:, t:t + 1]), t)
        _close(logits, jlogits)
    jserve, serve = jax.jit(jax_make_serve_step(jmodel)), make_serve_step(model)
    jtok, tok = jnp.asarray(tokens[:, -1:]), torch.from_numpy(tokens[:, -1:])
    for t in range(tokens.shape[1], tokens.shape[1] + 4):
        jtok, jcache = jserve(params, jcache, jtok, jnp.int32(t))
        tok, cache = serve(cache, tok, t)
        assert tok.dtype == torch.int32 and tok.shape == (B, 1)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    for seg in ("dense0", "moe"):
        for name in ("c_kv", "k_rope", "pos"):
            _close(cache[seg]["kv"][name], jcache[seg]["kv"][name])


def test_params_from_jax_loads_the_segments(pair):
    jmodel, params, model = pair
    assert [(s.name, s.kind, s.count) for s in model.segments] == [
        ("dense0", "dense", 1), ("moe", "moe", 2)]
    np.testing.assert_array_equal(model.moe[1].moe.w_gate.detach().numpy(),
                                  np.asarray(params["moe"]["moe"]["w_gate"][1]))
    np.testing.assert_array_equal(model.moe[0].moe.shared.w_down.detach().numpy(),
                                  np.asarray(params["moe"]["moe"]["shared"]["w_down"][0]))
    np.testing.assert_array_equal(model.dense0[0].attn.wkv_b_k.detach().numpy(),
                                  np.asarray(params["dense0"]["attn"]["wkv_b_k"][0]))
    assert model.dense0[0].ffn.w_up.shape == (256, 128 * 3)    # d_ff_expert · (top_k + shared)
    assert model.moe[0].moe.router.dtype == torch.float32


def test_init_weights_draws_expert_stacks_at_their_fan_in():
    """Expert stacks (E, in, out) take fan-in ``in``, not E; the router is
    the reference's "small" f32 leaf."""
    cfg = smoke_config(ARCH).with_overrides(dtype="bfloat16", param_dtype="bfloat16")
    cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, num_experts=16, d_ff_expert=512))
    model = Model(cfg, device="cpu", seed=0)
    layer = model.moe[0].moe
    assert layer.router.dtype == torch.float32 and layer.w_gate.dtype == torch.bfloat16
    for p, fan_in in ((layer.w_gate, 256), (layer.w_up, 256), (layer.w_down, 512)):
        assert abs(p.float().std().item() * fan_in ** 0.5 - 1) < 0.02
        assert abs(p[3].float().std().item() / p[11].float().std().item() - 1) < 0.05
    assert abs(layer.router.std().item() / 0.02 - 1) < 0.05
    attn = model.moe[0].attn
    assert abs(attn.wkv_b_k.float().std().item() * 64 ** 0.5 - 1) < 0.05   # fan-in r
