"""``chip_smoke.py``'s helpers for the tuning phases, on CPU tensors.

``recorded_attention`` keeps the backward's own calls (what
``FlashAttention.backward`` hands ``flash_attention_bwd``) beside the
forward's, and ``hold_recorded_bwd`` holds each against
``flash_attention_bwd_plain`` on the same inputs at their strides;
``plain_attention`` routes a gradient through the plain forward and the
plain backward, or a backward it is given. On the CPU the wrappers run
their plain versions, so these tests check the plumbing: what is kept, what
is restored, and that a wrong gradient fails the hold.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    return mod


def _inputs(seed, B=2, S=9, L=6, H=4, Hkv=2, hd=112):
    """Model-layout q (B, S, H, hd), k/v (B, L, Hkv, hd) that require grad,
    and a weight for the output."""
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))  # noqa: E731
    q, k, v = mk(B, S, H, hd), mk(B, L, Hkv, hd), mk(B, L, Hkv, hd)
    return [t.requires_grad_(True) for t in (q, k, v)], mk(B, S, H, hd)


@pytest.mark.parametrize("causal", [True, False])
def test_recorded_attention_keeps_and_holds_the_backwards_calls(smoke, causal):
    (q, k, v), w = _inputs(1, L=9 if causal else 6)
    seen, kept, kept_bwd = [], {}, {}
    backward = fa_mod.FlashAttention.backward
    with smoke.recorded_attention(seen, kept, kept_bwd):
        for _ in range(2):                                # the same call twice: kept once
            out = ops.gqa_flash(q, k, v, causal=causal)
            grads = torch.autograd.grad((out * w).sum(), (q, k, v))
    assert fa_mod.FlashAttention.backward is backward
    assert [bool(c.get("bwd")) for c in seen] == [False, True, False, True]
    assert len(kept) == len(kept_bwd) == 1
    (rq, rk, rv, _, dout, lse, kw, (dq, dk, dv)), = kept_bwd.values()
    assert rq.stride() == q.transpose(1, 2).stride() and kw["causal"] == causal
    assert dout.shape == rq.shape and lse.shape == rq.shape[:3]
    torch.testing.assert_close(dq.transpose(1, 2), grads[0], rtol=0, atol=0)
    torch.testing.assert_close(dk.transpose(1, 2), grads[1], rtol=0, atol=0)
    assert smoke.hold_recorded_bwd("[test]", kept_bwd) == 0.0


def test_hold_recorded_bwd_fails_a_wrong_gradient(smoke):
    (q, k, v), w = _inputs(2, hd=64)
    kept_bwd = {}
    with smoke.recorded_attention([], None, kept_bwd):
        out = ops.gqa_flash(q, k, v, causal=False)
        torch.autograd.grad((out * w).sum(), (q, k, v))
    key, rec = next(iter(kept_bwd.items()))
    dq, dk, dv = rec[-1]
    kept_bwd[key] = (*rec[:-1], (dq, dk * 1.01, dv))
    with pytest.raises(AssertionError, match="dk"):
        smoke.hold_recorded_bwd("[test]", kept_bwd)


def test_plain_attention_routes_the_backward_through_the_plain_version(smoke):
    (q, k, v), w = _inputs(3)
    ref = torch.autograd.grad((ops.gqa_flash(q, k, v) * w).sum(), (q, k, v))
    calls, routed = {}, []

    def bwd(*a, **kw):
        routed.append(kw)
        return fa_mod.flash_attention_bwd_plain(*a, **kw)

    with smoke.plain_calls(calls), smoke.plain_attention():
        grads = torch.autograd.grad((ops.gqa_flash(q, k, v) * w).sum(), (q, k, v))
        with torch.no_grad():
            ops.gqa_flash(q, k, v)                        # no graph: the plain forward alone
    assert calls["flash_attention_plain"] == 2 and calls["flash_attention_bwd_plain"] == 1
    for g, r in zip(grads, ref):
        torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-6)
    with smoke.plain_attention(bwd=bwd):
        torch.autograd.grad((ops.gqa_flash(q, k, v, window=4) * w).sum(), (q, k, v))
    assert routed == [{"causal": True, "window": 4, "q_offset": 0, "kv_len": None}]
    assert ops.flash_attention is fa_mod.flash_attention


def test_recorded_decode_keeps_the_serve_steps_own_calls(smoke):
    """paligemma-3b's serve step at smoke size: recorded_decode keeps each
    layer's flash_decode call with the cache's own K and V views (no copy),
    and the last step's layer-0 call still holds against the plain version
    after every later layer and step wrote the cache."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels import flash_decode as fd_mod
    from repro_torch.launch import make_serve_step
    from repro_torch.models import Model

    model = Model(smoke_config("paligemma-3b"), device="cpu", seed=0)
    cache = model.init_cache(3, 12)
    assert cache["blocks"]["kv"]["k"].shape == (2, 3, 12, 1, 64)
    assert (cache["blocks"]["kv"]["pos"] == -1).all() and not cache["blocks"]["kv"]["k"].any()
    serve, tok, seen = make_serve_step(model), torch.tensor([[5], [7], [9]]), []
    with smoke.recorded_decode(seen):
        for t in range(4):
            tok, cache = serve(cache, tok, t)
    assert ops.flash_decode is fd_mod.flash_decode and len(seen) == 2 * 4
    q, k, v, kw, out = seen[-2]                          # the last step's layer 0
    assert k.data_ptr() == cache["blocks"]["kv"]["k"][0].data_ptr() and kw["kv_len"] == 4
    kw = {x: y for x, y in kw.items() if x != "splits"}
    torch.testing.assert_close(out, fd_mod.flash_decode_plain(q, k, v, **kw), rtol=0, atol=0)
