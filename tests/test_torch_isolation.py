"""The port stands alone and never falls back.

- importing every module of ``repro_torch`` loads neither JAX nor ``repro``;
- entry points raise without a GPU unless the caller passes ``device="cpu"``;
- a kernel wrapper handed CUDA tensors launches its kernel or raises: it
  never quietly runs the plain version;
- a family the port does not run raises, and so does the flash_attention
  backward at a head dim it has no kernel for (256, which the forward and
  the decode take);
- ``chip_smoke.py`` imports nothing of ``repro`` and fails without a GPU.
"""
import ast
import dataclasses
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from repro_torch import resolve_device
from repro_torch.configs import smoke_config
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import flash_decode as fd_mod
from repro_torch.kernels import mla_decode as md_mod
from repro_torch.kernels import rwkv_wkv as rw_mod
from repro_torch.kernels import score_ce as sc_mod
from repro_torch.models import Model

ROOT = Path(__file__).resolve().parents[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len(names), bad)\n"
        "new = {'repro_torch.models.moe', 'repro_torch.kernels.mla_decode',\n"
        "       'repro_torch.api.service', 'repro_torch.cluster.engine',\n"
        "       'repro_torch.obs', 'repro_torch.obs.forensics'}\n"
        "sys.exit(1 if bad or len(names) < 60 or not new <= set(names) else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=_env(), timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(smoke_config("gpt2-base"))
    assert Model(smoke_config("gpt2-base"), device="cpu").device.type == "cpu"


class FellBack(Exception):
    pass


@pytest.fixture
def as_if_cuda(monkeypatch):
    """CPU tensors routed down the CUDA path; any use of a plain version
    there raises FellBack."""
    monkeypatch.setattr(_build, "device_kind", lambda *ts: "cuda")

    def fell_back(*a, **k):
        raise FellBack

    monkeypatch.setattr(sc_mod, "score_ce_plain", fell_back)
    monkeypatch.setattr(sc_mod, "score_ce_bwd_plain", fell_back)
    monkeypatch.setattr(fa_mod, "flash_attention_plain", fell_back)
    monkeypatch.setattr(fa_mod, "flash_attention_bwd_plain", fell_back)
    monkeypatch.setattr(fd_mod, "flash_decode_plain", fell_back)
    monkeypatch.setattr(fd_mod, "combine_partials_plain", fell_back)
    monkeypatch.setattr(rw_mod, "rwkv6_wkv_plain", fell_back)
    monkeypatch.setattr(rw_mod, "rwkv6_wkv_bwd_plain", fell_back)
    monkeypatch.setattr(md_mod, "mla_decode_plain", fell_back)
    monkeypatch.setattr(md_mod, "combine_partials_plain", fell_back)


def _raises_without_fallback(fn, exc=Exception, match=None):
    with pytest.raises(exc, match=match) as info:
        fn()
    assert not isinstance(info.value, FellBack), "the wrapper fell back to its plain version"


def test_score_ce_raises_on_cuda_misuse(as_if_cuda):
    h, e = torch.zeros(8, 16), torch.zeros(32, 16)
    lab = torch.zeros(8, dtype=torch.int32)
    _raises_without_fallback(lambda: sc_mod.score_ce(h.double(), e.double(), lab),
                             ValueError, "float32")
    _raises_without_fallback(lambda: sc_mod.score_ce(h, e, lab.long()), ValueError, "int32")
    _raises_without_fallback(lambda: sc_mod.score_ce(h[:, :12], e[:, :12], lab),
                             ValueError, "multiple of 8")
    _raises_without_fallback(lambda: sc_mod.score_ce(h.T.contiguous().T, e, lab),
                             ValueError, "contiguous")
    before = sc_mod.score_ce.launches
    _raises_without_fallback(lambda: sc_mod.score_ce(h, e, lab))   # no card, no nvcc here
    assert sc_mod.score_ce.launches == before


def test_flash_attention_raises_on_cuda_misuse(as_if_cuda):
    q = torch.zeros(1, 4, 8, 64)
    kv = torch.zeros(1, 2, 8, 64)
    _raises_without_fallback(lambda: fa_mod.flash_attention(q[..., :32], kv[..., :32],
                                                            kv[..., :32]),
                             ValueError, "head_dim=32")
    _raises_without_fallback(lambda: fa_mod.flash_attention(q.bfloat16(), kv, kv),
                             ValueError, "dtype")
    _raises_without_fallback(lambda: fa_mod.flash_attention(q, kv[:, :1].expand(1, 3, 8, 64),
                                                            kv[:, :1].expand(1, 3, 8, 64)),
                             ValueError, "H % Hkv")
    before = fa_mod.flash_attention.launches
    _raises_without_fallback(lambda: fa_mod.flash_attention(q, kv, kv))
    # under autograd the call goes through FlashAttention to the same launch
    grad_q = q.clone().requires_grad_(True)
    with pytest.raises(Exception) as info:
        fa_mod.flash_attention(grad_q, kv, kv)
    assert not isinstance(info.value, (FellBack, NotImplementedError))
    assert fa_mod.flash_attention.launches == before


def test_backward_wrappers_raise_on_cuda_misuse(as_if_cuda):
    """The backward wrappers check what their kernels take and, handed
    CUDA tensors, launch or raise; they never fall back. A gradient for the
    embedding goes through ScoreCE to the same launches."""
    h, e = torch.zeros(8, 16), torch.zeros(32, 16)
    lab = torch.zeros(8, dtype=torch.int32)
    lse, g = torch.zeros(8), torch.ones(8)
    _raises_without_fallback(lambda: sc_mod.score_ce_bwd(h, e, lab, lse.double(), g),
                             ValueError, "lse")
    _raises_without_fallback(lambda: sc_mod.score_ce_bwd(h, e, lab.long(), lse, g),
                             ValueError, "int32")
    before = sc_mod.score_ce_bwd.launches
    _raises_without_fallback(lambda: sc_mod.score_ce_bwd(h, e, lab, lse, g))
    assert sc_mod.score_ce_bwd.launches == before
    before_de = sc_mod.score_ce_de.launches
    _raises_without_fallback(lambda: sc_mod.score_ce_bwd(h, e, lab, lse, g, with_emb=True))
    with pytest.raises(Exception) as info:
        sc_mod.score_ce(h.requires_grad_(True), e.clone().requires_grad_(True), lab)
    assert not isinstance(info.value, (FellBack, NotImplementedError))
    assert sc_mod.score_ce_bwd.launches == before
    assert sc_mod.score_ce_de.launches == before_de

    q, kv = torch.zeros(1, 4, 8, 64), torch.zeros(1, 2, 8, 64)
    lse = torch.zeros(1, 4, 8)
    _raises_without_fallback(lambda: fa_mod.flash_attention_bwd(q, kv, kv, q, q, lse[..., :4]),
                             ValueError, "lse")
    _raises_without_fallback(lambda: fa_mod.flash_attention_bwd(q[..., :32], kv[..., :32],
                                                                kv[..., :32], q[..., :32],
                                                                q[..., :32], lse),
                             ValueError, "head_dim=32")
    before = fa_mod.flash_attention_bwd.launches
    _raises_without_fallback(lambda: fa_mod.flash_attention_bwd(q, kv, kv, q, q, lse))
    assert fa_mod.flash_attention_bwd.launches == before


def test_flash_decode_raises_on_cuda_misuse(as_if_cuda):
    q = torch.zeros(2, 8, 64)
    kv = torch.zeros(2, 2, 40, 64)
    _raises_without_fallback(lambda: fd_mod.flash_decode(q[..., :32], kv[..., :32],
                                                         kv[..., :32]),
                             ValueError, "head_dim=32")
    _raises_without_fallback(lambda: fd_mod.flash_decode(q.bfloat16(), kv, kv),
                             ValueError, "dtype")
    _raises_without_fallback(lambda: fd_mod.flash_decode(q[:, :7], kv, kv),
                             ValueError, "H % Hkv")
    _raises_without_fallback(lambda: fd_mod.flash_decode(q, kv, kv, splits=0),
                             ValueError, "splits")
    _raises_without_fallback(lambda: fd_mod.flash_decode(q, kv[:, :, :, :60], kv[:, :, :, :60]),
                             ValueError)
    grad_q = q.clone().requires_grad_(True)
    _raises_without_fallback(lambda: fd_mod.flash_decode(grad_q, kv, kv),
                             NotImplementedError, "forward-only")
    before = fd_mod.flash_decode.launches
    _raises_without_fallback(lambda: fd_mod.flash_decode(q, kv, kv, kv_len=30))
    assert fd_mod.flash_decode.launches == before


def test_rwkv6_wkv_raises_on_cuda_misuse(as_if_cuda):
    r = torch.zeros(2, 3, 5, 64)
    u, s = torch.zeros(3, 64), torch.zeros(2, 3, 64, 64)
    _raises_without_fallback(lambda: rw_mod.rwkv6_wkv(r[..., :32], r[..., :32], r[..., :32],
                                                      r[..., :32], u[:, :32], None),
                             ValueError, "head_dim=32")
    _raises_without_fallback(lambda: rw_mod.rwkv6_wkv(r, r, r, r.bfloat16(), u, s),
                             ValueError, "float32")
    _raises_without_fallback(lambda: rw_mod.rwkv6_wkv(r.bfloat16(), r, r, r, u, s),
                             ValueError, "dtype")
    _raises_without_fallback(lambda: rw_mod.rwkv6_wkv(r, r, r, r, u, s[:1]),
                             ValueError, "state")
    _raises_without_fallback(lambda: rw_mod.rwkv6_wkv(r, r, r, r[:, :, :4], u, s),
                             ValueError, "shape")
    before = rw_mod.rwkv6_wkv.launches
    _raises_without_fallback(lambda: rw_mod.rwkv6_wkv(r, r, r, r, u, None))
    # under autograd the call goes through RWKV6WKV to the same launch
    grad_r = r.clone().requires_grad_(True)
    with pytest.raises(Exception) as info:
        rw_mod.rwkv6_wkv(grad_r, r, r, r, u, s)
    assert not isinstance(info.value, (FellBack, NotImplementedError))
    assert rw_mod.rwkv6_wkv.launches == before


def test_rwkv6_wkv_bwd_raises_on_cuda_misuse(as_if_cuda):
    r, dy = torch.zeros(2, 3, 5, 64), torch.zeros(2, 3, 5, 64)
    u, s = torch.zeros(3, 64), torch.zeros(2, 3, 64, 64)
    _raises_without_fallback(lambda: rw_mod.rwkv6_wkv_bwd(r[..., :32], r[..., :32], r[..., :32],
                                                          r[..., :32], u[:, :32], None,
                                                          dy[..., :32]),
                             ValueError, "head_dim=32")
    _raises_without_fallback(lambda: rw_mod.rwkv6_wkv_bwd(r, r, r, r, u, s, dy[:, :, :4]),
                             ValueError, "dy")
    _raises_without_fallback(lambda: rw_mod.rwkv6_wkv_bwd(r, r, r, r, u, s, dy, s[:1]),
                             ValueError, "ds")
    before = rw_mod.rwkv6_wkv_bwd.launches
    _raises_without_fallback(lambda: rw_mod.rwkv6_wkv_bwd(r, r, r, r, u, s, dy, s))
    assert rw_mod.rwkv6_wkv_bwd.launches == before


def test_mla_decode_raises_on_cuda_misuse(as_if_cuda):
    ql, qp = torch.zeros(2, 8, 512), torch.zeros(2, 8, 64)
    ckv, kpe = torch.zeros(2, 40, 512), torch.zeros(2, 40, 64)
    kw = dict(scale=0.1, kv_len=30)
    _raises_without_fallback(lambda: md_mod.mla_decode(ql[..., :64], qp[..., :16], ckv[..., :64],
                                                       kpe[..., :16], **kw),
                             ValueError, "rope dim")
    _raises_without_fallback(lambda: md_mod.mla_decode(ql.bfloat16(), qp, ckv, kpe, **kw),
                             ValueError, "dtype")
    _raises_without_fallback(lambda: md_mod.mla_decode(ql, qp[:, :4], ckv, kpe, **kw),
                             ValueError, "disagree")
    _raises_without_fallback(lambda: md_mod.mla_decode(ql, qp, ckv, kpe, splits=0, **kw),
                             ValueError, "splits")
    _raises_without_fallback(lambda: md_mod.mla_decode(ql, qp, ckv[:, :, :500], kpe, **kw),
                             ValueError)
    grad_q = ql.clone().requires_grad_(True)
    _raises_without_fallback(lambda: md_mod.mla_decode(grad_q, qp, ckv, kpe, **kw),
                             NotImplementedError, "forward-only")
    before = md_mod.mla_decode.launches
    _raises_without_fallback(lambda: md_mod.mla_decode(ql, qp, ckv, kpe, splits=4, **kw))
    assert md_mod.mla_decode.launches == before


def test_unported_families_raise():
    """The MoE family, Mamba2, the Zamba2 hybrid, the encoder-decoder
    (audio) and the VLM are ported and build with the reference's segment
    names; an arch_type the port does not run raises."""
    from repro_torch.config import EncDecConfig, FrontendConfig, MoEConfig

    moe = smoke_config("qwen2-7b").with_overrides(
        arch_type="moe", moe=MoEConfig(num_experts=4, d_ff_expert=32))
    assert [s.name for s in Model(moe, device="cpu").segments] == ["dense0", "moe"]
    rwkv = smoke_config("rwkv6-7b")
    mamba = rwkv.with_overrides(ssm=dataclasses.replace(rwkv.ssm, kind="mamba2"))
    assert [(s.name, s.kind) for s in Model(mamba, device="cpu").segments] == \
        [("blocks", "mamba")]
    hybrid = Model(smoke_config("zamba2-7b"), device="cpu")
    assert [(s.name, s.kind) for s in hybrid.segments] == \
        [("mamba0", "mamba"), ("mamba1", "mamba"), ("mamba2", "mamba")]
    assert hybrid.shared_attn is not None
    vlm = smoke_config("qwen2-7b").with_overrides(
        arch_type="vlm", frontend=FrontendConfig(kind="vision", num_embeddings=8, embed_dim=48))
    audio = smoke_config("qwen2-7b").with_overrides(
        arch_type="audio", encdec=EncDecConfig(num_encoder_layers=2, encoder_seq_len=16),
        frontend=FrontendConfig(kind="audio", num_embeddings=8, embed_dim=48))
    encdec = Model(audio, device="cpu")
    assert [(s.name, s.kind) for s in encdec.segments] == [("decoder", "decoder_cross")]
    assert len(encdec.encoder.blocks) == 2 and encdec.frontend_proj.shape == (48, 256)
    vision = Model(vlm, device="cpu")
    assert [(s.name, s.kind) for s in vision.segments] == [("blocks", "dense")]
    assert vision.frontend_proj.shape == (48, 256)
    with pytest.raises(NotImplementedError, match="is not ported"):
        Model(vlm.with_overrides(arch_type="diffusion"), device="cpu")


def test_flash_attention_bwd_raises_at_a_head_dim_with_no_kernel(as_if_cuda):
    """The backward is built for head dims 64, 112 and 128; at 256 it raises
    ValueError before any launch, with no fallback, also when a gradient
    reaches it through FlashAttention."""
    q, kv = torch.zeros(1, 4, 8, 256), torch.zeros(1, 2, 8, 256)
    lse = torch.zeros(1, 4, 8)
    before = fa_mod.flash_attention_bwd.launches
    _raises_without_fallback(lambda: fa_mod.flash_attention_bwd(q, kv, kv, q, q, lse),
                             ValueError, "head_dim=256 has no CUDA kernel")
    _raises_without_fallback(lambda: fa_mod.FlashAttention.backward(
        types.SimpleNamespace(saved_tensors=(q, kv, kv, q, lse), kw={}), q),
        ValueError, "head_dim=256")
    assert fa_mod.flash_attention_bwd.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_takes_head_dim_112_to_its_kernel(as_if_cuda, dtype):
    """Head dim 112 (zamba2-7b) passes the backward's checks and goes on to
    build and launch its kernel, which this machine cannot: it raises there,
    with no fallback and no launch counted."""
    q, kv = torch.zeros(1, 4, 8, 112, dtype=dtype), torch.zeros(1, 2, 8, 112, dtype=dtype)
    lse = torch.zeros(1, 4, 8)
    assert 112 in fa_mod.HEAD_DIMS
    before = fa_mod.flash_attention_bwd.launches
    with pytest.raises(Exception) as info:
        fa_mod.flash_attention_bwd(q, kv, kv, q, q, lse)
    assert not isinstance(info.value, (FellBack, ValueError)), info.value
    assert fa_mod.flash_attention_bwd.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_256_goes_to_the_forward_and_decode_kernels(as_if_cuda, dtype):
    """Head dim 256 (paligemma-3b, H = 8 over one kv-head) passes the
    checks of flash_attention's forward and of flash_decode and goes on to
    build and launch their kernels, which this machine cannot: each raises
    there, with no fallback and no launch counted. The backward has no
    kernel at 256 (test_flash_attention_bwd_raises_at_a_head_dim_with_no_kernel)."""
    q, kv = torch.zeros(2, 8, 9, 256, dtype=dtype), torch.zeros(2, 1, 9, 256, dtype=dtype)
    assert 256 in fa_mod.HEAD_DIMS and 256 in fd_mod.HEAD_DIMS
    assert 256 not in fa_mod.BWD_HEAD_DIMS
    before = (fa_mod.flash_attention.launches, fd_mod.flash_decode.launches)
    for call in (lambda: fa_mod.flash_attention(q, kv, kv),
                 lambda: fd_mod.flash_decode(q[:, :, 0], kv, kv, kv_len=7)):
        with pytest.raises(Exception) as info:
            call()
        assert not isinstance(info.value, (FellBack, ValueError)), info.value
    assert (fa_mod.flash_attention.launches, fd_mod.flash_decode.launches) == before


def test_device_kind_rejects_mixed_devices():
    with pytest.raises(ValueError, match="all lie on"):
        _build.device_kind(torch.zeros(1), torch.zeros(1, device="meta"))


def test_chip_smoke_imports_nothing_of_repro_or_jax():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module or "")
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"repro", "jax", "jaxlib"}, sorted(mods)
    assert "repro_torch" in tops


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_gpu(tmp_path, alone):
    """Here (no card) it must exit non-zero and print no result; so too
    from a directory holding chip_smoke.py and nothing else."""
    script = ROOT / "chip_smoke.py"
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          env=env, cwd=script.parent, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
