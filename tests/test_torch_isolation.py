"""The port stands alone and never falls back.

- importing every module of ``repro_torch`` loads neither JAX nor ``repro``;
- entry points raise without a GPU unless the caller passes ``device="cpu"``;
- a kernel wrapper handed CUDA tensors launches its kernel or raises: it
  never quietly runs the plain version;
- ``chip_smoke.py`` imports nothing of ``repro`` and fails without a GPU.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import resolve_device
from repro_torch.configs import smoke_config
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa_mod
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
        "sys.exit(1 if bad or len(names) < 15 else 0)\n")
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
    monkeypatch.setattr(fa_mod, "flash_attention_plain", fell_back)


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
    grad_q = q.clone().requires_grad_(True)
    _raises_without_fallback(lambda: fa_mod.flash_attention(grad_q, kv, kv),
                             NotImplementedError, "forward-only")
    before = fa_mod.flash_attention.launches
    _raises_without_fallback(lambda: fa_mod.flash_attention(q, kv, kv))
    assert fa_mod.flash_attention.launches == before


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
