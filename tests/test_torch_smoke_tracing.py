"""``chip_smoke.py``'s reading of profiler traces, on synthetic traces.

On the card the profiler keeps the runtime's record of every launch but can
lose the device's record of the kernel, a few or all of a trace's.
``traced_kernels`` names each launch of a call from whichever call and trace
kept its kernel's record; these tests hand it traces that lose records as
the card's do and check what ``kernel_launches`` and ``profile_calls`` make
of them.
"""
import importlib.util
import json
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
# one call's launches: three kernels and a copy between them
CALL = (("fa_bwd_prep", True, 1.0), ("fa_bwd_bf16", True, 2.0),
        ("Memcpy DtoD (Device -> Device)", False, 3.0), ("fa_bwd_dq_out", True, 4.0))
CALLS = 3


@pytest.fixture
def smoke(tmp_path, monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "ROOT", tmp_path)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda *a, **k: None)
    return mod


def fake_profiler(monkeypatch, smoke, keep, offset_us=40.0):
    """Replaces torch.profiler.profile by one whose n-th trace (from 1) of
    CALLS calls keeps the kernel record of launch j of call i only where
    ``keep(n, i, j)``, each ``offset_us`` after its launch's; every runtime
    record is kept. Returns the traces taken so far, in a one-element list."""
    taken = [0]

    class Profile:
        def __init__(self, **kwargs):
            pass

        def __enter__(self):
            taken[0] += 1
            return self

        def __exit__(self, *exc):
            return False

        def export_chrome_trace(self, path):
            events, corr, ts = [], 0, 0.0
            for i in range(CALLS):
                events.append({"ph": "X", "cat": "user_annotation", "ts": ts, "dur": 100.0,
                               "name": f"{smoke.TRACED_CALL}{i}"})
                for j, (name, kernel, us) in enumerate(CALL):
                    corr += 1
                    events.append({"ph": "X", "cat": "cuda_runtime", "ts": ts + 10 + j,
                                   "dur": 2.0, "args": {"correlation": corr},
                                   "name": "cudaLaunchKernel" if kernel else "cudaMemcpyAsync"})
                    if keep(taken[0], i, j):
                        events.append({"ph": "X", "cat": "kernel" if kernel else "gpu_memcpy",
                                       "name": name, "ts": ts + 10 + j + offset_us, "dur": us,
                                       "args": {"correlation": corr, "grid": [1, 1, 1],
                                                "block": [128, 1, 1]}})
                ts += 200.0
            Path(path).write_text(json.dumps({"traceEvents": events}))

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    return taken


def test_launches_are_named_across_calls_and_traces(smoke, monkeypatch):
    # the first trace keeps nothing, the second every other record
    taken = fake_profiler(monkeypatch, smoke,
                          lambda n, i, j: n >= 3 or (n == 2 and (i + j) % 2 == 0))
    names = smoke.kernel_launches("test", lambda: None, calls=CALLS)
    assert names == ["fa_bwd_bf16", "fa_bwd_dq_out", "fa_bwd_prep"]
    assert taken[0] == 2
    smoke.own_kernels("flash_attention_bwd", names)


def test_a_launch_never_recorded_fails_the_listing(smoke, monkeypatch):
    taken = fake_profiler(monkeypatch, smoke, lambda n, i, j: j != 1)
    with pytest.raises(AssertionError, match="1 kernel launches stayed unnamed"):
        smoke.kernel_launches("test", lambda: None, calls=CALLS)
    assert taken[0] == smoke.PROFILER_ATTEMPTS


def test_a_copy_never_recorded_leaves_the_kernels_named(smoke, monkeypatch):
    fake_profiler(monkeypatch, smoke, lambda n, i, j: j != 2)
    assert smoke.kernel_launches("test", lambda: None, calls=CALLS) == [
        "fa_bwd_bf16", "fa_bwd_dq_out", "fa_bwd_prep"]


@pytest.mark.parametrize("lost", [False, True])
def test_profile_sums_each_launch_once_or_says_not_measured(smoke, monkeypatch, lost):
    fake_profiler(monkeypatch, smoke,
                  (lambda n, i, j: j != 0) if lost else (lambda n, i, j: i == n % CALLS))
    prof = smoke.profile_calls("test", lambda: None, warm=0, reps=1, traced=CALLS)
    if lost:
        assert prof["device_ms"] is None and prof["idle_share"] is None
    else:
        assert prof["device_ms"] == pytest.approx(sum(us for _, _, us in CALL) / 1e3)
        assert prof["kernels"] == 3



def test_unnamed_launches_are_reported_with_their_neighbours(smoke, monkeypatch, capsys):
    """The device's records 300 ms before their launches, one launch never
    recorded: the report gives the offset, the launch and its neighbours."""
    fake_profiler(monkeypatch, smoke, lambda n, i, j: j != 1, offset_us=-3e5)
    traced = smoke.traced_kernels("test", lambda: None, CALLS, attempts=2)
    assert traced["missing"] == 1 and traced["traces"] == 2
    out = capsys.readouterr().out
    assert "device clock against launches: -300.000 ms" in out
    assert "launch 1 (cudaLaunchKernel) unnamed, between fa_bwd_prep and Memcpy DtoD" in out
