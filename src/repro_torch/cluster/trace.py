"""LPT workload traces (paper §2.2 Fig 2b, §6.1 'Workload Construction').

The paper samples 20-minute traces from a production cluster with highly
spiky arrivals (max requests/min ~ 5x the mean). We reproduce that shape
with a two-state (base / spike) modulated Poisson process and attach to
each request:

  * an LLM (gpt2-base / gpt2-large / vicuna-7b, or the heavy models),
  * a duration drawn from a lognormal spanning "a few seconds to several
    minutes" (paper: job durations vary from seconds to minutes),
  * an SLO  = duration * S + allocation overhead (S = "SLO emergence"),
  * ITA values for the four initialization strategies (manual / induction
    / bank 'score' / ideal), derived from a relative-speedup distribution
    that can be CALIBRATED from real testbed measurements
    (`benchmarks/bench_bank.py` writes ``artifacts/ita_calibration.json``).

Loads follow §6.1: low (41/55/42), medium (77/71/65), high (99/85/76)
requests per LLM (GPT2-B / GPT2-L / V7B) in 20 minutes.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.jobs import (
    DEFAULT_SLO_CLASS,
    DEFAULT_TENANT,
    LLM_PROFILES,
    SLO_CLASSES,
    Job,
    SLOClass,
    iter_time,
)

TRACE_MINUTES = 20
LOADS: Dict[str, Dict[str, int]] = {
    "low": {"gpt2-base": 41, "gpt2-large": 55, "vicuna-7b": 42},
    "medium": {"gpt2-base": 77, "gpt2-large": 71, "vicuna-7b": 65},
    "high": {"gpt2-base": 99, "gpt2-large": 85, "vicuna-7b": 76},
}
HEAVY_LOADS: Dict[str, Dict[str, int]] = {
    "llama-30b": {"llama-30b": 59},
    "qwen7b-r1": {"qwen7b-r1": 70},
}

# Fallback ITA-speedup distributions (relative to the manual prompt's
# iteration count), used until bench_bank writes a measured calibration.
#   Fig 2c: median / max ITA are 1.7-4.5x the min -> manual is the typical
#   draw, ideal ~= the min.  Fig 9b: score vs induction speedup 1.2-4.7x.
DEFAULT_CALIBRATION = {
    # manual_over_ideal: how many times more iterations manual needs
    "manual_over_ideal": {"lo": 1.7, "hi": 4.5},
    # score (bank) ITA is >= 90 % of ideal for most tasks (Fig 9a)
    "bank_over_ideal": {"lo": 1.0, "hi": 1.25},
    # induction sits between manual and bank; worse for weak LLMs (Fig 9b)
    "induction_over_bank": {
        "gpt2-base": {"lo": 1.8, "hi": 2.8},
        "gpt2-large": {"lo": 1.38, "hi": 2.2},
        "vicuna-7b": {"lo": 1.28, "hi": 1.9},
        "llama-30b": {"lo": 1.25, "hi": 1.8},
        "qwen7b-r1": {"lo": 1.3, "hi": 1.9},
    },
}

CALIBRATION_PATH = os.path.join(
    os.environ.get("REPRO_ARTIFACTS", "artifacts"), "ita_calibration.json"
)


def load_calibration() -> Dict:
    if os.path.exists(CALIBRATION_PATH):
        with open(CALIBRATION_PATH) as f:
            measured = json.load(f)
        cal = json.loads(json.dumps(DEFAULT_CALIBRATION))  # deep copy
        cal.update(measured)
        return cal
    return DEFAULT_CALIBRATION


def _rng_range(rng: np.random.Generator, spec: Dict) -> float:
    return float(rng.uniform(spec["lo"], spec["hi"]))


@dataclass
class TraceConfig:
    load: str = "medium"              # low | medium | high, or heavy model name
    slo_emergence: float = 1.0        # S (paper Fig 7c/d: 0.5 / 1.0 / 1.5)
    minutes: int = TRACE_MINUTES
    seed: int = 0
    spike_prob: float = 0.12          # fraction of spike minutes
    spike_mult: float = 5.0           # paper: max rpm ~ 5x mean
    duration_lo: float = 5.0          # seconds
    duration_hi: float = 300.0
    scale: float = 1.0                # multiply request counts (scalability eval)
    llms: Optional[Sequence[str]] = None
    tenant: str = DEFAULT_TENANT      # stamp every job with this tenant
    slo_class: SLOClass = DEFAULT_SLO_CLASS  # ... and this service class


def arrival_times(
    rng: np.random.Generator, total: int, minutes: int, spike_prob: float,
    spike_mult: float,
) -> np.ndarray:
    """Two-state modulated Poisson: spike minutes carry spike_mult x base
    intensity; overall count is ~total."""
    weights = np.where(rng.random(minutes) < spike_prob, spike_mult, 1.0)
    per_min = rng.multinomial(total, weights / weights.sum())
    times = []
    for m, n in enumerate(per_min):
        times.extend(60.0 * m + rng.random(n) * 60.0)
    return np.sort(np.asarray(times))


def generate_trace(cfg: TraceConfig) -> List[Job]:
    """Returns Jobs sorted by submit time with per-strategy ITA attached."""
    rng = np.random.default_rng(cfg.seed)
    cal = load_calibration()
    if cfg.load in LOADS:
        counts = dict(LOADS[cfg.load])
    elif cfg.load in HEAVY_LOADS:
        counts = dict(HEAVY_LOADS[cfg.load])
    else:
        raise KeyError(f"unknown load {cfg.load!r}")
    if cfg.llms is not None:
        counts = {k: v for k, v in counts.items() if k in cfg.llms}
    jobs: List[Job] = []
    jid = 0
    for llm, n in counts.items():
        n = max(int(round(n * cfg.scale)), 1)
        prof = LLM_PROFILES[llm]
        times = arrival_times(rng, n, cfg.minutes, cfg.spike_prob, cfg.spike_mult)
        for t in times:
            # `dur` is the duration observed in the PRODUCTION trace —
            # i.e. with the production system's (bank-quality) initial
            # prompt on one replica. Manual/induction inits need 1.3-4.5x
            # more iterations (Fig 2c / Fig 9), which is what makes SLOs
            # tight for systems without prompt reusing.
            mu = np.log(np.sqrt(cfg.duration_lo * cfg.duration_hi))
            sigma = np.log(cfg.duration_hi / cfg.duration_lo) / 4.0
            dur = float(np.clip(rng.lognormal(mu, sigma),
                                cfg.duration_lo, cfg.duration_hi))
            it1 = iter_time(prof, prof.gpus_per_replica)
            iters_bank = max(int(dur / it1), 2)
            b_over_i = _rng_range(rng, cal["bank_over_ideal"])
            iters_ideal = max(int(iters_bank / b_over_i), 2)
            m_over_i = _rng_range(rng, cal["manual_over_ideal"])
            iters_manual = max(int(iters_ideal * m_over_i), 4)
            ind_spec = cal["induction_over_bank"].get(
                llm, {"lo": 1.3, "hi": 2.0})
            iters_induction = max(int(iters_bank * _rng_range(rng, ind_spec)), 2)
            # SLO = trace duration x S + one allocation overhead (§6.1),
            # scaled by the service class's stringency (standard = 1.0)
            slo = (dur * cfg.slo_emergence + prof.cold_overhead) \
                * cfg.slo_class.slo_multiplier
            job = Job(
                job_id=jid,
                llm=llm,
                submit_time=float(t),
                slo=float(slo),
                iters_manual=iters_manual,
                iters_bank=iters_bank,
                task_id=f"task{jid % 120}",
                tenant=cfg.tenant,
                slo_class=cfg.slo_class,
            )
            job.iters_ideal = iters_ideal            # extra attrs for ablations
            job.iters_induction = iters_induction
            jobs.append(job)
            jid += 1
    jobs.sort(key=lambda j: j.submit_time)
    for i, j in enumerate(jobs):
        j.job_id = i
    return jobs


@dataclass
class TenantSpec:
    """One tenant's slice of a multi-tenant trace: its load/SLO profile
    plus the service class it bought. ``slo_class`` accepts a catalogue
    name (``premium`` / ``standard`` / ``best-effort``) or an ad-hoc
    :class:`~repro_torch.core.jobs.SLOClass`."""

    name: str
    load: str = "medium"              # low | medium | high, or heavy model
    slo_class: Union[str, SLOClass] = "standard"  # SLO_CLASSES key or ad-hoc
    scale: float = 1.0                # per-tenant load multiplier
    slo_emergence: float = 1.0        # per-tenant S (SLO stringency)
    spike_prob: float = 0.12          # per-tenant burst shape: fraction of
    spike_mult: float = 5.0           # spike minutes and their intensity

    def resolved_class(self) -> SLOClass:
        if isinstance(self.slo_class, SLOClass):
            return self.slo_class
        return SLO_CLASSES[self.slo_class]


DEFAULT_TENANT_MIX = (
    TenantSpec("acme", load="medium", slo_class="premium", scale=0.5),
    TenantSpec("globex", load="medium", slo_class="standard"),
    TenantSpec("initech", load="high", slo_class="best-effort", scale=0.7),
)

# The elastic-control-plane stressor: heavier aggregate load than the
# default mix, much spikier arrivals (most of a tenant's traffic lands
# in a few burst minutes), and imbalanced per-tenant scales. Static
# placement strands these bursts on whichever shards the placement
# hashed them to; work stealing and queue-pressure autoscaling are
# exactly the mechanisms that win here (`bench_multitenant` measures
# the head-to-head).
BURSTY_TENANT_MIX = (
    TenantSpec("acme", load="high", slo_class="premium", scale=0.6,
               spike_prob=0.25, spike_mult=8.0),
    TenantSpec("globex", load="medium", slo_class="standard",
               spike_prob=0.15, spike_mult=10.0),
    TenantSpec("initech", load="high", slo_class="best-effort", scale=1.2,
               spike_prob=0.3, spike_mult=6.0),
)


def generate_tenant_mix(
    tenants: Sequence[TenantSpec] = DEFAULT_TENANT_MIX,
    *,
    minutes: int = TRACE_MINUTES,
    seed: int = 0,
) -> List[Job]:
    """A multi-tenant workload: each tenant's sub-trace is generated with
    its own load / scale / stringency (decorrelated seeds), stamped with
    the tenant's identity and service class, and the union is merged in
    arrival order with globally unique job ids."""
    jobs: List[Job] = []
    for k, spec in enumerate(tenants):
        cls = spec.resolved_class()
        sub = generate_trace(TraceConfig(
            load=spec.load, slo_emergence=spec.slo_emergence,
            minutes=minutes, seed=seed + 7919 * (k + 1), scale=spec.scale,
            spike_prob=spec.spike_prob, spike_mult=spec.spike_mult,
            tenant=spec.name, slo_class=cls,
        ))
        for j in sub:
            j.task_id = f"{spec.name}/{j.task_id}"
        jobs.extend(sub)
    jobs.sort(key=lambda j: (j.submit_time, j.tenant))
    for i, j in enumerate(jobs):
        j.job_id = i
    return jobs


def clone_jobs(jobs: List[Job]) -> List[Job]:
    """Fresh Job copies (runtime state reset) so the same trace can be
    replayed through several systems."""
    out = []
    for j in jobs:
        c = Job(job_id=j.job_id, llm=j.llm, submit_time=j.submit_time,
                slo=j.slo, iters_manual=j.iters_manual,
                iters_bank=j.iters_bank, max_iters=j.max_iters,
                task_id=j.task_id, tenant=j.tenant, slo_class=j.slo_class)
        for extra in ("iters_ideal", "iters_induction"):
            if hasattr(j, extra):
                setattr(c, extra, getattr(j, extra))
        out.append(c)
    return out
