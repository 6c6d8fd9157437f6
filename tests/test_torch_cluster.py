"""The port's Workload Scheduler against the reference's, on the CPU.

``repro_torch.cluster`` and ``repro_torch.core.jobs`` are host-only copies
of the reference's, so they are held to it exactly: every golden summary of
``tests/test_policies.py``, and on seeded traces every record and every
event (job state included, floats compared bit for bit) across policies,
shard counts, placements, the elastic control plane, tenant mixes and a
fault plane. The one intended difference is ``FaultPlane._hazard_schedule``:
the port skips a rate whose ``rate / 3600`` underflows to 0, where the
reference divides by zero; its schedule equals the reference's with that
rate set to 0.

Each package generates its own trace, and the traces are compared too.
"""
import dataclasses
import enum
import functools
import math
from types import SimpleNamespace

import numpy as np
import pytest

from _hypothesis_compat import given, settings, st
from test_policies import GOLDEN, _cfg_for

import repro.cluster as ref_cluster
import repro.cluster.trace as ref_trace
import repro.core.jobs as ref_jobs
import repro_torch.cluster as port_cluster
import repro_torch.cluster.trace as port_trace
import repro_torch.core.jobs as port_jobs
from repro_torch.cluster.baselines import ElasticFlowSim, INFlessSim
from repro_torch.core.scheduler import PromptTunerSim

REF = SimpleNamespace(c=ref_cluster, jobs=ref_jobs, trace=ref_trace, name="reference")
PORT = SimpleNamespace(c=port_cluster, jobs=port_jobs, trace=port_trace, name="port")


def plain(x):
    """A package-free, bit-exact value of ``x``: dataclasses and objects by
    their attributes in order, enums by value, floats by ``float.hex`` (so
    nan and inf compare too), arrays by dtype, shape and bytes."""
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.value)
    if isinstance(x, float):
        return float(x).hex()
    if isinstance(x, np.ndarray):
        return ("ndarray", str(x.dtype), x.shape, x.tobytes())
    if isinstance(x, (list, tuple)):
        return tuple(plain(v) for v in x)
    if isinstance(x, dict):
        return tuple((plain(k), plain(v)) for k, v in x.items())
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple((k, plain(v)) for k, v in vars(x).items())
    return x


def port_cfg(ref_cfg):
    """The port's SimConfig with the reference one's fields."""
    return port_cluster.SimConfig(**dataclasses.asdict(ref_cfg))


@functools.lru_cache(maxsize=None)
def _golden_trace(side_name, key):
    side = PORT if side_name == "port" else REF
    load, seed, minutes, _ = key
    return side.c.generate_trace(side.c.TraceConfig(load=load, seed=seed, minutes=minutes))


GOLDEN_CASES = [(key, name) for key in sorted(GOLDEN) for name in GOLDEN[key]]


@pytest.mark.parametrize("key,name", GOLDEN_CASES, ids=[f"{k[0]}-{n}" for k, n in GOLDEN_CASES])
def test_port_reproduces_policy_goldens_exactly(key, name):
    """The port's registry and a one-shard port ClusterFabric give every
    golden summary exactly, on the port's own trace."""
    base, ref_cfg = _cfg_for(name, key[3])
    cfg = port_cfg(ref_cfg)
    jobs = _golden_trace("port", key)
    engine = port_cluster.policies.build(base, cfg)
    assert engine.run(port_cluster.clone_jobs(jobs)).summary() == GOLDEN[key][name]
    fabric = port_cluster.ClusterFabric(cfg, base, shards=1)
    assert fabric.run(port_cluster.clone_jobs(jobs)).summary() == GOLDEN[key][name]


def test_port_legacy_shims_reproduce_goldens():
    """``PromptTunerSim``, ``INFlessSim``, ``ElasticFlowSim``,
    ``make_system`` and ``ClusterSim`` subclassing keep working in the port."""
    key = ("low", 3, 4, 16)
    jobs = _golden_trace("port", key)
    cfg = port_cluster.SimConfig(max_gpus=key[3])
    for name, cls in (("prompttuner", PromptTunerSim), ("infless", INFlessSim),
                      ("elasticflow", ElasticFlowSim)):
        assert cls(cfg).run(port_cluster.clone_jobs(jobs)).summary() == GOLDEN[key][name]
        assert port_cluster.make_system(name, cfg).run(
            port_cluster.clone_jobs(jobs)).summary() == GOLDEN[key][name]
    assert issubclass(ElasticFlowSim, port_cluster.ClusterSim)
    assert sorted(port_cluster.baselines.SYSTEMS) == port_cluster.policies.available()


# -- jobs, profiles, traces ---------------------------------------------------------

def test_jobs_module_matches_reference():
    assert plain(port_jobs.LLM_PROFILES) == plain(ref_jobs.LLM_PROFILES)
    assert plain(port_jobs.SLO_CLASSES) == plain(ref_jobs.SLO_CLASSES)
    assert plain(port_jobs.DEFAULT_SLO_CLASS) == plain(ref_jobs.DEFAULT_SLO_CLASS)
    for const in ("GPU_PRICE_PER_S", "STORAGE_PRICE_PER_JOB_S", "DEFAULT_TENANT"):
        assert getattr(port_jobs, const) == getattr(ref_jobs, const)
    assert [p.value for p in port_jobs.JobPhase] == [p.value for p in ref_jobs.JobPhase]
    for llm in ref_jobs.LLM_PROFILES:
        for gpus in (1, 2, 3, 4, 8, 16):
            assert port_jobs.iter_time(port_jobs.LLM_PROFILES[llm], gpus) == \
                ref_jobs.iter_time(ref_jobs.LLM_PROFILES[llm], gpus)
            for bank in (False, True):
                kw = dict(job_id=0, llm=llm, submit_time=1.5, slo=90.0, iters_manual=300,
                          iters_bank=80, iters_done=7)
                assert port_jobs.exec_time(port_jobs.Job(**kw), gpus, used_bank=bank,
                                           alloc_overhead=2.5) == \
                    ref_jobs.exec_time(ref_jobs.Job(**kw), gpus, used_bank=bank,
                                       alloc_overhead=2.5)


TRACES = {  # id -> side -> jobs
    "low": lambda s: s.c.generate_trace(s.c.TraceConfig(load="low", seed=1, minutes=4)),
    "high-scaled": lambda s: s.c.generate_trace(s.c.TraceConfig(
        load="high", seed=2, minutes=3, scale=0.5, slo_emergence=1.5)),
    "heavy": lambda s: s.c.generate_trace(s.c.TraceConfig(
        load=sorted(s.trace.HEAVY_LOADS)[0], seed=3, minutes=3)),
    "tenant-mix": lambda s: s.c.generate_tenant_mix(minutes=3, seed=4),
    "bursty-mix": lambda s: s.c.generate_tenant_mix(s.c.BURSTY_TENANT_MIX, minutes=3, seed=5),
}


def scaled_mix(side, mix, factor, seed):
    """A tenant mix with every tenant's request count scaled by ``factor``
    (the scheduling runs below stay within seconds)."""
    specs = getattr(side.c, mix)
    return side.c.generate_tenant_mix(
        tuple(dataclasses.replace(t, scale=t.scale * factor) for t in specs), minutes=2,
        seed=seed)


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_traces_match_reference(trace):
    """Both packages draw the same jobs (ids, times, SLOs, ITAs, tenants,
    classes) from the same seed, reading the same calibration file."""
    assert port_trace.CALIBRATION_PATH == ref_trace.CALIBRATION_PATH
    assert plain(port_trace.load_calibration()) == plain(ref_trace.load_calibration())
    ref_jobs_, port_jobs_ = TRACES[trace](REF), TRACES[trace](PORT)
    assert len(ref_jobs_) > 10
    assert plain(port_jobs_) == plain(ref_jobs_)
    assert plain(port_cluster.clone_jobs(port_jobs_)) == plain(ref_cluster.clone_jobs(ref_jobs_))


# -- records and events on seeded runs ------------------------------------------------

HAZARD = dict(crash_rate=30.0, preempt_rate=15.0, slow_rate=15.0, flap_rate=8.0,
              mean_downtime_s=45.0, preempt_lead_s=20.0, flap_period_s=30.0, horizon_s=400.0)


def _fault_plane(side, seed=3, **rates):
    return side.c.FaultPlane(hazard=side.c.HazardConfig(**{**HAZARD, **rates}), seed=seed)


SCENARIOS = {  # id -> side, policy -> (fabric, jobs)
    "2-shards-hash": lambda s, p: (
        s.c.ClusterFabric(s.c.SimConfig(max_gpus=16), p, shards=2, placement="hash"),
        TRACES["low"](s)),
    "3-shards-least-loaded-elastic-tenants": lambda s, p: (
        s.c.ClusterFabric(s.c.SimConfig(max_gpus=24), p, shards=3, placement="least-loaded",
                          elastic=s.c.ElasticConfig(
                              quotas={"acme": s.c.TenantQuota(max_outstanding=4)})),
        scaled_mix(s, "DEFAULT_TENANT_MIX", 0.25, seed=4)),
    "4-shards-elastic-bursty": lambda s, p: (
        s.c.ClusterFabric(s.c.SimConfig(max_gpus=32), p, shards=4,
                          elastic=s.c.ElasticConfig()),
        scaled_mix(s, "BURSTY_TENANT_MIX", 0.2, seed=5)),
    "2-shards-elastic-faults": lambda s, p: (
        s.c.ClusterFabric(s.c.SimConfig(max_gpus=16, checkpoint_interval_s=20.0), p,
                          shards=2, elastic=s.c.ElasticConfig(), faults=_fault_plane(s)),
        s.c.generate_trace(s.c.TraceConfig(load="low", seed=3, minutes=3))),
    "4-shards-faults": lambda s, p: (
        s.c.ClusterFabric(s.c.SimConfig(max_gpus=16), p, shards=4,
                          faults=_fault_plane(s, seed=2)),
        TRACES["low"](s)),
}
COUNTERS = ("steals", "resizes", "rejections", "drains", "quarantines", "sheds", "crashes",
            "preemptions", "warnings", "slowdowns", "recoveries", "retries")


def run_side(side, scenario, policy):
    """(result, events, rejections, counters) of one package's run; each
    event is made plain when it is delivered, with its job's state then."""
    fabric, jobs = SCENARIOS[scenario](side, policy)
    events = []
    fabric.on_event(lambda e: events.append(plain(e)))
    res = fabric.run(side.c.clone_jobs(jobs))
    counters = {(part, k): getattr(obj, k) for part, obj in
                (("controller", fabric.controller), ("faults", fabric.faults))
                if obj is not None for k in COUNTERS if hasattr(obj, k)}
    return res, events, plain(fabric.rejections), counters


@pytest.mark.parametrize("policy", ref_cluster.policies.available())
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_records_and_events_match_reference(scenario, policy):
    assert port_cluster.policies.available() == ref_cluster.policies.available()
    ref_res, ref_events, ref_rej, ref_counts = run_side(REF, scenario, policy)
    res, events, rej, counts = run_side(PORT, scenario, policy)
    key = lambda r: (r.job.job_id, r.start, r.finish, r.gpus, r.violated, r.used_bank,
                     r.job.restarts)
    assert [key(r) for r in res.records] == [key(r) for r in ref_res.records]
    assert plain(res) == plain(ref_res)                 # records, ledgers, util samples
    assert events == ref_events
    assert rej == ref_rej and counts == ref_counts
    assert res.summary() == ref_res.summary()
    assert res.summary_by_tenant() == ref_res.summary_by_tenant()
    assert len(events) > len(res.records)


def test_fault_scenarios_exercise_faults_and_control():
    """The fault and elastic scenarios above are not vacuous."""
    _, events, _, counts = run_side(PORT, "2-shards-elastic-faults", "prompttuner")
    kinds = {e[1][1] for e in events}
    assert {"shard_failed", "shard_recovered", "job_orphaned", "job_retried"} <= kinds, kinds
    assert counts[("faults", "crashes")] > 0 and counts[("faults", "preemptions")] > 0
    assert counts[("controller", "resizes")] > 0
    _, _, _, counts = run_side(PORT, "4-shards-faults", "prompttuner")
    assert counts[("faults", "slowdowns")] > 0
    _, _, rej, _ = run_side(PORT, "3-shards-least-loaded-elastic-tenants", "prompttuner")
    assert rej, "the tenant quota rejected nothing"
    _, events, _, counts = run_side(PORT, "4-shards-elastic-bursty", "prompttuner")
    assert counts[("controller", "steals")] > 0 and counts[("controller", "resizes")] > 0


# -- the hazard schedule's underflowing rate ------------------------------------------

def _schedule(side, shards, seed, **rates):
    return plain(_fault_plane(side, seed=seed, **rates)._hazard_schedule(shards))


TINY = math.ulp(0.0)      # the least positive float: TINY / 3600 underflows to 0


@pytest.mark.parametrize("kind", ["crash_rate", "preempt_rate", "slow_rate", "flap_rate"])
def test_hazard_schedule_skips_an_underflowing_rate(kind):
    assert TINY > 0.0 and TINY / 3600.0 == 0.0
    got = _schedule(PORT, 3, 5, **{kind: TINY})
    assert got == _schedule(REF, 3, 5, **{kind: 0.0})
    assert got != _schedule(REF, 3, 5)                 # the other kinds still fire
    with pytest.raises(ZeroDivisionError):             # the reference's own fault
        _schedule(REF, 3, 5, **{kind: TINY})


def test_fabric_run_with_an_underflowing_rate_matches_reference_at_zero():
    jobs = {s.name: TRACES["low"](s) for s in (REF, PORT)}
    out = {}
    for side, rate in ((REF, 0.0), (PORT, TINY)):
        fab = side.c.ClusterFabric(side.c.SimConfig(max_gpus=16), "prompttuner", shards=2,
                                   elastic=side.c.ElasticConfig(),
                                   faults=_fault_plane(side, seed=2, slow_rate=rate))
        out[side.name] = plain(fab.run(side.c.clone_jobs(jobs[side.name])))
    assert out["port"] == out["reference"]


@settings(max_examples=25, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(min_value=0, max_value=10_000),
       crash=st.floats(min_value=0.0, max_value=40.0),
       preempt=st.floats(min_value=0.0, max_value=20.0),
       slow=st.floats(min_value=0.0, max_value=20.0),
       flap=st.floats(min_value=0.0, max_value=10.0))
def test_hazard_schedule_matches_reference_with_underflow_as_zero(seed, crash, preempt, slow,
                                                                  flap):
    """Any rates: the port's schedule is the reference's with every rate
    whose ``rate / 3600`` underflows set to 0."""
    rates = dict(crash_rate=crash, preempt_rate=preempt, slow_rate=slow, flap_rate=flap)
    as_ref = {k: (r if r / 3600.0 else 0.0) for k, r in rates.items()}
    assert _schedule(PORT, 2, seed, **rates) == _schedule(REF, 2, seed, **as_ref)
