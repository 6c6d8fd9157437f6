"""The port's SLO forensics and alert rules, on the CPU.

Every test of ``tests/test_forensics.py`` runs here on the port's objects:
scripted attribution units, the reconciliation invariant (blame sums to
overrun) under the chaos profiles and random fault schedules, determinism,
offline == live, and alert replay at identical simulated times. Seeded runs
through both packages are held to each other exactly in
``tests/test_torch_obs.py``.
"""
import json
import math

import pytest

from _hypothesis_compat import given, settings, st
from repro_torch.cluster import (
    BURSTY_TENANT_MIX,
    CHAOS_PROFILES,
    ClusterFabric,
    ElasticConfig,
    FaultPlane,
    HazardConfig,
    SimConfig,
    TraceConfig,
    clone_jobs,
    generate_tenant_mix,
    generate_trace,
)
from repro_torch.cluster.elastic import ALERT_FIRED, ALERT_RESOLVED, JOB_STOLEN
from repro_torch.cluster.engine import JOB_DONE, EngineEvent
from repro_torch.cluster.faults import SHARD_SLOWED
from repro_torch.core.jobs import Job
from repro_torch.obs import (
    CAUSES,
    AlertRule,
    AlertRules,
    Telemetry,
    analyze,
    read_jsonl,
)
from repro_torch.obs.alerts import BURN_RATE, QUARANTINE_COUNT, QUEUE_PRESSURE
from repro_torch.obs.audit import AuditEntry
from repro_torch.obs.forensics import EXEC
from repro_torch.obs.spans import INIT, QUEUED, RUNNING, JobTimeline, ShardHop, Span


def mk_tl(job_id=0, submit=0.0, deadline=100.0, violated=True,
          shed_reason=None):
    return JobTimeline(job_id=job_id, task_id="t", llm="gpt2-base",
                       tenant="t0", slo_class="standard",
                       submit_time=submit, deadline=deadline,
                       violated=violated, shed_reason=shed_reason)


def span(tl, phase, shard, start, end, truncated=False):
    tl.spans.append(Span(job_id=tl.job_id, phase=phase, shard=shard,
                         start=start, end=end, truncated=truncated))


# -- scripted attribution units ----------------------------------------------


def test_queue_wait_blame_on_late_completion():
    """50s queued + 10s init + 70s exec vs a 100s deadline: the 30s
    overrun lands on queue_wait (exec and cold_start consume the
    allowance first)."""
    tl = mk_tl(deadline=100.0)
    span(tl, QUEUED, 0, 0.0, 50.0)
    span(tl, INIT, 0, 50.0, 60.0)
    span(tl, RUNNING, 0, 60.0, 130.0)
    rep = analyze([tl])
    jb = rep.job(0)
    assert jb.seconds["queue_wait"] == pytest.approx(50.0)
    assert jb.seconds["cold_start"] == pytest.approx(10.0)
    assert jb.seconds[EXEC] == pytest.approx(70.0)
    assert jb.overrun_s == pytest.approx(30.0)
    assert jb.blame["queue_wait"] == pytest.approx(30.0)
    assert sum(jb.blame.values()) == pytest.approx(jb.overrun_s)
    assert jb.primary_cause == "queue_wait"
    assert rep.totals["queue_wait"] == pytest.approx(30.0)


def test_steal_splits_placement_and_landing_cost_and_indicts():
    """Queued time before a steal indicts the placement; queued time
    after landing is the hop's cost — and the blamed placement seconds
    point at the audit decision that moved the job."""
    tl = mk_tl(deadline=50.0)
    span(tl, QUEUED, 0, 0.0, 20.0)
    tl.hops.append(ShardHop(job_id=0, time=20.0, src=0, dst=1,
                            kind="steal"))
    span(tl, QUEUED, 1, 20.0, 30.0)
    span(tl, INIT, 1, 30.0, 35.0)
    span(tl, RUNNING, 1, 35.0, 200.0)
    audit = [AuditEntry(time=20.0, action=JOB_STOLEN, shard=1, job_id=0,
                        detail="steal 0->1")]
    rep = analyze([tl], audit)
    jb = rep.job(0)
    assert jb.seconds["placement"] == pytest.approx(20.0)
    assert jb.seconds["steal_hop"] == pytest.approx(10.0)
    assert sum(jb.blame.values()) == pytest.approx(jb.overrun_s)
    assert jb.blame["placement"] == pytest.approx(20.0)
    assert jb.indicts is not None and jb.indicts["action"] == JOB_STOLEN


def test_crash_rework_and_retry_backoff():
    """Truncated spans are thrown-away work; the gap to the retry
    re-entry is the recovery policy's backoff."""
    tl = mk_tl(deadline=70.0)
    span(tl, QUEUED, 0, 0.0, 10.0)
    span(tl, INIT, 0, 10.0, 15.0, truncated=True)
    span(tl, RUNNING, 0, 15.0, 40.0, truncated=True)
    tl.hops.append(ShardHop(job_id=0, time=50.0, src=0, dst=1,
                            kind="retry"))
    span(tl, QUEUED, 1, 50.0, 55.0)       # gap 40-50 = backoff
    span(tl, INIT, 1, 55.0, 60.0)
    span(tl, RUNNING, 1, 60.0, 120.0)
    rep = analyze([tl])
    jb = rep.job(0)
    assert jb.seconds["crash_rework"] == pytest.approx(30.0)
    assert jb.seconds["retry_backoff"] == pytest.approx(10.0)
    # a retry hop's landing queue is plain queue_wait, not steal_hop
    assert jb.seconds["steal_hop"] == 0.0
    assert jb.seconds["queue_wait"] == pytest.approx(15.0)
    assert jb.overrun_s == pytest.approx(50.0)
    assert sum(jb.blame.values()) == pytest.approx(50.0)
    assert jb.blame["crash_rework"] == pytest.approx(30.0)
    assert jb.blame["retry_backoff"] == pytest.approx(10.0)


def test_slowdown_tax_rebuilt_from_audited_factor():
    """A shard_slowed audit entry (factor in inputs) splits the final
    attempt into nominal exec + straggler tax."""
    tl = mk_tl(deadline=30.0)
    span(tl, QUEUED, 0, 0.0, 10.0)
    span(tl, INIT, 0, 10.0, 20.0)
    span(tl, RUNNING, 0, 20.0, 60.0)
    audit = [AuditEntry(time=0.0, action=SHARD_SLOWED, shard=0,
                        inputs={"factor": 2.0})]
    rep = analyze([tl], audit)
    jb = rep.job(0)
    # attempt wall = 50s at x2 => 25s tax, 15s nominal running
    assert jb.seconds["slowdown"] == pytest.approx(25.0)
    assert jb.seconds[EXEC] == pytest.approx(15.0)
    assert sum(jb.blame.values()) == pytest.approx(jb.overrun_s)
    assert jb.primary_cause == "slowdown"
    # without the audit log the seconds stay in exec, invariant intact
    jb2 = analyze([tl]).job(0)
    assert jb2.seconds["slowdown"] == 0.0
    assert sum(jb2.blame.values()) == pytest.approx(jb2.overrun_s)


def test_shed_job_blames_entire_observed_lifecycle():
    """A shed job has no finish: every observed second is blamed, even
    when the shed instant precedes the deadline."""
    tl = mk_tl(deadline=500.0, shed_reason="best-effort shed")
    span(tl, QUEUED, 0, 0.0, 80.0, truncated=True)
    rep = analyze([tl])
    jb = rep.job(0)
    assert jb.shed and rep.shed == 1 and rep.completed_late == 0
    assert jb.overrun_s == pytest.approx(80.0)
    assert jb.blame["queue_wait"] == pytest.approx(80.0)


def test_non_violated_and_rejected_jobs_are_excluded():
    ok = mk_tl(job_id=1, violated=False)
    span(ok, RUNNING, 0, 0.0, 10.0)
    rej = mk_tl(job_id=2, violated=None)
    rej.reject_reason = "quota"
    assert analyze([ok, rej]).violated == 0


# -- reconciliation under chaos ----------------------------------------------


def _chaos_run(profile, seed, *, elastic=True):
    jobs = generate_trace(TraceConfig(load="medium", seed=seed, minutes=4))
    faults = FaultPlane(hazard=CHAOS_PROFILES[profile], seed=seed)
    fab = ClusterFabric(
        SimConfig(max_gpus=8, checkpoint_interval_s=30.0), "prompttuner",
        shards=2, elastic=ElasticConfig() if elastic else None,
        faults=faults)
    tel = Telemetry().attach(fab)
    fab.run(clone_jobs(jobs))
    return tel


def _assert_reconciles(rep):
    assert rep.violated > 0, "chaos run produced nothing to blame"
    for jb in rep.jobs:
        assert sum(jb.blame.values()) == pytest.approx(jb.overrun_s,
                                                       abs=1e-6)
        assert sum(jb.seconds.values()) == pytest.approx(
            jb.end - jb.start, abs=1e-6)
        for v in jb.blame.values():
            assert v >= -1e-9


@pytest.mark.parametrize("profile", sorted(CHAOS_PROFILES))
def test_forensics_deterministic_and_reconciles(profile):
    """Same seed + profile => byte-identical report; every job's blame
    sums to its measured overrun."""
    a = _chaos_run(profile, seed=3).forensics()
    b = _chaos_run(profile, seed=3).forensics()
    dump = lambda r: json.dumps(r.to_dict(), sort_keys=True)  # noqa: E731
    assert dump(a) == dump(b)
    _assert_reconciles(a)


def test_forensics_offline_matches_live(tmp_path):
    """analyze() over a reloaded JSONL export reproduces the live
    report byte-for-byte."""
    tel = _chaos_run("mixed", seed=0)
    live = tel.forensics()
    path = tel.export_jsonl(str(tmp_path / "run.jsonl"))
    loaded = read_jsonl(path)
    offline = analyze(loaded["timelines"], loaded["audit"])
    assert json.dumps(live.to_dict(), sort_keys=True, default=float) == \
        json.dumps(offline.to_dict(), sort_keys=True, default=float)


def _assert_blame_reconciles_under(seed, crash, preempt, slow):
    jobs = generate_trace(TraceConfig(load="medium", seed=seed % 7,
                                      minutes=3))
    hz = HazardConfig(crash_rate=crash, preempt_rate=preempt,
                      slow_rate=slow, flap_rate=8.0,
                      mean_downtime_s=45.0, preempt_lead_s=20.0,
                      flap_period_s=30.0, horizon_s=400.0)
    faults = FaultPlane(hazard=hz, seed=seed)
    fab = ClusterFabric(
        SimConfig(max_gpus=8, checkpoint_interval_s=20.0), "prompttuner",
        shards=2, elastic=ElasticConfig(), faults=faults)
    tel = Telemetry().attach(fab)
    fab.run(clone_jobs(jobs))
    rep = tel.forensics()
    for jb in rep.jobs:
        assert sum(jb.blame.values()) == pytest.approx(jb.overrun_s,
                                                       abs=1e-6)
        assert sum(jb.seconds.values()) == pytest.approx(
            jb.end - jb.start, abs=1e-6)


@settings(max_examples=8, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(min_value=0, max_value=10_000),
       crash=st.floats(min_value=0.0, max_value=40.0),
       preempt=st.floats(min_value=0.0, max_value=20.0),
       slow=st.floats(min_value=0.0, max_value=20.0))
def test_blame_sums_to_overrun_under_random_fault_schedules(
        seed, crash, preempt, slow):
    """The reconciliation invariant holds across arbitrary seeded
    hazard schedules — crashes, preemptions, slowdowns, flaps. The one
    intended difference from the reference: a subnormal rate (whose
    ``rate / 3600`` underflows to 0) passes here, because the port's
    ``FaultPlane._hazard_schedule`` skips it where the reference divides
    by zero; the next test pins that case."""
    _assert_blame_reconciles_under(seed, crash, preempt, slow)


@pytest.mark.parametrize("kind", ["crash", "preempt", "slow"])
def test_blame_sums_to_overrun_at_a_subnormal_rate(kind):
    """The reference's falsifying example (one rate the least positive
    float, the others 0) reconciles in the port."""
    rates = dict(crash=0.0, preempt=0.0, slow=0.0)
    rates[kind] = math.ulp(0.0)
    _assert_blame_reconciles_under(0, **rates)


# -- alert rules --------------------------------------------------------------


def test_alert_rule_validation():
    with pytest.raises(ValueError, match="interval"):
        AlertRules(interval=0.0)
    with pytest.raises(ValueError, match="duplicate"):
        AlertRules([AlertRule("a", BURN_RATE, 2.0),
                    AlertRule("a", QUEUE_PRESSURE, 2.0)])
    with pytest.raises(ValueError, match="unknown rule kind"):
        AlertRules([AlertRule("a", "nope", 2.0)])


def _done(t, job_id, slo):
    job = Job(job_id=job_id, llm="gpt2-base", submit_time=0.0, slo=slo,
              iters_manual=10, iters_bank=10)
    return EngineEvent(kind=JOB_DONE, time=t, job=job, shard=0)


def test_burn_rate_fires_and_resolves():
    """All-violating completions push both windows over threshold; a
    stream of on-time completions brings the short window back down."""
    rules = AlertRules([AlertRule("burn", BURN_RATE, threshold=2.0,
                                  short_s=60.0, long_s=300.0,
                                  target_attainment=0.90)], interval=15.0)
    emitted = []
    rules.bind(emit=emitted.append)
    for i in range(5):
        rules.on_event(_done(10.0 + i, job_id=i, slo=1.0))    # violated
    rules.on_event(_done(30.0, job_id=99, slo=1000.0))
    assert [h.kind for h in rules.history] == [ALERT_FIRED]
    assert rules.history[0].time == pytest.approx(15.0)
    for i in range(40):
        rules.on_event(_done(100.0 + 2 * i, job_id=100 + i, slo=1000.0))
    assert [h.kind for h in rules.history] == [ALERT_FIRED, ALERT_RESOLVED]
    assert rules.active["burn"] is False
    assert [e.kind for e in emitted] == [h.kind for h in rules.history]


def test_quarantine_rule_counts_audit_decisions():
    from repro_torch.cluster.elastic import QUARANTINE

    rules = AlertRules([AlertRule("q", QUARANTINE_COUNT, threshold=2.0,
                                  window_s=100.0)], interval=10.0)

    class FakeAudit:
        entries = [AuditEntry(time=5.0, action=QUARANTINE, shard=0),
                   AuditEntry(time=8.0, action=QUARANTINE, shard=1)]

    rules.bind(audit=FakeAudit())
    rules.on_event(EngineEvent(kind="round", time=12.0, shard=0))
    assert [h.kind for h in rules.history] == [ALERT_FIRED]
    assert rules.history[0].time == pytest.approx(10.0)


def test_controller_tracks_active_alerts():
    """ALERT_* events on the bus land in the controller's active set
    (the hook a future SLO autotuner subscribes through)."""
    fab = ClusterFabric(SimConfig(max_gpus=8), "prompttuner", shards=2,
                        elastic=ElasticConfig())
    fab.announce(EngineEvent(kind=ALERT_FIRED, time=5.0, shard=-1,
                             detail="slo-burn: over budget"))
    assert fab.controller.active_alerts == {"slo-burn": 5.0}
    fab.announce(EngineEvent(kind=ALERT_RESOLVED, time=9.0, shard=-1,
                             detail="slo-burn: back under"))
    assert fab.controller.active_alerts == {}


def test_alert_replay_fires_at_identical_sim_times(tmp_path):
    """Replaying the rules from the exported JSONL reproduces the live
    (time, kind, rule) transition list exactly."""
    jobs = generate_tenant_mix(BURSTY_TENANT_MIX, minutes=10, seed=0)
    faults = FaultPlane(hazard=CHAOS_PROFILES["mixed"], seed=0)
    fab = ClusterFabric(
        SimConfig(max_gpus=16, checkpoint_interval_s=30.0,
                  checkpoint_min_compute_s=180.0), "prompttuner",
        shards=2, elastic=ElasticConfig(), faults=faults)
    alerts = AlertRules()
    tel = Telemetry(alerts=alerts).attach(fab)
    fab.run(clone_jobs(jobs))
    assert alerts.history, "run produced no alerts — pick a harsher mix"
    assert tel.summary_counters()["alerts_fired"] == sum(
        1 for h in alerts.history if h.kind == ALERT_FIRED)

    path = tel.export_jsonl(str(tmp_path / "run.jsonl"))
    loaded = read_jsonl(path)
    replayed = AlertRules().replay(
        loaded["timelines"], loaded["metrics"], loaded["audit"],
        window=tel.metrics.window)
    assert [(h.time, h.kind, h.rule) for h in replayed] == \
        [(h.time, h.kind, h.rule) for h in alerts.history]


def test_alerts_off_by_default_is_inert():
    """Telemetry without AlertRules never emits alert events and the
    run's results stay bit-identical (pinned more broadly in
    test_obs; this guards the counter surface)."""
    tel = _chaos_run("mixed", seed=1)
    c = tel.summary_counters()
    assert c["alerts_fired"] == 0.0 and c["alerts_resolved"] == 0.0


# -- report surface -----------------------------------------------------------


def test_render_mentions_every_cause():
    tel = _chaos_run("mixed", seed=0)
    text = tel.forensics().render()
    for c in CAUSES:
        assert c in text
    assert "violated jobs" in text


def test_cause_shares_sum_to_one_when_any_blame():
    rep = _chaos_run("mixed", seed=0).forensics()
    shares = rep.cause_shares()
    assert sum(shares.values()) == pytest.approx(1.0)
    assert set(shares) == set(CAUSES) | {EXEC}
