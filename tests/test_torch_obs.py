"""The port's fleet telemetry plane, on the CPU.

``repro_torch.obs`` is a host-only copy of the reference's ``repro.obs``,
so every test of ``tests/test_obs.py`` runs here on the port's objects
(metrics registry semantics, span folding from scripted event sequences,
export round-trips, elastic-decision audit coverage, telemetry on == off,
the service's ``telemetry=``), and seeded runs through both packages are
held to each other exactly: counters, metric rows, timelines, audit
entries, reports and forensics bit for bit, JSONL exports byte for byte,
Chrome traces equal but for ``otherData.source`` (``"repro_torch.obs"``
against ``"repro.obs"``, the one intended difference), and each package
reads the other's export to the same report and forensics.
"""
import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import repro.api as ref_api
import repro.cluster as ref_cluster
import repro.core.jobs as ref_jobs
import repro.core.prompt_bank as ref_pb
import repro.obs as ref_obs
import repro_torch.api as port_api
import repro_torch.cluster as port_cluster
import repro_torch.core.jobs as port_jobs
import repro_torch.core.prompt_bank as port_pb
import repro_torch.obs as port_obs
from test_torch_cluster import plain
from test_torch_service import SERVICES, blob_bank, cosine_factory, request_script

from repro_torch.api import PromptTunerService, SubmitRequest
from repro_torch.cluster import (
    ClusterFabric,
    ElasticConfig,
    JOB_STOLEN,
    SHARD_RESIZED,
    SimConfig,
    TenantQuota,
    TraceConfig,
    clone_jobs,
    generate_tenant_mix,
    generate_trace,
)
from repro_torch.cluster.engine import ARRIVAL, JOB_DONE, EngineEvent
from repro_torch.core.jobs import Job
from repro_torch.obs import (
    AuditLog,
    MetricsRegistry,
    Telemetry,
    TimelineRecorder,
    read_jsonl,
    render_report,
    to_chrome_trace,
    validate_chrome_trace,
    write_jsonl,
)
from repro_torch.obs.spans import INIT, QUEUED, REJECTED, RUNNING


def mk_job(jid, llm="gpt2-base", submit=0.0, slo=600.0, tenant="t0"):
    return Job(job_id=jid, llm=llm, submit_time=submit, slo=slo,
               iters_manual=400, iters_bank=200, tenant=tenant)


# -- metrics registry -------------------------------------------------------------


def test_counter_is_monotone_and_label_keyed():
    reg = MetricsRegistry()
    reg.counter("jobs", shard=0).inc()
    reg.counter("jobs", shard=0).inc(2)
    reg.counter("jobs", shard=1).inc()
    assert reg.value("jobs", shard=0) == 3
    assert reg.value("jobs", shard=1) == 1
    assert reg.value("jobs", shard=9) == 0          # absent series reads 0
    assert reg.total("jobs") == 4
    # label ORDER does not split the series
    reg.counter("pair", a=1, b=2).inc()
    reg.counter("pair", b=2, a=1).inc()
    assert reg.value("pair", a=1, b=2) == 2
    with pytest.raises(ValueError, match="only go up"):
        reg.counter("jobs", shard=0).inc(-1)
    # one name, one kind
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("jobs", shard=0)


def test_gauge_tracks_window_excursion():
    reg = MetricsRegistry(window=10.0)
    g = reg.gauge("depth", shard=0)
    g.set(5)
    g.set(1)
    g.set(3)
    assert g.read() == {"value": 3.0, "min": 1.0, "max": 5.0}
    reg.advance(10.0)                               # rolls the window
    assert g.read() == {"value": 3.0, "min": 3.0, "max": 3.0}
    g.add(-2)
    assert g.read()["value"] == 1.0


def test_histogram_log_buckets_and_quantiles():
    reg = MetricsRegistry()
    h = reg.histogram("wait", shard=0)
    assert h.bucket_index(0.0005) == 0              # <= base
    assert h.bucket_index(0.001) == 0
    assert h.bucket_index(0.002) == 1
    assert h.bucket_index(0.004) == 2
    for v in (0.5, 1.0, 2.0, 4.0, 100.0):
        h.observe(v)
    assert h.count == 5
    assert h.sum == pytest.approx(107.5)
    assert h.min == 0.5 and h.max == 100.0
    assert h.mean == pytest.approx(21.5)
    # quantile returns a bucket upper bound >= the true value, <= max
    assert h.quantile(0.5) >= 1.0
    assert h.quantile(1.0) == 100.0
    assert h.quantile(0.0) == 0.0 or h.quantile(0.0) <= 0.5 * 2
    with pytest.raises(ValueError, match=">= 0"):
        h.observe(-1.0)


def test_windowed_snapshots_and_counter_deltas():
    reg = MetricsRegistry(window=60.0)
    reg.counter("done").inc(2)
    reg.advance(60.0)                # captures [0, 60)
    reg.counter("done").inc(3)
    reg.advance(125.0)               # captures [60, 120)
    reg.counter("done").inc(1)
    reg.close()                      # partial [120, 125]
    assert [(w.start, w.end) for w in reg.windows] == [
        (0.0, 60.0), (60.0, 120.0), (120.0, 125.0)]
    assert [w.series["done"]["value"] for w in reg.windows] == [2, 5, 6]
    assert [d for _, _, d in reg.window_deltas("done")] == [2, 3, 1]
    # a jump across several boundaries captures each one
    reg2 = MetricsRegistry(window=10.0)
    reg2.counter("x").inc()
    reg2.advance(35.0)
    assert len(reg2.windows) == 3


# -- span folding from scripted events --------------------------------------------


def test_span_folding_full_lifecycle():
    rec = TimelineRecorder()
    job = mk_job(7, submit=10.0)
    rec.on_event(EngineEvent(ARRIVAL, 10.0, job, shard=2))
    assert rec.timeline(7).spans[-1].end is None    # open queued span
    job.start_time = 40.0
    job.init_overhead = 5.0
    job.gpus = 2
    job.used_bank = True
    rec.on_event(EngineEvent(JOB_DONE, 100.0, job, shard=2))
    tl = rec.timeline(7)
    assert [(s.phase, s.start, s.end) for s in tl.spans] == [
        (QUEUED, 10.0, 40.0), (INIT, 40.0, 45.0), (RUNNING, 45.0, 100.0)]
    assert tl.shard == 2 and tl.done and tl.finish == 100.0
    assert tl.gpus == 2 and tl.used_bank
    assert tl.violated is False                     # slo=600 from t=10
    assert tl.phase_seconds(QUEUED) == 30.0
    assert rec.timeline(999) is None and len(rec) == 1


def test_span_folding_stolen_job_records_shard_hop():
    rec = TimelineRecorder()
    job = mk_job(3)
    rec.on_event(EngineEvent(ARRIVAL, 0.0, job, shard=0))
    # fabric contract: ev.shard on JOB_STOLEN is the RECEIVER
    rec.on_event(EngineEvent(JOB_STOLEN, 50.0, job, shard=1,
                             detail="shard 0 -> 1"))
    job.start_time = 60.0
    job.init_overhead = 0.0
    job.gpus = 1
    rec.on_event(EngineEvent(JOB_DONE, 90.0, job, shard=1))
    tl = rec.timeline(3)
    assert [(h.src, h.dst, h.time) for h in tl.hops] == [(0, 1, 50.0)]
    assert [(s.phase, s.shard, s.start, s.end) for s in tl.spans] == [
        (QUEUED, 0, 0.0, 50.0), (QUEUED, 1, 50.0, 60.0),
        (RUNNING, 1, 60.0, 90.0)]
    assert tl.phase_seconds(QUEUED) == 60.0         # both queued stints


def test_span_folding_rejection_and_roundtrip_dict():
    from repro_torch.cluster.elastic import JOB_REJECTED
    from repro_torch.obs.spans import JobTimeline
    rec = TimelineRecorder()
    rec.on_event(EngineEvent(JOB_REJECTED, 5.0, mk_job(1, submit=5.0),
                             shard=-1, detail="cost cap"))
    tl = rec.timeline(1)
    assert tl.reject_reason == "cost cap" and not tl.done
    assert tl.spans[0].phase == REJECTED and tl.spans[0].duration == 0.0
    back = JobTimeline.from_dict(tl.to_dict())
    assert back.to_dict() == tl.to_dict()


# -- live fabric integration ------------------------------------------------------


def _stealable_fabric():
    return ClusterFabric(SimConfig(max_gpus=8), "prompttuner", shards=2,
                         elastic=ElasticConfig())


def test_telemetry_counters_match_fabric_ground_truth():
    fab = _stealable_fabric()
    events = []
    fab.on_event(events.append)
    tel = Telemetry(window=30.0).attach(fab)
    jobs = [mk_job(i) for i in range(12)]
    res = fab.run(clone_jobs(jobs))
    c = tel.summary_counters()
    assert c["jobs_submitted"] == len(jobs)
    assert c["jobs_completed"] == len(res.records)
    assert c["steals"] == fab.controller.steals > 0
    # the counter counts SHARD_RESIZED events (donor shrink + receiver
    # grow each emit one); controller.resizes counts transfers
    assert c["resizes"] == len([e for e in events
                                if e.kind == SHARD_RESIZED])
    assert c["rounds"] > 0
    # a stolen job's recorded hop matches the event stream
    hopped = [tl for tl in tel.timeline.timelines().values() if tl.hops]
    assert len(hopped) == fab.controller.steals
    # double-attach is loud
    with pytest.raises(ValueError, match="already attached"):
        tel.attach(fab)


def test_audit_carries_shard_health_for_every_elastic_decision():
    # steals: the textbook 2-shard strand; resizes + rejections: the
    # bursty mix under a tight cost cap
    fab = _stealable_fabric()
    events = []
    fab.on_event(events.append)
    tel = Telemetry().attach(fab)
    fab.run(clone_jobs([mk_job(i) for i in range(12)]))

    fab2 = ClusterFabric(SimConfig(max_gpus=16), "prompttuner", shards=2,
                         elastic=ElasticConfig(quotas={
                             "initech": TenantQuota(cost_usd=2.0)}))
    events2 = []
    fab2.on_event(events2.append)
    tel2 = Telemetry().attach(fab2)
    fab2.run(generate_tenant_mix(minutes=6, seed=0))

    for evs, audit in ((events, tel.audit), (events2, tel2.audit)):
        for kind in (JOB_STOLEN, SHARD_RESIZED):
            stream = [e for e in evs if e.kind == kind]
            logged = audit.query(action=kind)
            assert len(stream) == len(logged)
            for e, a in zip(stream, logged):
                assert a.time == e.time and a.shard == e.shard
                assert a.inputs, f"{kind} audit entry missing inputs"
                for h in a.inputs.values():
                    assert {"pressure", "free_capacity", "pending_jobs"
                            } <= set(h)
    assert len(tel.audit.query(action=JOB_STOLEN)) > 0
    assert len(tel2.audit.query(action=SHARD_RESIZED)) > 0
    # rejections carry the whole fleet's health
    rejected = tel2.audit.query(action="job_rejected")
    assert len(rejected) == len(fab2.rejections) > 0
    assert all(len(a.inputs) == 2 for a in rejected)
    # explain() surfaces the nearest decisions around a time
    t = tel2.audit.query(action=SHARD_RESIZED)[0].time
    assert any(e.action == SHARD_RESIZED
               for e in tel2.audit.explain(shard=tel2.audit.query(
                   action=SHARD_RESIZED)[0].shard, t=t))


# -- exports ----------------------------------------------------------------------


def _recorded_run(tmp_path=None):
    fab = _stealable_fabric()
    tel = Telemetry(window=30.0).attach(fab)
    fab.run(clone_jobs([mk_job(i) for i in range(12)]))
    return fab, tel


def test_chrome_trace_is_valid_and_contains_hops():
    fab, tel = _recorded_run()
    tel.metrics.close()
    doc = to_chrome_trace(tel.timeline, tel.metrics, tel.audit,
                          shards=len(fab.shards))
    assert validate_chrome_trace(doc) == []
    json.dumps(doc)                                 # serializable
    phases = {e["ph"] for e in doc["traceEvents"]}
    assert {"X", "M"} <= phases
    assert "i" in phases                            # steal instants
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert all(e["dur"] >= 0 for e in xs)
    names = {e["name"] for e in xs}
    assert {"queued", "running"} <= names
    # corruption is caught
    bad = {"traceEvents": [{"ph": "X", "name": "x", "ts": 1, "pid": 0,
                            "tid": 0, "dur": -5}]}
    assert validate_chrome_trace(bad)


def test_jsonl_round_trip_renders_identical_report(tmp_path):
    _fab, tel = _recorded_run()
    tel.metrics.close()
    path = write_jsonl(str(tmp_path / "run.jsonl"), tel.timeline,
                       tel.metrics, tel.audit)
    loaded = read_jsonl(path)
    assert len(loaded["timelines"]) == len(tel.timeline)
    assert len(loaded["audit"]) == len(tel.audit.entries)
    live = render_report(tel.timeline, tel.metrics.to_dicts(), bucket=30.0)
    replay = render_report(loaded["timelines"], loaded["metrics"],
                           bucket=30.0)
    assert replay == live
    # audit entries survive with their health inputs intact
    by_action = {}
    for a in loaded["audit"]:
        by_action.setdefault(a.action, []).append(a)
    assert set(by_action) == {a.action for a in tel.audit.entries}
    for a in by_action.get(JOB_STOLEN, []):
        assert "src" in a.inputs and "pressure" in a.inputs["src"]


# -- recording must not perturb the simulation ------------------------------------


def test_results_identical_with_telemetry_on_and_off():
    """shards=1 + telemetry attached must stay float-for-float identical
    to the bare run — recording rides the event stream only."""
    jobs = generate_trace(TraceConfig(load="medium", seed=0, minutes=5))
    base = ClusterFabric(SimConfig(max_gpus=16), "prompttuner",
                         shards=1).run(clone_jobs(jobs)).summary()
    fab = ClusterFabric(SimConfig(max_gpus=16), "prompttuner", shards=1)
    tel = Telemetry().attach(fab)
    got = fab.run(clone_jobs(jobs)).summary()
    assert got == base                              # exact, not approx
    assert tel.summary_counters()["jobs_completed"] == len(jobs)
    # elastic multi-shard runs are deterministic under observation too
    e1 = _stealable_fabric().run(
        clone_jobs([mk_job(i) for i in range(12)])).summary()
    fab2 = _stealable_fabric()
    Telemetry().attach(fab2)
    e2 = fab2.run(clone_jobs([mk_job(i) for i in range(12)])).summary()
    assert e1 == e2


# -- service surface --------------------------------------------------------------


def test_service_telemetry_kwarg_and_handle_timeline():
    svc = PromptTunerService(SimConfig(max_gpus=8), telemetry=True)
    assert isinstance(svc.telemetry, Telemetry)
    hs = [svc.submit(SubmitRequest(task_id=f"t{i}", llm="gpt2-base",
                                   slo=600.0, iters_manual=400,
                                   iters_bank=120, submit_time=float(i)))
          for i in range(4)]
    svc.run_until_idle()
    tl = hs[0].timeline()
    assert tl.done and {s.phase for s in tl.spans} >= {QUEUED, RUNNING}
    assert "attainment" in svc.report()
    # off by default: handles raise a pointed error
    svc2 = PromptTunerService(SimConfig(max_gpus=8))
    assert svc2.telemetry is None
    h = svc2.submit(SubmitRequest(task_id="x", llm="gpt2-base", slo=600.0,
                                  iters_manual=400, iters_bank=120))
    with pytest.raises(ValueError, match="telemetry=True"):
        h.timeline()
    with pytest.raises(ValueError, match="telemetry=True"):
        svc2.report()
    # a pre-attached Telemetry on a different fabric is rejected
    other = ClusterFabric(SimConfig(max_gpus=8), "prompttuner", shards=1)
    stray = Telemetry().attach(other)
    with pytest.raises(ValueError, match="different fabric"):
        PromptTunerService(SimConfig(max_gpus=8), telemetry=stray)


# -- the port against the reference, exactly ----------------------------------------

REF = SimpleNamespace(api=ref_api, c=ref_cluster, jobs=ref_jobs, obs=ref_obs, pb=ref_pb,
                      name="reference", source="repro.obs")
PORT = SimpleNamespace(api=port_api, c=port_cluster, jobs=port_jobs, obs=port_obs, pb=port_pb,
                       name="port", source="repro_torch.obs")


def side_job(side, jid):
    return side.jobs.Job(job_id=jid, llm="gpt2-base", submit_time=0.0, slo=600.0,
                         iters_manual=400, iters_bank=200, tenant="t0")


RUNS = {  # id -> side -> (fabric, jobs, un-attached Telemetry)
    "medium-one-shard": lambda s: (
        s.c.ClusterFabric(s.c.SimConfig(max_gpus=16), "prompttuner", shards=1),
        s.c.generate_trace(s.c.TraceConfig(load="medium", seed=0, minutes=5)),
        s.obs.Telemetry()),
    "stealable-elastic": lambda s: (
        s.c.ClusterFabric(s.c.SimConfig(max_gpus=8), "prompttuner", shards=2,
                          elastic=s.c.ElasticConfig()),
        [side_job(s, i) for i in range(12)],
        s.obs.Telemetry(window=30.0)),
    "fault-plane-mixed": lambda s: (
        s.c.ClusterFabric(s.c.SimConfig(max_gpus=8, checkpoint_interval_s=30.0),
                          "prompttuner", shards=2, elastic=s.c.ElasticConfig(),
                          faults=s.c.FaultPlane(hazard=s.c.CHAOS_PROFILES["mixed"], seed=3)),
        s.c.generate_trace(s.c.TraceConfig(load="medium", seed=3, minutes=4)),
        s.obs.Telemetry()),
    "alert-rules-bursty-faults": lambda s: (
        s.c.ClusterFabric(s.c.SimConfig(max_gpus=16, checkpoint_interval_s=30.0,
                                        checkpoint_min_compute_s=180.0),
                          "prompttuner", shards=2, elastic=s.c.ElasticConfig(),
                          faults=s.c.FaultPlane(hazard=s.c.CHAOS_PROFILES["mixed"], seed=0)),
        s.c.generate_tenant_mix(s.c.BURSTY_TENANT_MIX, minutes=10, seed=0),
        s.obs.Telemetry(alerts=s.obs.AlertRules())),
}


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """(side, run id) -> that package's run with telemetry attached, its
    exports (written under a temporary directory) and its reads, each
    made once for the module."""
    cache = {}

    def get(side, run):
        if (side.name, run) not in cache:
            fabric, jobs, tel = RUNS[run](side)
            tel.attach(fabric)
            res = fabric.run(side.c.clone_jobs(jobs))
            out = tmp_path_factory.mktemp(f"{side.name}-{run}")
            cache[side.name, run] = SimpleNamespace(
                res=res, tel=tel, report=tel.report(), forensics=tel.forensics(),
                trace=Path(tel.export_chrome_trace(str(out / "run.trace.json"))),
                jsonl=Path(tel.export_jsonl(str(out / "run.jsonl"))),
                alerts=[] if tel.alerts is None else
                [(h.time, h.kind, h.rule, h.detail) for h in tel.alerts.history])
        return cache[side.name, run]
    return get


def trace_without_source(path, source):
    doc = json.loads(path.read_text())
    assert doc["otherData"].pop("source") == source
    return doc


@pytest.mark.parametrize("run", sorted(RUNS))
def test_telemetry_matches_reference_exactly(recorded, run):
    ref, port = recorded(REF, run), recorded(PORT, run)
    assert port.res.summary() == ref.res.summary()
    assert plain(port.res.records) == plain(ref.res.records)
    assert plain(port.tel.summary_counters()) == plain(ref.tel.summary_counters())
    assert plain(list(port.tel.metrics.to_dicts())) == plain(list(ref.tel.metrics.to_dicts()))
    assert plain(port.tel.timeline.to_dicts()) == plain(ref.tel.timeline.to_dicts())
    assert plain(port.tel.audit.to_dicts()) == plain(ref.tel.audit.to_dicts())
    assert port.report == ref.report
    assert plain(port.forensics.to_dict()) == plain(ref.forensics.to_dict())
    assert port.forensics.render() == ref.forensics.render()
    assert plain(port.alerts) == plain(ref.alerts)
    assert port.jsonl.read_bytes() == ref.jsonl.read_bytes()
    assert plain(trace_without_source(port.trace, PORT.source)) == \
        plain(trace_without_source(ref.trace, REF.source))


def test_parity_runs_are_not_vacuous(recorded):
    """Each run of the comparison above exercises what it is named for."""
    c = {run: recorded(PORT, run).tel.summary_counters() for run in RUNS}
    assert c["medium-one-shard"]["jobs_completed"] > 50
    assert c["stealable-elastic"]["steals"] > 0
    assert c["fault-plane-mixed"]["shard_failures"] > 0
    assert recorded(PORT, "fault-plane-mixed").forensics.violated > 0
    assert c["alert-rules-bursty-faults"]["alerts_fired"] > 0
    assert c["alert-rules-bursty-faults"]["alerts_resolved"] > 0


@pytest.mark.parametrize("reader,writer", [(REF, PORT), (PORT, REF)],
                         ids=["reference-reads-port", "port-reads-reference"])
@pytest.mark.parametrize("run", sorted(RUNS))
def test_each_package_reads_the_others_export(recorded, run, reader, writer):
    """The other package's JSONL export renders the writer's live report
    and forensics; its Chrome trace validates; its alert rules replay to
    the same transitions at the same simulated times."""
    rec = recorded(writer, run)
    loaded = reader.obs.read_jsonl(str(rec.jsonl))
    window = rec.tel.metrics.window
    assert reader.obs.render_report(loaded["timelines"], loaded["metrics"],
                                    bucket=window) == rec.report
    offline = reader.obs.analyze(loaded["timelines"], loaded["audit"])
    assert plain(offline.to_dict()) == plain(rec.forensics.to_dict())
    assert reader.obs.validate_chrome_trace_file(str(rec.trace)) == []
    if rec.alerts:
        replayed = reader.obs.AlertRules().replay(
            loaded["timelines"], loaded["metrics"], loaded["audit"], window=window)
        assert plain([(h.time, h.kind, h.rule, h.detail) for h in replayed]) == \
            plain(rec.alerts)


# -- the service with telemetry, on and off and against the reference ----------------


def serve(side, service_id, telemetry):
    """The request script of ``tests/test_torch_service.py`` through one
    package's service; its records, summary and handles."""
    bank, _ = blob_bank(side)
    svc = SERVICES[service_id](side, bank, cosine_factory(side), telemetry=telemetry)
    handles = []
    for reqs in request_script(blob_bank(REF)[1]):
        handles += [svc.submit(side.api.SubmitRequest(**f)) for f in reqs]
        svc.run_until_idle()
    key = lambda r: (r.job.job_id, r.start, r.finish, r.gpus, r.violated)  # noqa: E731
    return svc, handles, plain([key(r) for r in svc.sim_result().records]), plain(svc.summary())


@pytest.mark.parametrize("service_id", sorted(SERVICES))
def test_service_telemetry_matches_reference_and_perturbs_nothing(service_id):
    got = {}
    for side in (REF, PORT):
        svc, handles, records, summary = serve(side, service_id, True)
        _, _, records_off, summary_off = serve(side, service_id, None)
        assert records == records_off and summary == summary_off
        tel = svc.telemetry
        got[side.name] = dict(
            records=records, summary=summary, report=svc.report(),
            forensics=plain(svc.forensics_report().to_dict()),
            counters=plain(tel.summary_counters()),
            metrics=plain(list(tel.metrics.to_dicts())),
            audit=plain(tel.audit.to_dicts()),
            timelines=plain([h.timeline().to_dict() for h in handles if not h.rejected]))
        assert all(h.timeline().done for h in handles if not h.rejected)
    for key in got["reference"]:
        assert got["port"][key] == got["reference"][key], key
