"""Fleet telemetry plane: metrics, span timelines, traces, audit.

:class:`Telemetry` is the one-call wiring for the whole observability
subsystem::

    tel = Telemetry(window=30.0)
    fab = ClusterFabric(cfg, "prompttuner", shards=8, elastic=ElasticConfig())
    tel.attach(fab)
    fab.run(jobs)
    print(tel.report())                       # SLO-attainment time series
    tel.export_chrome_trace("run.trace.json") # open in ui.perfetto.dev
    tel.export_jsonl("run.jsonl")             # offline analysis

It subscribes one callback to the fabric's existing typed event stream
(``on_event``) and passively derives everything from it:

* **metrics** (:class:`~repro_torch.obs.metrics.MetricsRegistry`) — engine
  rounds / queue depth / warm-vs-cold starts, per-shard/per-tenant
  throughput and placement outcomes, elastic steals / resizes /
  rejections, and :class:`~repro_torch.cluster.health.ShardHealth` pressure
  and slack sampled as gauges each scheduler round;
* **span timelines** (:class:`~repro_torch.obs.spans.TimelineRecorder`) —
  per-job submitted → queued → init → running → done lifecycles with
  shard hops, exportable as Chrome-trace/Perfetto JSON;
* **audit log** (:class:`~repro_torch.obs.audit.AuditLog`) — attached to the
  fabric's :class:`~repro_torch.cluster.elastic.ElasticController` so every
  steal / resize / rejection / reclaim records the ShardHealth inputs
  it acted on.

Recording is strictly opt-in: nothing subscribes until
:meth:`Telemetry.attach`, so an un-instrumented run takes the engine's
``if not self._subscribers: return`` fast path and produces
float-for-float identical results (pinned by ``tests/test_obs.py``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.cluster.elastic import (
    ALERT_FIRED,
    ALERT_RESOLVED,
    JOB_REJECTED,
    JOB_STOLEN,
    SHARD_RESIZED,
)
from repro_torch.cluster.engine import ARRIVAL, JOB_DONE, ROUND, EngineEvent
from repro_torch.cluster.faults import (
    JOB_ORPHANED,
    JOB_RETRIED,
    JOB_SHED,
    SHARD_FAILED,
    SHARD_RECOVERED,
    SHARD_SLOWED,
    SHARD_WARNED,
)
from repro_torch.cluster.health import shard_health

from repro_torch.obs.alerts import (
    DEFAULT_RULES,
    AlertEvent,
    AlertRule,
    AlertRules,
)
from repro_torch.obs.audit import AuditEntry, AuditLog, health_dict
from repro_torch.obs.export import (
    read_jsonl,
    to_chrome_trace,
    validate_chrome_trace,
    validate_chrome_trace_file,
    write_chrome_trace,
    write_jsonl,
)
from repro_torch.obs.forensics import (
    CAUSES,
    ForensicsReport,
    JobBlame,
    analyze,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    WindowSnapshot,
)
from repro_torch.obs.report import render_report, report_rows
from repro_torch.obs.spans import JobTimeline, ShardHop, Span, TimelineRecorder

__all__ = [
    "ALERT_FIRED",
    "ALERT_RESOLVED",
    "CAUSES",
    "DEFAULT_RULES",
    "AlertEvent",
    "AlertRule",
    "AlertRules",
    "AuditEntry",
    "AuditLog",
    "Counter",
    "ForensicsReport",
    "Gauge",
    "Histogram",
    "JobBlame",
    "JobTimeline",
    "MetricsRegistry",
    "ShardHop",
    "Span",
    "Telemetry",
    "TimelineRecorder",
    "WindowSnapshot",
    "analyze",
    "health_dict",
    "read_jsonl",
    "render_report",
    "report_rows",
    "to_chrome_trace",
    "validate_chrome_trace",
    "validate_chrome_trace_file",
    "write_chrome_trace",
    "write_jsonl",
]


class Telemetry:
    """Wires a metrics registry, a timeline recorder, and an audit log
    into one fabric (or bare engine wrapped in a 1-shard fabric).

    ``window`` is the metrics snapshot period in *simulated* seconds.
    """

    def __init__(self, *, window: float = 60.0,
                 alerts: Optional[AlertRules] = None) -> None:
        self.metrics = MetricsRegistry(window=window)
        self.timeline = TimelineRecorder()
        self.audit = AuditLog()
        self.alerts = alerts
        self._fabric = None

    # -- wiring --------------------------------------------------------------

    def attach(self, fabric) -> "Telemetry":
        """Subscribe to ``fabric``'s event stream and hook the audit log
        into its elastic controller (when present). Attach exactly once,
        any time before ``run``; returns self for chaining."""
        if self._fabric is not None:
            raise ValueError("Telemetry is already attached to a fabric; "
                             "use one Telemetry per fabric")
        self._fabric = fabric
        fabric.on_event(self._on_event)
        controller = getattr(fabric, "controller", None)
        if controller is not None:
            controller.audit = self.audit
        faults = getattr(fabric, "faults", None)
        if faults is not None:
            faults.audit = self.audit
        if self.alerts is not None:
            # subscribed AFTER telemetry: metric windows are captured
            # before any rule reads them — the same visibility the
            # offline replay reconstructs. Emissions go through
            # fabric.announce so the controller sees them too.
            self.alerts.bind(emit=fabric.announce, metrics=self.metrics,
                             audit=self.audit)
            fabric.on_event(self.alerts.on_event)
        return self

    @property
    def attached(self) -> bool:
        return self._fabric is not None

    # -- event folding -------------------------------------------------------

    def _on_event(self, ev: EngineEvent) -> None:
        self.metrics.advance(ev.time)
        first_arrival = (ev.kind == ARRIVAL and ev.job is not None
                         and self.timeline.timeline(ev.job.job_id) is None)
        self.timeline.on_event(ev)
        kind = ev.kind
        if kind == ROUND:
            self.metrics.counter("rounds", shard=ev.shard).inc()
            self._sample_shard(ev.shard)
        elif kind == ARRIVAL:
            # a steal re-admission re-emits ARRIVAL on the receiver;
            # only the first arrival is a submission
            if first_arrival:
                self.metrics.counter("jobs_submitted", shard=ev.shard,
                                     tenant=ev.job.tenant).inc()
                self.metrics.counter("placements", shard=ev.shard).inc()
        elif kind == JOB_DONE:
            self._on_job_done(ev)
        elif kind == JOB_STOLEN:
            self.metrics.counter("steals", shard=ev.shard).inc()
        elif kind == SHARD_RESIZED:
            self.metrics.counter("resizes", shard=ev.shard).inc()
        elif kind == JOB_REJECTED:
            self.metrics.counter("rejections",
                                 tenant=ev.job.tenant).inc()
        elif kind == SHARD_FAILED:
            self.metrics.counter("shard_failures", shard=ev.shard).inc()
        elif kind == SHARD_RECOVERED:
            self.metrics.counter("shard_recoveries", shard=ev.shard).inc()
        elif kind == SHARD_WARNED:
            self.metrics.counter("shard_warnings", shard=ev.shard).inc()
        elif kind == SHARD_SLOWED:
            self.metrics.counter("shard_slowdowns", shard=ev.shard).inc()
        elif kind == JOB_ORPHANED:
            self.metrics.counter("jobs_orphaned", shard=ev.shard,
                                 tenant=ev.job.tenant).inc()
        elif kind == JOB_RETRIED:
            self.metrics.counter("jobs_retried", shard=ev.shard,
                                 tenant=ev.job.tenant).inc()
        elif kind == JOB_SHED:
            self.metrics.counter("jobs_shed", tenant=ev.job.tenant).inc()
        elif kind == ALERT_FIRED or kind == ALERT_RESOLVED:
            # alert transitions land in the audit log so they export as
            # JSONL records and Chrome-trace instants with no extra
            # wiring (the rule name leads the detail string)
            self.metrics.counter(
                "alerts_fired" if kind == ALERT_FIRED
                else "alerts_resolved").inc()
            self.audit.decision(time=ev.time, action=kind, shard=ev.shard,
                                detail=ev.detail or "")

    def _sample_shard(self, shard: int) -> None:
        """ShardHealth pressure/slack signals as gauges, sampled each
        scheduler round."""
        if self._fabric is None or not (0 <= shard
                                        < len(self._fabric.shards)):
            return
        faults = getattr(self._fabric, "faults", None)
        h = shard_health(self._fabric.shards[shard], shard, faults)
        m = self.metrics
        m.gauge("queue_depth", shard=shard).set(h.pending_jobs)
        m.gauge("pressure", shard=shard).set(h.pressure)
        m.gauge("running_gpus", shard=shard).set(h.running_gpus)
        m.gauge("cold_free", shard=shard).set(h.cold_free)
        m.gauge("warm_idle", shard=shard).set(h.warm_idle)
        if h.min_slack != float("inf"):
            m.gauge("min_slack_s", shard=shard).set(h.min_slack)
        if faults is not None:
            m.gauge("alive", shard=shard).set(1.0 if h.alive else 0.0)
            m.gauge("draining", shard=shard).set(1.0 if h.draining else 0.0)
            m.gauge("recent_failures", shard=shard).set(h.recent_failures)

    def _on_job_done(self, ev: EngineEvent) -> None:
        job = ev.job
        m = self.metrics
        m.counter("jobs_completed", shard=ev.shard, tenant=job.tenant).inc()
        if ev.time > job.deadline + 1e-9:
            m.counter("slo_violations", shard=ev.shard,
                      tenant=job.tenant).inc()
        start = job.start_time if job.start_time is not None else ev.time
        m.histogram("queue_wait_s", shard=ev.shard).observe(
            max(start - job.submit_time, 0.0))
        m.histogram("exec_s", shard=ev.shard).observe(
            max(ev.time - start, 0.0))
        prof = job.profile()
        alloc = job.init_overhead - (prof.bank_lookup_s if job.used_bank
                                     else 0.0)
        # warm-vs-cold classification: policies pay ~warm_overhead on a
        # warm hit and >= ~cold_overhead (INFless jitters it 0.8-2.2x)
        # on a cold start; split at 75% of the profile's cold overhead.
        start_kind = "cold" if alloc >= 0.75 * prof.cold_overhead else "warm"
        m.counter("starts", kind=start_kind, shard=ev.shard).inc()
        if job.used_bank:
            m.counter("bank_routed", shard=ev.shard).inc()

    # -- reads / exports -----------------------------------------------------

    def report(self, *, bucket: Optional[float] = None,
               title: str = "SLO attainment over time") -> str:
        """The per-time-bucket SLO-attainment / queue-depth report."""
        self.metrics.close()
        return render_report(self.timeline, self.metrics.to_dicts(),
                             bucket=bucket or self.metrics.window,
                             title=title)

    def export_chrome_trace(self, path: str) -> str:
        """Write the Chrome-trace/Perfetto JSON for this run."""
        self.metrics.close()
        shards = len(self._fabric.shards) if self._fabric is not None else None
        return write_chrome_trace(path, self.timeline, self.metrics,
                                  self.audit, shards=shards)

    def export_jsonl(self, path: str) -> str:
        """Write the structured JSONL export (timelines + metric windows
        + audit entries)."""
        self.metrics.close()
        return write_jsonl(path, self.timeline, self.metrics, self.audit)

    def forensics(self) -> ForensicsReport:
        """Per-violation blame attribution rolled up fleet-wide (see
        :mod:`repro_torch.obs.forensics`)."""
        return analyze(self.timeline, self.audit)

    def summary_counters(self) -> Dict[str, float]:
        """Cross-label totals of the headline counters (quick asserts
        and logs)."""
        return {name: self.metrics.total(name)
                for name in ("jobs_submitted", "jobs_completed",
                             "slo_violations", "steals", "resizes",
                             "rejections", "rounds", "shard_failures",
                             "shard_recoveries", "jobs_orphaned",
                             "jobs_retried", "jobs_shed",
                             "alerts_fired", "alerts_resolved")}
