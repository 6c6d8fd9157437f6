"""SLO forensics: deterministic per-violation blame attribution.

The telemetry plane records *that* a job violated its SLO; this module
answers *why*, in seconds. For every violated or shed job,
:func:`analyze` walks the job's :class:`~repro_torch.obs.spans.JobTimeline`
spans, its :class:`~repro_torch.obs.spans.ShardHop` moves, and the
:class:`~repro_torch.obs.audit.AuditLog` (fault-plane slowdown factors and
the elastic decisions that placed/moved the job) and decomposes the
observed lifecycle ``[submit, end]`` into cause categories:

* ``queue_wait``   — time queued with no elastic move to show for it;
* ``cold_start``   — the final attempt's init span (allocation +
  instance warm-up + bank lookup + checkpoint-restore tax);
* ``crash_rework`` — truncated init/running spans: work a shard
  failure threw away;
* ``retry_backoff``— gaps between an orphaning and the retry re-entry
  (the recovery policy's exponential backoff);
* ``steal_hop``    — queued time on a shard the job was stolen *to*
  (the move's landing cost);
* ``slowdown``     — the straggler tax on the final attempt: wall time
  in excess of what the shard would have taken at speed x1, rebuilt
  from the audited ``shard_slowed`` factors (a ``shard_failed`` entry
  resets the factor — the engine's crash path does);
* ``placement``    — queued time on a shard the controller later stole
  the job *off*: evidence the original placement was wrong, with the
  specific audit decision it indicts attached;
* ``exec``         — nominal execution (the final attempt's running
  span minus the slowdown tax). Not a violation cause per se, but it
  can retain blame when execution alone exceeds the SLO.

**Reconciliation invariant** (pinned by tests): the category seconds
tile the observed lifecycle exactly, and the *blame* — what is left of
each category after the job's slack allowance is consumed in
:data:`_CONSUME_ORDER` — sums to the job's measured overrun:

* completed-late job: ``sum(blame) == finish - deadline``;
* shed job (no finite finish): the whole observed lifecycle is blamed,
  ``sum(blame) == end - start`` — none of a shed job's spent time fit
  inside a budget it never met.

The lifecycle anchor ``start`` is ``min(submit_time, first span
start)``: a shard crash can orphan-and-retry a job *before* its
nominal arrival (the whole trace is pre-submitted to shard queues), so
observed activity may legitimately precede ``submit_time``.

Everything is computed from exported data — a reloaded JSONL trace
(:func:`repro_torch.obs.export.read_jsonl`) produces the byte-identical
report the live recorder does.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.cluster.elastic import DRAIN, JOB_STOLEN
from repro_torch.cluster.faults import SHARD_FAILED, SHARD_SLOWED
from repro_torch.obs.audit import AuditLog
from repro_torch.obs.spans import INIT, QUEUED, REJECTED, RUNNING, JobTimeline

# The seven violation causes, in report order. EXEC is the residual
# nominal-execution category; it only shows up in a blame breakdown
# when the job could not have met its SLO even with a perfect fleet.
CAUSES = ("queue_wait", "cold_start", "crash_rework", "retry_backoff",
          "steal_hop", "slowdown", "placement")
EXEC = "exec"

# Order in which a job's slack allowance (the part of its lifecycle
# that fit inside the deadline) is consumed. Benign categories come
# first, so the blame lands on the pathological tail: a job that spent
# its whole budget executing and then waited out a retry backoff
# blames the backoff, not the execution.
_CONSUME_ORDER = (EXEC, "cold_start", "queue_wait", "placement",
                  "steal_hop", "retry_backoff", "crash_rework", "slowdown")

_EPS = 1e-9


def _timelines_list(timelines) -> List[JobTimeline]:
    from repro_torch.obs.spans import TimelineRecorder

    if isinstance(timelines, TimelineRecorder):
        return [tl for _, tl in sorted(timelines.timelines().items())]
    if isinstance(timelines, dict):
        return [tl for _, tl in sorted(timelines.items())]
    return sorted(timelines, key=lambda tl: tl.job_id)


def _audit_entries(audit) -> List:
    if audit is None:
        return []
    if isinstance(audit, AuditLog):
        return list(audit.entries)
    return list(audit)


def _slow_windows(entries) -> Dict[int, List[Tuple[float, float]]]:
    """Per-shard sorted ``(time, speed_factor)`` steps rebuilt from the
    audit log: ``shard_slowed`` entries carry the factor in their
    inputs; a ``shard_failed`` entry resets to x1 (the engine's crash
    path clears the multiplier)."""
    out: Dict[int, List[Tuple[float, float]]] = {}
    for e in entries:
        if e.action == SHARD_SLOWED:
            inputs = e.inputs if isinstance(e.inputs, dict) else {}
            try:
                factor = float(inputs.get("factor", 1.0))
            except (TypeError, ValueError):
                factor = 1.0
            out.setdefault(e.shard, []).append((e.time, factor))
        elif e.action == SHARD_FAILED:
            out.setdefault(e.shard, []).append((e.time, 1.0))
    for steps in out.values():
        steps.sort()
    return out


def _speed_at(slow: Dict[int, List[Tuple[float, float]]], shard: int,
              t: float) -> float:
    factor = 1.0
    for ts, f in slow.get(shard, ()):
        if ts <= t + _EPS:
            factor = f
        else:
            break
    return factor


@dataclass
class JobBlame:
    """One violated/shed job's decomposition and blame breakdown."""

    job_id: int
    tenant: str
    slo_class: str
    shard: int
    submit_time: float
    start: float                    # observed lifecycle anchor:
                                    # min(submit, first span start)
    deadline: float
    end: float                      # finish, or the shed/truncation instant
    overrun_s: float                # what the blame must sum to
    shed: bool
    retries: int
    hops: int
    seconds: Dict[str, float]       # full lifecycle decomposition
    blame: Dict[str, float]         # past-allowance remainder per cause
    primary_cause: str
    indicts: Optional[Dict] = None  # audit decision `placement` points at

    def to_dict(self) -> Dict:
        return {
            "job_id": self.job_id, "tenant": self.tenant,
            "slo_class": self.slo_class, "shard": self.shard,
            "submit_time": self.submit_time, "start": self.start,
            "deadline": self.deadline,
            "end": self.end, "overrun_s": self.overrun_s,
            "shed": self.shed, "retries": self.retries, "hops": self.hops,
            "seconds": dict(self.seconds), "blame": dict(self.blame),
            "primary_cause": self.primary_cause, "indicts": self.indicts,
        }


@dataclass
class ForensicsReport:
    """Fleet-wide rollup: blamed seconds per cause across every
    violated/shed job, plus the per-job breakdowns."""

    jobs: List[JobBlame] = field(default_factory=list)
    totals: Dict[str, float] = field(default_factory=dict)
    primary_counts: Dict[str, int] = field(default_factory=dict)
    violated: int = 0
    completed_late: int = 0
    shed: int = 0

    def cause_shares(self) -> Dict[str, float]:
        """Each cause's fraction of all blamed seconds (zeros when
        nothing violated)."""
        total = sum(self.totals.values())
        if total <= 0:
            return {c: 0.0 for c in self.totals}
        return {c: v / total for c, v in self.totals.items()}

    def job(self, job_id: int) -> Optional[JobBlame]:
        for jb in self.jobs:
            if jb.job_id == job_id:
                return jb
        return None

    def to_dict(self) -> Dict:
        return {
            "type": "forensics",
            "violated": self.violated,
            "completed_late": self.completed_late,
            "shed": self.shed,
            "totals": dict(self.totals),
            "shares": self.cause_shares(),
            "primary_counts": dict(self.primary_counts),
            "jobs": [jb.to_dict() for jb in self.jobs],
        }

    def render(self, *, title: str = "top causes of violation") -> str:
        shares = self.cause_shares()
        lines = [f"== SLO forensics: {title} ==",
                 f"{'cause':<14s} {'blamed_s':>10s} {'share%':>7s} "
                 f"{'primary':>8s}"]
        order = sorted(self.totals,
                       key=lambda c: (-self.totals[c],
                                      (CAUSES + (EXEC,)).index(c)))
        for c in order:
            lines.append(f"{c:<14s} {self.totals[c]:>10.1f} "
                         f"{100.0 * shares.get(c, 0.0):>7.1f} "
                         f"{self.primary_counts.get(c, 0):>8d}")
        lines.append(f"total: {self.violated} violated jobs "
                     f"({self.completed_late} completed late, "
                     f"{self.shed} shed), "
                     f"{sum(self.totals.values()):.1f} blamed seconds")
        return "\n".join(lines)


def _decompose(tl: JobTimeline,
               slow: Dict[int, List[Tuple[float, float]]]
               ) -> Tuple[Dict[str, float], float, float]:
    """Tile the observed lifecycle ``[start, end]`` into category
    seconds, chronologically."""
    spans = [s for s in tl.spans
             if s.end is not None and s.phase != REJECTED]
    end = spans[-1].end
    # a crash can orphan-and-retry a pre-submitted job before its
    # nominal arrival, so the anchor is the earlier of the two
    t0 = min(tl.submit_time, spans[0].start)
    sec: Dict[str, float] = {c: 0.0 for c in CAUSES}
    sec[EXEC] = 0.0
    steal_hops = [h for h in tl.hops if h.kind == "steal"]
    final_run = None
    for i, s in enumerate(spans):
        if s.phase == RUNNING and not s.truncated:
            final_run = i
    cursor = t0
    for i, s in enumerate(spans):
        gap = s.start - cursor
        if gap > _EPS:
            # a gap between spans is dead air: before the first span it
            # is pre-placement queueing; after a truncated span it is
            # the recovery policy's retry backoff
            sec["queue_wait" if i == 0 else "retry_backoff"] += gap
        dur = s.end - s.start
        if s.phase == QUEUED:
            if any(abs(h.time - s.end) <= _EPS and h.src == s.shard
                   for h in steal_hops):
                # the controller moved the job OFF this shard: the wait
                # here indicts the original placement decision
                sec["placement"] += dur
            elif any(abs(h.time - s.start) <= _EPS and h.dst == s.shard
                     for h in steal_hops):
                sec["steal_hop"] += dur
            else:
                sec["queue_wait"] += dur
        elif s.phase == INIT:
            sec["crash_rework" if s.truncated else "cold_start"] += dur
        elif s.phase == RUNNING:
            if s.truncated:
                sec["crash_rework"] += dur
            elif i == final_run:
                # the engine scales the whole attempt duration by the
                # shard speed at start: tax = wall * (1 - 1/factor)
                a_start = s.start
                if (i > 0 and spans[i - 1].phase == INIT
                        and not spans[i - 1].truncated
                        and abs(spans[i - 1].end - s.start) <= _EPS):
                    a_start = spans[i - 1].start
                factor = _speed_at(slow, s.shard, a_start)
                tax = 0.0
                if factor > 1.0:
                    tax = (s.end - a_start) * (1.0 - 1.0 / factor)
                tax = min(max(tax, 0.0), dur)
                sec["slowdown"] += tax
                sec[EXEC] += dur - tax
            else:
                sec[EXEC] += dur
        cursor = max(cursor, s.end)
    # fold any float sliver into exec so the tiling is exact
    sec[EXEC] += (end - t0) - sum(sec.values())
    return sec, t0, end


def _blame(sec: Dict[str, float], allowance: float) -> Dict[str, float]:
    blame: Dict[str, float] = {}
    left = max(allowance, 0.0)
    for cat in _CONSUME_ORDER:
        v = sec.get(cat, 0.0)
        used = min(left, v)
        left -= used
        blame[cat] = v - used
    return blame


def _primary(blame: Dict[str, float]) -> str:
    order = CAUSES + (EXEC,)
    return max(order, key=lambda c: (blame.get(c, 0.0), -order.index(c)))


def analyze(timelines, audit=None) -> ForensicsReport:
    """Blame every violated/shed job and roll the fleet up.

    ``timelines`` is a :class:`~repro_torch.obs.spans.TimelineRecorder`, a
    dict, or a list of :class:`JobTimeline` — live or reloaded from a
    JSONL export; ``audit`` an :class:`~repro_torch.obs.audit.AuditLog` or a
    list of entries (used for slowdown factors and the placement
    indictment; omitting it zeroes ``slowdown`` but keeps the
    reconciliation invariant — the seconds stay in ``exec``)."""
    tls = _timelines_list(timelines)
    entries = _audit_entries(audit)
    slow = _slow_windows(entries)
    report = ForensicsReport(
        totals={c: 0.0 for c in CAUSES + (EXEC,)},
        primary_counts={})
    for tl in tls:
        if tl.violated is not True or tl.reject_reason is not None:
            continue
        if not tl.spans or tl.spans[-1].end is None:
            continue               # open lifecycle: finalize() first
        sec, t0, end = _decompose(tl, slow)
        shed = tl.shed_reason is not None
        if shed:
            # no finite finish: every observed second was wasted
            overrun = end - t0
        else:
            overrun = max(end - tl.deadline, 0.0)
        allowance = (end - t0) - overrun
        blame = _blame(sec, allowance)
        primary = _primary(blame)
        indicts = None
        if blame.get("placement", 0.0) > _EPS:
            for e in entries:
                if (e.job_id == tl.job_id
                        and e.action in (JOB_STOLEN, DRAIN)):
                    indicts = {"time": e.time, "action": e.action,
                               "shard": e.shard, "detail": e.detail}
                    break
        jb = JobBlame(
            job_id=tl.job_id, tenant=tl.tenant, slo_class=tl.slo_class,
            shard=tl.shard, submit_time=tl.submit_time, start=t0,
            deadline=tl.deadline, end=end, overrun_s=overrun, shed=shed,
            retries=tl.retries, hops=len(tl.hops), seconds=sec,
            blame=blame, primary_cause=primary, indicts=indicts)
        report.jobs.append(jb)
        report.violated += 1
        if shed:
            report.shed += 1
        else:
            report.completed_late += 1
        for c, v in blame.items():
            report.totals[c] = report.totals.get(c, 0.0) + v
        report.primary_counts[primary] = (
            report.primary_counts.get(primary, 0) + 1)
    return report
