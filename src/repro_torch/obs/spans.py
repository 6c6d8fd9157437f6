"""Per-job lifecycle span timelines, folded from the fabric event stream.

A :class:`TimelineRecorder` subscribes through the existing ``on_event``
contract (``fabric.on_event(recorder.on_event)`` — or let
:class:`~repro_torch.obs.Telemetry` wire it) and folds the typed event kinds
into one :class:`JobTimeline` per job:

* ``ARRIVAL`` opens the job's *queued* span on its placed shard;
* ``job_stolen`` closes the queued span on the donor and opens a fresh
  one on the receiving shard (a **shard hop**, kept in ``hops``);
* ``JOB_DONE`` finalizes: the engine stamps ``start_time`` /
  ``init_overhead`` / ``finish_time`` / ``gpus`` on the Job, so the
  closing fold splits the executed tail into an *init* span (allocation
  + instance warm-up + bank lookup) and a *running* span — yielding the
  full submitted → queued → init → running → done lifecycle without any
  extra engine instrumentation;
* ``job_rejected`` produces a zero-length *rejected* timeline carrying
  the quota reason.

The fault plane (:mod:`repro_torch.cluster.faults`) adds three more kinds:

* ``job_orphaned`` closes whatever span was open as **truncated** — if
  the job had already started (the event fires before the fabric scrubs
  the runtime state), the fold derives truncated *init*/*running* spans
  up to the crash instant, so the trace shows exactly how much work the
  failure threw away;
* ``job_retried`` opens a fresh queued span on the retry shard and
  records the crash-driven move as a :class:`ShardHop`;
* ``job_shed`` closes the open span truncated and stamps the shed
  reason — the job's terminal state without a ``JOB_DONE``.

Spans are plain frozen dataclasses; the Chrome-trace / JSONL exporters
(:mod:`repro_torch.obs.export`) consume them as-is. Jobs that never complete
(still pending when the run is cut off) keep their open queued span —
``end=None`` — which is itself diagnostic: that is *where* a violated
job spent its deadline. Call :meth:`TimelineRecorder.finalize` after a
run to close those stragglers as truncated spans at the horizon
instead of dropping them.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional

from repro_torch.cluster.elastic import JOB_REJECTED, JOB_STOLEN
from repro_torch.cluster.engine import ARRIVAL, JOB_DONE, EngineEvent
from repro_torch.cluster.faults import JOB_ORPHANED, JOB_RETRIED, JOB_SHED

QUEUED, INIT, RUNNING, REJECTED = "queued", "init", "running", "rejected"


@dataclass(frozen=True)
class Span:
    """One closed (or still-open, ``end=None``) phase of a job's life on
    one shard."""

    job_id: int
    phase: str                 # queued | init | running | rejected
    shard: int
    start: float
    end: Optional[float]
    truncated: bool = False    # cut short by a fault / run horizon

    @property
    def duration(self) -> Optional[float]:
        return None if self.end is None else self.end - self.start


@dataclass(frozen=True)
class ShardHop:
    """One cross-shard move: the job left ``src`` for ``dst`` at
    ``time``. ``kind`` distinguishes an elastic steal/drain from a
    crash-driven retry re-placement — forensics blames them to
    different causes (``steal_hop`` vs ``crash_rework``)."""

    job_id: int
    time: float
    src: int
    dst: int
    kind: str = "steal"        # "steal" | "retry"


@dataclass
class JobTimeline:
    """Everything observed about one job, in span form."""

    job_id: int
    task_id: str
    llm: str
    tenant: str
    slo_class: str
    submit_time: float
    deadline: float
    spans: List[Span] = field(default_factory=list)
    hops: List[ShardHop] = field(default_factory=list)
    gpus: int = 0
    used_bank: bool = False
    violated: Optional[bool] = None     # None until JOB_DONE / rejection
    reject_reason: Optional[str] = None
    retries: int = 0                    # crash-driven re-placements
    shed_reason: Optional[str] = None   # set when the job was load-shed

    @property
    def shard(self) -> int:
        """Final shard (where the job ran, or last queued)."""
        return self.spans[-1].shard if self.spans else -1

    @property
    def done(self) -> bool:
        return self.violated is not None and self.reject_reason is None

    @property
    def finish(self) -> Optional[float]:
        for s in reversed(self.spans):
            if s.phase == RUNNING:
                return s.end
        return None

    def phase_seconds(self, phase: str) -> float:
        """Total closed-span seconds the job spent in ``phase``."""
        return sum(s.duration for s in self.spans
                   if s.phase == phase and s.end is not None)

    def to_dict(self) -> Dict:
        return {
            "type": "timeline",
            "job_id": self.job_id,
            "task_id": self.task_id,
            "llm": self.llm,
            "tenant": self.tenant,
            "slo_class": self.slo_class,
            "submit_time": self.submit_time,
            "deadline": self.deadline,
            "gpus": self.gpus,
            "used_bank": self.used_bank,
            "violated": self.violated,
            "reject_reason": self.reject_reason,
            "retries": self.retries,
            "shed_reason": self.shed_reason,
            "spans": [{"phase": s.phase, "shard": s.shard,
                       "start": s.start, "end": s.end,
                       "truncated": s.truncated}
                      for s in self.spans],
            "hops": [{"time": h.time, "src": h.src, "dst": h.dst,
                      "kind": h.kind}
                     for h in self.hops],
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "JobTimeline":
        tl = cls(
            job_id=int(d["job_id"]), task_id=d["task_id"], llm=d["llm"],
            tenant=d["tenant"], slo_class=d["slo_class"],
            submit_time=float(d["submit_time"]),
            deadline=float(d["deadline"]), gpus=int(d["gpus"]),
            used_bank=bool(d["used_bank"]), violated=d["violated"],
            reject_reason=d.get("reject_reason"),
            retries=int(d.get("retries", 0)),
            shed_reason=d.get("shed_reason"),
        )
        tl.spans = [Span(job_id=tl.job_id, phase=s["phase"],
                         shard=int(s["shard"]), start=float(s["start"]),
                         end=None if s["end"] is None else float(s["end"]),
                         truncated=bool(s.get("truncated", False)))
                    for s in d["spans"]]
        tl.hops = [ShardHop(job_id=tl.job_id, time=float(h["time"]),
                            src=int(h["src"]), dst=int(h["dst"]),
                            kind=h.get("kind", "steal"))
                   for h in d["hops"]]
        return tl


class TimelineRecorder:
    """Folds the fabric event stream into :class:`JobTimeline` objects.

    Stateless about the fabric beyond the events themselves — it can
    replay a recorded event list just as well as a live subscription
    (which is what the scripted-sequence tests do).
    """

    def __init__(self) -> None:
        self._timelines: Dict[int, JobTimeline] = {}

    # -- event folding -------------------------------------------------------

    def on_event(self, ev: EngineEvent) -> None:
        if ev.job is None:
            return                       # ROUND / SHARD_RESIZED: no job
        if ev.kind == ARRIVAL:
            self._on_arrival(ev)
        elif ev.kind == JOB_STOLEN:
            self._on_stolen(ev)
        elif ev.kind == JOB_DONE:
            self._on_done(ev)
        elif ev.kind == JOB_REJECTED:
            self._on_rejected(ev)
        elif ev.kind == JOB_ORPHANED:
            self._on_orphaned(ev)
        elif ev.kind == JOB_RETRIED:
            self._on_retried(ev)
        elif ev.kind == JOB_SHED:
            self._on_shed(ev)

    def _timeline_for(self, ev: EngineEvent) -> JobTimeline:
        job = ev.job
        tl = self._timelines.get(job.job_id)
        if tl is None:
            tl = JobTimeline(
                job_id=job.job_id, task_id=job.task_id, llm=job.llm,
                tenant=job.tenant, slo_class=job.slo_class.name,
                submit_time=job.submit_time, deadline=job.deadline)
            self._timelines[job.job_id] = tl
        return tl

    def _close_open_span(self, tl: JobTimeline, t: float,
                         truncated: bool = False) -> Optional[Span]:
        if tl.spans and tl.spans[-1].end is None:
            closed = replace(tl.spans[-1], end=t, truncated=truncated)
            tl.spans[-1] = closed
            return closed
        return None

    def _on_arrival(self, ev: EngineEvent) -> None:
        tl = self._timeline_for(ev)
        if tl.spans and tl.spans[-1].end is None:
            # steal re-admission: migrate() re-enqueues the job on the
            # receiver, whose engine emits a second ARRIVAL right after
            # the JOB_STOLEN fold already opened the receiver-side
            # queued span — not a new submission, nothing to add
            return
        tl.spans.append(Span(job_id=tl.job_id, phase=QUEUED, shard=ev.shard,
                             start=ev.time, end=None))

    def _on_stolen(self, ev: EngineEvent) -> None:
        # ev.shard is the RECEIVING shard (fabric contract); the donor is
        # wherever the open queued span lives.
        tl = self._timeline_for(ev)
        closed = self._close_open_span(tl, ev.time)
        src = closed.shard if closed is not None else -1
        tl.hops.append(ShardHop(job_id=tl.job_id, time=ev.time, src=src,
                                dst=ev.shard))
        tl.spans.append(Span(job_id=tl.job_id, phase=QUEUED, shard=ev.shard,
                             start=ev.time, end=None))

    def _on_done(self, ev: EngineEvent) -> None:
        job = ev.job
        tl = self._timeline_for(ev)
        start = job.start_time if job.start_time is not None else ev.time
        self._close_open_span(tl, start)
        init_end = min(start + job.init_overhead, ev.time)
        if init_end > start:
            tl.spans.append(Span(job_id=tl.job_id, phase=INIT,
                                 shard=ev.shard, start=start, end=init_end))
        tl.spans.append(Span(job_id=tl.job_id, phase=RUNNING, shard=ev.shard,
                             start=init_end, end=ev.time))
        tl.gpus = job.gpus
        tl.used_bank = job.used_bank
        tl.violated = ev.time > tl.deadline + 1e-9

    def _on_rejected(self, ev: EngineEvent) -> None:
        tl = self._timeline_for(ev)
        tl.spans.append(Span(job_id=tl.job_id, phase=REJECTED, shard=ev.shard,
                             start=ev.time, end=ev.time))
        tl.reject_reason = ev.detail or "rejected"
        tl.violated = None

    def _on_orphaned(self, ev: EngineEvent) -> None:
        # Fired before the fabric scrubs the job, so start_time /
        # init_overhead still describe the attempt the crash cut short.
        job = ev.job
        tl = self._timeline_for(ev)
        start = job.start_time
        if start is None:
            self._close_open_span(tl, ev.time, truncated=True)
            return
        self._close_open_span(tl, start)
        init_end = min(start + job.init_overhead, ev.time)
        if init_end > start:
            tl.spans.append(Span(job_id=tl.job_id, phase=INIT, shard=ev.shard,
                                 start=start, end=init_end, truncated=True))
        if ev.time > init_end:
            tl.spans.append(Span(job_id=tl.job_id, phase=RUNNING,
                                 shard=ev.shard, start=init_end, end=ev.time,
                                 truncated=True))

    def _on_retried(self, ev: EngineEvent) -> None:
        tl = self._timeline_for(ev)
        src = tl.spans[-1].shard if tl.spans else -1
        if src != ev.shard:
            tl.hops.append(ShardHop(job_id=tl.job_id, time=ev.time, src=src,
                                    dst=ev.shard, kind="retry"))
        tl.retries += 1
        tl.spans.append(Span(job_id=tl.job_id, phase=QUEUED, shard=ev.shard,
                             start=ev.time, end=None))

    def _on_shed(self, ev: EngineEvent) -> None:
        tl = self._timeline_for(ev)
        self._close_open_span(tl, ev.time, truncated=True)
        tl.shed_reason = ev.detail or "shed"
        tl.violated = True

    # -- finalization --------------------------------------------------------

    def finalize(self, horizon: Optional[float] = None) -> int:
        """Close every still-open span as **truncated** at ``horizon``
        (default: the latest timestamp seen anywhere in the recording).
        Jobs that never reached ``JOB_DONE`` — still queued when the run
        was cut off — end up with a closed, truncated span instead of
        being dropped by end-aware consumers. Returns the number of
        spans closed. Idempotent."""
        if horizon is None:
            horizon = 0.0
            for tl in self._timelines.values():
                for s in tl.spans:
                    horizon = max(horizon, s.start,
                                  s.end if s.end is not None else s.start)
        closed = 0
        for tl in self._timelines.values():
            if tl.spans and tl.spans[-1].end is None:
                t = max(horizon, tl.spans[-1].start)
                self._close_open_span(tl, t, truncated=True)
                closed += 1
        return closed

    # -- reads ---------------------------------------------------------------

    def timelines(self) -> Dict[int, JobTimeline]:
        return dict(self._timelines)

    def timeline(self, job_id: int) -> Optional[JobTimeline]:
        return self._timelines.get(job_id)

    def __len__(self) -> int:
        return len(self._timelines)

    def to_dicts(self) -> List[Dict]:
        return [tl.to_dict() for _, tl in sorted(self._timelines.items())]
