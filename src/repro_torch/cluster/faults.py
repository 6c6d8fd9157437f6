"""Fault plane: deterministic failure injection + crash-aware recovery.

Real fleets lose shards — instances crash, spot capacity is preempted
with seconds of warning, stragglers run slow, and flaky hosts flap.
SLO-Guard's argument (PAPERS.md) is that an SLO system's numbers are
only believable when its accounting survives exactly these events. The
:class:`FaultPlane` injects them into a running
:class:`~repro_torch.cluster.fabric.ClusterFabric` deterministically (seeded,
schedule- or hazard-rate-driven), and the recovery half of the stack
puts the work back:

* **shard crash** — every replica lost at once: running jobs are killed
  (checkpointed progress credited, see ``SimConfig.checkpoint_*``),
  queued jobs and undelivered arrivals are orphaned, the shard stops
  billing and attracting placement;
* **spot preemption** — a crash announced ``lead_s`` early via a
  :data:`SHARD_WARNED` event; a failure-aware
  :class:`~repro_torch.cluster.elastic.ElasticController` drains the shard
  proactively during the warning window;
* **transient slowdown** — a per-shard step-time multiplier (straggler)
  applied to jobs started while it lasts;
* **flapping** — repeated crash/recover cycles; the controller
  quarantines shards whose recent failure count crosses its threshold.

Orphaned jobs are re-queued through fabric placement with exponential
backoff and a per-job retry budget (:class:`RecoveryPolicy`); a job
whose budget is exhausted — or that no capacity can ever serve again —
is *shed*: recorded as a violated terminal record so every submitted
job still resolves to exactly one outcome. All transitions flow as
typed events (:data:`SHARD_FAILED` / :data:`SHARD_RECOVERED` /
:data:`JOB_ORPHANED` / :data:`JOB_RETRIED` / :data:`JOB_SHED`) into the
fabric's existing ``on_event`` stream, so the telemetry plane renders
failure lifecycles with no extra wiring.

The plane keeps its own time-ordered action heap which the fabric's run
loop interleaves with engine events (an injection or retry fires at its
exact simulated time even when every engine is idle). With no plane
attached — the default — the fabric is bit-identical to the pre-fault
code path (pinned in ``tests/test_faults.py``).
"""
from __future__ import annotations

import heapq
import itertools
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.jobs import Job

# Fault-lifecycle event kinds, alongside the engine's ARRIVAL/ROUND/
# JOB_DONE and the elastic plane's stolen/resized/rejected.
SHARD_FAILED = "shard_failed"        # crash or preemption landed
SHARD_RECOVERED = "shard_recovered"  # capacity restored after downtime
SHARD_WARNED = "shard_warned"        # spot preemption announced (lead time)
SHARD_SLOWED = "shard_slowed"        # straggler multiplier applied/cleared
JOB_ORPHANED = "job_orphaned"        # a job lost its shard mid-flight
JOB_RETRIED = "job_retried"          # an orphan re-entered placement
JOB_SHED = "job_shed"                # terminal: retry budget/capacity gone


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault. ``kind`` selects which knobs apply:

    * ``"crash"`` — at ``time``, shard dies; back after ``down_s``
      (``None``: stays down);
    * ``"preempt"`` — warning at ``time``, kill at ``time + lead_s``,
      back after ``down_s``;
    * ``"slow"`` — step-time multiplied by ``factor`` for
      ``duration_s``;
    * ``"flap"`` — ``cycles`` crash/recover cycles spaced ``period_s``
      apart, each down for ``down_s`` (default: half the period).
    """

    kind: str
    time: float
    shard: int
    down_s: Optional[float] = None
    lead_s: float = 30.0
    factor: float = 2.0
    duration_s: float = 120.0
    cycles: int = 3
    period_s: float = 60.0


@dataclass(frozen=True)
class HazardConfig:
    """Random fault generation: expected events per shard per hour for
    each fault type, expanded into a concrete seeded schedule over
    ``horizon_s`` at :meth:`FaultPlane.attach` (exponential inter-
    arrivals and downtimes — memoryless spot behaviour)."""

    crash_rate: float = 0.0           # crashes / shard / hour
    preempt_rate: float = 0.0         # preemptions / shard / hour
    slow_rate: float = 0.0            # slowdown episodes / shard / hour
    flap_rate: float = 0.0            # flapping bursts / shard / hour
    mean_downtime_s: float = 120.0
    preempt_lead_s: float = 30.0
    slow_factor: float = 2.0
    mean_slow_duration_s: float = 180.0
    flap_cycles: int = 3
    flap_period_s: float = 60.0
    horizon_s: float = 1200.0


@dataclass(frozen=True)
class RecoveryPolicy:
    """Retry semantics for orphaned jobs: attempt ``k`` (1-based) is
    re-placed ``min(backoff_base_s * 2**(k-1), backoff_cap_s)`` after
    the orphaning; past ``max_retries`` the job is shed."""

    max_retries: int = 3
    backoff_base_s: float = 5.0
    backoff_cap_s: float = 120.0


# Named chaos profiles the benchmarks / CLI sweep over.
CHAOS_PROFILES: Dict[str, HazardConfig] = {
    "crashes": HazardConfig(crash_rate=5.0, mean_downtime_s=150.0),
    "preemptions": HazardConfig(preempt_rate=5.0, preempt_lead_s=45.0,
                                mean_downtime_s=240.0),
    "mixed": HazardConfig(crash_rate=2.5, preempt_rate=2.5, slow_rate=2.0,
                          flap_rate=1.0, mean_downtime_s=150.0,
                          preempt_lead_s=45.0),
}


class FaultPlane:
    """Injects faults into one fabric and owns the recovery bookkeeping.

    Construct with an explicit ``schedule`` (a sequence of
    :class:`FaultEvent`), a :class:`HazardConfig` (expanded with
    ``seed`` once the shard count is known), or both; pass the plane to
    ``ClusterFabric(..., faults=plane)``, which calls :meth:`attach`.
    The same seed + schedule + workload replays the identical failure
    history — chaos runs are exactly reproducible.
    """

    def __init__(self, schedule: Sequence[FaultEvent] = (), *,
                 hazard: Optional[HazardConfig] = None, seed: int = 0,
                 recovery: Optional[RecoveryPolicy] = None):
        self.schedule = list(schedule)
        self.hazard = hazard
        self.seed = seed
        self.recovery = recovery or RecoveryPolicy()
        self.fabric = None
        self.audit = None              # duck-typed AuditLog sink (obs)
        # lifecycle counters (introspection / benchmarks)
        self.crashes = 0
        self.preemptions = 0
        self.warnings = 0
        self.slowdowns = 0
        self.recoveries = 0
        self.retries = 0
        self.sheds = 0
        self.warned: Dict[int, float] = {}       # shard -> kill time
        self._down: Dict[int, int] = {}          # shard -> capacity lost
        self._failures: Dict[int, List[float]] = {}   # shard -> crash times
        self._attempts: Dict[int, int] = {}      # job_id -> retries used
        self._seq = itertools.count()
        self._actions: List[Tuple[float, int, str, int, object]] = []

    # -- wiring ---------------------------------------------------------------

    def attach(self, fabric) -> "FaultPlane":
        """Bind to ``fabric`` and expand the schedule (and any hazard
        config, now that the shard count is known) into the action
        heap. Called by the fabric constructor; attach exactly once."""
        if self.fabric is not None:
            raise ValueError("FaultPlane is already attached to a fabric; "
                             "use one plane per fabric")
        self.fabric = fabric
        for f in self.schedule:
            self._expand(f)
        if self.hazard is not None:
            for f in self._hazard_schedule(len(fabric.shards)):
                self._expand(f)
        return self

    def _hazard_schedule(self, shards: int) -> List[FaultEvent]:
        hz = self.hazard
        rng = random.Random(self.seed)
        out: List[FaultEvent] = []
        kinds = (("crash", hz.crash_rate), ("preempt", hz.preempt_rate),
                 ("slow", hz.slow_rate), ("flap", hz.flap_rate))
        for shard in range(shards):
            for kind, rate in kinds:
                # A rate so small that rate / 3600 underflows to 0 has
                # no arrivals; expovariate(0.0) would divide by zero.
                if rate <= 0 or rate / 3600.0 == 0.0:
                    continue
                t = rng.expovariate(rate / 3600.0)
                while t < hz.horizon_s:
                    out.append(FaultEvent(
                        kind=kind, time=t, shard=shard,
                        down_s=rng.expovariate(1.0 / hz.mean_downtime_s),
                        lead_s=hz.preempt_lead_s,
                        factor=hz.slow_factor,
                        duration_s=rng.expovariate(
                            1.0 / hz.mean_slow_duration_s),
                        cycles=hz.flap_cycles,
                        period_s=hz.flap_period_s))
                    t += rng.expovariate(rate / 3600.0)
        out.sort(key=lambda f: (f.time, f.shard, f.kind))
        return out

    def _expand(self, f: FaultEvent) -> None:
        if f.kind == "crash":
            self._push(f.time, "crash", f.shard, f.down_s)
        elif f.kind == "preempt":
            self._push(f.time, "warn", f.shard, (f.lead_s, f.down_s))
        elif f.kind == "slow":
            self._push(f.time, "slow", f.shard, f.factor)
            self._push(f.time + f.duration_s, "unslow", f.shard, None)
        elif f.kind == "flap":
            down = f.down_s if f.down_s is not None else f.period_s / 2.0
            for c in range(f.cycles):
                self._push(f.time + c * f.period_s, "crash", f.shard, down)
        else:
            raise ValueError(f"unknown fault kind {f.kind!r}; expected "
                             "crash | preempt | slow | flap")

    def _push(self, t: float, kind: str, shard: int, payload) -> None:
        heapq.heappush(self._actions,
                       (t, next(self._seq), kind, shard, payload))

    # -- run-loop surface (consumed by ClusterFabric.run) ---------------------

    def next_time(self) -> Optional[float]:
        return self._actions[0][0] if self._actions else None

    def fire_next(self) -> None:
        """Apply the earliest queued action through fabric verbs."""
        t, _, kind, shard, payload = heapq.heappop(self._actions)
        if kind == "crash":
            self._kill(shard, t, payload, reason="crash")
        elif kind == "warn":
            lead, down = payload
            if shard in self._down:
                return                 # already dead: nothing to warn about
            self.warnings += 1
            self.warned[shard] = t + lead
            self._audit(t, SHARD_WARNED, shard,
                        detail=f"spot preemption in {lead:g}s")
            self.fabric.warn_shard(shard, t, kill_at=t + lead)
            self._push(t + lead, "preempt", shard, down)
        elif kind == "preempt":
            self.warned.pop(shard, None)
            self._kill(shard, t, payload, reason="spot preemption")
        elif kind == "recover":
            if shard in self._down:
                cap = self._down.pop(shard)
                self.recoveries += 1
                self._failures.setdefault(shard, [])
                self._audit(t, SHARD_RECOVERED, shard,
                            detail=f"+{cap} GPUs restored")
                self.fabric.recover_shard(shard, cap, t)
        elif kind == "slow":
            if shard not in self._down:
                self.slowdowns += 1
                # the factor rides in inputs so forensics can rebuild
                # per-shard slowdown windows from the audit log alone
                self._audit(t, SHARD_SLOWED, shard,
                            detail=f"x{payload:g} step time",
                            inputs={"factor": payload})
                self.fabric.slow_shard(shard, payload, t)
        elif kind == "unslow":
            if shard not in self._down:
                self._audit(t, SHARD_SLOWED, shard,
                            detail="x1 step time (cleared)",
                            inputs={"factor": 1.0})
                self.fabric.slow_shard(shard, 1.0, t)
        elif kind == "retry":
            self._fire_retry(payload, t)

    def _kill(self, shard: int, t: float, down_s, *, reason: str) -> None:
        if shard in self._down:
            return                     # double-kill: already dead
        if reason == "crash":
            self.crashes += 1
            # only unannounced crashes feed the flap signal: a warned
            # spot preemption is normal churn, and quarantining the
            # capacity when it returns would just waste it
            self._failures.setdefault(shard, []).append(t)
        else:
            self.preemptions += 1
        self.warned.pop(shard, None)
        # mark down *before* fail_shard: the orphan callbacks it runs
        # (retry scheduling, immediate sheds) must see the shard as dead
        self._down[shard] = 0
        # an announced kill (spot preemption) had a warning lead to flush
        # a final snapshot; an unannounced crash only keeps whole blocks
        orphans, lost = self.fabric.fail_shard(
            shard, t, reason=reason, final_snapshot=reason != "crash")
        self._down[shard] = lost
        self._audit(t, SHARD_FAILED, shard,
                    detail=f"{reason}: -{lost} GPUs, "
                           f"{len(orphans)} jobs orphaned")
        if down_s is not None:
            self._push(t + down_s, "recover", shard, None)

    # -- orphan retry / shed --------------------------------------------------

    def on_orphaned(self, job: Job, t: float) -> None:
        """Called by ``fabric.fail_shard`` per orphan: schedule a backed-
        off retry, or shed when the per-job budget is spent."""
        used = self._attempts.get(job.job_id, 0)
        if used >= self.recovery.max_retries:
            self.shed(job, t, f"retry budget exhausted "
                              f"({used}/{self.recovery.max_retries})")
            return
        self._attempts[job.job_id] = used + 1
        backoff = min(self.recovery.backoff_base_s * (2 ** used),
                      self.recovery.backoff_cap_s)
        self._push(t + backoff, "retry", -1, job)

    def _fire_retry(self, job: Job, t: float) -> None:
        attempt = self._attempts.get(job.job_id, 0)
        if self.fabric.requeue(job, t, attempt=attempt):
            self.retries += 1
            self._audit(t, JOB_RETRIED, self.fabric.placed.get(job.job_id, -1),
                        job_id=job.job_id, tenant=job.tenant,
                        detail=f"attempt {attempt}")
            return
        # No shard can hold a replica right now. If a recovery is still
        # queued, park the retry until right after it lands; otherwise
        # the capacity is gone for good and the job is shed.
        for ts, _, kind, _, _ in sorted(self._actions):
            if kind == "recover":
                self._push(max(ts, t), "retry", -1, job)
                return
        self.shed(job, t, "no shard capacity left to retry on")

    def shed(self, job: Job, t: float, reason: str) -> None:
        self.sheds += 1
        self._audit(t, JOB_SHED, -1, job_id=job.job_id, tenant=job.tenant,
                    detail=reason)
        self.fabric.shed_job(job, t, reason)

    # -- introspection (controller / tests / benchmarks) ----------------------

    def is_down(self, shard: int) -> bool:
        return shard in self._down

    def placeable(self, shard: int) -> bool:
        """Should new work land on ``shard``? Not while it is dead or
        inside a preemption-warning window."""
        return shard not in self._down and shard not in self.warned

    def capacity_lost(self) -> int:
        """GPUs currently failed out of the fleet (restored on
        recovery) — the conservation term the property tests pin."""
        return sum(self._down.values())

    def recent_failures(self, shard: int, now: float,
                        window: float) -> int:
        """Crash/preempt count on ``shard`` within ``window`` seconds —
        the flap signal the controller quarantines on."""
        return sum(1 for ts in self._failures.get(shard, ())
                   if now - ts <= window)

    def retries_used(self, job_id: int) -> int:
        return self._attempts.get(job_id, 0)

    def _audit(self, t: float, action: str, shard: int, *,
               job_id: Optional[int] = None, tenant: Optional[str] = None,
               detail: str = "", inputs: Optional[Dict] = None) -> None:
        if self.audit is not None:
            self.audit.decision(time=t, action=action, shard=shard,
                                job_id=job_id, tenant=tenant, detail=detail,
                                inputs=inputs)
