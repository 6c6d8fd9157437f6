"""Elastic control plane: work stealing, autoscaling, tenant quotas.

The paper's headline claim is an *elastic* Workload Scheduler that
reallocates resources fast enough to cut SLO violations 4.0-7.9x and
cost 1.6-4.5x. The static :class:`~repro_torch.cluster.fabric.ClusterFabric`
places each job exactly once; a saturated shard then strands jobs while
neighbours idle. :class:`ElasticController` closes that gap with three
mechanisms, all acting *between* scheduling rounds through fabric verbs
(``migrate`` / ``resize_shard``), never inside a policy's round:

1. **Cross-shard work stealing** — pending jobs a saturated shard cannot
   serve with its currently free capacity are migrated to shards with
   headroom, respecting ``gpus_per_replica`` feasibility and preferring
   destinations whose warm pool already holds the job's LLM (warmth-
   aware: a steal to a warm shard pays the warm overhead, not a cold
   start).
2. **Queue-pressure autoscaling** — cold (free, unbilled) GPUs move from
   low-pressure donors to shards whose pressure stays above
   ``pressure_high`` for ``hysteresis_cycles`` consecutive control
   cycles; a per-shard ``autoscale_cooldown`` stops the fleet from
   thrashing. The fleet total is conserved; a shard shrunk to
   ``min_shard_gpus`` is effectively spun down.
3. **Per-tenant admission quotas** — a :class:`TenantQuota` caps a
   tenant's GPU-second budget, billed cost, and concurrently
   outstanding jobs. Enforcement is fleet-wide at submit time
   (completed ledgers + in-flight commitments + pending estimates);
   rejections surface as typed :data:`JOB_REJECTED` events and on the
   service's :class:`~repro_torch.api.types.JobHandle`.

A fourth, supporting mechanism keeps elasticity affordable under the
serverless billing model (every warm GPU bills, busy or idle): each
cycle starts by returning warm GPUs idle longer than
``idle_reclaim_after`` to the unbilled cold pool, fleet-wide — far
earlier than the policy's own ``reclaim_window``.

The controller subscribes to the fabric-wide ``EngineEvent`` stream and
runs one control cycle per ``control_interval`` of simulated time,
keyed off ROUND events — fully deterministic, so elastic runs are
reproducible seed-for-seed.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.cluster.engine import ROUND, ClusterEngine, EngineEvent
from repro_torch.cluster.health import ShardHealth, fleet_health
from repro_torch.cluster.policies.base import admission_key
from repro_torch.core.jobs import Job, exec_time

# Fabric-level event kinds, alongside the engine's ARRIVAL/ROUND/JOB_DONE.
JOB_STOLEN = "job_stolen"          # a pending job migrated between shards
JOB_REJECTED = "job_rejected"      # a submission bounced off a tenant quota
SHARD_RESIZED = "shard_resized"    # autoscaler moved GPUs between shards

# Alert lifecycle kinds, emitted onto the same stream by the obs-layer
# AlertRules evaluator (repro_torch.obs.alerts) via ``fabric.announce``. They
# are defined here — not in obs — so the controller (and the future
# SLO autotuner) can subscribe without a cluster->obs import cycle.
# ``detail`` starts with the firing rule's name: ``"<rule>: <why>"``.
ALERT_FIRED = "alert_fired"        # a rule's condition became true
ALERT_RESOLVED = "alert_resolved"  # the condition cleared

# Failure-aware audit action tags. Drains ride the job_stolen fabric
# event and sheds the job_shed event; quarantine is pure controller
# state, so it exists only in the audit log.
DRAIN = "drain"
QUARANTINE = "quarantine"
SHED = "job_shed"


@dataclass(frozen=True)
class TenantQuota:
    """Per-tenant admission caps; ``None`` leaves a dimension uncapped.

    ``gpu_seconds`` / ``cost_usd`` are *budgets*: a submission is
    rejected when the tenant's committed spend (completed ledger +
    running commitments + pending estimates) plus the new job's own
    estimate would exceed them. ``max_outstanding`` caps how many of the
    tenant's jobs may be queued or running at once."""

    gpu_seconds: Optional[float] = None
    cost_usd: Optional[float] = None
    max_outstanding: Optional[int] = None


@dataclass
class ElasticConfig:
    """Knobs of the elastic control plane."""

    control_interval: float = 2.0     # s of sim time between control cycles
    steal_enabled: bool = True
    autoscale_enabled: bool = True
    pressure_high: float = 1.25       # demand/capacity that marks saturation
    pressure_low: float = 0.25        # below this a shard may donate GPUs
    hysteresis_cycles: int = 1        # consecutive hot cycles before scaling
    autoscale_step: int = 8           # max GPUs a receiver gains per cycle
    autoscale_cooldown: float = 4.0   # s between resizes of the same shard
    min_shard_gpus: int = 1           # shrink floor (== spin-down at 1)
    idle_reclaim_after: Optional[float] = 3.0  # early warm->cold reclaim
    #   window, fleet-wide (None: only the policy's reclaim_window applies)
    max_steals_per_cycle: int = 16
    max_migrations_per_job: int = 3   # anti-thrash: stop bouncing a job
    steal_only_salvageable: bool = True  # steal only when the destination
    #   can still meet the job's SLO (warmth-adjusted completion estimate)
    quotas: Dict[str, TenantQuota] = field(default_factory=dict)
    # Failure awareness — all three act only when the fabric carries a
    # FaultPlane (repro_torch.cluster.faults); without one they are inert.
    drain_on_warning: bool = True     # evacuate preemption-warned shards
    quarantine_enabled: bool = True   # bench flapping shards
    flap_threshold: int = 2           # failures within flap_window to trip
    flap_window: float = 300.0        # s of failure history considered
    quarantine_s: float = 120.0       # re-admission delay (extended while
    #   the shard keeps failing: health-gated, not a fixed timer)
    shed_enabled: bool = True         # degrade gracefully under capacity
    #   loss: drop best-effort jobs that are doomed anyway


def job_gpu_second_estimate(engine: ClusterEngine, job: Job) -> float:
    """A submission's committed-spend estimate for quota purposes: one
    warm replica for the job's full predicted execution."""
    prof = job.profile()
    need = prof.gpus_per_replica
    return need * exec_time(job, need, used_bank=engine.use_bank_for(job),
                            alloc_overhead=prof.warm_overhead)


class ElasticController:
    """Drives steal / autoscale / quota decisions for one fabric.

    Constructed by :class:`~repro_torch.cluster.fabric.ClusterFabric` when
    ``elastic=`` is given; it subscribes itself to the fabric event
    stream and acts through ``fabric.migrate`` / ``fabric.resize_shard``.
    """

    def __init__(self, fabric, cfg: Optional[ElasticConfig] = None):
        self.fabric = fabric
        self.cfg = cfg or ElasticConfig()
        self.steals = 0                   # lifetime counters (introspection)
        self.resizes = 0
        self.rejections = 0
        self.drains = 0                   # jobs evacuated off warned shards
        self.quarantines = 0              # flapping shards benched
        self.sheds = 0                    # doomed best-effort jobs dropped
        # Optional decision sink (duck-typed as repro_torch.obs.audit.AuditLog):
        # when attached — Telemetry.attach does it — every steal / resize
        # / rejection / reclaim records the ShardHealth inputs it acted
        # on, so control actions stay attributable to recorded signals.
        self.audit = None
        # rule name -> fire time for alerts currently firing (populated
        # only when an AlertRules evaluator is attached to the fabric)
        self.active_alerts: Dict[str, float] = {}
        self._next_cycle_at = 0.0
        self._hot_streak: Dict[int, int] = {}
        self._last_resize: Dict[int, float] = {}
        self._migrations: Dict[int, int] = {}   # job_id -> times stolen
        self._quarantined_until: Dict[int, float] = {}   # shard -> t
        self._in_cycle = False
        fabric.on_event(self._on_event)

    # -- quotas (submit-time admission) ---------------------------------------

    def set_quota(self, tenant: str, quota: TenantQuota) -> None:
        self.cfg.quotas[tenant] = quota

    def tenant_commitment(self, tenant: str) -> Tuple[float, float, int]:
        """Fleet-wide committed ``(gpu_seconds, cost_usd, outstanding)``
        for ``tenant``: completed ledgers, plus the full span of running
        jobs (their busy time settles onto the ledger only at
        completion), plus one-replica estimates for queued work."""
        gpu_s = cost = 0.0
        outstanding = 0
        for eng in self.fabric.shards:
            gpu_s += eng.gpu_seconds_by_tenant.get(tenant, 0.0)
            cost += eng.cost_by_tenant.get(tenant, 0.0)
            price = eng.cfg.price_per_gpu_s
            for job, gpus in eng.running.values():
                if job.tenant != tenant:
                    continue
                outstanding += 1
                fin = eng.finish_time_of(job.job_id)
                span = max((fin if fin is not None else eng.now)
                           - job.start_time, 0.0)
                gpu_s += gpus * span
                cost += gpus * span * price * job.slo_class.price_tier
            for job in eng.pending_jobs() + eng.queued_arrivals():
                if job.tenant != tenant:
                    continue
                outstanding += 1
                est = job_gpu_second_estimate(eng, job)
                gpu_s += est
                cost += est * price * job.slo_class.price_tier
        return gpu_s, cost, outstanding

    def admission_error(self, job: Job) -> Optional[str]:
        """``None`` if ``job`` may be admitted; else the rejection
        reason. Called by ``fabric.submit`` before placement."""
        quota = self.cfg.quotas.get(job.tenant)
        if quota is None:
            return None
        gpu_s, cost, outstanding = self.tenant_commitment(job.tenant)
        if (quota.max_outstanding is not None
                and outstanding >= quota.max_outstanding):
            return (f"tenant {job.tenant!r} at max outstanding jobs "
                    f"({outstanding} >= {quota.max_outstanding})")
        eng = self.fabric.shards[0]
        est = job_gpu_second_estimate(eng, job)
        if (quota.gpu_seconds is not None
                and gpu_s + est > quota.gpu_seconds):
            return (f"tenant {job.tenant!r} GPU-second budget exceeded "
                    f"({gpu_s:.0f} committed + {est:.0f} est "
                    f"> {quota.gpu_seconds:.0f})")
        est_cost = (est * eng.cfg.price_per_gpu_s
                    * job.slo_class.price_tier)
        if quota.cost_usd is not None and cost + est_cost > quota.cost_usd:
            return (f"tenant {job.tenant!r} cost cap exceeded "
                    f"(${cost:.2f} committed + ${est_cost:.2f} est "
                    f"> ${quota.cost_usd:.2f})")
        return None

    # -- control loop ----------------------------------------------------------

    def _on_event(self, ev: EngineEvent) -> None:
        if ev.kind in (ALERT_FIRED, ALERT_RESOLVED):
            name = (ev.detail or "").split(":", 1)[0].strip()
            if ev.kind == ALERT_FIRED:
                self.active_alerts[name] = ev.time
                # pressure relief: drop the interval gate so the very
                # next ROUND runs a control cycle instead of waiting
                # out the remainder of control_interval
                self._next_cycle_at = min(self._next_cycle_at, ev.time)
            else:
                self.active_alerts.pop(name, None)
            return
        if ev.kind != ROUND or self._in_cycle:
            return
        if ev.time < self._next_cycle_at:
            return
        self._next_cycle_at = ev.time + self.cfg.control_interval
        # steals/resizes emit fabric events, which re-enter this
        # subscriber; the guard keeps a cycle from triggering itself
        self._in_cycle = True
        try:
            self.control_cycle(ev.time)
        finally:
            self._in_cycle = False

    def _fleet_health(self) -> List[ShardHealth]:
        return fleet_health(self.fabric.shards,
                            getattr(self.fabric, "faults", None))

    def control_cycle(self, t: float) -> None:
        """One deterministic control decision at sim time ``t``."""
        if len(self.fabric.shards) < 2:
            return
        healths = self._fleet_health()
        # Reclaim first: idle warm GPUs return to cold early (billing
        # stops), making low-pressure shards better donors below.
        self._reclaim_idle(t, healths)
        # Failure awareness next: quarantine flappers, evacuate
        # preemption-warned shards, shed doomed best-effort load — all
        # before autoscale/steal read their pressure snapshot, so the
        # healthy mechanisms never route work toward dying capacity.
        faults = getattr(self.fabric, "faults", None)
        if faults is not None:
            self._failure_cycle(t, healths, faults)
            healths = self._fleet_health()
        # Autoscale first, on the undisturbed pressure snapshot: moving
        # cold capacity toward saturated shards keeps their warm pools
        # consolidated (cheap). Stealing then spreads only the overflow
        # the grown shard still cannot serve — if steals ran first they
        # would drain the very queue-pressure signal the autoscaler
        # needs, and the fleet would converge to scattered cold starts.
        if self.cfg.autoscale_enabled:
            self._autoscale_cycle(t, healths)
        if self.cfg.steal_enabled:
            # re-snapshot: resizes changed capacity and free pools
            self._steal_cycle(t, self._fleet_health())

    # -- failure awareness (active only with a FaultPlane on the fabric) -------

    def is_quarantined(self, shard: int, t: float) -> bool:
        """Is ``shard`` currently benched for flapping? Consulted by
        ``fabric.shard_admissible`` (placement + retries) and by the
        steal/autoscale destination filters."""
        return t < self._quarantined_until.get(shard, float("-inf"))

    def _failure_cycle(self, t: float, healths: List[ShardHealth],
                       faults) -> None:
        cfg = self.cfg
        if cfg.quarantine_enabled:
            self._quarantine_cycle(t, faults)
        if cfg.drain_on_warning and faults.warned:
            self._drain_cycle(t, healths, faults)
        if cfg.shed_enabled and faults.capacity_lost() > 0:
            self._shed_cycle(t, faults)

    def _quarantine_cycle(self, t: float, faults) -> None:
        """Bench shards whose recent failure count marks them as
        flapping. Re-admission is health-gated, not a fixed timer: a
        shard that keeps failing inside the window has its bench
        extended every cycle, and only ages back in once its failure
        history clears ``flap_window``."""
        cfg = self.cfg
        for i in range(len(self.fabric.shards)):
            if faults.is_down(i):
                continue               # dead shards need no bench
            fails = faults.recent_failures(i, t, cfg.flap_window)
            if fails < cfg.flap_threshold:
                continue
            newly = not self.is_quarantined(i, t)
            self._quarantined_until[i] = max(
                self._quarantined_until.get(i, float("-inf")),
                t + cfg.quarantine_s)
            if newly:
                self.quarantines += 1
                if self.audit is not None:
                    self.audit.decision(
                        time=t, action=QUARANTINE, shard=i,
                        detail=(f"{fails} failures in {cfg.flap_window:g}s "
                                f">= {cfg.flap_threshold}; benched until "
                                f"t={t + cfg.quarantine_s:g}"),
                        inputs={"recent_failures": fails})

    def _drain_cycle(self, t: float, healths: List[ShardHealth],
                     faults) -> None:
        """Proactively evacuate pending work off preemption-warned
        shards during the warning lead time — moved jobs restart from a
        queue, not from a crash, so no retry budget is spent and no
        checkpoint is lost."""
        shards = self.fabric.shards
        by_shard = {h.shard: h for h in healths}
        free = {h.shard: h.free_capacity for h in healths}
        for src in sorted(faults.warned):
            for job in list(shards[src].pending_jobs()):
                need = job.profile().gpus_per_replica
                best = None
                best_key = None
                for h in healths:
                    dst = h.shard
                    if (dst == src or shards[dst].cfg.max_gpus < need
                            or not self.fabric.shard_admissible(dst)):
                        continue
                    if free[dst] < need:
                        # a drain only beats the orphan->retry path when
                        # the destination can actually start the job;
                        # pushing evacuees into a saturated queue just
                        # trades one wait for another and forfeits the
                        # warned shard's remaining lead-time throughput
                        continue
                    warm = len(shards[dst].pool(job.llm).idle) >= need
                    key = (warm, free[dst], -dst)
                    if best_key is None or key > best_key:
                        best, best_key = dst, key
                if best is None:
                    continue           # nowhere to go: the crash path
                #   (orphan -> retry) will pick the job up instead
                if self.fabric.migrate(job.job_id, best, at=t):
                    free[best] -= need
                    self.drains += 1
                    if self.audit is not None:
                        self.audit.decision(
                            time=t, action=DRAIN, shard=best,
                            job_id=job.job_id, tenant=job.tenant,
                            detail=(f"evacuated shard {src} (preemption "
                                    f"warned) -> {best}"),
                            inputs={"src": by_shard[src],
                                    "dst": by_shard[best]})

    def _shed_cycle(self, t: float, faults) -> None:
        """Graceful degradation while the fleet is short on capacity:
        drop pending *best-effort* jobs that would miss their SLO even
        if started right now at the maximum feasible replica count —
        they can only burn GPUs premium/standard jobs need, and their
        violation is already certain."""
        gmax = max(e.cfg.max_gpus for e in self.fabric.shards)
        for eng in self.fabric.shards:
            for job in list(eng.pending_jobs()):
                if job.slo_class.priority >= 0:
                    continue           # only best-effort class is shed
                prof = job.profile()
                gpus = min(eng.cfg.max_replicas_per_job
                           * prof.gpus_per_replica, max(gmax, 1))
                if gpus < prof.gpus_per_replica:
                    continue
                best_fin = t + exec_time(
                    job, gpus, used_bank=eng.use_bank_for(job),
                    alloc_overhead=prof.warm_overhead)
                if best_fin <= job.deadline:
                    continue           # still salvageable: keep it
                if eng.extract_pending(job.job_id) is None:
                    continue
                self.sheds += 1
                if self.audit is not None:
                    self.audit.decision(
                        time=t, action=SHED, shard=-1, job_id=job.job_id,
                        tenant=job.tenant,
                        detail=(f"best-effort job doomed (best finish "
                                f"{best_fin:.0f} > deadline "
                                f"{job.deadline:.0f}) while fleet is "
                                f"{faults.capacity_lost()} GPUs short"))
                self.fabric.shed_job(job, t,
                                     "degraded fleet: doomed best-effort "
                                     "load shed")
        # Second stage: doomed best-effort jobs *holding GPUs* while
        # higher classes queue on the same shard. Their violation is
        # already certain (scheduled finish past deadline), so every
        # extra second they run starves salvageable premium/standard
        # work of capacity the degraded fleet no longer has — kill them
        # and let the queue claim the GPUs at the next round. The
        # terminal record is a violated shed either way.
        for eng in self.fabric.shards:
            if not any(j.slo_class.priority >= 0
                       for j in eng.pending_jobs()):
                continue
            for job_id, (job, gpus) in list(eng.running.items()):
                if job.slo_class.priority >= 0:
                    continue
                fin = eng.finish_time_of(job_id)
                if fin is None or fin <= job.deadline:
                    continue
                if eng.cancel_running(job_id, t) is None:
                    continue
                eng.ensure_round(t)
                self.sheds += 1
                if self.audit is not None:
                    self.audit.decision(
                        time=t, action=SHED, shard=-1, job_id=job.job_id,
                        tenant=job.tenant,
                        detail=(f"doomed running best-effort job "
                                f"(scheduled finish {fin:.0f} > deadline "
                                f"{job.deadline:.0f}) preempted for "
                                f"queued premium/standard work"))
                self.fabric.shed_job(job, t,
                                     "degraded fleet: doomed running "
                                     "best-effort job preempted")

    # -- mechanism 0: early fleet-wide idle reclaim ----------------------------

    def _reclaim_idle(self, t: float, healths: List[ShardHealth]) -> None:
        """Billing control: warm GPUs idle for more than
        ``idle_reclaim_after`` seconds return to the (unbilled) cold
        pool now, on every shard, instead of waiting out the policy's
        full ``reclaim_window``. Serverless billing charges for every
        warm GPU, so spread-out elastic fleets would otherwise pay for
        warm pools the next burst may never revisit; a busy shard is
        naturally untouched (its pools have no idle GPUs to take)."""
        window = self.cfg.idle_reclaim_after
        if window is None:
            return
        for h in healths:
            if h.warm_idle > 0:
                n = self.fabric.shards[h.shard].view.mature_and_reclaim(
                    window)
                if n > 0 and self.audit is not None:
                    self.audit.decision(
                        time=t, action="idle_reclaim", shard=h.shard,
                        detail=f"{n} warm GPUs idle > {window:g}s -> cold",
                        inputs={"shard": h})

    # -- mechanism 1: cross-shard work stealing --------------------------------

    def _overflow_jobs(self, eng: ClusterEngine, h: ShardHealth) -> List[Job]:
        """Pending jobs beyond what the shard's currently free capacity
        can serve, in admission order: the shard keeps the highest-
        priority prefix it can cover; the tail is steal-eligible.
        In-flight warming GPUs count as local capacity — the policy has
        already paid their cold start for exactly these jobs, and
        stealing them away would strand freshly warmed (billed) GPUs."""
        jobs = sorted(eng.pending_jobs(), key=admission_key)
        warming = sum(len(p.warming) for p in eng.pools.values())
        local = h.cold_free + h.warm_idle + warming
        overflow: List[Job] = []
        for job in jobs:
            need = job.profile().gpus_per_replica
            if local >= need:
                local -= need
            else:
                overflow.append(job)
        return overflow

    def _steal_cycle(self, t: float, healths: List[ShardHealth]) -> None:
        shards = self.fabric.shards
        by_shard = {h.shard: h for h in healths}
        free = {h.shard: h.free_capacity for h in healths}
        moves = 0
        for h in sorted(healths, key=lambda x: x.pressure, reverse=True):
            if h.pressure <= self.cfg.pressure_high or h.pending_jobs == 0:
                break
            src = h.shard
            for job in self._overflow_jobs(shards[src], h):
                if moves >= self.cfg.max_steals_per_cycle:
                    return
                if (self._migrations.get(job.job_id, 0)
                        >= self.cfg.max_migrations_per_job):
                    continue
                prof = job.profile()
                need = prof.gpus_per_replica
                best = None
                best_key = None
                for hd in healths:
                    dst = hd.shard
                    if dst == src or shards[dst].cfg.max_gpus < need:
                        continue
                    if free[dst] < need:
                        continue
                    if not self.fabric.shard_admissible(dst):
                        continue   # dead / warned / quarantined shard
                    warm = len(shards[dst].pool(job.llm).idle) >= need
                    if self.cfg.steal_only_salvageable:
                        # SLO-aware: move only where the (warmth-
                        # adjusted) completion still makes the deadline.
                        # A job no destination can save stays queued —
                        # its demand keeps the autoscaler's pressure
                        # signal honest instead of paying a pointless
                        # cold start elsewhere.
                        ov = (prof.warm_overhead if warm
                              else prof.cold_overhead)
                        fin = t + exec_time(
                            job, need,
                            used_bank=shards[dst].use_bank_for(job),
                            alloc_overhead=ov)
                        if fin > job.deadline:
                            continue
                    key = (warm, free[dst], -dst)   # warmth, then headroom
                    if best_key is None or key > best_key:
                        best, best_key = dst, key
                if best is None:
                    continue
                if self.fabric.migrate(job.job_id, best, at=t):
                    free[best] -= need
                    free[src] += need
                    self._migrations[job.job_id] = (
                        self._migrations.get(job.job_id, 0) + 1)
                    moves += 1
                    self.steals += 1
                    if self.audit is not None:
                        self.audit.decision(
                            time=t, action=JOB_STOLEN, shard=best,
                            job_id=job.job_id, tenant=job.tenant,
                            detail=f"shard {src} -> {best}",
                            inputs={"src": h, "dst": by_shard[best]})

    # -- mechanism 2: queue-pressure autoscaling -------------------------------

    def _shrink_floor(self, eng: ClusterEngine) -> int:
        """Never shrink a shard below the replica unit of any job routed
        to it (pending or still-queued arrival) — a shard smaller than a
        queued job's replica would insta-violate it on arrival."""
        need = self.cfg.min_shard_gpus
        for job in eng.pending_jobs() + eng.queued_arrivals():
            need = max(need, job.profile().gpus_per_replica)
        return need

    def _autoscale_cycle(self, t: float, healths: List[ShardHealth]) -> None:
        cfg = self.cfg
        shards = self.fabric.shards
        for h in healths:
            if h.pressure > cfg.pressure_high:
                self._hot_streak[h.shard] = self._hot_streak.get(h.shard, 0) + 1
            else:
                self._hot_streak[h.shard] = 0

        def cooled(i: int) -> bool:
            return t - self._last_resize.get(i, -1e18) >= cfg.autoscale_cooldown

        receivers = [h for h in healths
                     if self._hot_streak.get(h.shard, 0) >= cfg.hysteresis_cycles
                     and cooled(h.shard)
                     and self.fabric.shard_admissible(h.shard)]
        donors = [h for h in healths
                  if h.pressure < cfg.pressure_low and cooled(h.shard)
                  and h.cold_free > 0]
        if not receivers or not donors:
            return
        receivers.sort(key=lambda x: x.pressure, reverse=True)
        donors.sort(key=lambda x: (x.pressure, -x.cold_free))
        spare = {d.shard: max(0, min(d.cold_free,
                                     d.gpus - self._shrink_floor(
                                         shards[d.shard])))
                 for d in donors}
        for r in receivers:
            want = cfg.autoscale_step
            for d in donors:
                if want <= 0:
                    break
                if d.shard == r.shard or spare[d.shard] <= 0:
                    continue
                k = min(want, spare[d.shard])
                before = shards[d.shard].cfg.max_gpus
                after = self.fabric.resize_shard(d.shard, before - k, at=t)
                moved = before - after   # shrink clamps to the cold pool
                if moved <= 0:
                    spare[d.shard] = 0
                    continue
                r_before = shards[r.shard].cfg.max_gpus
                r_after = self.fabric.resize_shard(r.shard, r_before + moved,
                                                   at=t)
                if self.audit is not None:
                    # one audit entry per emitted SHARD_RESIZED event,
                    # each carrying the pre-decision health snapshots
                    self.audit.decision(
                        time=t, action=SHARD_RESIZED, shard=d.shard,
                        detail=(f"{before} -> {after} GPUs (donor; "
                                f"pressure {d.pressure:.2f} < "
                                f"{cfg.pressure_low:g})"),
                        inputs={"shard": d, "receiver": r})
                    self.audit.decision(
                        time=t, action=SHARD_RESIZED, shard=r.shard,
                        detail=(f"{r_before} -> {r_after} GPUs (receiver; "
                                f"pressure {r.pressure:.2f} > "
                                f"{cfg.pressure_high:g} for "
                                f"{self._hot_streak.get(r.shard, 0)} "
                                f"cycles)"),
                        inputs={"shard": r, "donor": d})
                spare[d.shard] -= moved
                want -= moved
                self.resizes += 1
                self._last_resize[d.shard] = t
                self._last_resize[r.shard] = t
