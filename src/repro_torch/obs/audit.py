"""Elastic-decision audit log: every control action with the signals
that justified it.

SLO-Guard's premise — SLO-constrained autotuning is only trustworthy
when every decision is attributable to recorded signals — applied to
our control plane: each steal / resize / rejection / reclaim the
:class:`~repro_torch.cluster.elastic.ElasticController` performs is recorded
as an :class:`AuditEntry` carrying the :class:`~repro_torch.cluster.health.
ShardHealth` snapshot(s) the controller *acted on* (captured before the
action mutated the fleet, not re-derived after the fact). "Why did
shard 3 shrink at t=812?" is then answerable from the artifact::

    for e in audit.explain(shard=3, t=812.0):
        print(e.time, e.action, e.detail, e.inputs)

The log is a passive sink: the controller only writes into it when one
is attached (``Telemetry.attach`` does this), so un-instrumented runs
pay nothing.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.cluster.health import ShardHealth

# Audit action tags mirror the fabric event kinds they pair with, plus
# the reclaim action (which has no fabric event — it is pure billing
# upkeep inside a control cycle).
STEAL, RESIZE, REJECT, RECLAIM = ("job_stolen", "shard_resized",
                                  "job_rejected", "idle_reclaim")


def health_dict(h: ShardHealth) -> Dict[str, float]:
    """A ShardHealth snapshot as a JSON-able dict, including the derived
    pressure/free-capacity signals the controller thresholds on."""
    d = dataclasses.asdict(h)
    d["pressure"] = h.pressure
    d["free_capacity"] = h.free_capacity
    return d


@dataclass(frozen=True)
class AuditEntry:
    """One recorded control decision.

    ``inputs`` maps a role name (``"src"`` / ``"dst"`` for steals,
    ``"shard"`` for resizes and reclaims, ``"fleet"`` for rejections)
    to the ShardHealth dict(s) the decision read. ``shard`` is the
    primary acted-on shard (receiver for steals, resized shard for
    resizes, -1 for fleet-level rejections)."""

    time: float
    action: str
    shard: int
    job_id: Optional[int] = None
    tenant: Optional[str] = None
    detail: str = ""
    inputs: Dict[str, object] = field(default_factory=dict)

    def to_dict(self) -> Dict:
        return {"type": "audit", "time": self.time, "action": self.action,
                "shard": self.shard, "job_id": self.job_id,
                "tenant": self.tenant, "detail": self.detail,
                "inputs": self.inputs}

    @classmethod
    def from_dict(cls, d: Dict) -> "AuditEntry":
        return cls(time=float(d["time"]), action=d["action"],
                   shard=int(d["shard"]), job_id=d.get("job_id"),
                   tenant=d.get("tenant"), detail=d.get("detail", ""),
                   inputs=d.get("inputs", {}))


class AuditLog:
    """Append-only decision record with time/shard/action queries."""

    def __init__(self) -> None:
        self.entries: List[AuditEntry] = []

    def record(self, entry: AuditEntry) -> None:
        self.entries.append(entry)

    def decision(self, *, time: float, action: str, shard: int,
                 job_id: Optional[int] = None,
                 tenant: Optional[str] = None, detail: str = "",
                 inputs: Optional[Dict[str, object]] = None) -> AuditEntry:
        """Build-and-record convenience used by the ElasticController.
        ``inputs`` values may be :class:`ShardHealth` snapshots (converted
        to dicts) or anything already JSON-able. The controller only
        duck-types this sink, so :mod:`repro_torch.cluster.elastic` carries no
        import-time dependency on the obs package."""
        conv: Dict[str, object] = {}
        for role, v in (inputs or {}).items():
            conv[role] = health_dict(v) if isinstance(v, ShardHealth) else v
        entry = AuditEntry(time=time, action=action, shard=shard,
                           job_id=job_id, tenant=tenant, detail=detail,
                           inputs=conv)
        self.record(entry)
        return entry

    def __len__(self) -> int:
        return len(self.entries)

    # -- queries -------------------------------------------------------------

    def query(self, *, action: Optional[str] = None,
              shard: Optional[int] = None,
              job_id: Optional[int] = None,
              t0: float = float("-inf"),
              t1: float = float("inf")) -> List[AuditEntry]:
        """Entries matching every given filter, in record order."""
        out = []
        for e in self.entries:
            if action is not None and e.action != action:
                continue
            if shard is not None and e.shard != shard:
                continue
            if job_id is not None and e.job_id != job_id:
                continue
            if not t0 <= e.time <= t1:
                continue
            out.append(e)
        return out

    def explain(self, *, shard: int, t: float,
                around: float = 30.0) -> List[AuditEntry]:
        """The decisions touching ``shard`` within ``around`` seconds of
        ``t`` — the "why did shard 3 shrink at t=812?" query."""
        return self.query(shard=shard, t0=t - around, t1=t + around)

    # -- export --------------------------------------------------------------

    def to_dicts(self) -> List[Dict]:
        return [e.to_dict() for e in self.entries]
