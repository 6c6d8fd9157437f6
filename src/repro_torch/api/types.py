"""Typed request/handle/result surface of the PromptTuner service."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union

import numpy as np

from repro_torch.core.jobs import DEFAULT_TENANT, SLOClass


@dataclass
class SubmitRequest:
    """One LPT request as a user of the service states it (Table 3).

    ``iters_manual`` / ``iters_bank`` are the iterations-to-accuracy with
    the user's manual initial prompt vs. a bank-provided one (in the full
    testbed they come out of real tuning runs; the trace generator
    synthesizes them from the calibration distributions).

    ``tenant`` / ``slo_class`` identify who submitted and which service
    class they bought: the class's SLO multiplier scales ``slo`` (premium
    tightens, best-effort relaxes), its priority orders admission, and
    its price tier scales the tenant's billing ledger. ``slo_class``
    accepts a catalogue name (``premium`` / ``standard`` /
    ``best-effort``) or an :class:`~repro_torch.core.jobs.SLOClass`; omitted
    means the standard single-tenant behaviour, unchanged.

    ``prompt`` / ``feature`` optionally carry the freshly tuned soft
    prompt and its activation feature; when present, the service inserts
    the prompt into the bank once the job finishes — the online insertion
    loop of Fig 5b.
    """

    task_id: str
    llm: str
    slo: float                         # seconds from submission
    iters_manual: int
    iters_bank: int
    submit_time: Optional[float] = None    # None => service clock "now"
    max_iters: int = 10_000
    tenant: str = DEFAULT_TENANT
    slo_class: Optional[Union[str, SLOClass]] = None
    prompt: Optional[np.ndarray] = None
    feature: Optional[np.ndarray] = None


@dataclass(frozen=True)
class JobHandle:
    """Returned by ``submit``: identity plus the routing decision.

    A submission bounced off a tenant quota comes back with
    ``rejected=True`` (and ``shard=-1``): the job was never placed,
    never runs, and never bills; ``reject_reason`` carries the quota
    dimension that tripped (GPU-second budget / cost cap / outstanding
    cap)."""

    job_id: int
    task_id: str
    llm: str
    submitted_at: float
    routed_through_bank: bool          # §4.4.3 latency-budget decision
    tenant: str = DEFAULT_TENANT
    slo_class: str = "standard"        # resolved service-class name
    shard: int = 0                     # fabric shard the job was placed on
    effective_slo: Optional[float] = None  # slo x class multiplier (s)
    bank_origin: Optional[str] = None  # origin of the looked-up initial prompt
    bank_score: Optional[float] = None # its Eqn-1 score
    initial_prompt: Optional[np.ndarray] = None  # the prompt itself, for tuning
    rejected: bool = False             # tenant quota bounced this submission
    reject_reason: Optional[str] = None
    # Attached by a telemetry-enabled service (repro_torch.obs.Telemetry);
    # identity-only plumbing, excluded from equality/repr.
    telemetry: Optional[object] = field(default=None, repr=False,
                                        compare=False)

    def timeline(self):
        """This job's recorded lifecycle spans
        (:class:`~repro_torch.obs.spans.JobTimeline`), available when the
        service was built with ``telemetry=``. Grows as events fold in;
        complete after ``run_until_idle``."""
        if self.telemetry is None:
            raise ValueError(
                "no telemetry recorded for this job: construct the service "
                "with telemetry=True (or a repro_torch.obs.Telemetry instance)")
        return self.telemetry.timeline.timeline(self.job_id)


@dataclass(frozen=True)
class JobResult:
    """Returned by ``run_until_idle`` for each newly finished job."""

    handle: JobHandle
    gpus: int
    start: float
    finish: float
    violated: bool
    wait: float
    used_bank: bool
    init_overhead: float
    inserted_to_bank: bool             # Fig 5b online insertion happened
    retries: int = 0                   # crash-recovery re-placements

    @property
    def completed(self) -> bool:
        return np.isfinite(self.finish)
