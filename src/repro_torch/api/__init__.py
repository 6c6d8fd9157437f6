"""repro_torch.api — the service layer tying bank + tuner + scheduler into the
system the paper describes. See :class:`PromptTunerService`."""
from repro_torch.api.service import PromptTunerService
from repro_torch.api.types import JobHandle, JobResult, SubmitRequest
from repro_torch.cluster.engine import EngineEvent
from repro_torch.cluster.fabric import ClusterFabric
from repro_torch.core.jobs import SLO_CLASSES, SLOClass

__all__ = [
    "ClusterFabric",
    "EngineEvent",
    "JobHandle",
    "JobResult",
    "PromptTunerService",
    "SLOClass",
    "SLO_CLASSES",
    "SubmitRequest",
]
