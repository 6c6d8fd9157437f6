"""String-keyed scheduling-policy registry (the policy half of the
policy/mechanism split).

    from repro_torch.cluster import SimConfig, policies

    policies.available()                 # ['edf-cold', 'elasticflow', ...]
    cls = policies.get("prompttuner")    # policy class
    engine = policies.build("prompttuner", SimConfig(max_gpus=32))
    result = engine.run(jobs)
"""
from repro_torch.cluster.policies.base import SchedulingPolicy, available, get, register

# importing a module registers its policies
from repro_torch.cluster.policies.prompttuner import PromptTunerPolicy
from repro_torch.cluster.policies.infless import INFlessPolicy
from repro_torch.cluster.policies.elasticflow import ElasticFlowPolicy
from repro_torch.cluster.policies.simple import EDFColdPolicy, FIFOPolicy


def build(name: str, cfg=None):
    """Engine + policy in one call: the standard way to stand up a
    system. Returns a ready-to-``run`` ClusterEngine."""
    from repro_torch.cluster.engine import ClusterEngine, SimConfig
    cfg = cfg or SimConfig()
    return ClusterEngine(cfg, get(name)(cfg))


__all__ = [
    "EDFColdPolicy",
    "ElasticFlowPolicy",
    "FIFOPolicy",
    "INFlessPolicy",
    "PromptTunerPolicy",
    "SchedulingPolicy",
    "available",
    "build",
    "get",
    "register",
]
