from repro_torch.data.pipeline import LoaderConfig, TaskLoader
from repro_torch.data.synthetic import (
    BOS,
    FAMILIES,
    PAD,
    SEP,
    TaskSpec,
    batch_to_torch,
    make_tasks,
    sample_batch,
)

__all__ = [
    "BOS",
    "FAMILIES",
    "LoaderConfig",
    "PAD",
    "SEP",
    "TaskLoader",
    "TaskSpec",
    "batch_to_torch",
    "make_tasks",
    "sample_batch",
]
