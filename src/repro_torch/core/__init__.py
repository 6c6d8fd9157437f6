from repro_torch.core.bank_builder import (
    ScoreContext,
    build_bank,
    make_score_fn,
    select_manual,
)
from repro_torch.core.prompt_bank import LookupResult, PromptBank, PromptEntry

__all__ = [
    "LookupResult",
    "PromptBank",
    "PromptEntry",
    "ScoreContext",
    "build_bank",
    "make_score_fn",
    "select_manual",
]
