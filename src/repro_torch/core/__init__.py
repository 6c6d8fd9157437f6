from repro_torch.core.bank_builder import (
    ScoreContext,
    build_bank,
    build_bank_from_pretrain,
    make_score_fn,
    measure_ita,
    select_ideal,
    select_induction,
    select_manual,
    select_score,
)
from repro_torch.core.prompt_bank import LookupResult, PromptBank, PromptEntry

__all__ = [
    "LookupResult",
    "PromptBank",
    "PromptEntry",
    "ScoreContext",
    "build_bank",
    "build_bank_from_pretrain",
    "make_score_fn",
    "measure_ita",
    "select_ideal",
    "select_induction",
    "select_manual",
    "select_score",
]
