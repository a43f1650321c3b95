"""Serving beyond the single loop (the counterpart of
``flexflow_tpu/serving``): for now the request journal; the scheduler
and the fleet come with ROADMAP.md queue 1, item 8."""

from flexflow_torch.serving.journal import (
    EV_ADMIT,
    EV_DONE,
    EV_DRAIN,
    EV_TOKENS,
    KNOWN_KINDS,
    JournalState,
    MemoryJournal,
    RequestJournal,
    fold_journal_events,
)

__all__ = ["EV_ADMIT", "EV_DONE", "EV_DRAIN", "EV_TOKENS", "KNOWN_KINDS",
           "JournalState", "MemoryJournal", "RequestJournal",
           "fold_journal_events"]
